"""The port's 2D panels (`eval/vis2d.py`) against the JAX package's on the
same seeded inputs at 24x32, and the stage-1 validator's "images" against
JAX's validator's.

Each panel is compared as the uint8 image a writer stores, round(255 x):
at most 1 level apart (the PCA's SVD and the colour maps in other fp32
orders). The k-means map takes k-means++'s draws from JAX's key
(tests/test_torch_downstream.py rebuilds them). `compute_profile`, which
gives a map and not a panel, is held to 1e-6. The validator runs one batch
of tests/test_torch_eval_forward.py's model with the render's draws from
JAX's key and the panel's k-means draws from PRNGKey(0), as JAX's draws.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.vis2d as J
import scenedino_tpu.training.validation as jvalidation
from scenedino_torch.eval import vis2d
from scenedino_torch.training import trainer, validation
from tests.test_torch_downstream import _kmeans_pp_draws
from tests.test_torch_eval_forward import V, H, W, _coarse_draws, _configs, _eval_batch, _t, models  # noqa: F401

PH, PW = 24, 32
VAL_CFG = {"metrics": [{"type": "depth", "args": None}, {"type": "dino", "args": None}]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _levels(panel):
    return np.round(np.clip(np.asarray(panel, np.float64), 0, 1) * 255).astype(np.int64)


def _same_panel(ours, ref, name=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    assert np.abs(_levels(ours) - _levels(ref)).max() <= 1, name


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    feats = rng.normal(size=(PH, PW, 16)).astype(np.float32)
    segs = rng.integers(-1, 19, size=(PH, PW))
    weights = u(PH, PW, 8)
    return {
        "imgs": u(2, 3, PH, PW, lo=-1), "depth": u(PH, PW, lo=1, hi=100), "rgb": u(PH, PW, 3),
        "rgb_gt": u(PH, PW, 3), "dino_features": feats,
        "dino_gt": (feats + 0.5 * rng.normal(size=feats.shape)).astype(np.float32), "segs_pred": segs,
        "segs_gt": np.roll(segs, 3, 1), "invalid": u(PH, PW, 2, 1) > 0.5, "weights": weights / 4,
        "z_samps": np.sort(u(PH, PW, 8, lo=3, hi=80), -1), "uncert": u(PH, PW),
        "profiles": J.compute_profile(u(16, 12, 8, hi=0.4), u(16, 12, 8) > 0.9),
        "dino_artifacts": rng.normal(size=(PH, PW, 12)).astype(np.float32), "downsample_weight": u(PH, PW),
        "downsample_salience": u(PH, PW, lo=-2, hi=2), "per_patch_weight": u(PH, PW),
        "flows_fwd": u(PH, PW, 2, lo=-3, hi=3), "flows_bwd": u(PH, PW, 2, lo=-3, hi=3),
        "rendered_flow": u(PH, PW, 2, lo=-0.1, hi=0.1), "occs_fwd": u(PH, PW), "occs_bwd": u(PH, PW),
        "occ_pred": u(PH, PW), "depths": u(PH, PW, lo=0, hi=60),
    }


# each panel function and the input keys it takes
PANELS = {
    "colormap": ("uncert",), "get_input_imgs": ("imgs",), "get_depth": ("depth",),
    "get_reconstruction": ("rgb",), "get_dino_pca": ("dino_features",), "get_segmentation": ("segs_pred",),
    "get_alpha_profile": ("weights",), "get_reconstruction_rmse": ("rgb", "rgb_gt"),
    "get_dino_cos_sim": ("dino_features", "dino_gt"), "get_invalids": ("invalid",),
    "get_ray_entropy": ("weights", "z_samps"), "get_ray_entropy_weights": ("weights",),
    "get_per_patch_weight": ("per_patch_weight",), "get_alpha_sum": ("weights",),
    "get_depth_profile": ("z_samps", "weights"), "get_profiles": ("profiles",), "get_uncertainty": ("uncert",),
    "get_downsampling_weight": ("downsample_weight",), "get_downsampling_salience": ("downsample_salience",),
    "get_dino_artifacts": ("dino_artifacts",), "flow_to_image": ("flows_fwd",),
    "get_flow": ("flows_fwd", "flows_bwd"), "get_occlusions": ("occs_fwd", "occs_bwd"),
    "get_predicted_occlusions": ("occ_pred",), "get_depth_direct": ("depths",),
}


@pytest.mark.parametrize("name", list(PANELS))
def test_panel_matches_jax(inputs, name):
    args = [inputs[k] for k in PANELS[name]]
    _same_panel(getattr(vis2d, name)(*args), getattr(J, name)(*args), name)


def test_rendered_flow_kmeans_and_profile_match_jax(inputs):
    f = inputs["rendered_flow"]
    _same_panel(vis2d.get_rendered_flow(f, PH, PW), J.get_rendered_flow(f, PH, PW))
    feats = inputs["dino_features"]
    for k, seed in ((8, 0), (5, 3)):
        draws = _kmeans_pp_draws(jax.random.PRNGKey(seed), PH * PW, k)
        _same_panel(vis2d.get_kmeans_map(feats, k, draws=draws), J.get_kmeans_map(feats, k, seed=seed))
    sig = np.random.default_rng(1).uniform(0, 0.4, size=(16, 12, 8)).astype(np.float32)
    for dim in (0, 1, 2):
        np.testing.assert_allclose(vis2d.compute_profile(torch.from_numpy(sig), sig > 0.35, dim),
                                   J.compute_profile(sig, sig > 0.35, dim), atol=1e-6)
    # a panel of tensors is the panel of their values
    _same_panel(vis2d.get_depth(torch.from_numpy(inputs["depth"])), J.get_depth(inputs["depth"]))


def _jax_kmeans_draws(n_points, n_clusters, generator):
    """k-means++'s draws of JAX's get_kmeans_map (PRNGKey(0)), for the port's."""
    return _kmeans_pp_draws(jax.random.PRNGKey(0), n_points, n_clusters)


def test_tb_visualize_matches_jax(inputs, monkeypatch):
    monkeypatch.setattr(vis2d, "draw_kmeans_pp", _jax_kmeans_draws)
    ours, ref = vis2d.tb_visualize(inputs), J.tb_visualize(inputs)
    assert sorted(ours) == sorted(ref) and len(ref) == 25
    for name in ref:
        _same_panel(ours[name], ref[name], name)


def test_stage1_validator_images_match_jax(models, monkeypatch):  # noqa: F811
    """One batch through both validators: the "images" panels of JAX's
    against the port's, the port's render fed JAX's draws."""
    jfield, params, model = models
    jt, tt, jr, tr = _configs()
    batch = _eval_batch(8, 1)
    key = jax.random.PRNGKey(10)
    jv = jvalidation.make_stage1_validator("validation", VAL_CFG, jfield, jt, jr,
                                           lambda: iter([{k: jnp.asarray(v) for k, v in batch.items()}]))
    ref = jv(types.SimpleNamespace(params=params), key)["images"]

    u = _coarse_draws(jax.random.split(key)[1], V * H * W)
    real = trainer.stage1_eval_forward
    monkeypatch.setattr(trainer, "stage1_eval_forward",
                        lambda field, b, cfg, rcfg, generator=None, **kw: real(field, b, cfg, rcfg, u=u, **kw))
    monkeypatch.setattr(vis2d, "draw_kmeans_pp", _jax_kmeans_draws)
    v = validation.make_stage1_validator("validation", VAL_CFG, model, tt, tr,
                                         lambda: iter([{k: _t(x) for k, x in batch.items()}]))
    ours = v(None, torch.Generator())["images"]
    assert sorted(ours) == sorted(ref) == sorted(["input_imgs", "depth", "reconstruction", "reconstruction_rmse",
                                                  "dino_pca", "dino_kmeans", "dino_cos_sim", "dino_gt_pca"])
    for name in ref:
        _same_panel(ours[name], ref[name], name)
