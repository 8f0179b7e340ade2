"""The port's validation render and stage-1 metrics against the reference's
on the same weights, inputs and draws (CPU, fp32).

The model is tests/test_torch_training.py's: the flagship's structure with
a ViT-S/8 student and teacher cut to width 64, depth 3, 2 heads; 32x64
images, V = 4; the JAX tree drawn from a seed and carried across with
`load_jax_params`. The render's draws are rebuilt from the JAX key: at
V*H*W = 8192 rays the reference's chunked render is one `render_rays`
call, whose coarse draws are `uniform(split(key, 5)[0])`.

Bounds: rays and the distance-to-z factors to fp32 rounding (rtol 1e-6,
atol 1e-6); the render's depth and rgb rtol 1e-4 (sums in other orders
through a ViT, a DPT and the compositing) with atol 1e-5 for colours near
0 (a colour is a weighted sum in [0, 1]), the pooled and teacher DINO
grids atol 1e-5; the metrics on equal inputs rtol 1e-5; the validator's
metric dict over two batches rtol 1e-4.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.core.geometry as jgeometry
import scenedino_tpu.core.ray_sampler as jray_sampler
import scenedino_tpu.eval.metrics as jmetrics
import scenedino_tpu.renderer.nerf as jnerf
import scenedino_tpu.training.trainer as jtrain
import scenedino_tpu.training.validation as jvalidation
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_torch.core import geometry
from scenedino_torch.core.ray_sampler import ImageRaySampler
from scenedino_torch.eval import metrics
from scenedino_torch.models.factory import make_model
from scenedino_torch.renderer.nerf import RenderConfig
from scenedino_torch.training import trainer, validation
from scenedino_torch.utils.convert import load_jax_params
from tests.test_torch_training import MODEL, _batch, _random_params

V, H, W = 4, 32, 64
N_COARSE = 8
VAL_CFG = {
    "metrics": [{"type": "depth", "args": {"to_z": True}}, {"type": "dino", "args": None},
                {"type": "nvs", "args": None}],
    "save_best": {"metric": "dino_cos_sim", "sign": 1},
    "events": [{"type": "ITERATION_COMPLETED", "args": {"every": 7}}],
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def models():
    jfield = j_make_model(MODEL)
    params = _random_params(jfield, _batch(), seed=3)
    model = make_model(MODEL, device="cpu", training=True)
    assert load_jax_params(model, params["params"]) == []
    return jfield, params, model


def _eval_batch(seed, B):
    b = _batch(seed)
    rng = np.random.default_rng(seed + 100)
    depths = rng.uniform(4.0, 40.0, size=(2, 1, H, W)).astype(np.float32)
    depths[rng.uniform(size=depths.shape) < 0.1] = 0.0  # invalid ground truth
    b["depths"] = depths
    return {k: v[:B] for k, v in b.items()}


def _configs():
    return jtrain.TrainConfig(), trainer.TrainConfig(), jnerf.RenderConfig(n_coarse=N_COARSE), \
        RenderConfig(n_coarse=N_COARSE)


def _coarse_draws(key, n_rays):
    return _t(jax.random.uniform(jax.random.split(key, 5)[0], (n_rays, N_COARSE)))


def test_image_ray_sampler_matches_reference():
    rng = np.random.default_rng(1)
    b = _batch(1)
    poses = b["poses"] @ np.linalg.inv(b["poses"][:, :1])
    ref = np.asarray(jray_sampler.ImageRaySampler(3.0, 80.0, height=H, width=W).sample(
        None, jnp.asarray(poses), jnp.asarray(b["projs"])))
    sampler = ImageRaySampler(3.0, 80.0, H, W)
    ours = sampler.sample(_t(poses), _t(b["projs"]))
    assert ours.shape == ref.shape == (2, V * H * W, 11)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(rng.normal(size=(2, V * H * W, 3)).astype(np.float32))
    np.testing.assert_array_equal(sampler.reconstruct(x, V).numpy(), x.numpy().reshape(2 * V, H, W, 3))


def test_distance_to_z_matches_reference():
    rng = np.random.default_rng(2)
    depth = rng.uniform(3.0, 80.0, size=(2, 3, 12, 20)).astype(np.float32)
    projs = np.broadcast_to(np.array([[1.1, 0, 0.05], [0, 2.2, -0.1], [0, 0, 1]], np.float32), (2, 3, 3, 3))
    ref = np.asarray(jgeometry.distance_to_z(jnp.asarray(depth), jnp.asarray(projs)))
    ours = geometry.distance_to_z(_t(depth), _t(projs)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    assert (ours <= depth + 1e-5).all()  # z never exceeds the distance


def test_stage1_eval_forward_matches_reference(models):
    jfield, params, model = models
    jt, tt, jr, tr = _configs()
    B = 2
    batch = _eval_batch(3, B)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p, b, k: jtrain.stage1_eval_forward(jfield, p, b, k, jt, jr))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    out = trainer.stage1_eval_forward(model, {k: _t(v) for k, v in batch.items()}, tt, tr,
                                      u=_coarse_draws(key, B * V * H * W))
    assert sorted(out) == sorted(ref)
    for k, r in ref.items():
        assert tuple(out[k].shape) == r.shape, k
        assert out[k].grad_fn is None, k
    for k in ("depth", "rgb"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("dino_pred_grid", "dino_gt_grid"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5, err_msg=k)
    for k in ("imgs_gt", "projs", "depths_gt"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_stage1_eval_forward_draws_and_refusals(models):
    _, _, model = models
    _, tt, _, tr = _configs()
    batch = {k: _t(v) for k, v in _eval_batch(5, 1).items()}
    with pytest.raises(ValueError, match="draws"):
        trainer.stage1_eval_forward(model, batch, tt, tr)
    occ = trainer.stage1_eval_forward(model, {**batch, "occ_pts": torch.zeros(1, 2, 4, 3)}, tt, tr,
                                      generator=torch.Generator())  # the occupancy probe (tests/test_torch_occ.py)
    assert occ["occ_densities"].shape == (1, 8) and bool(torch.isfinite(occ["occ_densities"]).all())
    a = trainer.stage1_eval_forward(model, batch, tt, tr, generator=torch.Generator().manual_seed(1), chunk=1000)
    b = trainer.stage1_eval_forward(model, batch, tt, tr, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["depth"], b["depth"], rtol=1e-6, atol=1e-6)  # chunking changes nothing


@pytest.mark.parametrize("scaling", ["median", None])
def test_depth_metrics_match_reference(scaling):
    rng = np.random.default_rng(6)
    gt = rng.uniform(3.0, 60.0, size=(2, 16, 24)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.15] = 0.0
    pred = (gt * rng.uniform(0.7, 1.4, size=gt.shape) + rng.uniform(0, 2, size=gt.shape)).astype(np.float32)
    pred[0, 0, :3] = 0.0  # clamped to 1e-3
    ref = jmetrics.depth_metrics(jnp.asarray(pred), jnp.asarray(gt), scaling=scaling)
    ours = metrics.depth_metrics(pred, gt, scaling=scaling)
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(r), rtol=1e-5, err_msg=k)
    mask = rng.uniform(size=gt.shape) < 0.5
    ref_m = jmetrics.depth_metrics(jnp.asarray(pred), jnp.asarray(gt), mask=jnp.asarray(mask), scaling=scaling)
    ours_m = metrics.depth_metrics(torch.from_numpy(pred), torch.from_numpy(gt), mask=mask, scaling=scaling)
    for k, r in ref_m.items():
        np.testing.assert_allclose(float(ours_m[k]), float(r), rtol=1e-5, err_msg=k)


def test_image_and_feature_metrics_match_reference():
    rng = np.random.default_rng(7)
    pred = rng.uniform(0, 1, size=(1, 20, 30, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(scale=0.05, size=pred.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(metrics.psnr(pred, gt)), float(jmetrics.psnr(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim_skimage(pred[0], gt[0]), jmetrics.ssim_skimage(pred[0], gt[0]), rtol=1e-5)
    fp = rng.normal(size=(2, 3, 4, 5, 32)).astype(np.float32)
    fg = (fp + rng.normal(scale=0.5, size=fp.shape)).astype(np.float32)
    fg[0, 0, 0, 0] = 0.0  # a zero vector: the eps guards the norm
    np.testing.assert_allclose(float(metrics.dino_cosine_similarity(fp, fg)),
                               float(jmetrics.dino_cosine_similarity(jnp.asarray(fp), jnp.asarray(fg))), rtol=1e-5)


def test_stage1_validator_matches_reference(models, monkeypatch):
    """Two batches of one item each: the reference's validator (its panels
    aside but for their names) against the port's, the port's render fed the draws the
    reference's validator derives from its key."""
    jfield, params, model = models
    jt, tt, jr, tr = _configs()
    batches = [_eval_batch(s, 1) for s in (8, 9)]
    key = jax.random.PRNGKey(10)
    jv = jvalidation.make_stage1_validator("validation", VAL_CFG, jfield, jt, jr,
                                           lambda: iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]))
    ref = jv(types.SimpleNamespace(params=params), key)
    jvalidation_panels = ref.pop("images")

    draws = []
    k = key
    for _ in batches:
        k, sub = jax.random.split(k)
        draws.append(_coarse_draws(sub, V * H * W))
    real = trainer.stage1_eval_forward

    def with_reference_draws(field, batch, cfg, rcfg, generator=None, **kw):
        return real(field, batch, cfg, rcfg, u=draws.pop(0), **kw)

    monkeypatch.setattr(trainer, "stage1_eval_forward", with_reference_draws)
    v = validation.make_stage1_validator("validation", VAL_CFG, model, tt, tr,
                                         lambda: iter([{k: _t(x) for k, x in b.items()} for b in batches]))
    assert v.every == jv.every == 7 and v.save_best == validation.SaveBestConfig("dino_cos_sim", 1.0)
    out = v(None, torch.Generator())
    assert not draws
    assert sorted(out.pop("images")) == sorted(jvalidation_panels)  # the panels: tests/test_torch_vis2d.py
    assert sorted(out) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(out[name], float(r), rtol=1e-4, atol=1e-7, err_msg=name)


def test_accumulator_subset_and_events_match_reference():
    acc, jacc = validation.DictMeanAccumulator("depth"), jvalidation.DictMeanAccumulator("depth")
    for vals in ({"a1": 0.5, "abs_rel": 0.2}, {"a1": float("nan"), "abs_rel": 0.4}, {"a1": 0.7}):
        acc.update(vals)
        jacc.update(vals)
    assert acc.compute() == jacc.compute() == {"depth_a1": 0.6, "depth_abs_rel": pytest.approx(0.3)}
    for conf, n in (({"type": "range", "args": {"start": 2, "end": 5}}, 10), (None, 3),
                    ({"type": "random", "args": {"size": 4}}, 10)):
        np.testing.assert_array_equal(validation.subset_indices(conf, n, seed=1),
                                      jvalidation.subset_indices(conf, n, seed=1))
    for conf in (VAL_CFG, {"every": 3}, {}):
        assert validation._events_every(conf) == jvalidation._events_every(conf)
    assert validation.SaveBestConfig.from_dict(None) is None
    assert validation.SaveBestConfig.from_dict({"metric": "depth_abs_rel", "sign": -1}).sign == -1.0
