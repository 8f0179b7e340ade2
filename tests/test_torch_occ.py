"""The occupancy evaluation of the port against the JAX package's on the
CPU: the metric functions (`occupancy_metrics`,
`compute_occ_metrics_visible`, `fg_ari`: exactly; `ssim_index`: rtol 1e-6,
a convolution in another order), the validation render's density at a
batch's `occ_pts` (`stage1_eval_forward`, atol 1e-5) and the stage-1
validator's "occ" metrics on a batch carrying `occ_pts`, `is_occupied`
and `is_visible` (equal: each is a share of points on either side of the
threshold, whose densities the test holds at least 1e-4 away from it).

The model and the render's draws are tests/test_torch_eval_forward.py's;
JAX's data is read where its validator takes it to the host.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.metrics as jmetrics
import scenedino_tpu.eval.vis2d as jvis2d
import scenedino_tpu.training.validation as jvalidation
from scenedino_torch.eval import metrics
from scenedino_torch.training import trainer, validation
from tests.test_torch_eval_forward import V, H, W, _coarse_draws, _configs, _eval_batch, models  # noqa: F401

N_OCC = 4 * 8 * 16
THR = 1.0  # inside the random field's density range
VAL_CFG = {"metrics": [{"type": "nvs", "args": None}, {"type": "occ", "args": {"occ_threshold": THR}}]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occupancy_metric_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 5000))
    pred, gt, vis, fg = (rng.random(n) < p for p in (0.4, 0.3, 0.6, 0.7))
    for ours, ref in ((metrics.compute_occ_metrics_visible(pred, gt, vis),
                       jmetrics.compute_occ_metrics_visible(pred, gt, vis)),
                      (metrics.occupancy_metrics(torch.from_numpy(pred), gt, vis),
                       jmetrics.occupancy_metrics(pred, gt, vis)),
                      (metrics.occupancy_metrics(pred, gt), jmetrics.occupancy_metrics(pred, gt))):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert float(ours[k]) == float(ref[k]), k
    labels = rng.integers(0, 6, size=(2, n)), rng.integers(0, 4, size=n)
    for lab in labels[0]:
        assert metrics.fg_ari(lab, labels[1], fg) == jmetrics.fg_ari(lab, labels[1], fg)
    assert metrics.fg_ari(labels[1], labels[1], fg) == jmetrics.fg_ari(labels[1], labels[1], fg) == 1.0
    assert metrics.fg_ari(labels[1], labels[1], np.zeros(n, bool)) == 0.0
    x, y = (rng.uniform(0, 1, size=(2, 3, 20, 24)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(metrics.ssim_index(torch.from_numpy(x), torch.from_numpy(y))),
                               float(jmetrics.ssim_index(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)


def _occ_batch(seed):
    """tests/test_torch_eval_forward.py's batch of one item with occupancy
    probe points 4 to 40 m ahead in a (4, 8, 16) grid and seeded labels."""
    b = _eval_batch(seed, 1)
    rng = np.random.default_rng(seed + 7)
    xs, ys, zs = np.linspace(-6, 6, 4), np.linspace(-2, 1, 8), np.linspace(4, 40, 16)
    b["occ_pts"] = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)[None].astype(np.float32)
    b["is_occupied"] = rng.random((1, N_OCC)) < 0.4
    b["is_visible"] = rng.random((1, N_OCC)) < 0.5
    return b


@pytest.fixture(scope="module")
def runs(models):  # noqa: F811
    """Both validators on one occupancy batch; JAX's data as its validator
    fetches it, the port's as its render returns it."""
    jfield, params, model = models
    jt, tt, jr, tr = _configs()
    batch = _occ_batch(4)
    key = jax.random.PRNGKey(11)
    fetched = []
    real_get = jax.device_get

    def device_get(x):
        fetched.append(real_get(x))
        return fetched[-1]

    jv = jvalidation.make_stage1_validator("validation", VAL_CFG, jfield, jt, jr,
                                           lambda: iter([{k: jnp.asarray(v) for k, v in batch.items()}]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_get", device_get)
        mp.setattr(jvis2d, "tb_visualize", lambda vis: {})  # the panels: tests/test_torch_vis2d.py
        ref = jv(types.SimpleNamespace(params=params), key)

    u = _coarse_draws(jax.random.split(key)[1], V * H * W)
    real = trainer.stage1_eval_forward
    outs = []

    def with_reference_draws(field, b, cfg, rcfg, generator=None, **kw):
        outs.append(real(field, b, cfg, rcfg, u=u, **kw))
        return outs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "stage1_eval_forward", with_reference_draws)
        v = validation.make_stage1_validator("validation", VAL_CFG, model, tt, tr,
                                             lambda: iter([{k: torch.as_tensor(x) for k, x in batch.items()}]))
        ours = v(None, torch.Generator())
    return dict(ref=ref, ours=ours, jdata=fetched[0], data=outs[0])


def test_eval_forward_occupancy_densities_match_jax(runs):
    dens, jdens = runs["data"]["occ_densities"], np.asarray(runs["jdata"]["occ_densities"])
    assert tuple(dens.shape) == jdens.shape == (1, N_OCC)
    np.testing.assert_allclose(dens.numpy(), jdens, rtol=0, atol=1e-5)
    assert float(dens.std()) > 0


def test_validator_occupancy_metrics_match_jax(runs):
    dens = np.asarray(runs["jdata"]["occ_densities"])
    assert np.abs(dens - THR).min() > 1e-4  # no point within the densities' bound of the threshold
    assert 0 < (dens > THR).mean() < 1  # both sides of the threshold are compared
    ref = {k: v for k, v in runs["ref"].items() if k.startswith("occ_")}
    ours = {k: v for k, v in runs["ours"].items() if k.startswith("occ_")}
    assert sorted(ours) == sorted(ref) == sorted(f"occ_{k}" for k in (
        "o_acc", "o_prec", "o_rec", "ie_acc", "ie_prec", "ie_rec", "ie_r", "t_ie", "t_no_nop_nv"))
    for k in ref:
        assert ours[k] == ref[k], k
    np.testing.assert_allclose(runs["ours"]["nvs_psnr"], runs["ref"]["nvs_psnr"], rtol=1e-4)
