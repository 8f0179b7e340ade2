"""The port's exact permutohedral CRF (`eval/permutohedral.py`) against the
JAX package's on the CPU, both numpy on the host: `gaussian_filter` to
atol 1e-5 (and against a dense Gaussian within the lattice's
approximation), `dense_crf_exact`'s labels equal at 24x32 with 19 classes,
and the 2D evaluator's "<mode>_crf" rows with `crf_method="exact"`: on
the JAX evaluator's own labels and rendered colours, the port's rows
equal JAX's, and a port run with the exact CRF gives finite scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.permutohedral as J
from scenedino_tpu.eval.seg2d import Seg2DEvaluator as JSeg2DEvaluator
from scenedino_torch.eval import permutohedral
from scenedino_torch.eval.seg2d import Seg2DEvaluator
from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
from scenedino_torch.utils.convert import load_jax_head
from tests.test_torch_seg2d import H, W, K, _draws, _frames
from tests.test_torch_stage2 import HEAD, setup  # noqa: F401  (the shared module fixture)

MODES = ("stego_kmeans", "direct_linear")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("d", [2, 5])
def test_gaussian_filter_matches_jax(d):
    rng = np.random.default_rng(d)
    feats = rng.normal(scale=2.0, size=(300, d))
    values = rng.normal(size=(300, 3))
    ours = permutohedral.gaussian_filter(feats, values)
    np.testing.assert_allclose(ours, J.gaussian_filter(feats, values), rtol=0, atol=1e-5)
    lat = permutohedral.PermutohedralLattice(feats)
    assert lat.m == J.PermutohedralLattice(feats).m
    dense = np.exp(-0.5 * ((feats[:, None] - feats[None]) ** 2).sum(-1))
    exact = dense @ values / dense.sum(1, keepdims=True)
    assert np.abs(ours - exact).mean() < 0.5 * np.abs(values - exact).mean()  # the lattice approximates it


def test_dense_crf_exact_labels_match_jax():
    rng = np.random.default_rng(0)
    img = rng.random((24, 32, 3))
    img[:, 16:] *= 0.3  # an edge for the bilateral kernel
    logits = rng.normal(size=(24, 32, 19)) * 2
    ours = permutohedral.dense_crf_exact(img, logits)
    ref = J.dense_crf_exact(img, logits)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    kernels = permutohedral.crf_kernels(img)  # one image's lattices for several score maps
    np.testing.assert_array_equal(permutohedral.dense_crf_exact(None, logits, kernels=kernels), ours)
    chw = np.transpose(img, (2, 0, 1)) * 2 - 1
    np.testing.assert_array_equal(permutohedral.refine_segmentation_exact(chw, logits),
                                  J.refine_segmentation_exact(chw, logits))


def test_seg2d_exact_crf_rows_match_jax(setup):  # noqa: F811
    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, setup["hvars"])
    head.eval()
    ours = Seg2DEvaluator(field=setup["model"], head=head, image_size=(H, W), n_coarse=K, n_classes=5, modes=MODES,
                          apply_crf=True, crf_method="exact")
    ref = JSeg2DEvaluator(field=setup["jfield"], head=setup["jhead"], field_params=setup["params"],
                          head_variables=setup["hvars"], image_size=(H, W), n_coarse=K, n_classes=5, modes=MODES,
                          apply_crf=True, crf_method="exact")
    f = _frames()[0]
    jpreds = ref._predict(ref.field_params, ref.head_variables, *(jnp.asarray(f[k])[None]
                                                                 for k in ("imgs", "projs", "poses")),
                          jax.random.PRNGKey(0))
    rgb = np.asarray(jpreds["_rgb"])
    rows = ours._exact_crf(torch.from_numpy(rgb.copy()), {m: torch.from_numpy(np.array(jpreds[m])) for m in MODES})
    eye = np.eye(5, dtype=np.float32)
    for m in MODES:  # the JAX evaluator's rows (its run(): the lattice on its labels' one-hot and its colours)
        jrow = J.dense_crf_exact(rgb, eye[np.asarray(jpreds[m])]).argmax(-1)
        np.testing.assert_array_equal(rows[m + "_crf"].numpy(), jrow)
    res = ours.run(_frames()[:1], draws=_draws)
    assert ours.result_modes == MODES + ("stego_kmeans_crf", "direct_linear_crf")
    for m in ours.result_modes:
        assert np.isfinite(res[m]["miou"]) and 0.0 <= res[m]["acc"] <= 1.0
    with pytest.raises(ValueError, match="run\\(\\) only"):
        ours.run_sharded(_frames())
