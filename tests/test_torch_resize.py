"""The port's resize matrices (scenedino_torch.core.resize) against the
reference's (scenedino_tpu.core.resize) and against `F.interpolate`
(align_corners=False, antialias=False), and the ViT's position-embedding
resize built on them.

The matrices are built by the same numpy arithmetic: equal bit for bit.
The resize itself is two fp32 matmuls: atol 2e-5, rtol 1e-5 against the
JAX twin and against torch's fp64 `F.interpolate` (tests/test_resize.py's
bound); "nearest" is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import scenedino_tpu.core.resize as jresize
import scenedino_tpu.models.vit as jvit
from scenedino_torch.core import resize
from scenedino_torch.models import vit

CASES = [
    ((37, 37), (12, 40)),   # DINOv2 pos-embed grid -> the 192x640 grid
    ((28, 28), (24, 80)),   # DINO v1/8 pos-embed -> 192x640
    ((7, 9), (31, 17)),     # odd upscale
    ((64, 48), (8, 6)),     # 8x downscale
    ((16, 16), (16, 16)),   # identity
]
MODES = ["bilinear", "bicubic", "nearest"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,size", CASES)
def test_matrices_equal_the_references(mode, shape, size):
    for n_in, n_out in zip(shape, size):
        ours = resize.torch_resize_matrix(n_in, n_out, mode)
        ref = jresize.torch_resize_matrix(n_in, n_out, mode)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(resize.resize_matrix(n_in, n_out, mode, torch.device("cpu")).numpy(), ref)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,size", CASES)
def test_interpolate_matches_jax_and_torch(mode, shape, size):
    rng = np.random.default_rng([*shape, *size, MODES.index(mode)])
    x = rng.normal(size=(2, *shape, 5)).astype(np.float32)
    ours = resize.torch_interpolate(torch.from_numpy(x), size, mode=mode).numpy()
    ref_jax = np.asarray(jresize.torch_interpolate(jnp.asarray(x), size, mode=mode))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).double()
    kw = {} if mode == "nearest" else {"align_corners": False, "antialias": False}
    ref_torch = F.interpolate(t, size=size, mode=mode, **kw).permute(0, 2, 3, 1).numpy()
    if mode == "nearest":
        np.testing.assert_array_equal(ours, ref_torch.astype(np.float32))
        np.testing.assert_array_equal(ours, ref_jax)
    else:
        np.testing.assert_allclose(ours, ref_jax, atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(ours, ref_torch, atol=2e-5, rtol=1e-5)


def test_interpolate_keeps_the_dtype_and_leading_axes():
    x = torch.randn(3, 2, 7, 9, 4, dtype=torch.bfloat16)
    y = resize.torch_interpolate(x, (5, 11), mode="bicubic")
    assert y.dtype == torch.bfloat16 and y.shape == (3, 2, 5, 11, 4)


@pytest.mark.parametrize("grid_orig,grid_new,prefix", [((28, 28), (24, 80), 1), ((28, 28), (4, 8), 1),
                                                       ((6, 5), (6, 5), 1), ((7, 7), (3, 9), 0)])
def test_interpolate_pos_embed_matches_reference(grid_orig, grid_new, prefix):
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(1, prefix + grid_orig[0] * grid_orig[1], 12)).astype(np.float32)
    ours = vit.interpolate_pos_embed(torch.from_numpy(pos), grid_orig, grid_new, num_prefix_tokens=prefix)
    ref = jvit.interpolate_pos_embed(jnp.asarray(pos), grid_orig, grid_new, num_prefix_tokens=prefix)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_pos_embed_gradient_is_finite_and_nonzero():
    """The student's position embedding is trained: the matmuls carry its
    gradient to every stored entry that a tap reaches."""
    g = torch.Generator().manual_seed(0)
    pos = torch.randn(1, 1 + 28 * 28, 16, generator=g).requires_grad_(True)
    out = vit.interpolate_pos_embed(pos, (28, 28), (24, 80))
    (out * torch.randn(out.shape, generator=g)).sum().backward()
    g = pos.grad
    assert torch.isfinite(g).all()
    assert (g[0, 0] != 0).all()  # the class token passes through
    assert (g[0, 1:].abs().sum(-1) > 0).float().mean() > 0.9


def test_matrices_first_built_in_inference_mode_serve_a_training_step():
    """A serving request (inference mode) may build a matrix first; the
    cached matrix must still take part in a later autograd graph."""
    resize.resize_matrix.cache_clear()
    pos = torch.randn(1, 1 + 7 * 7, 8, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        served = vit.interpolate_pos_embed(pos, (7, 7), (5, 9))
    trained = pos.clone().requires_grad_(True)
    out = vit.interpolate_pos_embed(trained, (7, 7), (5, 9))
    out.sum().backward()
    assert torch.equal(out.detach(), served) and torch.isfinite(trained.grad).all()
