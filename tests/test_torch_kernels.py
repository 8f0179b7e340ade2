"""The port's hand-written kernels against their plain PyTorch versions on
the card, at shapes beyond the main path's: ragged token counts, other
sample counts and widths, both code modes, rays that leave the encode
view; and the attention backward kernels against the plain backward.
The `cuda` tests skip without a card; on one, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest` because the suite's conftest imports JAX). This file
imports no JAX. Bounds are those of chip_smoke.py and the same reasons:
K1 2e-2 (bf16 output, P rounded to bf16 for P @ V); K2 depth 5e-2 m,
feature and colour 5e-3 (bf16 rounding flips of the hidden layer); the
log-sum-exp 1e-3 (fp32 statistics of bf16 inputs, summed in another
order); the backward's dq, dk, dv K1_BWD_REL of the largest magnitude of
the plain result plus 1e-3 (P and dS are rounded to bf16 for the
products, the results to bf16; at N = 1 dq and dk are round-off around
0).
"""
import numpy as np
import pytest
import torch

from scenedino_torch.core import rays as rays_mod
from scenedino_torch.core.sampling import sample_coarse
from scenedino_torch.kernels import build, launches, reset_launches
from scenedino_torch.kernels.attention import (
    attention,
    attention_bwd_plain,
    attention_fwd,
    attention_lse_plain,
    attention_plain,
)
from scenedino_torch.kernels.point_render import PointRenderConfig, point_render, point_render_plain


K1_BWD_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_build_targets_hopper_and_keys_libraries_by_source():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in ("attention", "attention_bwd", "point_render"):
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").exists()


def test_launch_counters_reset_and_ignore_cpu_calls():
    reset_launches()
    q = torch.randn(1, 5, 2, 64)
    attention(q, q, q)
    q.requires_grad_(True)
    attention(q, q, q).sum().backward()
    assert launches() == {"attention": 0, "attention_bwd_dq": 0, "attention_bwd_dkv": 0, "point_render": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_attention_kernel_matches_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    q, k, v = (torch.randn(2, n, 3, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    before = attention.launches
    out = attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert (out.float() - attention_plain(q, k, v).float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    q80 = torch.randn(1, 8, 2, 80, device=cuda).to(torch.bfloat16)
    q32 = torch.randn(1, 8, 2, 64, device=cuda)
    qnc = torch.randn(1, 8, 64, 2, device=cuda).to(torch.bfloat16).transpose(2, 3)
    for q in (q80, q32, qnc):
        with pytest.raises(ValueError):
            attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_attention_backward_kernels_match_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(100 + n)
    q, k, v, do = (torch.randn(2, n, 3, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(4))
    out, lse = attention_fwd(q, k, v, with_lse=True)
    assert (lse - attention_lse_plain(q, k)).abs().max().item() <= 1e-3
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = launches()
    attention(*leaves).backward(do)
    torch.cuda.synchronize()
    after = launches()
    assert after["attention_bwd_dq"] == before["attention_bwd_dq"] + 1
    assert after["attention_bwd_dkv"] == before["attention_bwd_dkv"] + 1
    for got, ref in zip((t.grad for t in leaves), attention_bwd_plain(q, k, v, out, do, lse)):
        assert torch.isfinite(got).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= K1_BWD_REL * ref.float().abs().max().item() + 1e-3, err


@pytest.mark.cuda
def test_attention_forward_result_does_not_depend_on_the_lse(cuda):
    q, k, v = (torch.randn(1, 130, 2, 64, device=cuda).to(torch.bfloat16) for _ in range(3))
    assert torch.equal(attention_fwd(q, k, v)[0], attention_fwd(q, k, v, with_lse=True)[0])


def _pose(angle, shift):
    c, s = np.cos(angle), np.sin(angle)
    return torch.tensor([[c, 0, s, shift[0]], [0, 1, 0, shift[1]], [-s, 0, c, shift[2]], [0, 0, 0, 1]],
                        dtype=torch.float32)


def _k2_inputs(dev, H, W, K, D, E, cfg, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    kmat = torch.tensor([[0.7, 0.0, 0.02], [0.0, 2.3, -0.05], [0.0, 0.0, 1.0]], device=dev)
    wide = torch.tensor([[0.4, 0.0, 0.0], [0.0, 1.2, 0.0], [0.0, 0.0, 1.0]], device=dev)  # leaves the encode view
    r, _ = rays_mod.rays_from_k(_pose(0.1, (0.5, -0.2, 0.3)).to(dev)[None], wide[None], W, H, cfg.z_near, cfg.z_far)
    flat = r.reshape(-1, 8).contiguous()
    z = sample_coarse(flat, K, generator=g).contiguous()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    C = cfg.code_dims
    return (flat, z, randn(2 * H, 2 * W, D).to(torch.bfloat16), randn(C, D, scale=C ** -0.5).to(torch.bfloat16),
            randn(D, scale=0.1), randn(D, E, scale=D ** -0.5).to(torch.bfloat16), randn(E, scale=0.3),
            torch.linalg.inv(_pose(-0.05, (0.1, 0.0, -0.2))).contiguous().to(dev), kmat,
            torch.rand(H, W, 3, generator=g, device=dev).to(torch.bfloat16), torch.eye(4, device=dev), kmat)


@pytest.mark.cuda
@pytest.mark.parametrize("K,D,E,cfg", [
    (32, 128, 65, PointRenderConfig()),
    (48, 64, 17, PointRenderConfig(code_mode="distance", inv_z=False, hard_alpha_cap=False)),
    (7, 8, 2, PointRenderConfig(num_freqs=4, include_input=False)),
])
def test_point_render_kernel_matches_plain(cuda, K, D, E, cfg):
    args = _k2_inputs(cuda, 24, 40, K, D, E, cfg, seed=K)
    before = point_render.launches
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    assert point_render.launches == before + 1
    ref = point_render_plain(*args, cfg)
    errs = [(o - p).abs().max().item() for o, p in zip(out, ref)]
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert errs[0] <= 5e-2 and errs[1] <= 5e-3 and errs[2] <= 5e-3, errs


@pytest.mark.cuda
def test_point_render_kernel_refuses_what_it_does_not_take(cuda):
    cfg = PointRenderConfig()
    args = list(_k2_inputs(cuda, 8, 16, 32, 16, 9, cfg, seed=0))
    bad = [
        (2, args[2].float()),  # fp32 grid
        (1, torch.cat([args[1]] * 3, 1)[:, :96].contiguous()),  # K = 96
        (0, args[0].t().contiguous().t()),  # non-contiguous rays
    ]
    for i, value in bad:
        call = list(args)
        call[i] = value
        with pytest.raises(ValueError):
            point_render(*call, cfg)
