"""The port's hand-written kernels against their plain PyTorch versions on
the card, at shapes beyond the main path's: ragged token counts, other
sample counts and widths, both code modes, rays that leave the encode
view; and the attention backward kernels against the plain backward.
The `cuda` tests skip without a card; on one, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest` because the suite's conftest imports JAX). This file
imports no JAX. Bounds are those of chip_smoke.py and the same reasons:
K1 2e-2 (bf16 output, P rounded to bf16 for P @ V); K2 depth 5e-2 m,
feature and colour 5e-3 (bf16 rounding flips of the hidden layer); K2's
median depth the plain version's sample or its neighbour (a flip moves
the CDF across 0.5 only on a near tie), on at most 1% of rays; K3
weights 5e-3; K4 sigma and feature 1e-2 (per point, not averaged over a
ray); the row gather exactly; the
log-sum-exp 1e-3 (fp32 statistics of bf16 inputs, summed in another
order); the backward's dq, dk, dv K1_BWD_REL of the largest magnitude of
the plain result plus 1e-3 (P and dS are rounded to bf16 for the
products, the results to bf16; at N = 1 dq and dk are round-off around
0); two launches of the backward kernels give the same bits (no atomics).
"""
import numpy as np
import pytest
import torch

from scenedino_torch.core import rays as rays_mod
from scenedino_torch.core.sampling import sample_coarse
from scenedino_torch.kernels import WRAPPERS, build, launches, reset_launches
from scenedino_torch.kernels.attention import (
    attention,
    attention_bwd_plain,
    attention_fwd,
    attention_lse_plain,
    attention_plain,
)
from scenedino_torch.kernels.point_render import (
    PointRenderConfig,
    point_query,
    point_query_plain,
    point_render,
    point_render_plain,
    probe_weights,
    probe_weights_plain,
)
from scenedino_torch.kernels.row_gather import row_gather, row_gather_plain


K1_BWD_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_build_targets_hopper_and_keys_libraries_by_source():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.all_names() == ["attention", "attention_bwd", "point_render", "row_gather"]
    for name in build.all_names():
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").exists()


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and every file it includes with
    quotes, transitively: a changed header gives a new name, so a stale
    library is never loaded."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "common").mkdir()
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "common/a.cuh"\nint k;\n')
    (tmp_path / "common" / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "common" / "b.cuh").write_text("int b;\n")
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = build.library_path("k")
    assert build.library_path("k") == before
    (tmp_path / "common" / "b.cuh").write_text("int b2;\n")
    changed = build.library_path("k")
    assert changed != before and changed.name.startswith("libk-")
    (tmp_path / "k.cu").write_text('#include "common/a.cuh"\nint k2;\n')
    assert build.library_path("k") not in (before, changed)


def test_launch_counters_reset_and_ignore_cpu_calls():
    reset_launches()
    q = torch.randn(1, 5, 2, 64)
    attention(q, q, q)
    q.requires_grad_(True)
    attention(q, q, q).sum().backward()
    row_gather(torch.randn(4, 16), torch.tensor([3, 0], dtype=torch.int32))
    cfg = PointRenderConfig()
    field = (torch.randn(4, 6, 8), torch.randn(39, 8), torch.zeros(8), torch.randn(8, 3), torch.zeros(3),
             torch.eye(4), torch.eye(3))
    point_query(torch.rand(5, 3) + 3.0, *field, cfg)
    rays = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 3.0, 80.0]])
    probe_weights(rays, torch.tensor([[4.0, 9.0]]), *field[:3], field[3][:, :1], field[4][:1], *field[5:], cfg)
    assert launches() == {name: 0 for name in WRAPPERS}
    assert list(WRAPPERS) == ["attention", "attention_bwd_dq", "attention_bwd_dkv", "point_render",
                              "probe_weights", "point_query", "row_gather"]


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
@pytest.mark.parametrize("n,batch", [(1, 2), (63, 2), (64, 2), (65, 2), (128, 2), (129, 2), (200, 2), (1921, 1)])
def test_attention_backward_kernels_match_plain(cuda, n, batch):
    """Ragged token counts around the 64-row tile and the 128-row block of
    two warpgroups, and the ViT-B/8 count at 192x640."""
    g = torch.Generator(device=cuda).manual_seed(100 + n)
    q, k, v, do = (torch.randn(batch, n, 3, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(4))
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
def test_attention_backward_kernels_repeat_bitwise_and_refuse_misaligned(cuda):
    from scenedino_torch.kernels.attention import attention_bwd_dkv, attention_bwd_dq

    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn(2, 200, 3, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(4))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    first = attention_bwd_dq(q, k, v, o, do, lse)
    again = attention_bwd_dq(q, k, v, o, do, lse)
    first += attention_bwd_dkv(q, k, v, do, lse, first[1])
    again += attention_bwd_dkv(q, k, v, do, lse, again[1])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))  # no atomics
    store = torch.zeros(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = store[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention_bwd_dq(shifted, k, v, o, do, lse)


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


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 7])
def test_point_render_kernel_median_matches_plain(cuda, K):
    """The weight-median depth is a sample depth; it is the plain version's
    sample, or its neighbour on a near tie of the CDF with 0.5."""
    cfg = PointRenderConfig(depth_statistic="median")
    args = _k2_inputs(cuda, 24, 40, K, 128, 65, cfg, seed=K + 1)
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    ref = point_render_plain(*args, cfg)
    z = args[1]
    k_idx = (z - out[0][:, None]).abs().argmin(-1)
    p_idx = (z - ref[0][:, None]).abs().argmin(-1)
    assert torch.equal(z.gather(1, k_idx[:, None])[:, 0], out[0])
    assert (k_idx - p_idx).abs().max().item() <= 1 and (k_idx != p_idx).float().mean().item() <= 0.01
    assert (out[1] - ref[1]).abs().max().item() <= 5e-3 and (out[2] - ref[2]).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("K,D,cfg", [
    (16, 128, PointRenderConfig()),
    (7, 8, PointRenderConfig(num_freqs=4, include_input=False, code_mode="distance")),
    (64, 64, PointRenderConfig(inv_z=False, hard_alpha_cap=False)),
])
def test_probe_weights_kernel_matches_plain(cuda, K, D, cfg):
    rays, z, grid, w_code, b1, w2, b2, fw, fk = _k2_inputs(cuda, 24, 40, K, D, 3, cfg, seed=K)[:9]
    args = (rays, z, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(), fw, fk)
    before = probe_weights.launches
    out = probe_weights(*args, cfg)
    torch.cuda.synchronize()
    assert probe_weights.launches == before + 1
    assert out.shape == z.shape and bool(torch.isfinite(out).all())
    assert (out - probe_weights_plain(*args, cfg)).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("D,E,cfg", [
    (128, 65, PointRenderConfig()),
    (16, 9, PointRenderConfig(code_mode="distance", inv_z=False)),
    (8, 2, PointRenderConfig(num_freqs=4, include_input=False)),
])
def test_point_query_kernel_matches_plain(cuda, D, E, cfg):
    rays, z, grid, w_code, b1, w2, b2, fw, fk = _k2_inputs(cuda, 24, 40, 8, D, E, cfg, seed=D)[:9]
    pts = (rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]).reshape(-1, 3)[:7000].contiguous()  # ragged tile
    args = (pts, grid, w_code, b1, w2, b2, fw, fk)
    before = point_query.launches
    sigma, feat = point_query(*args, cfg)
    torch.cuda.synchronize()
    assert point_query.launches == before + 1
    ref_sigma, ref_feat = point_query_plain(*args, cfg)
    assert sigma.shape == (7000,) and feat.shape == (7000, E - 1)
    assert (sigma - ref_sigma).abs().max().item() <= 1e-2 and (feat - ref_feat).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_probe_and_query_kernels_refuse_what_they_do_not_take(cuda):
    cfg = PointRenderConfig()
    rays, z, grid, w_code, b1, w2, b2, fw, fk = _k2_inputs(cuda, 8, 16, 16, 16, 9, cfg, seed=0)[:9]
    sig_w2, sig_b2 = w2[:, :1].contiguous(), b2[:1].contiguous()
    pts = (rays[:, :3] + 5.0 * rays[:, 3:6]).contiguous()
    calls = [
        lambda: probe_weights(rays, z, grid, w_code, b1, w2, b2, fw, fk, cfg),  # not the density column alone
        lambda: probe_weights(rays, z, grid.float(), w_code, b1, sig_w2, sig_b2, fw, fk, cfg),  # fp32 grid
        lambda: probe_weights(rays, z.t().contiguous().t(), grid, w_code, b1, sig_w2, sig_b2, fw, fk, cfg),
        lambda: point_query(torch.cat([pts, pts[:, :1]], -1), grid, w_code, b1, w2, b2, fw, fk, cfg),  # (P, 4)
        lambda: point_query(pts.double(), grid, w_code, b1, w2, b2, fw, fk, cfg),
        lambda: point_query(pts, grid, w_code, b1, sig_w2, sig_b2, fw, fk, cfg),  # no feature column
    ]
    for call in calls:
        with pytest.raises(ValueError):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C,dtype", [
    (512, 128, torch.float32),  # P1: 512 B rows
    (32768, 128, torch.bfloat16),  # P2's table: 256 B rows
    (7680, 32, torch.float32),  # the probe path's weights and depths: 128 B rows, 4 a warp
    (1000, 16, torch.float32),  # 64 B rows, 8 a warp
    (300, 24, torch.bfloat16),  # 48 B: 3 vectors, a warp copies 10 rows
    (64, 8, torch.bfloat16),  # 16 B: one vector a row
])
def test_row_gather_kernel_is_exact(cuda, rows, C, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows)
    table = torch.randn(rows, C, generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, rows, (4099,), generator=g, device=cuda, dtype=torch.int32)
    before = row_gather.launches
    out = row_gather(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(out, row_gather_plain(table, idx))
    assert row_gather(table, idx[:0]).shape == (0, C)


@pytest.mark.cuda
def test_row_gather_kernel_writes_zeros_for_an_index_out_of_range(cuda):
    table = torch.randn(10, 16, device=cuda)
    out = row_gather(table, torch.tensor([0, -1, 10, 9, 1 << 30], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(out[[0, 3]], table[[0, 9]]) and not out[[1, 2, 4]].any()


@pytest.mark.cuda
def test_row_gather_kernel_refuses_what_it_does_not_take(cuda):
    table = torch.randn(64, 16, device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    flat = torch.randn(64 * 16 + 1, device=cuda)
    bad = [
        (table, idx.long()),  # int64 indices
        (torch.randn(64, 2, device=cuda), idx),  # 8-byte rows
        (torch.randn(64, 256, device=cuda), idx),  # 1 KB rows, wider than 512 B
        (torch.randn(64, 32, device=cuda)[:, ::2], idx),  # not contiguous
        (table.double(), idx),  # fp64
        (table.half(), idx),  # fp16
        (flat[1:].view(64, 16), idx),  # 4 bytes off 16-byte alignment
        (table, idx.cpu()),  # two devices
    ]
    for t, i in bad:
        with pytest.raises(ValueError):
            row_gather(t, i)
