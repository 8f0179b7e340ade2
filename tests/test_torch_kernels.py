"""The port's hand-written kernels against their plain PyTorch versions on
the card, at shapes beyond the main path's: ragged token counts, other
sample counts and widths, both code modes, rays that leave the encode
view; and the attention backward kernels against the plain backward;
and one stage-1 step on a batch of the KITTI-360 loader through the
kernels against the same step on the CPU; serving's rest: the int8
grid's encode view through K6, the unfused render against K2, and the
trained-field probe bound through K3, the row gather and K2; every shape
the JAX package takes: K2 and K3 at 96, 128 and 256 samples a ray, K6 at
96 and 128 and with a z code of 17 and 31 columns, K1 at head dims 8 to 256
(csrc/attention_any.cu; its register operands at one tile over many tiles
and seeds) and past 256 (csrc/attention_wide.cu, 264 to 1280); every width
the JAX package takes: K2, K3, K4 and K6 through their wide walk
(csrc/wide_walk.cuh) past the shipped instantiations (D past 128 and not a
multiple of 8, E past 128 and at 769, 69 and 99 code columns, 33 z-code
columns, 257 to 512 samples a ray); and the
scaled-keys sweep of both shipped K1 forwards (ROADMAP queue 3, item C).
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
order, exp2 approximate on the card); K6 (the encode view) up to 256
samples a ray, in fp32 depth 1e-3 m, feature and colour 1e-4 (three TF32
passes: fp32's accuracy, summed in another order), in bf16
K2's bounds and its median rule, the feature's times its largest
magnitude where that exceeds 1 (these tests' random inputs are larger
than the path's, and a flip of h moves the feature in proportion); the backward's dq, dk, dv K1_BWD_REL of the largest magnitude of
the plain result plus 1e-3 (P and dS are rounded to bf16 for the
products, the results to bf16; at N = 1 dq and dk are round-off around
0); two launches of the forward or the backward kernels give the same
bits (no atomics).
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
from scenedino_torch.kernels.encode_view import EncodeViewConfig, encode_view, encode_view_plain
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
    assert build.all_names() == ["attention", "attention_any", "attention_bwd", "attention_d80", "attention_d80_bwd",
                                 "attention_wide", "encode_view", "point_render", "row_gather"]
    for name in build.all_names():
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").exists()
    # the K1 kernels at every head dim include hopper.cuh (the D = 80 pair its rows of 80 too), and nothing else
    for name in ("attention", "attention_bwd", "attention_d80", "attention_d80_bwd", "attention_any", "attention_wide"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu", "hopper.cuh"], name
    # the field kernels also include their wide walk's header (which includes hopper.cuh)
    for name in ("point_render", "encode_view"):
        assert sorted(p.name for p in build.sources(name)) == sorted([f"{name}.cu", "hopper.cuh", "wide_walk.cuh"])


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
    for d in (64, 80, 32, 384):
        q = torch.randn(1, 5, 2, d)
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
    encode_view(torch.randn(3, 8), torch.rand(3, 4).sort(-1).values * 10 + 3, torch.ones(3), torch.randn(13, 8),
                torch.randn(8, 5), torch.zeros(5), torch.rand(3, 3), EncodeViewConfig())
    assert launches() == {name: 0 for name in WRAPPERS}
    assert list(WRAPPERS) == ["attention", "attention_bwd_dq", "attention_bwd_dkv", "attention_d80",
                              "attention_d80_bwd_dq", "attention_d80_bwd_dkv", "attention_any",
                              "attention_any_bwd_dq", "attention_any_bwd_dkv", "attention_wide",
                              "attention_wide_bwd_dq", "attention_wide_bwd_dkv", "point_render",
                              "probe_weights", "point_query", "row_gather", "encode_view"]


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
    """fp32 and a non-contiguous tensor are refused and launch nothing; no
    head dim is: D = 264, once refused, launches csrc/attention_wide.cu."""
    q264 = torch.randn(1, 8, 2, 264, device=cuda).to(torch.bfloat16)
    q32 = torch.randn(1, 8, 2, 64, device=cuda)
    qnc = torch.randn(1, 8, 64, 2, device=cuda).to(torch.bfloat16).transpose(2, 3)
    before = launches()
    for q in (q32, qnc):
        with pytest.raises(ValueError):
            attention(q, q, q)
    assert launches() == before
    with pytest.raises(ValueError, match="bf16"):
        attention(q32, q32, q32)
    out = attention(q264, q264, q264)
    torch.cuda.synchronize()
    after = launches()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {"attention_wide": 1}
    assert (out.float() - attention_plain(q264, q264, q264).float()).abs().max().item() <= 2e-2


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


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n", [1, 65, 129, 193, 1921])
def test_attention_forward_and_lse_match_plain_at_vit_heads(cuda, n, batch):
    """H = 12 as in ViT-B/8; at these N the last block of a head (three
    warpgroups of 64 query rows) holds 1, 1, 1, 1 and 1 valid rows, so whole
    warpgroups lie past N, and the last walked key tile is ragged."""
    g = torch.Generator(device=cuda).manual_seed(200 + n + batch)
    q, k, v = (torch.randn(batch, n, 12, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    before = attention.launches
    out, lse = attention_fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert out.shape == q.shape and lse.shape == (batch, 12, n) and torch.isfinite(out).all()
    assert (out.float() - attention_plain(q, k, v).float()).abs().max().item() <= 2e-2
    assert (lse - attention_lse_plain(q, k)).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_attention_forward_repeats_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(2, 1921, 12, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    first, again = attention_fwd(q, k, v, with_lse=True), attention_fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


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
    """An fp32 grid and non-contiguous rays are refused, and nothing is
    launched; K = 257 (past the shipped instantiations' 256) is rendered by
    the wide walk, within K2's bounds."""
    cfg = PointRenderConfig()
    args = list(_k2_inputs(cuda, 8, 16, 32, 16, 9, cfg, seed=0))
    bad = [
        (2, args[2].float()),  # fp32 grid
        (0, args[0].t().contiguous().t()),  # non-contiguous rays
    ]
    before = launches()
    for i, value in bad:
        call = list(args)
        call[i] = value
        with pytest.raises(ValueError):
            point_render(*call, cfg)
    assert launches() == before
    args[1] = sample_coarse(args[0], 257, generator=torch.Generator(device=cuda).manual_seed(257)).contiguous()
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    assert launches()["point_render"] == before["point_render"] + 1
    ref = point_render_plain(*args, cfg)
    errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
    assert errs[0] <= 5e-2 and errs[1] <= 5e-3 and errs[2] <= 5e-3, errs


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
    (64, 20, PointRenderConfig()),  # the S4C baseline's field (d_hidden 64, 19 logits)
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
    (7680, 192, torch.float32),  # the probe path's at n_probe 96: 768 B rows, one warp a row
    (300, 512, torch.float32),  # the probe path's at n_probe 256: 2 KB rows
    (100, 520, torch.bfloat16),  # 1040 B: 65 vectors, a warp's lanes one, two or three each
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


def _row_gather_refusals(dev):
    table = torch.randn(64, 16, device=dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    flat = torch.randn(64 * 16 + 1, device=dev)
    return [
        (table, idx.long()),  # int64 indices
        (torch.randn(64, 2, device=dev), idx),  # 8-byte rows
        (torch.randn(64, 32, device=dev)[:, ::2], idx),  # not contiguous
        (table.double(), idx),  # fp64
        (table.half(), idx),  # fp16
        (flat[1:].view(64, 16), idx),  # 4 bytes off 16-byte alignment
        (table, idx.cpu()),  # two devices
        (table[None], idx),  # a 3-D table
        (table, idx[None]),  # 2-D indices
    ]


@pytest.mark.cuda
def test_row_gather_kernel_refuses_what_it_does_not_take(cuda):
    for t, i in _row_gather_refusals(cuda):
        with pytest.raises(ValueError):
            row_gather(t, i)


@pytest.mark.cuda
def test_row_gather_refuses_as_before_once_its_function_is_cached(cuda):
    """The typed C function is looked up once; every check still runs on
    every call, and a refused call launches nothing."""
    table = torch.randn(64, 16, device=cuda)
    row_gather(table, torch.zeros(8, dtype=torch.int32, device=cuda))
    before = row_gather.launches
    for t, i in _row_gather_refusals(cuda):
        with pytest.raises(ValueError):
            row_gather(t, i)
    assert row_gather.launches == before


@pytest.mark.cuda
def test_row_gather_launches_on_the_current_stream(cuda):
    """On a second stream the gather waits for that stream's earlier work:
    the table is written there behind a long sleep, so a launch on any
    other stream would read the zeros it held before."""
    table = torch.zeros(512, 128, device=cuda)
    source = torch.randn(512, 128, device=cuda)
    idx = torch.randint(0, 512, (256,), device=cuda, dtype=torch.int32)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)  # tens of milliseconds of the side stream
        table.copy_(source)
        out = row_gather(table, idx)
    side.synchronize()
    assert torch.equal(out, source[idx.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,D,E", [(7, 16, 7), (32, 64, 17), (32, 128, 65), (19, 128, 68), (48, 128, 65),
                                   (64, 64, 17), (9, 64, 33), (40, 96, 24), (5, 18, 3)])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_encode_view_kernel_matches_plain(cuda, dtype, K, D, E, depth_statistic):
    g = torch.Generator(device=cuda).manual_seed(K * D + E)
    N = 3000
    cfg = EncodeViewConfig(depth_statistic=depth_statistic)
    base = torch.randn(N, D, generator=g, device=cuda)
    z = (torch.rand(N, K, generator=g, device=cuda) * 77 + 3).sort(-1).values
    zscale = torch.rand(N, generator=g, device=cuda) * 0.2 + 0.8
    w_z = (torch.randn(13, D, generator=g, device=cuda) * 0.3).to(dtype)
    w2 = (torch.randn(D, E, generator=g, device=cuda) / D ** 0.5).to(dtype)
    b2 = torch.randn(E, generator=g, device=cuda) * 0.2
    color = torch.rand(N, 3, generator=g, device=cuda)
    args = (base, z, zscale, w_z, w2, b2, color)
    reset_launches()
    out = encode_view(*args, cfg)
    again = encode_view(*args, cfg)
    assert launches()["encode_view"] == 2
    ref = encode_view_plain(*args, cfg)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    if depth_statistic == "median":
        k_o = (z - out[0][:, None]).abs().argmin(-1)
        k_r = (z - ref[0][:, None]).abs().argmin(-1)
        assert torch.equal(z.gather(1, k_o[:, None])[:, 0], out[0])
        assert (k_o - k_r).abs().max().item() <= 1 and (k_o != k_r).float().mean().item() <= 1e-2
    bounds = (1e-3, 1e-4, 1e-4) if dtype == torch.float32 else (5e-2, 5e-3, 5e-3)
    for i, (o, r, b) in enumerate(zip(out, ref, bounds)):
        if i == 0 and depth_statistic == "median":
            continue
        if dtype == torch.bfloat16 and i == 1:  # a flip of h moves the feature in proportion to its scale
            b *= max(1.0, r.abs().max().item())
        assert (o - r).abs().max().item() <= b, (i, (o - r).abs().max().item())


@pytest.mark.cuda
def test_encode_view_kernel_refuses_what_it_does_not_take(cuda):
    """Non-contiguous and fp64 inputs are refused, and nothing is launched;
    K = 257, E = 69 and D = 136 (past the shipped instantiations) are
    rendered by the wide walk, within the fp32 bounds."""
    cfg = EncodeViewConfig()
    N, D, E, K = 8, 16, 7, 4
    args = [torch.randn(N, D, device=cuda), torch.rand(N, K, device=cuda).sort(-1).values * 10 + 3,
            torch.ones(N, device=cuda), torch.randn(13, D, device=cuda), torch.randn(D, E, device=cuda),
            torch.zeros(E, device=cuda), torch.rand(N, 3, device=cuda)]
    encode_view(*args, cfg)
    before = launches()
    for bad in ({0: torch.randn(D, N, device=cuda).T}, {6: torch.rand(N, 3, device=cuda).to(torch.float64)}):
        call = [bad.get(i, a) for i, a in enumerate(args)]
        with pytest.raises(ValueError, match="CUDA encode_view kernel"):
            encode_view(*call, cfg)
    assert launches() == before
    for wide in ({1: torch.rand(N, 257, device=cuda).sort(-1).values * 70 + 3},
                 {4: torch.randn(D, 69, device=cuda) * 0.25, 5: torch.zeros(69, device=cuda)},
                 {0: torch.randn(N, 136, device=cuda), 3: torch.randn(13, 136, device=cuda),
                  4: torch.randn(136, E, device=cuda) * 0.1}):
        call = [wide.get(i, a) for i, a in enumerate(args)]
        out = encode_view(*call, cfg)
        for o, r, b in zip(out, encode_view_plain(*call, cfg), (1e-3, 1e-4, 1e-4)):
            assert (o - r).abs().max().item() <= b
    assert launches()["encode_view"] == before["encode_view"] + 3


@pytest.mark.cuda
def test_point_query_kernel_at_an_ssc_block_then_the_heads_labels(cuda):
    """K4 at the SSC evaluator's block: the first 524,288 voxel centres of
    the 256x256x32 grid in the coherent (z, x, y) order, over the
    flagship's 384x1280x128 bf16 folded grid (W2 128x65), against
    `point_query_plain` within 1e-2 on the points in [z_near, z_far]; then
    a seeded 64 -> 768 expansion and stage-2 head in stego_kmeans mode give
    the same labels to at least 99.9% of those points."""
    from scenedino_torch.eval.sscbench import generate_point_grid
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.models.encoder import MlpDimReduction

    g = torch.Generator(device=cuda).manual_seed(11)
    pts, _ = generate_point_grid()
    block = torch.from_numpy(pts.reshape(256, 256, 32, 3).transpose(2, 0, 1, 3).reshape(-1, 3)[:128 * 128 * 32].copy())
    block = block.to(cuda)
    cfg = PointRenderConfig()
    D, E, C = 128, 65, 39
    b2 = torch.randn(E, generator=g, device=cuda) * 0.1
    b2[0] += 0.5
    field = (torch.randn(384, 1280, D, generator=g, device=cuda).to(torch.bfloat16),
             (torch.randn(C, D, generator=g, device=cuda) * C ** -0.5).to(torch.bfloat16),
             torch.randn(D, generator=g, device=cuda) * 0.1,
             (torch.randn(D, E, generator=g, device=cuda) * D ** -0.5).to(torch.bfloat16), b2,
             torch.eye(4, device=cuda), torch.tensor([[0.7, 0.0, 0.0], [0.0, 2.3, 0.0], [0.0, 0.0, 1.0]], device=cuda))
    before = point_query.launches
    sigma, feat = point_query(block, *field, cfg)
    torch.cuda.synchronize()
    assert point_query.launches == before + 1
    ref_sigma, ref_feat = point_query_plain(block, *field, cfg)
    near = (block[:, 2] >= cfg.z_near) & (block[:, 2] <= cfg.z_far)
    assert near.float().mean().item() > 0.5
    assert (sigma - ref_sigma)[near].abs().max().item() <= 1e-2
    assert (feat - ref_feat)[near].abs().max().item() <= 1e-2
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        expand = MlpDimReduction(64, 768).to(cuda)
    head = SemanticHead(SemanticHeadConfig(), generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.no_grad():
        labels = head(expand(feat), mode="stego_kmeans")
        ref_labels = head(expand(ref_feat), mode="stego_kmeans")
    assert (labels == ref_labels)[near].float().mean().item() >= 0.999


@pytest.mark.cuda
def test_encode_view_kernel_on_one_fp32_evaluation_frame(cuda):
    """K6 as the 2D evaluator launches it: one frame of the fp32 state (its
    fold in fp32, three TF32 passes) at 192x640 rays x 32 samples from a
    384x1280x128 grid, W2 128x65: within the fp32 bounds of its plain
    version, two launches bitwise equal, the median on a sample depth."""
    from scenedino_torch.tools.bench_encode_view import Shape, check

    r = check(torch.Generator(device=cuda).manual_seed(12), Shape("2D evaluation", 1, torch.float32, 192, 640, 128, 65),
              reps=2)
    assert r["ok"], r


@pytest.mark.cuda
def test_grid_predictor_argmax_takes_the_first_of_a_tie_on_the_card(cuda):
    """The SSC predictor's alpha-weighted argmax on CUDA tensors: equal
    weighted scores (a tie, or sigma 0) give the first class, as on the CPU
    and as jnp.argmax."""
    from scenedino_torch.eval.sscbench import make_grid_predictor

    sigma = torch.tensor([0.0, 1.0, 1.0, 2.0], device=cuda)
    scores = torch.tensor([[0.0, 1.0, 1.0], [0.5, 0.5, 0.2], [0.1, 0.3, 0.3], [0.2, 0.2, 0.2]], device=cuda)
    predict = make_grid_predictor(lambda b, _: (sigma[None], scores[None]), chunk_points=4, grow=False,
                                  grid_dim=(4, 1, 1), coherent=False)
    assert predict(torch.zeros(4, 3, device=cuda), None)[1].reshape(-1).tolist() == [0, 0, 1, 0]


def _gpu_cpu_step(model, batch, draws, tcfg, rcfg, lcfg, device, art=None):
    """One stage-1 forward and backward: (loss, {name: grad on the CPU})."""
    import dataclasses

    from scenedino_torch.training import trainer

    model.zero_grad(set_to_none=True)
    moved = {f: getattr(draws, f).to(device) for f in ("pv", "py", "px", "u")}
    d = dataclasses.replace(draws, **moved, crops=None if draws.crops is None else draws.crops.to(device))
    a = None if art is None else art.to(device).requires_grad_(True)
    loss, _ = trainer.stage1_forward(model, {k: v.to(device) for k, v in batch.items()}, d, tcfg, rcfg, lcfg, a)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters() if p.grad is not None}
    if a is not None:
        grads["artifact_field"] = a.grad.float().cpu()
    return loss.item(), grads


def _assert_step_close(gpu, cpu):
    """chip_smoke.py phase 5's small-step bounds: the loss 1e-2 relative,
    each gradient's relative L2 error 0.1, a gradient under 1e-3 of the
    largest of its module measured against that 1e-3."""
    (gpu_loss, gpu_grads), (cpu_loss, cpu_grads) = gpu, cpu
    assert np.isfinite(gpu_loss) and abs(gpu_loss - cpu_loss) <= 1e-2 * abs(cpu_loss)
    assert sorted(gpu_grads) == sorted(cpu_grads)

    def module(n):
        return n.rpartition(".")[0]

    norms = {n: torch.linalg.vector_norm(r).item() for n, r in cpu_grads.items()}
    largest = {}
    for n, v in norms.items():
        largest[module(n)] = max(largest.get(module(n), 0.0), v)
    errs = {n: torch.linalg.vector_norm(gpu_grads[n] - r).item() / max(norms[n], 1e-3 * largest[module(n)])
            for n, r in cpu_grads.items() if norms[n] > 0}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.1, (worst, errs[worst])


@pytest.mark.cuda
def test_stage1_step_on_a_kitti_360_batch_matches_the_cpu(cuda, tmp_path):
    """One stage-1 step of the shipped KITTI-360 recipe's model (ViT-B/8 and
    DPT 256 in bf16, seeded weights) on a batch of 2 items of the port's
    KITTI-360 loader (8 views: the stereo pairs and the resampled fisheyes
    at two timesteps) at 64x512 (513 tokens, so the ViT takes K1): the
    card's step launches K1 forward, dq and dkv; its loss and gradients
    against the same step on the CPU (plain versions), within phase 5's
    small-step bounds of chip_smoke.py (the loss 1e-2 relative, each
    gradient's relative L2 error 0.1: bf16 rounded in other places through
    12 blocks forward and back). A gradient under 1e-3 of the largest one
    of its module is round-off of a cancelling sum and is measured against
    that 1e-3 instead of its own norm: the FeatUp salience conv's bias,
    which the patch softmax ignores but for the patch weights' 1 % spread
    (its gradient 1.6e-8 against the weight's 6.3e-5 on the card; its own
    relative error 0.11 with the kernels and 0.05 without them, the rest
    at most 0.022; NVIDIA H100 80GB HBM3, 700.00 W)."""
    import copy

    from scenedino_torch.datasets.kitti_360 import KITTI360Dataset
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, make_model
    from scenedino_torch.training import trainer
    from test_torch_kitti360 import write_kitti_tree  # tests/ is on the path, with or without the conftest

    h, w = 64, 512
    root = write_kitti_tree(tmp_path / "kitti")
    ds = KITTI360Dataset(data_path=str(root), pose_path=str(root / "data_poses"), target_image_size=(h, w),
                         fisheye_offset=(2, 3), color_aug=True)
    items = []
    for i in (0, 3):
        ds._rng_local.rng = np.random.RandomState(i)
        items.append(ds[i])
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])) for k in ("imgs", "poses", "projs")}
    B, V = batch["imgs"].shape[:2]
    assert V == 8
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(SCENEDINO_KITTI_360_TRAIN)
    model = make_model(model_conf, device=cuda, seed=0, training=True)
    enc = model.encoder
    gp = enc.gt_patch_size
    gc = torch.Generator().manual_seed(5)
    draws = trainer.draw_stage1(gc, tcfg, rcfg, B, V, h, w, gp)
    art = 1e-3 * torch.randn(enc.gt_encoder.latent_size, h // gp, w // gp, generator=gc)

    reset_launches()
    gpu = _gpu_cpu_step(model, batch, draws, tcfg, rcfg, lcfg, cuda, art)
    torch.cuda.synchronize()
    counts = launches()
    assert counts["attention"] > 0 and counts["attention_bwd_dq"] > 0 and counts["attention_bwd_dkv"] > 0, counts
    _assert_step_close(gpu, _gpu_cpu_step(copy.deepcopy(model).to("cpu"), batch, draws, tcfg, rcfg, lcfg, "cpu",
                                          art))


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch,drift", [(1, 2, False), (31, 2, False), (32, 2, False), (33, 2, False),
                                           (63, 2, False), (64, 2, False), (65, 2, False), (127, 2, False),
                                           (128, 2, False), (129, 2, False), (200, 2, False), (585, 1, False),
                                           (585, 4, False), (1921, 2, False), (1921, 2, True),
                                           (1921, 2, "scaled")])
def test_attention_d80_kernels_match_plain(cuda, n, batch, drift):
    """K1 at head dim 80 (csrc/attention_d80.cu's forward, csrc/
    attention_d80_bwd.cu's dq and dkv): the forward with and without the
    log-sum-exp, dq and dkv against the plain versions, around the 32- and
    64-row tiles and the 128-row block, at the I-JEPA-H/14 shapes (one image
    takes the forward's small-grid instantiation) and at the D = 80 training
    step's token count; two launches bitwise equal. `drift`: keys that drift
    along the walk (12 n / N added to key row n), so that the forward's
    running max moves after the first tile (the lazy rescale's jump;
    tests/test_torch_attention_d80.py shows it moves); "scaled": key row n
    scaled by 1 + 4 n / N instead, where the softmax lands on one key and
    |out| reaches 4 (ROADMAP queue 3: at this seed the kernel and SDPA both
    read 1.5625e-2 against the fp32 plain version rounded to bf16)."""
    from scenedino_torch.kernels.attention import attention_bwd_dkv, attention_bwd_dq

    g = torch.Generator(device=cuda).manual_seed(200 + n)
    heads = {585: 16, 1921: 12}.get(n, 3)
    q, k, v, do = (torch.randn(batch, n, heads, 80, generator=g, device=cuda).to(torch.bfloat16) for _ in range(4))
    ramp = torch.arange(n, device=cuda, dtype=torch.float32)[None, :, None, None] / n
    if drift == "scaled":
        k = (k.float() * (1 + 4 * ramp)).to(torch.bfloat16)
    elif drift:
        k = (k.float() + 12 * ramp).to(torch.bfloat16)
    before = launches()
    out, lse = attention_fwd(q, k, v, with_lse=True)
    plain_out = attention_fwd(q, k, v)[0]
    dq, di = attention_bwd_dq(q, k, v, out, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    again = attention_bwd_dq(q, k, v, out, do, lse)[0], attention_bwd_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    after = launches()
    assert after["attention_d80"] == before["attention_d80"] + 2
    assert after["attention_d80_bwd_dq"] == before["attention_d80_bwd_dq"] + 2
    assert after["attention_d80_bwd_dkv"] == before["attention_d80_bwd_dkv"] + 2
    assert after["attention"] == before["attention"]
    assert torch.equal(out, plain_out) and torch.equal(dq, again[0]) and torch.equal(dk, again[1][0])
    assert (out.float() - attention_plain(q, k, v).float()).abs().max().item() <= 2e-2
    assert (lse - attention_lse_plain(q, k)).abs().max().item() <= 1e-3
    assert (di - (do.float() * out.float()).sum(-1).transpose(1, 2)).abs().max().item() <= 1e-3
    for got, ref in zip((dq, dk, dv), attention_bwd_plain(q, k, v, out, do, lse)):
        assert torch.isfinite(got).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= K1_BWD_REL * ref.float().abs().max().item() + 1e-3, err


def _seeded_batch(B, V, h, w, seed):
    rng = np.random.default_rng(seed)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (B, V, 4, 4)).copy()
    poses[:, :, 0, 3] += np.arange(V) * 0.3
    poses[:, :, 2, 3] += rng.uniform(0.0, 0.5, size=(B, V))
    projs = np.broadcast_to(np.array([[0.7, 0, 0], [0, 2.3, 0], [0, 0, 1]], np.float32), (B, V, 3, 3)).copy()
    return {"imgs": torch.from_numpy(rng.uniform(-1, 1, size=(B, V, 3, h, w)).astype(np.float32)),
            "poses": torch.from_numpy(poses), "projs": torch.from_numpy(projs)}


@pytest.mark.cuda
def test_stage1_step_at_head_dim_80_matches_the_cpu(cuda):
    """The flagship step with its ViTs cut to heads of 80 (vit_overrides
    width 160, num_heads 2) at 64x512, 513 tokens: the card's step
    launches the D = 80 forward, dq and dkv and no D = 64 kernel; its loss
    and gradients against the CPU's within phase 5's bounds."""
    import copy

    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, make_model
    from scenedino_torch.training import trainer

    h, w = 64, 512
    conf = copy.deepcopy(SCENEDINO_KITTI_360_TRAIN)
    conf["model"]["encoder"]["vit_overrides"] = {"width": 160, "num_heads": 2}
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    model = make_model(model_conf, device=cuda, seed=0, training=True)
    batch = _seeded_batch(2, 4, h, w, 1)
    gc = torch.Generator().manual_seed(6)
    draws = trainer.draw_stage1(gc, tcfg, rcfg, 2, 4, h, w, model.encoder.gt_patch_size)
    art = 1e-3 * torch.randn(160, h // 8, w // 8, generator=gc)
    reset_launches()
    gpu = _gpu_cpu_step(model, batch, draws, tcfg, rcfg, lcfg, cuda, art)
    torch.cuda.synchronize()
    counts = launches()
    assert counts["attention_d80"] == 24 and counts["attention_d80_bwd_dq"] == 12, counts
    assert counts["attention_d80_bwd_dkv"] == 12 and counts["attention"] == 0, counts
    _assert_step_close(gpu, _gpu_cpu_step(copy.deepcopy(model).to("cpu"), batch, draws, tcfg, rcfg, lcfg, "cpu",
                                          art))


@pytest.mark.cuda
def test_upsample_gt_step_matches_the_cpu(cuda):
    """configs/train_scenedino_kitti_360_upsampler.yaml's model (bf16,
    ViT-B/8 student and teacher, the multiscale-crop teacher, a per-pixel
    target) at 64x512, B = 1, V = 4: the card's step runs the teacher's 8
    views and the student through K1; its loss and gradients against the
    CPU's on the same crops, within phase 5's bounds."""
    import copy

    from scenedino_torch.models.factory import make_model
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load

    h, w = 64, 512
    conf = load("configs/train_scenedino_kitti_360_upsampler.yaml")
    conf["model"]["encoder"]["image_size"] = [h, w]
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    model = make_model(model_conf, device=cuda, seed=0, training=True)
    assert model.encoder.crop_views == 2 and tcfg.dino_upscaled and not tcfg.compensate_artifacts
    batch = _seeded_batch(1, 4, h, w, 2)
    draws = trainer.draw_stage1(torch.Generator().manual_seed(7), tcfg, rcfg, 1, 4, h, w, 8, crop_views=2)
    reset_launches()
    gpu = _gpu_cpu_step(model, batch, draws, tcfg, rcfg, lcfg, cuda)
    torch.cuda.synchronize()
    counts = launches()
    assert counts["attention"] == 24 and counts["attention_bwd_dq"] == 12, counts  # teacher 12 + student 12
    _assert_step_close(gpu, _gpu_cpu_step(copy.deepcopy(model).to("cpu"), batch, draws, tcfg, rcfg, lcfg, "cpu"))


def _serving_state(cuda, h, w, D=128, E=65, quantize=False, seed=0):
    """A random folded serving state of one 2h x 2w grid on the card: bf16
    weights and colours, the grid bf16 or int8 with its per-channel scale
    (`quantize_folded`), an encode camera at the origin."""
    from scenedino_torch.ops import fast_field as ff

    g = torch.Generator(device=cuda).manual_seed(seed)
    folded = torch.randn(1, 1, 2 * h, 2 * w, D, generator=g, device=cuda)
    scale = None
    if quantize:
        folded, scale = ff.quantize_folded(folded)
    k = torch.tensor([[1.1, 0.0, 0.02], [0.0, 2.2, -0.01], [0.0, 0.0, 1.0]], device=cuda)[None, None]
    eye = torch.eye(4, device=cuda)[None, None]
    b2 = torch.randn(E, generator=g, device=cuda) * 0.2
    b2[0] += 0.5
    bf16 = torch.bfloat16
    return ff.FastFieldState(
        folded_grid=folded if quantize else folded.to(bf16),
        w_code=(torch.randn(39, D, generator=g, device=cuda) * 0.3).to(bf16),
        b1=torch.randn(D, generator=g, device=cuda) * 0.1,
        w2=(torch.randn(D, E, generator=g, device=cuda) / D ** 0.5).to(bf16), b2=b2, feat_ks=k, feat_w2c=eye,
        color_imgs=torch.rand(1, 1, h, w, 3, generator=g, device=cuda).to(bf16), color_ks=k, color_w2c=eye,
        grid_scale=scale)


@pytest.mark.cuda
def test_encode_view_kernel_on_the_int8_grid(cuda):
    """The int8 state's encode view: its preamble dequantizes the grid to the
    fp32 base, K6 takes it with the bf16 W_z and W2; against the plain
    version at the bf16 bounds (the feature's times its largest magnitude)."""
    from scenedino_torch.models.field import FieldConfig
    from scenedino_torch.ops import fast_field as ff

    h, w = 48, 160
    fs = _serving_state(cuda, h, w, quantize=True)
    cfg = FieldConfig()
    u = torch.rand(h * w, 32, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    args, ecfg = ff.encode_view_inputs(fs, cfg, h, w, u[None])
    assert args[0].dtype == torch.float32 and args[3].dtype == args[4].dtype == torch.bfloat16
    reset_launches()
    out = ff.render_encode_view(fs, cfg, h, w, u=u)
    assert launches()["encode_view"] == 1
    ref = encode_view_plain(*args, ecfg)
    for i, (o, r, b) in enumerate(zip(out, ref, (5e-2, 5e-3, 5e-3))):
        if i == 1:
            b *= max(1.0, r.abs().max().item())
        assert (o.reshape(r.shape) - r).abs().max().item() <= b, i


@pytest.mark.cuda
def test_unfused_render_against_the_point_render_kernel(cuda):
    """render_novel_view (plain torch on the card) against
    render_novel_view_fused (K2) on one bf16 state and the same strata:
    K2's depth and feature bounds; colours to 1e-2 (the unfused lookup
    blends the bf16 image in bf16 as the reference does, K2 in fp32); the
    int8 state refused by K2's path and rendered by the unfused one."""
    from scenedino_torch.models.field import FieldConfig
    from scenedino_torch.ops import fast_field as ff

    h, w, K = 48, 160, 32
    fs = _serving_state(cuda, h, w, seed=2)
    cfg = FieldConfig()
    c, s = np.cos(0.05), np.sin(0.05)
    pose = torch.tensor([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.0], [0, 0, 0, 1]], device=cuda)
    k = fs.feat_ks[0, 0]
    u = torch.rand(h * w, K, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    reset_launches()
    ref = ff.render_novel_view(fs, cfg, pose, k, h, w, u=u, n_coarse=K)
    assert not any(launches().values())
    out = ff.render_novel_view_fused(fs, cfg, pose, k, h, w, u=u, n_coarse=K)
    assert launches()["point_render"] == 1
    errs = [(o - r).abs().max().item() for o, r in zip(out, ref)]
    assert errs[0] <= 5e-2 and errs[1] <= 5e-3 * max(1.0, ref[1].abs().max().item()) and errs[2] <= 1e-2, errs
    q = _serving_state(cuda, h, w, seed=2, quantize=True)
    with pytest.raises(NotImplementedError, match="exact-only"):
        ff.render_novel_view_fused(q, cfg, pose, k, h, w, u=u, n_coarse=K)
    d, f, rgb = ff.render_novel_view(q, cfg, pose, k, h, w, u=u, n_coarse=K)
    assert all(torch.isfinite(t).all() for t in (d, f, rgb))


@pytest.mark.cuda
def test_probe_bound_on_the_trained_field_through_the_kernels(cuda):
    """tests/test_torch_probe_trained.py's bound with the renders on the
    card (bf16 state): the 128-sample gold and the exact render through
    K2, the probe through K3, the row gather and K2."""
    from scenedino_torch.tools import probe_quality_trained as pq

    err_p, err_e, cos, counts = pq.probe_errors(cuda)
    assert counts["point_render"] == 3 and counts["probe_weights"] == 1 and counts["row_gather"] == 1, counts
    stats, failed = pq.bound(err_p, err_e, cos)
    assert not failed, (failed, stats)


# ---------------------------------------------- every shape the JAX package takes


@pytest.mark.cuda
@pytest.mark.parametrize("K", [96, 128, 256])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_point_render_kernel_past_64_samples_matches_plain(cuda, K, depth_statistic):
    """K2 with a ray over two to four of its 64-point tiles (96 leaves 32
    dead rows in the last): the transmittance and sums carried from tile to
    tile, the median from the ray's stored weights; K2's bounds and median
    rule."""
    cfg = PointRenderConfig(depth_statistic=depth_statistic)
    args = _k2_inputs(cuda, 12, 20, K, 128, 65, cfg, seed=K)
    before = point_render.launches
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    assert point_render.launches == before + 1
    ref = point_render_plain(*args, cfg)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    if depth_statistic == "median":
        z = args[1]
        k_idx = (z - out[0][:, None]).abs().argmin(-1)
        p_idx = (z - ref[0][:, None]).abs().argmin(-1)
        assert torch.equal(z.gather(1, k_idx[:, None])[:, 0], out[0])
        assert (k_idx - p_idx).abs().max().item() <= 1 and (k_idx != p_idx).float().mean().item() <= 0.01
    else:
        assert (out[0] - ref[0]).abs().max().item() <= 5e-2
    assert (out[1] - ref[1]).abs().max().item() <= 5e-3 and (out[2] - ref[2]).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("K", [96, 128, 256])
def test_probe_weights_kernel_past_64_samples_matches_plain(cuda, K):
    cfg = PointRenderConfig()
    rays, z, grid, w_code, b1, w2, b2, fw, fk = _k2_inputs(cuda, 12, 20, K, 128, 3, cfg, seed=K + 5)[:9]
    args = (rays, z, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(), fw, fk)
    before = probe_weights.launches
    out = probe_weights(*args, cfg)
    torch.cuda.synchronize()
    assert probe_weights.launches == before + 1
    assert out.shape == z.shape and bool(torch.isfinite(out).all())
    assert (out - probe_weights_plain(*args, cfg)).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("K,num_freqs,dtype", [(96, 6, torch.float32), (96, 6, torch.bfloat16),
                                               (128, 6, torch.float32), (128, 6, torch.bfloat16),
                                               (48, 8, torch.float32), (48, 8, torch.bfloat16),
                                               (128, 8, torch.float32), (128, 8, torch.bfloat16),
                                               (32, 15, torch.bfloat16), (32, 15, torch.float32)])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_encode_view_kernel_past_64_samples_and_16_code_columns_matches_plain(cuda, dtype, K, num_freqs,
                                                                             depth_statistic):
    """K6 with a ray over two of its 64-row tiles, and with a z code of 17
    columns (num_freqs 8) and of 31 (num_freqs 15): the second k16 step of
    the code product; the bounds of test_encode_view_kernel_matches_plain.
    At num_freqs 15 (a top frequency of 1.5 x 2^14) one ulp of the normalized
    depth moves a code argument by ~1e-3 rad, so the kernel and the plain
    version normalize depth with the same float32 constants and roundings
    (core/encoding.zn_constants) and the fp32 state meets the fp32 bounds."""
    g = torch.Generator(device=cuda).manual_seed(K + num_freqs)
    N, D, E = 3000, 128, 65
    cfg = EncodeViewConfig(num_freqs=num_freqs, depth_statistic=depth_statistic)
    base = torch.randn(N, D, generator=g, device=cuda)
    z = (torch.rand(N, K, generator=g, device=cuda) * 77 + 3).sort(-1).values
    zscale = torch.rand(N, generator=g, device=cuda) * 0.2 + 0.8
    w_z = (torch.randn(cfg.code_dims, D, generator=g, device=cuda) * 0.3).to(dtype)
    w2 = (torch.randn(D, E, generator=g, device=cuda) / D ** 0.5).to(dtype)
    b2 = torch.randn(E, generator=g, device=cuda) * 0.2
    color = torch.rand(N, 3, generator=g, device=cuda)
    args = (base, z, zscale, w_z, w2, b2, color)
    reset_launches()
    out = encode_view(*args, cfg)
    again = encode_view(*args, cfg)
    assert launches()["encode_view"] == 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    ref = encode_view_plain(*args, cfg)
    if depth_statistic == "median":
        k_o = (z - out[0][:, None]).abs().argmin(-1)
        k_r = (z - ref[0][:, None]).abs().argmin(-1)
        assert torch.equal(z.gather(1, k_o[:, None])[:, 0], out[0])
        assert (k_o - k_r).abs().max().item() <= 1 and (k_o != k_r).float().mean().item() <= 1e-2
    bounds = (1e-3, 1e-4, 1e-4) if dtype == torch.float32 else (5e-2, 5e-3, 5e-3)
    for i, (o, r, b) in enumerate(zip(out, ref, bounds)):
        if i == 0 and depth_statistic == "median":
            continue
        if dtype == torch.bfloat16 and i == 1:
            b *= max(1.0, r.abs().max().item())
        assert (o - r).abs().max().item() <= b, (i, (o - r).abs().max().item())


@pytest.mark.cuda
def test_point_kernels_and_encode_view_take_what_was_past_their_ceilings(cuda):
    """257 samples a ray (K2, K3, K6) and 33 z-code columns (num_freqs 16
    with the input, K6), once refused, run through the kernels' wide walk:
    one launch each, within their bounds; an fp32 grid is still refused and
    launches nothing."""
    cfg = PointRenderConfig()
    args = list(_k2_inputs(cuda, 4, 8, 257, 16, 9, cfg, seed=0))
    before = launches()
    with pytest.raises(ValueError):
        point_render(*args[:2], args[2].float(), *args[3:], cfg)
    assert launches() == before
    out = point_render(*args, cfg)
    sig = (*args[:5], args[5][:, :1].contiguous(), args[6][:1].contiguous(), *args[7:9])
    weights = probe_weights(*sig, cfg)
    torch.cuda.synchronize()
    ref = point_render_plain(*args, cfg)
    assert max((o - r).abs().max().item() for o, r in zip(out, ref)) <= 5e-2
    assert (out[1] - ref[1]).abs().max().item() <= 5e-3 and (out[2] - ref[2]).abs().max().item() <= 5e-3
    assert (weights - probe_weights_plain(*sig, cfg)).abs().max().item() <= 5e-3
    N, D, E = 8, 16, 7
    ev = [torch.randn(N, D, device=cuda), torch.rand(N, 4, device=cuda).sort(-1).values * 10 + 3,
          torch.ones(N, device=cuda), None, torch.randn(D, E, device=cuda), torch.zeros(E, device=cuda),
          torch.rand(N, 3, device=cuda)]
    # a bf16 state (the fp32 one at num_freqs 16: test_encode_view_kernel_at_every_width_matches_plain)
    wide = EncodeViewConfig(num_freqs=16)
    ev16 = list(ev)
    ev16[3] = (torch.randn(wide.code_dims, D, device=cuda) * 0.3).to(torch.bfloat16)
    ev16[4] = (ev[4] / D ** 0.5).to(torch.bfloat16)
    for i, (o, r, b) in enumerate(zip(encode_view(*ev16, wide), encode_view_plain(*ev16, wide), (5e-2, 5e-3, 5e-3))):
        if i == 1:  # a flip of h moves the feature in proportion to its scale
            b *= max(1.0, r.abs().max().item())
        assert (o - r).abs().max().item() <= b
    ev[1], ev[3] = torch.rand(N, 257, device=cuda).sort(-1).values * 10 + 3, torch.randn(13, D, device=cuda)
    for o, r, b in zip(encode_view(*ev, EncodeViewConfig()), encode_view_plain(*ev, EncodeViewConfig()),
                       (1e-3, 1e-4, 1e-4)):
        assert (o - r).abs().max().item() <= b
    after = launches()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "point_render": 1, "probe_weights": 1, "encode_view": 2}


# ------------------------------------------------ every width the JAX package takes


def _median_holds(z, got, ref):
    k_idx = (z - got[:, None]).abs().argmin(-1)
    p_idx = (z - ref[:, None]).abs().argmin(-1)
    return (torch.equal(z.gather(1, k_idx[:, None])[:, 0], got) and (k_idx - p_idx).abs().max().item() <= 1
            and (k_idx != p_idx).float().mean().item() <= 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("K,D,E,num_freqs", [
    (32, 132, 65, 6),  # D not a multiple of 8
    (32, 128, 129, 6),  # E past 128
    (32, 128, 65, 11),  # 69 code columns
    (48, 512, 769, 16),  # the flagship's head: 99 code columns, the A operands in global scratch
    (32, 264, 200, 6),  # the A operands in shared memory, a ragged last output chunk
    (320, 128, 65, 6),  # 320 and 512 samples a ray
    (512, 128, 65, 6),
])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_point_render_kernel_at_every_width_matches_plain(cuda, K, D, E, num_freqs, depth_statistic):
    """K2 past the shipped instantiations (the wide walk, csrc/wide_walk.cuh):
    K2's bounds and median rule; two launches give the same bits."""
    cfg = PointRenderConfig(num_freqs=num_freqs, depth_statistic=depth_statistic)
    args = _k2_inputs(cuda, 8, 20, K, D, E, cfg, seed=K + D + E)
    reset_launches()
    out = point_render(*args, cfg)
    again = point_render(*args, cfg)
    torch.cuda.synchronize()
    assert launches()["point_render"] == 2 and sum(launches().values()) == 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    ref = point_render_plain(*args, cfg)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    if depth_statistic == "median":
        assert _median_holds(args[1], out[0], ref[0])
    else:
        assert (out[0] - ref[0]).abs().max().item() <= 5e-2
    assert (out[1] - ref[1]).abs().max().item() <= 5e-3 and (out[2] - ref[2]).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("K,D,num_freqs", [(16, 132, 6), (16, 512, 16), (32, 128, 11), (320, 128, 6),
                                           (512, 264, 6)])
def test_probe_weights_kernel_at_every_width_matches_plain(cuda, K, D, num_freqs):
    cfg = PointRenderConfig(num_freqs=num_freqs)
    rays, z, grid, w_code, b1, w2, b2, fw, fk = _k2_inputs(cuda, 8, 20, K, D, 3, cfg, seed=K + D)[:9]
    args = (rays, z, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(), fw, fk)
    reset_launches()
    out = probe_weights(*args, cfg)
    again = probe_weights(*args, cfg)
    torch.cuda.synchronize()
    assert launches()["probe_weights"] == 2 and sum(launches().values()) == 2
    assert torch.equal(out, again) and out.shape == z.shape and bool(torch.isfinite(out).all())
    assert (out - probe_weights_plain(*args, cfg)).abs().max().item() <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("D,E,num_freqs", [(132, 65, 6), (512, 769, 16), (128, 129, 11), (264, 200, 6), (8, 2, 11)])
def test_point_query_kernel_at_every_width_matches_plain(cuda, D, E, num_freqs):
    """K4's bound as chip_smoke.py phase 3c holds it, over each point's largest
    output (at least 1), on every point: at num_freqs 16 too, nearer than
    z_near as well, where the normalized inverse depth reaches thousands, as
    the kernel and the plain version round it alike."""
    cfg = PointRenderConfig(num_freqs=num_freqs)
    rays, z, grid, w_code, b1, w2, b2, fw, fk = _k2_inputs(cuda, 24, 40, 8, D, E, cfg, seed=D + E)[:9]
    pts = (rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]).reshape(-1, 3)[:7000].contiguous()
    args = (pts, grid, w_code, b1, w2, b2, fw, fk)
    reset_launches()
    sigma, feat = point_query(*args, cfg)
    again = point_query(*args, cfg)
    torch.cuda.synchronize()
    assert launches()["point_query"] == 2 and sum(launches().values()) == 2
    assert torch.equal(sigma, again[0]) and torch.equal(feat, again[1])
    ref_sigma, ref_feat = point_query_plain(*args, cfg)
    assert sigma.shape == (7000,) and feat.shape == (7000, E - 1)
    d = torch.maximum((sigma - ref_sigma).abs(), (feat - ref_feat).abs().amax(-1))
    scaled = d / torch.clamp_min(torch.maximum(ref_sigma, ref_feat.abs().amax(-1)), 1.0)
    assert scaled.max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,K,D,E,num_freqs", [
    *[(dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
      for shape in ((32, 264, 769, 8), (32, 132, 130, 6), (48, 200, 69, 6), (320, 128, 65, 6), (512, 128, 65, 6),
                    (32, 512, 769, 8))],
    (torch.bfloat16, 32, 264, 769, 16), (torch.bfloat16, 32, 512, 769, 16), (torch.bfloat16, 96, 136, 65, 16),
    (torch.float32, 32, 264, 769, 16), (torch.float32, 96, 136, 65, 16),
])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_encode_view_kernel_at_every_width_matches_plain(cuda, dtype, K, D, E, num_freqs, depth_statistic):
    """K6 past the shipped instantiations (the wide walk): D past 128 (and
    not a multiple of 8), E past 68, a z code of 33 columns, 320 and 512
    samples a ray, in both states; the bounds of
    test_encode_view_kernel_matches_plain; two launches give the same bits.
    The 33-column code (num_freqs 16) in both states: at a frequency of
    1.5 x 2^15 one ulp of the normalized depth would move a code argument
    past the fp32 bounds, and the kernel rounds it as the plain version
    does (test_encode_view_kernel_past_64_samples_and_16_code_columns_matches_plain)."""
    g = torch.Generator(device=cuda).manual_seed(K * D + E)
    N = 1000
    cfg = EncodeViewConfig(num_freqs=num_freqs, depth_statistic=depth_statistic)
    base = torch.randn(N, D, generator=g, device=cuda)
    z = (torch.rand(N, K, generator=g, device=cuda) * 77 + 3).sort(-1).values
    zscale = torch.rand(N, generator=g, device=cuda) * 0.2 + 0.8
    w_z = (torch.randn(cfg.code_dims, D, generator=g, device=cuda) * 0.3).to(dtype)
    w2 = (torch.randn(D, E, generator=g, device=cuda) / D ** 0.5).to(dtype)
    b2 = torch.randn(E, generator=g, device=cuda) * 0.2
    color = torch.rand(N, 3, generator=g, device=cuda)
    args = (base, z, zscale, w_z, w2, b2, color)
    reset_launches()
    out = encode_view(*args, cfg)
    again = encode_view(*args, cfg)
    assert launches()["encode_view"] == 2 and sum(launches().values()) == 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    ref = encode_view_plain(*args, cfg)
    if depth_statistic == "median":
        assert _median_holds(z, out[0], ref[0])
    bounds = (1e-3, 1e-4, 1e-4) if dtype == torch.float32 else (5e-2, 5e-3, 5e-3)
    for i, (o, r, b) in enumerate(zip(out, ref, bounds)):
        if i == 0 and depth_statistic == "median":
            continue
        if dtype == torch.bfloat16 and i == 1:
            b *= max(1.0, r.abs().max().item())
        assert (o - r).abs().max().item() <= b, (i, (o - r).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 48, 96, 128, 256, 8, 20, 200, 16, 56, 192, 76])
@pytest.mark.parametrize("n", [1, 65, 130, 600])
def test_attention_any_kernels_match_plain(cuda, D, n):
    """K1 at the head dims of csrc/attention_any.cu (8 to 56 computed at 64
    columns, 76 to 128 at 128, 192 and 200 at 192 and 256; 20 and 76 have
    rows that are not 16-byte aligned, which the wrappers pad to 24 and 80
    and still route to csrc/attention_any.cu): the forward with and without
    the log-sum-exp, dq and dkv against the plain versions, ragged token
    counts around its 64-row tiles, two launches bitwise equal, each launch
    counted on the route of D, the D = 64 and 80 counts untouched."""
    from scenedino_torch.kernels.attention import attention_bwd_dkv, attention_bwd_dq, route

    assert route(D)[0] == "any"
    g = torch.Generator(device=cuda).manual_seed(300 + D + n)
    q, k, v, do = (torch.randn(2, n, 3, D, generator=g, device=cuda).to(torch.bfloat16) for _ in range(4))
    before = launches()
    out, lse = attention_fwd(q, k, v, with_lse=True)
    plain_out = attention_fwd(q, k, v)[0]
    dq, di = attention_bwd_dq(q, k, v, out, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    again = attention_bwd_dq(q, k, v, out, do, lse)[0], attention_bwd_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    after = launches()
    assert after["attention_any"] == before["attention_any"] + 2
    assert after["attention_any_bwd_dq"] == before["attention_any_bwd_dq"] + 2
    assert after["attention_any_bwd_dkv"] == before["attention_any_bwd_dkv"] + 2
    assert all(after[name] == before[name] for name in ("attention", "attention_bwd_dq", "attention_bwd_dkv",
                                                        "attention_d80", "attention_d80_bwd_dq",
                                                        "attention_d80_bwd_dkv"))
    assert torch.equal(out, plain_out) and torch.equal(dq, again[0]) and torch.equal(dk, again[1][0])
    assert torch.equal(dv, again[1][1])
    assert (out.float() - attention_plain(q, k, v).float()).abs().max().item() <= 2e-2
    assert (lse - attention_lse_plain(q, k)).abs().max().item() <= 1e-3
    assert (di - (do.float() * out.float()).sum(-1).transpose(1, 2)).abs().max().item() <= 1e-3
    for got, ref in zip((dq, dk, dv), attention_bwd_plain(q, k, v, out, do, lse)):
        assert torch.isfinite(got).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= K1_BWD_REL * ref.float().abs().max().item() + 1e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1921, 2, 384), (2, 1921, 1, 768), (2, 1921, 2, 512), (2, 1921, 4, 320),
                                   (2, 1921, 1, 1280), (2, 1921, 2, 264), (2, 130, 3, 300), (1, 65, 2, 448)])
def test_attention_wide_kernels_match_plain(cuda, shape):
    """K1 past head dim 256 (csrc/attention_wide.cu) at chip_smoke.py phase
    20a's shapes, at D = 300 (padded to 304 by the wrappers) and at a ragged
    token count: the forward with and without the log-sum-exp, dq and dkv
    against the plain versions, two launches bitwise equal, each launch
    counted on the wide route and no other count moved."""
    from scenedino_torch.kernels.attention import attention_bwd_dkv, attention_bwd_dq, route

    B, n, H, D = shape
    assert route(D)[0] == "wide"
    g = torch.Generator(device=cuda).manual_seed(700 + D + n)
    q, k, v, do = (torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16) for _ in range(4))
    before = launches()
    out, lse = attention_fwd(q, k, v, with_lse=True)
    plain_out = attention_fwd(q, k, v)[0]
    dq, di = attention_bwd_dq(q, k, v, out, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    again = attention_bwd_dq(q, k, v, out, do, lse)[0], attention_bwd_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    after = launches()
    wide = ("attention_wide", "attention_wide_bwd_dq", "attention_wide_bwd_dkv")
    assert all(after[name] == before[name] + 2 for name in wide)
    assert all(after[name] == before[name] for name in after if name not in wide)
    assert torch.equal(out, plain_out) and torch.equal(dq, again[0]) and torch.equal(dk, again[1][0])
    assert torch.equal(dv, again[1][1])
    assert (out.float() - attention_plain(q, k, v).float()).abs().max().item() <= 2e-2
    assert (lse - attention_lse_plain(q, k)).abs().max().item() <= 1e-3
    assert (di - (do.float() * out.float()).sum(-1).transpose(1, 2)).abs().max().item() <= 1e-3
    for got, ref in zip((dq, dk, dv), attention_bwd_plain(q, k, v, out, do, lse)):
        assert torch.isfinite(got).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= K1_BWD_REL * ref.float().abs().max().item() + 1e-3, err


@pytest.mark.cuda
def test_attention_wide_kernels_neither_spill_nor_serialize(cuda):
    """ptxas' report of csrc/attention_wide.cu's forward, dq and dkv: no
    spill, and no note of serialized wgmma or of an injected
    warpgroup.arrive (C75xx)."""
    from scenedino_torch.tools import bench_attention_wide as baw

    build.build(["attention_wide"])
    log = build.build_log("attention_wide")
    report = baw.wide_report(log)
    assert not baw.spilled(report), report
    assert not baw.wgmma_notes(log)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 48, 56])
def test_attention_any_register_operands_at_one_tile_over_many_tiles_and_seeds(cuda, D):
    """At 64 padded columns the forward's Q and dq's Q and dO are wgmma's A
    operand from registers, and the k-steps past D run under a predicate
    (one to four of them at D = 16 to 56): over 11 to 31 walked tiles and
    four seeds each, the forward, its log-sum-exp, dq, dk and dv hold the
    plain versions and a second launch gives the same bits."""
    from scenedino_torch.kernels.attention import attention_bwd_dkv, attention_bwd_dq

    for n in (700, 1921):
        for seed in range(4):
            g = torch.Generator(device=cuda).manual_seed(1000 * seed + n + D)
            q, k, v, do = (torch.randn(2, n, 3, D, generator=g, device=cuda).to(torch.bfloat16) for _ in range(4))
            runs = []
            for _ in range(2):
                out, lse = attention_fwd(q, k, v, with_lse=True)
                dq, di = attention_bwd_dq(q, k, v, out, do, lse)
                runs.append((out, lse, dq, di) + attention_bwd_dkv(q, k, v, do, lse, di))
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*runs)), (n, seed)
            out, lse, dq, di, dk, dv = runs[0]
            assert (out.float() - attention_plain(q, k, v).float()).abs().max().item() <= 2e-2, (n, seed)
            assert (lse - attention_lse_plain(q, k)).abs().max().item() <= 1e-3, (n, seed)
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), attention_bwd_plain(q, k, v, out, do, lse)):
                err = (got.float() - ref.float()).abs().max().item()
                assert err <= K1_BWD_REL * ref.float().abs().max().item() + 1e-3, (name, n, seed, err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80])
def test_attention_forwards_hold_the_scaled_keys_sweep(cuda, D):
    """Item C of ROADMAP queue 3: both shipped forwards, built with the exact
    rescale, on keys scaled along the walk (key row n by 1 + 4 n / N) at
    chip_smoke.py phase 11a's 16 cases (4 shapes x seeds 200 + N, 1, 2, 3),
    each within the card test's bound of 2e-2 of the fp32 plain version
    rounded to bf16 (the lazy rescale read 3.125e-2 on 8 and 11 of them)."""
    errs = {}
    for b, n, h in ((4, 585, 16), (2, 1921, 12), (4, 1921, 12), (4, 2305, 12)):
        for seed in (200 + n, 1, 2, 3):
            g = torch.Generator(device=cuda).manual_seed(seed)
            q, k, v = (torch.randn(b, n, h, D, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
            ramp = torch.arange(n, device=cuda, dtype=torch.float32)[None, :, None, None] / n
            k = (k.float() * (1 + 4 * ramp)).to(torch.bfloat16)
            out = attention_fwd(q, k, v)[0].float()
            errs[b, n, h, seed] = (out - attention_plain(q, k, v).float()).abs().max().item()
    assert len(errs) == 16 and max(errs.values()) <= 2e-2, errs
