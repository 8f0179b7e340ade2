#!/usr/bin/env python3
"""Drive the PyTorch port (`scenedino_torch`) on one NVIDIA GPU and hold
its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  0 device   the card's name and power limit; TF32 off for fp32 compares
  1 build    nvcc builds every kernel of the paths from csrc/ (sm_90a);
             the K1 backward kernels' registers and spills (none allowed)
  2 K1       attention kernel vs its plain version at ViT-B/8 @192x640
             (1, 1921, 12, 64) bf16; kernel, plain and
             F.scaled_dot_product_attention times (the last only as a
             yardstick: the port never calls it)
  2b K1-bwd  the backward kernels (dq; dk and dv) vs the plain fp32
             backward at the training shape (4, 1921, 12, 64) bf16, and
             two launches bitwise equal; kernel, plain and
             scaled_dot_product_attention-backward times, the pair's TFLOP/s
  3 K2       point-render kernel vs its plain version at full width:
             192x640 rays x 32 samples, 384x1280x128 bf16 grid, d_out 65;
             then with the weight-median depth
  3b probe   the probe path's kernels at the shapes it gives them: K3 at
             48x160 rays x 16 samples over the same grid with the density
             column of W2; the row gather of their weights and depths, a
             (7680, 32) fp32 table, at the 122,880 pixels' probe rows
             (exact; kernel, plain and torch.index_select times); K2 on
             the 10 + 2 resampled, sorted depths of each pixel
  3c K4      point-query kernel vs its plain version over the 2,097,152
             SSCBench voxel centres (bench.py's (z, x, y) order)
  3d gather  the row-gather kernel at P1's shape (256 rows of a 512x128
             fp32 table) and P2's (2^20 rows of a 32768x128 bf16
             table), exact at both; kernel, plain and torch.index_select
             times
  Bounds: the larger of the bytes moved (each input read once, each
  output written once; of a folded grid only the distinct rows that the
  points' corner lookups read) over 3.35 TB/s and the FLOP over the bf16
  tensor-core peak.
  4 slice    the flagship field (ViT-B/8 + DPT 256, bf16, seeded random
             weights) answers 3 novel-view requests (encode ->
             build_fast_state -> render_novel_view_fused, 32 samples),
             3 probe requests (encode_prefolded -> render_novel_view_probe
             at its defaults), 3 SSC voxel queries (encode_prefolded ->
             fast_query_fused over the 2,097,152 voxel centres) and 3
             encode-view renders (encode_prefolded -> render_encode_view);
             the launch counters, zeroed before each path and read after
             it, show each path's kernels ran; stage times and profiles;
             then small requests of the exact, probe and query paths are
             checked against the same model run on the CPU
  5 train    the flagship stage-1 training step (configs/
             train_scenedino_kitti_360.yaml: student ViT-B/8 + DPT 256 and
             frozen ViT-B/8 teacher in bf16, FeatUp downsampler, 64->768
             MLP, artifact field, 192x640, batch 4, V = 4, 2048 rays in
             8x8 patches, 32 samples, two-group Adam) takes 3 steps on
             seeded random weights and seeded images; each step must be
             finite, applied and move the parameters, with 12 launches of
             each backward kernel; stage times, peak memory and a
             profile; then one step at 32x96 is checked against the same
             model run on the CPU
  6 kernels  one JSON line: launches (all serving paths and training
             together), error, times and bound per kernel
The line before the last is the card's name and power limit as
nvidia-smi prints them; the last line is {"ok": true, "device": {...}}.
Any failed phase exits non-zero before that line. Needs one CUDA card;
exits non-zero without one, and outside a checkout of the repository.
"""
import argparse
import copy
import dataclasses
import json
import sys
import time

import numpy as np
import torch

H, W, K = 192, 640, 32
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bounds of the kernel-vs-plain comparisons
K1_TOL = 2e-2  # bf16 output (ulp 2^-8 at |x| ~ 1) plus P rounded to bf16 for P @ V
K2_DEPTH_TOL = 5e-2  # metres: sample weights move by bf16 rounding flips of h
K2_FEAT_TOL = 5e-3  # one bf16 ulp of h through W2 (|W2| ~ 0.1)
K2_RGB_TOL = 5e-3  # fp32 colour blend on both sides; only the weights differ
# the median depth is a sample depth: the kernel's is the plain version's
# sample, or its neighbour where a bf16 flip of h moves the CDF across 0.5
# (a near tie), on at most this share of rays
K2_MEDIAN_FLIPS = 1e-2
K3_TOL = 5e-3  # weights in [0, 1], moved by bf16 rounding flips of h as K2's are
# per point, where K2's feature is averaged over a ray's samples: about two
# bf16 flips of h (ulp 2^-6 at |h| < 4) through W2 entries (|w| < 0.35);
# on points nearer than z_near, relative to the point's largest output
K4_TOL = 1e-2
# the backward kernels against the plain fp32 backward, per output: this
# fraction of the largest |plain| value plus 1e-3 (P and dS are rounded to
# bf16 for the tensor-core products and the results to bf16)
K1_BWD_REL = 2e-2
# the small-input check: the same bf16 model on the GPU (kernels) and on the
# CPU (plain versions), summed in other orders through 12 blocks and the DPT
SLICE_DEPTH_REL = 1e-2
SLICE_COS = 0.99
# the probe path resamples depths by comparing draws with the probe's
# weight CDF, a step function of the weights: a draw within the two
# runs' weight differences of a step picks the next bin, so a few rays
# may differ by more; the bound holds at the 99th percentile
PROBE_DEPTH_REL_P99 = 1e-2
# the query's sigma against its largest value (sigma near 0 has no
# meaningful relative error)
QUERY_SIGMA_REL = 1e-2
# the small training check, same bf16 model and draws on the GPU and the
# CPU: the loss is a mean over ~1e5 terms whose bf16 rounding differs
# element by element; a gradient tensor's relative L2 error collects those
# differences through 12 blocks forward and back
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL = 0.1
TRAIN_STEPS = 3


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def novel_pose(device):
    """0.3 m right, 0.1 m up, 3 degrees of yaw (bench.py's novel camera)."""
    c, s = np.cos(0.05), np.sin(0.05)
    m = np.array([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.0], [0, 0, 0, 1]], np.float32)
    return torch.from_numpy(m).to(device)


def intrinsics(device):
    return torch.tensor([[0.7, 0.0, 0.0], [0.0, 2.3, 0.0], [0.0, 0.0, 1.0]], device=device)


def phase_k1(gen):
    from scenedino_torch.kernels.attention import attention, attention_plain
    from scenedino_torch.utils.timing import time_ms

    B, N, Hh, D = 1, 1921, 12, 64
    q, k, v = (torch.randn(B, N, Hh, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    out = attention(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - attention_plain(q, k, v).float()).abs().max().item()
    if not err <= K1_TOL:
        fail(f"K1 attention disagrees with its plain version: max abs err {err} > {K1_TOL}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_ms(lambda: attention(q, k, v), inner=10)
    plain_ms = time_ms(lambda: attention_plain(q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=10)
    b, by = bound_ms(4.0 * B * Hh * N * N * D, 4 * B * N * Hh * D * 2)
    print(f"phase 2 K1 attention (1, {N}, {Hh}, {D}) bf16: max_abs_err {err:.3e} (bound {K1_TOL}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b:.4f} ms ({by})",
          flush=True)
    return {"name": "attention", "route": "cuda", "source": "scenedino_torch/csrc/attention.cu",
            "replaces": "scenedino_tpu/models/vit.py:126", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms}


def phase_k1_bwd(gen):
    from scenedino_torch.kernels.attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        attention_fwd,
    )
    from scenedino_torch.utils.timing import time_ms

    B, N, Hh, D = 4, 1921, 12, 64
    q, k, v, do = (torch.randn(B, N, Hh, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    dq, di = attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    # no atomics: a second launch gives the same bits
    dq2, di2 = attention_bwd_dq(q, k, v, o, do, lse)
    dk2, dv2 = attention_bwd_dkv(q, k, v, do, lse, di2)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in ((dq, dq2), (di, di2), (dk, dk2), (dv, dv2))):
        fail("K1 backward: two launches on the same inputs differ")
    ref = attention_bwd_plain(q, k, v, o, do, lse)
    errs, bounds = [], []
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        errs.append((got.float() - r.float()).abs().max().item())
        bounds.append(K1_BWD_REL * r.float().abs().max().item() + 1e-3)
        if not (torch.isfinite(got).all() and errs[-1] <= bounds[-1]):
            fail(f"K1 backward {name} disagrees with the plain backward: max abs err {errs[-1]} > {bounds[-1]}")

    ms_dq = time_ms(lambda: attention_bwd_dq(q, k, v, o, do, lse), inner=5)
    ms_dkv = time_ms(lambda: attention_bwd_dkv(q, k, v, do, lse, di), inner=5)
    plain_ms = time_ms(lambda: attention_bwd_plain(q, k, v, o, do, lse), reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), inner=5)
    # FlashAttention-2's count with S recomputed: QK^T, dO V^T, dS K, dS^T Q
    # and P^T dO, each 2 N^2 D per (batch, head); dq alone needs the first
    # three, dk and dv alone the other two after the first two again
    unit = 2.0 * B * Hh * N * N * D
    t_bytes, s_bytes = B * N * Hh * D * 2, B * Hh * N * 4
    b_dq, by_dq = bound_ms(3 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v o dO dq; lse, di
    b_dkv, by_dkv = bound_ms(4 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v dO dk dv; lse, di
    b_all, by_all = bound_ms(5 * unit, 8 * t_bytes + s_bytes)
    bytes_ms = [n / PEAK_BYTES * 1e3 for n in (6 * t_bytes + 2 * s_bytes, 8 * t_bytes + s_bytes)]
    print(f"phase 2b K1 backward ({B}, {N}, {Hh}, {D}) bf16: max_abs_err dq {errs[0]:.3e} (bound {bounds[0]:.3e}), "
          f"dk {errs[1]:.3e} (bound {bounds[1]:.3e}), dv {errs[2]:.3e} (bound {bounds[2]:.3e}); kernel dq "
          f"{ms_dq:.4f} ms, dkv {ms_dkv:.4f} ms, together {ms_dq + ms_dkv:.4f} ms "
          f"({7 * unit / (ms_dq + ms_dkv) / 1e9:.1f} TFLOP/s over their 7 products; two launches bitwise equal); "
          f"plain backward {plain_ms:.4f} ms; sdpa backward {lib_ms:.4f} ms (the pair takes "
          f"{(ms_dq + ms_dkv) / lib_ms:.2f} of it); bound dq {b_dq:.4f} ms ({by_dq}), dkv "
          f"{b_dkv:.4f} ms ({by_dkv}), the whole backward at 10 N^2 D B H FLOP {b_all:.4f} ms ({by_all}); "
          f"bytes terms: each kernel {bytes_ms[0]:.4f} ms, the whole backward {bytes_ms[1]:.4f} ms",
          flush=True)
    common = {"route": "cuda", "source": "scenedino_torch/csrc/attention_bwd.cu", "plain_ms": plain_ms,
              "library_ms": lib_ms}
    return [
        {"name": "attention_bwd_dq", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
         "max_abs_err": errs[0], "ms": ms_dq, "bound_ms": b_dq, "bound_by": by_dq, **common},
        {"name": "attention_bwd_dkv", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
         "max_abs_err": max(errs[1:]), "ms": ms_dkv, "bound_ms": b_dkv, "bound_by": by_dkv, **common},
    ]


def flagship_field(gen, dev="cuda"):
    """The serving head's folded grid and weights at the flagship widths:
    384x1280x128 bf16 grid, W_code 39x128, W2 128x65 (seeded random)."""
    Hg, Wg, D, E, C = 2 * H, 2 * W, 128, 65, 39

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    grid = randn(Hg, Wg, D).to(torch.bfloat16)
    w_code = randn(C, D, scale=C ** -0.5).to(torch.bfloat16)
    b1 = randn(D, scale=0.1)
    w2 = randn(D, E, scale=D ** -0.5).to(torch.bfloat16)
    b2 = randn(E, scale=0.1)
    b2[0] += 0.5
    return grid, w_code, b1, w2, b2


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _ray_points(rays, z):
    return (rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]).reshape(-1, 3)


def grid_rows_read(pts, grid, w2c, k):
    """Distinct rows of the (Hg, Wg, D) grid that the 4-corner lookups of
    world points `pts` (P, 3) read, from the plain version's corner
    indices: the grid bytes a kernel over these points must move are these
    rows, not the whole grid."""
    from scenedino_torch.core import cameras
    from scenedino_torch.kernels.point_render import _corners, _to_pixel

    Hg, Wg, _ = grid.shape
    seen = torch.zeros(Hg * Wg, dtype=torch.bool, device=pts.device)
    for p0 in range(0, pts.shape[0], 1 << 20):
        xy = cameras.project(pts[p0:p0 + (1 << 20)], w2c, k)[0]
        (y0, x0, y1, x1), _, _ = _corners(_to_pixel(xy[:, 0], Wg), _to_pixel(xy[:, 1], Hg), Hg, Wg)
        for row in (y0 * Wg + x0, y0 * Wg + x1, y1 * Wg + x0, y1 * Wg + x1):
            seen[row] = True
    return int(seen.sum())


def phase_k2(gen):
    from scenedino_torch.core import rays as rays_mod
    from scenedino_torch.core.sampling import sample_coarse
    from scenedino_torch.kernels.point_render import PointRenderConfig, point_render, point_render_plain
    from scenedino_torch.utils.timing import time_ms

    dev = "cuda"
    cfg = PointRenderConfig()
    r, _ = rays_mod.rays_from_k(novel_pose(dev)[None], intrinsics(dev)[None], W, H, cfg.z_near, cfg.z_far)
    flat = r.reshape(-1, 8).contiguous()
    z = sample_coarse(flat, K, generator=gen).contiguous()
    grid, w_code, b1, w2, b2 = flagship_field(gen)
    D, E, C = grid.shape[-1], w2.shape[-1], w_code.shape[0]
    args = (flat, z, grid, w_code, b1, w2, b2, torch.eye(4, device=dev), intrinsics(dev),
            torch.rand(H, W, 3, generator=gen, device=dev).to(torch.bfloat16), torch.eye(4, device=dev),
            intrinsics(dev))
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    ref = point_render_plain(*args, cfg)
    errs = [(o - p).abs().max().item() for o, p in zip(out, ref)]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    print(f"phase 3 K2 errors: depth {errs[0]:.3e} m, feature {errs[1]:.3e}, rgb {errs[2]:.3e}", flush=True)
    if not (finite and errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL):
        fail(f"K2 point_render disagrees with its plain version (finite={finite}, errors {errs}; "
             f"bounds {K2_DEPTH_TOL}, {K2_FEAT_TOL}, {K2_RGB_TOL})")

    # the weight-median depth: a sample depth, the plain version's or its neighbour
    med = dataclasses.replace(cfg, depth_statistic="median")
    out_m = point_render(*args, med)
    torch.cuda.synchronize()
    ref_m = point_render_plain(*args, med)
    k_idx = (z - out_m[0][:, None]).abs().argmin(-1)
    p_idx = (z - ref_m[0][:, None]).abs().argmin(-1)
    on_sample = torch.equal(z.gather(1, k_idx[:, None])[:, 0], out_m[0])
    off = (k_idx - p_idx).abs().max().item()
    flips = (k_idx != p_idx).float().mean().item()
    med_err = (out_m[0] - ref_m[0]).abs().max().item()
    print(f"phase 3 K2 median depth: on a sample depth {on_sample}; rays whose sample differs from the plain "
          f"version's {flips:.3e} (bound {K2_MEDIAN_FLIPS}), by at most {off} sample(s) (bound 1); max abs err "
          f"{med_err:.3e} m", flush=True)
    if not (on_sample and off <= 1 and flips <= K2_MEDIAN_FLIPS):
        fail("K2's weight-median depth disagrees with its plain version")

    ms = time_ms(lambda: point_render(*args, cfg))
    ms_median = time_ms(lambda: point_render(*args, med))
    plain_ms = time_ms(lambda: point_render_plain(*args, cfg))
    R = flat.shape[0]
    rows = grid_rows_read(_ray_points(flat, z), grid, *args[7:9])
    b, by = bound_ms(2.0 * R * K * (C * D + D * E),
                     rows * D * 2 + nbytes(*args[:2], *args[3:]) + R * (1 + (E - 1) + 3) * 4)
    print(f"phase 3 K2 point_render ({R} rays x {K}, grid {H * 2}x{W * 2}x{D} bf16): kernel {ms:.4f} ms "
          f"(median depth {ms_median:.4f} ms), plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; {rows} distinct "
          f"grid rows read)", flush=True)
    return {"name": "point_render", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:825", "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def phase_probe(gen):
    """K3, the row gather and K2 at the shapes the probe path gives them:
    48x160 probe rays x 16 samples; their weights and depths side by side,
    a (7680, 32) fp32 table, read at (y // 4) * 160 + x // 4 for the
    122,880 pixels; K2 on each pixel's 10 + 2 resampled, sorted depths."""
    from scenedino_torch.core import rays as rays_mod
    from scenedino_torch.core import sampling
    from scenedino_torch.kernels.point_render import (
        PointRenderConfig,
        point_render,
        point_render_plain,
        probe_weights,
        probe_weights_plain,
    )
    from scenedino_torch.kernels.row_gather import row_gather, row_gather_plain
    from scenedino_torch.ops.fast_field import draw_probe
    from scenedino_torch.utils.timing import time_ms

    dev, s, Kp = "cuda", 4, 16
    cfg = PointRenderConfig()
    r, _ = rays_mod.rays_from_k(novel_pose(dev)[None], intrinsics(dev)[None], W, H, cfg.z_near, cfg.z_far)
    flat = r.reshape(-1, 8).contiguous()
    rays = r[0, ::s, ::s].reshape(-1, 8).contiguous()
    draws = draw_probe(H, W, gen, dev)
    z = sampling.sample_coarse(rays, Kp, u=draws.u_probe).contiguous()
    grid, w_code, b1, w2, b2 = flagship_field(gen)
    cams = (torch.eye(4, device=dev), intrinsics(dev))
    args = (rays, z, grid, w_code, b1, w2[:, :1].contiguous(), b2[:1].contiguous(), *cams)
    w_probe = probe_weights(*args, cfg)
    torch.cuda.synchronize()
    err = (w_probe - probe_weights_plain(*args, cfg)).abs().max().item()
    finite = bool(torch.isfinite(w_probe).all())
    print(f"phase 3b K3 probe_weights error: weights {err:.3e} (bound {K3_TOL})", flush=True)
    if not (finite and err <= K3_TOL):
        fail(f"K3 probe_weights disagrees with its plain version (finite={finite}, error {err})")
    ms = time_ms(lambda: probe_weights(*args, cfg), inner=10)
    plain_ms = time_ms(lambda: probe_weights_plain(*args, cfg))
    R, D, C = rays.shape[0], grid.shape[-1], w_code.shape[0]
    rows = grid_rows_read(_ray_points(rays, z), grid, *cams)
    b, by = bound_ms(2.0 * R * Kp * (C * D + D), rows * D * 2 + nbytes(*args[:2], *args[3:]) + R * Kp * 4)
    print(f"phase 3b K3 probe_weights ({R} rays x {Kp}, grid {H * 2}x{W * 2}x{D} bf16, density column): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; {rows} distinct grid rows read)",
          flush=True)
    k3 = {"name": "probe_weights", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
          "replaces": "scenedino_tpu/ops/fast_field.py:792", "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}

    # the nearest upsample, as render_novel_view_probe builds its table and index
    table = torch.cat([w_probe, z], -1).contiguous()
    idx = ((torch.arange(H, device=dev) // s)[:, None] * (W // s)
           + (torch.arange(W, device=dev) // s)[None]).reshape(-1).to(torch.int32)
    full = row_gather(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(full, row_gather_plain(table, idx)):
        fail("the row gather at the probe path's shape is not exact")
    g_ms = time_ms(lambda: row_gather(table, idx), reps=20, inner=20)
    g_plain = time_ms(lambda: row_gather_plain(table, idx), reps=20, inner=20)
    g_lib = time_ms(lambda: torch.index_select(table, 0, idx), reps=20, inner=20)
    n = idx.shape[0]
    gb, gby = bound_ms(0.0, n * table.shape[1] * 4 + nbytes(table, idx))
    print(f"phase 3b row_gather at the probe path's shape ({n} rows of a {table.shape[0]}x{table.shape[1]} fp32 "
          f"table, exact): kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, index_select {g_lib:.4f} ms, bound "
          f"{gb:.5f} ms ({gby})", flush=True)
    gather = {"name": "row_gather", "route": "cuda", "source": "scenedino_torch/csrc/row_gather.cu",
              "replaces": "tools/bench_pallas_gather.py:38", "max_abs_err": 0.0, "ms": g_ms,
              "plain_ms": g_plain, "bound_ms": gb, "bound_by": gby, "library_ms": g_lib}

    # K2 on the resampled depths: 10 from each pixel's histogram, 2 stratified
    zf = sampling.sample_coarse_from_dist(flat, full[:, :Kp], full[:, Kp:], 10, u=draws.u_fine, t=draws.t_fine)
    zf = torch.cat([zf, sampling.sample_coarse(flat, 2, u=draws.u_uniform)], -1)
    zf = torch.sort(zf, -1).values.contiguous()
    colour = torch.rand(H, W, 3, generator=gen, device=dev).to(torch.bfloat16)
    args = (flat, zf, grid, w_code, b1, w2, b2, *cams, colour, *cams)
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    errs = [(o - p).abs().max().item() for o, p in zip(out, point_render_plain(*args, cfg))]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    Kf = zf.shape[1]
    print(f"phase 3b K2 on the probe's {Kf} resampled depths, errors: depth {errs[0]:.3e} m, feature "
          f"{errs[1]:.3e}, rgb {errs[2]:.3e}", flush=True)
    if not (finite and errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL):
        fail(f"K2 point_render at {Kf} samples disagrees with its plain version (finite={finite}, errors {errs})")
    k2_ms = time_ms(lambda: point_render(*args, cfg))
    k2_plain = time_ms(lambda: point_render_plain(*args, cfg))
    E, Rf = w2.shape[-1], flat.shape[0]
    rows = grid_rows_read(_ray_points(flat, zf), grid, *cams)
    kb, kby = bound_ms(2.0 * Rf * Kf * (C * D + D * E),
                       rows * D * 2 + nbytes(*args[:2], *args[3:]) + Rf * (1 + (E - 1) + 3) * 4)
    print(f"phase 3b K2 point_render ({Rf} rays x {Kf}): kernel {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, bound "
          f"{kb:.4f} ms ({kby}; {rows} distinct grid rows read)", flush=True)
    return [k3, gather]


def ssc_points(device):
    """The 2,097,152 SSCBench voxel centres in bench.py's (z, x, y) order."""
    from scenedino_torch.eval.sscbench import generate_point_grid

    pts, _ = generate_point_grid()
    pts = pts.reshape(256, 256, 32, 3).transpose(2, 0, 1, 3).reshape(-1, 3)
    return torch.from_numpy(np.ascontiguousarray(pts)).to(device)


def phase_k4(gen):
    from scenedino_torch.kernels.point_render import PointRenderConfig, point_query, point_query_plain
    from scenedino_torch.utils.timing import time_ms

    dev = "cuda"
    cfg = PointRenderConfig()
    pts = ssc_points(dev)
    grid, w_code, b1, w2, b2 = flagship_field(gen)
    args = (pts, grid, w_code, b1, w2, b2, torch.eye(4, device=dev), intrinsics(dev))
    sigma, feat = point_query(*args, cfg)
    torch.cuda.synchronize()
    # the plain version chunk by chunk, so memory stays bounded; errors on
    # the points in the depth range [z_near, z_far], and on every point
    # scaled by the size of its outputs: nearer than z_near the normalized
    # inverse depth reaches ~6e3 (a bf16 ulp of 32 in the code) and h
    # reaches ~1e3 (a bf16 ulp of 4), so an fp32 difference before either
    # rounding (the tensor cores' summation order against the plain fp32
    # product's) can round it the other way and move an output by ~1
    in_range = (pts[:, 2] >= cfg.z_near) & (pts[:, 2] <= cfg.z_far)
    err_abs, err_range, err_scaled, chunk = 0.0, 0.0, 0.0, 1 << 18
    for p0 in range(0, pts.shape[0], chunk):
        ref_s, ref_f = point_query_plain(pts[p0:p0 + chunk], *args[1:], cfg)
        d = torch.maximum((sigma[p0:p0 + chunk] - ref_s).abs(), (feat[p0:p0 + chunk] - ref_f).abs().amax(-1))
        scale = torch.clamp_min(torch.maximum(ref_s, ref_f.abs().amax(-1)), 1.0)
        err_abs = max(err_abs, d.max().item())
        err_range = max(err_range, d[in_range[p0:p0 + chunk]].max().item())
        err_scaled = max(err_scaled, (d / scale).max().item())
    finite = bool(torch.isfinite(sigma).all() and torch.isfinite(feat).all())
    print(f"phase 3c K4 point_query errors (sigma and feature): {int(in_range.sum())} points in [{cfg.z_near}, "
          f"{cfg.z_far}] m max abs {err_range:.3e} (bound {K4_TOL}); all points max abs {err_abs:.3e}, over each "
          f"point's largest output (at least 1) {err_scaled:.3e} (bound {K4_TOL})", flush=True)
    if not (finite and err_range <= K4_TOL and err_scaled <= K4_TOL):
        fail(f"K4 point_query disagrees with its plain version (finite={finite})")
    ms = time_ms(lambda: point_query(*args, cfg))
    plain_ms = time_ms(lambda: point_query_plain(*args, cfg), reps=5)
    P, D, E, C = pts.shape[0], grid.shape[-1], w2.shape[-1], w_code.shape[0]
    out_bytes = P * 4 + P * (E - 1) * 4
    rows = grid_rows_read(pts, grid, *args[6:8])
    in_bytes = rows * D * 2 + nbytes(args[0], *args[2:])
    b, by = bound_ms(2.0 * P * (C * D + D * E), in_bytes + out_bytes)
    print(f"phase 3c K4 point_query ({P} points, grid {H * 2}x{W * 2}x{D} bf16, d_out {E}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}: inputs {in_bytes / 1e6:.1f} MB read once, of them "
          f"{rows} distinct grid rows; sigma and feature {out_bytes / 1e6:.1f} MB written once)", flush=True)
    return {"name": "point_query", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:990", "max_abs_err": err_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def phase_gather(seed):
    """The row gather at P1's and P2's shapes, through their tools."""
    from scenedino_torch.kernels.row_gather import row_gather, row_gather_plain
    from scenedino_torch.tools import bench_gather, probe_gather
    from scenedino_torch.utils.timing import time_ms

    if not probe_gather.run("cuda"):
        fail("the row gather at P1's shape is not exact")
    rows, C, n = probe_gather.ROWS, probe_gather.C, probe_gather.BLK
    t1 = torch.arange(rows * C, dtype=torch.float32, device="cuda").reshape(rows, C)
    i1 = torch.from_numpy(np.random.RandomState(0).randint(0, rows, n).astype(np.int32)).cuda()
    p1 = {name: time_ms(fn, reps=20, inner=20) for name, fn in (
        ("kernel", lambda: row_gather(t1, i1)), ("plain", lambda: row_gather_plain(t1, i1)),
        ("index_select", lambda: torch.index_select(t1, 0, i1)))}
    b1, by1 = bound_ms(0.0, n * C * 4 + nbytes(t1, i1))
    print(f"phase 3d row_gather at P1's shape ({n} rows of a {rows}x{C} fp32 table, exact): kernel "
          f"{p1['kernel']:.4f} ms, plain {p1['plain']:.4f} ms, index_select {p1['index_select']:.4f} ms, bound "
          f"{b1:.5f} ms ({by1})", flush=True)
    m = bench_gather.measure(seed)
    if not m["equal"]:
        fail("the row gather at P2's shape differs from torch.index_select")
    table, idx = bench_gather.inputs(seed)
    plain_ms = time_ms(lambda: row_gather_plain(table, idx), reps=20, inner=5)
    P, C = idx.shape[0], table.shape[1]
    b, by = bound_ms(0.0, P * C * 2 + nbytes(table, idx))
    print(f"phase 3d row_gather at P2's shape ({P} rows of a {table.shape[0]}x{C} bf16 table, exact): kernel "
          f"{m['kernel_ms']:.4f} ms ({P / m['kernel_ms'] / 1e3:.1f} Mrows/s), plain {plain_ms:.4f} ms, "
          f"index_select {m['index_select_ms']:.4f} ms, bound {b:.4f} ms ({by})", flush=True)


def cameras_of(device):
    return intrinsics(device)[None, None], torch.eye(4, device=device)[None, None]


@torch.inference_mode()
def serve(model, img, u, device):
    """One novel-view request: encode -> fold -> render the novel camera (no graph)."""
    from scenedino_torch.ops.fast_field import build_fast_state, render_novel_view_fused

    h, w = img.shape[-2:]
    Ks, poses = cameras_of(device)
    state = model.encode(img, Ks, poses, ids_encoder=(0,))
    fs = build_fast_state(model, state, compute_dtype=torch.bfloat16)
    return render_novel_view_fused(fs, model.cfg, novel_pose(device), intrinsics(device), h, w,
                                   u=u, n_coarse=K)


@torch.inference_mode()
def serve_probe(model, img, draws, device):
    """One probe request: encode_prefolded -> render_novel_view_probe at its defaults."""
    from scenedino_torch.ops.fast_field import encode_prefolded, render_novel_view_probe

    h, w = img.shape[-2:]
    fs = encode_prefolded(model, img, *cameras_of(device))
    return render_novel_view_probe(fs, model.cfg, novel_pose(device), intrinsics(device), h, w, draws=draws)


@torch.inference_mode()
def serve_query(model, img, pts, device):
    """One SSC voxel query: encode_prefolded -> fast_query_fused."""
    from scenedino_torch.ops.fast_field import encode_prefolded, fast_query_fused

    return fast_query_fused(encode_prefolded(model, img, *cameras_of(device)), model.cfg, pts)


@torch.inference_mode()
def serve_encode_view(model, img, u, device):
    """One encode-view render: encode_prefolded -> render_encode_view."""
    from scenedino_torch.ops.fast_field import encode_prefolded, render_encode_view

    h, w = img.shape[-2:]
    return render_encode_view(encode_prefolded(model, img, *cameras_of(device)), model.cfg, h, w, u=u,
                              n_coarse=K)


def profile_device(fn):
    """Device time of one call of `fn` by kernel (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    cpu_ops = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    by_name = {}
    for e in events:
        # device-side ranges named after a CPU operator repeat the time of its kernels
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in cpu_ops:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    times = sorted(((n, t) for n, t in by_name.items() if t > 0), key=lambda t: -t[1])
    busy = sum(t for _, t in times)
    if busy == 0:
        return "profiler saw no device time"
    top = "; ".join(f"{name[:70]} {t:.3f} ms" for name, t in times[:10])
    return (f"device busy {busy:.3f} ms of {wall:.3f} ms wall (profiled), idle share "
            f"{max(0.0, 1 - busy / wall):.3f}; top: {top}")


def check_depth(name, depth, dino, rgb):
    """Shapes, finiteness and the [3, 80] m depth range of one full-frame answer."""
    if depth.shape != (H, W) or dino.shape != (H, W, 64) or rgb.shape != (H, W, 3):
        fail(f"{name} output shapes {depth.shape}, {dino.shape}, {rgb.shape}")
    if not all(bool(torch.isfinite(t).all()) for t in (depth, dino, rgb)):
        fail(f"{name} output is not finite")
    # depth is a convex combination of sample depths in [3, 80]; 1e-3 m of fp32 slack
    if not (depth.min().item() >= 3.0 - 1e-3 and depth.max().item() <= 80.0 + 1e-3):
        fail(f"{name} depth outside [3, 80]: [{depth.min().item()}, {depth.max().item()}]")


def run_path(name, requests, answer, check, expect):
    """Drive one serving path: the launch counters zeroed just before, read
    just after; each request's launches must meet `expect` (name -> the
    least count, or the exact count where `exact`). Returns the counts and
    the host ms of each request (synchronized)."""
    from scenedino_torch import kernels

    kernels.reset_launches()
    times = []
    for req in requests:
        before = kernels.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = answer(*req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(*out)
        per = {k: n - before[k] for k, n in kernels.launches().items()}
        bad = {k: per[k] for k, (least, exact) in expect.items() if (per[k] != least if exact else per[k] < least)}
        if bad or any(per[k] for k in per if k not in expect):
            fail(f"the {name} path did not run through its kernels: launches {per}, expected {expect}")
    return kernels.launches(), times


def stages_of(steps):
    """Synchronized host ms of each named step of one request, run in order."""
    ms, carry = {}, None
    with torch.inference_mode():
        for name, step in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = step(carry)
            torch.cuda.synchronize()
            ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
    return ms


def phase_slice(seed):
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model
    from scenedino_torch.utils.timing import time_ms
    from scenedino_torch.ops.fast_field import (
        build_fast_state,
        draw_probe,
        encode_prefolded,
        fast_query_fused,
        render_encode_view,
        render_novel_view_fused,
        render_novel_view_probe,
    )

    conf = {**SCENEDINO_KITTI_360}
    conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
    model = make_model(conf, device="cuda", seed=seed)
    blocks = model.encoder.vit_encoder.vit.cfg.depth
    imgs, gens = [], []
    for i in range(3):
        g = torch.Generator(device="cuda").manual_seed(seed + 100 + i)
        imgs.append(torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1)
        gens.append(g)
    Ks, poses = cameras_of("cuda")
    pts = ssc_points("cuda")
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        return json.dumps(counts)

    # the exact novel-view path
    reqs = [(img, torch.rand(H * W, K, generator=g, device="cuda"), "cuda") for img, g in zip(imgs, gens)]
    counts, times = run_path("novel-view", reqs, lambda *r: serve(model, *r), lambda *o: check_depth("novel-view", *o),
                             {"attention": (blocks, True), "point_render": (1, True)})
    img, u, _ = reqs[0]
    stages = stages_of([
        ("encode_ms", lambda _: model.encode(img, Ks, poses)),
        ("fold_ms", lambda st: build_fast_state(model, st)),
        ("render_ms", lambda fs: render_novel_view_fused(fs, model.cfg, novel_pose("cuda"), intrinsics("cuda"), H, W,
                                                         u=u, n_coarse=K)),
    ])
    print(f"phase 4 slice: 3 novel-view requests at {H}x{W}, ms per request {[round(t, 3) for t in times]}; "
          f"stages of one request {json.dumps(stages)}; launches {add(counts)}", flush=True)
    print(f"phase 4 profile (novel view): {profile_device(lambda: serve(model, *reqs[1]))}", flush=True)

    # the probe-guided path at its defaults (16-sample probe at stride 4, 10 + 2 samples)
    reqs = [(img, draw_probe(H, W, g, "cuda"), "cuda") for img, g in zip(imgs, gens)]
    counts, times = run_path("probe", reqs, lambda *r: serve_probe(model, *r), lambda *o: check_depth("probe", *o),
                             {"attention": (blocks, True), "probe_weights": (1, True), "row_gather": (1, False),
                              "point_render": (1, True)})
    img, draws, _ = reqs[0]
    stages = stages_of([
        ("encode_prefolded_ms", lambda _: encode_prefolded(model, img, Ks, poses)),
        ("render_ms", lambda fs: render_novel_view_probe(fs, model.cfg, novel_pose("cuda"), intrinsics("cuda"), H, W,
                                                         draws=draws)),
    ])
    with torch.inference_mode():  # the fold inside the DPT's last conv against the fold after it
        prefolded_ms = time_ms(lambda: encode_prefolded(model, img, Ks, poses), reps=5)
        two_step_ms = time_ms(lambda: build_fast_state(model, model.encode(img, Ks, poses)), reps=5)
    print(f"phase 4 probe: 3 requests at {H}x{W}, ms per request {[round(t, 3) for t in times]}; stages of one "
          f"request {json.dumps(stages)}; launches {add(counts)}; encode_prefolded {prefolded_ms:.3f} ms against "
          f"encode + build_fast_state {two_step_ms:.3f} ms (CUDA events, median of 5)", flush=True)
    print(f"phase 4 profile (probe): {profile_device(lambda: serve_probe(model, *reqs[1]))}", flush=True)

    # the SSC voxel query over the full grid
    def check_query(sigma, feat):
        if sigma.shape != (pts.shape[0],) or feat.shape != (pts.shape[0], 64):
            fail(f"SSC query output shapes {sigma.shape}, {feat.shape}")
        if not (torch.isfinite(sigma).all() and torch.isfinite(feat).all() and sigma.min() >= 0):
            fail("SSC query output is not finite, or sigma < 0")

    reqs = [(img, pts, "cuda") for img in imgs]
    counts, times = run_path("SSC query", reqs, lambda *r: serve_query(model, *r), check_query,
                             {"attention": (blocks, True), "point_query": (1, True)})
    stages = stages_of([
        ("encode_prefolded_ms", lambda _: encode_prefolded(model, imgs[0], Ks, poses)),
        ("query_ms", lambda fs: fast_query_fused(fs, model.cfg, pts)),
    ])
    print(f"phase 4 SSC query: 3 queries of {pts.shape[0]} voxel centres, ms per query "
          f"{[round(t, 3) for t in times]}; stages of one query {json.dumps(stages)}; launches {add(counts)}",
          flush=True)
    print(f"phase 4 profile (SSC query): {profile_device(lambda: serve_query(model, *reqs[1]))}", flush=True)

    # the encode-view render (no feature lookup, no kernel of its own)
    reqs = [(img, torch.rand(H * W, K, generator=g, device="cuda"), "cuda") for img, g in zip(imgs, gens)]
    counts, times = run_path("encode-view", reqs, lambda *r: serve_encode_view(model, *r),
                             lambda *o: check_depth("encode-view", *o), {"attention": (blocks, True)})
    img, u, _ = reqs[0]
    stages = stages_of([
        ("encode_prefolded_ms", lambda _: encode_prefolded(model, img, Ks, poses)),
        ("render_ms", lambda fs: render_encode_view(fs, model.cfg, H, W, u=u, n_coarse=K)),
    ])
    print(f"phase 4 encode view: 3 renders at {H}x{W}, ms per render {[round(t, 3) for t in times]}; stages of one "
          f"render {json.dumps(stages)}; launches {add(counts)}", flush=True)

    # small inputs: the same model on the GPU (kernels) and on the CPU (plain versions)
    cpu_model = copy.deepcopy(model).to("cpu")
    g = torch.Generator().manual_seed(seed + 7)
    h, w = 32, 96
    img = torch.rand(1, 1, 3, h, w, generator=g) * 2 - 1
    u = torch.rand(h * w, K, generator=g)
    gpu = [t.float().cpu() for t in serve(model, img.cuda(), u.cuda(), "cuda")]
    cpu = [t.float() for t in serve(cpu_model, img, u, "cpu")]
    rel = ((gpu[0] - cpu[0]).abs() / cpu[0]).max().item()
    cos = torch.nn.functional.cosine_similarity(gpu[1].reshape(-1, 64), cpu[1].reshape(-1, 64), dim=-1).median().item()
    print(f"phase 4 small-input check ({h}x{w}, GPU kernels vs CPU plain, bf16): depth max rel err "
          f"{rel:.3e} (bound {SLICE_DEPTH_REL}), feature median cosine {cos:.6f} (bound {SLICE_COS})",
          flush=True)
    if not (rel <= SLICE_DEPTH_REL and cos >= SLICE_COS):
        fail("the GPU slice disagrees with the CPU reference on the small input")

    draws = draw_probe(h, w, g)
    gpu = [t.float().cpu() for t in serve_probe(model, img.cuda(), type(draws)(*(t.cuda() for t in draws)), "cuda")]
    cpu = [t.float() for t in serve_probe(cpu_model, img, draws, "cpu")]
    rel = ((gpu[0] - cpu[0]).abs() / cpu[0]).flatten()
    p99 = torch.quantile(rel, 0.99).item()
    cos = torch.nn.functional.cosine_similarity(gpu[1].reshape(-1, 64), cpu[1].reshape(-1, 64), dim=-1).median().item()
    print(f"phase 4 small-input probe check ({h}x{w}): depth rel err median {rel.median().item():.3e}, p99 "
          f"{p99:.3e} (bound {PROBE_DEPTH_REL_P99}), max {rel.max().item():.3e}; feature median cosine {cos:.6f} "
          f"(bound {SLICE_COS})", flush=True)
    if not (p99 <= PROBE_DEPTH_REL_P99 and cos >= SLICE_COS):
        fail("the GPU probe path disagrees with the CPU reference on the small input")

    small_pts = pts[::64].contiguous()
    gpu = [t.float().cpu() for t in serve_query(model, img.cuda(), small_pts, "cuda")]
    cpu = [t.float() for t in serve_query(cpu_model, img, small_pts.cpu(), "cpu")]
    sig_rel = ((gpu[0] - cpu[0]).abs().max() / cpu[0].abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(gpu[1], cpu[1], dim=-1).median().item()
    print(f"phase 4 small-input query check ({h}x{w} encode, {small_pts.shape[0]} voxel centres): sigma max abs err "
          f"over max sigma {sig_rel:.3e} (bound {QUERY_SIGMA_REL}), feature median cosine {cos:.6f} "
          f"(bound {SLICE_COS})", flush=True)
    if not (sig_rel <= QUERY_SIGMA_REL and cos >= SLICE_COS):
        fail("the GPU query disagrees with the CPU reference on the small input")
    return total


def train_batch(gen, B, h, w, device):
    """Seeded images in [-1, 1] for V = 4 views: a stereo pair (0.6 m
    baseline) and the same pair 1 m further along the road; every view
    looks down +z with the intrinsics of `intrinsics`."""
    imgs = torch.rand(B, 4, 3, h, w, generator=gen, device=device) * 2 - 1
    poses = torch.eye(4, device=device).repeat(B, 4, 1, 1)
    poses[:, :, 0, 3] = torch.tensor([0.0, 0.6, 0.0, 0.6], device=device)
    poses[:, :, 2, 3] = torch.tensor([0.0, 0.0, 1.0, 1.0], device=device)
    return {"imgs": imgs, "poses": poses, "projs": intrinsics(device).expand(B, 4, 3, 3).contiguous()}


class StageTimer:
    """The `mark` callback of a train step: synchronized ms since the last mark."""

    def __init__(self):
        self.ms = {}
        self.last = 0.0

    def start(self):
        torch.cuda.synchronize()
        self.last = time.perf_counter()

    def __call__(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[name] = (now - self.last) * 1e3
        self.last = now


def phase_train(seed):
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, make_model
    from scenedino_torch.training import trainer

    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(SCENEDINO_KITTI_360_TRAIN)
    Bt, V = SCENEDINO_KITTI_360_TRAIN["batch_size"], 4
    torch.cuda.reset_peak_memory_stats()
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    enc = model.encoder
    gp, blocks, t_blocks = enc.gt_patch_size, enc.vit_encoder.vit.cfg.depth, enc.gt_encoder.vit.cfg.depth
    g = torch.Generator(device="cuda").manual_seed(seed + 200)
    state = trainer.init_train_state(model, tcfg, artifact_shape=(enc.gt_encoder.latent_size, H // gp, W // gp),
                                     generator=g)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    batch = train_batch(g, Bt, H, W, "cuda")
    trainable = [p for group in state.optimizer.param_groups for p in group["params"]]
    expect = {**{name: 0 for name in kernels.WRAPPERS},
              "attention": blocks + t_blocks, "attention_bwd_dq": blocks, "attention_bwd_dkv": blocks}

    kernels.reset_launches()
    times, timer = [], StageTimer()
    for i in range(TRAIN_STEPS):
        draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, V, H, W, gp)
        before = [p.detach().clone() for p in trainable] + [state.artifact_field.detach().clone()]
        counts = kernels.launches()
        last = i == TRAIN_STEPS - 1
        timer.start()
        t0 = timer.last
        losses = step(state, batch, draws, mark=timer if last else None)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: n - counts[k] for k, n in kernels.launches().items()}
        loss = losses["rec_loss"].item()
        unchanged = sum(torch.equal(a, p) for a, p in zip(before, trainable + [state.artifact_field]))
        if not np.isfinite(loss):
            fail(f"training step {i + 1}: loss {loss}")
        if losses["nonfinite_consecutive"] != 0 or state.applied != i + 1:
            fail(f"training step {i + 1} was skipped as non-finite: {losses}")
        if unchanged > 0:
            fail(f"training step {i + 1} left {unchanged} of {len(before)} parameter tensors unchanged")
        if per_step != expect:
            fail(f"training step {i + 1} launched {per_step}, expected {expect}")
        print(f"phase 5 train step {i + 1}: loss {loss:.6f} "
              f"({json.dumps({k: round(float(v), 6) for k, v in losses.items() if k.startswith(('loss', 'edge', 'dino'))})}); "
              f"{times[-1]:.3f} ms; launches {json.dumps(per_step)}", flush=True)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 5 train: {TRAIN_STEPS} steps at batch {Bt}, {V} views, {H}x{W}, {tcfg.ray_batch_size} rays x "
          f"{rcfg.n_coarse} samples; first step {times[0]:.3f} ms (cuDNN's algorithm search and the kernels' "
          f"load), then {[round(t, 3) for t in times[1:]]} ms (the last synchronized at each stage); stages of the "
          f"last step {json.dumps({k: round(v, 3) for k, v in timer.ms.items()})}; peak memory allocated "
          f"{peak:.3f} GiB; launches {json.dumps(launches)}", flush=True)
    draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, V, H, W, gp)
    print(f"phase 5 profile: {profile_device(lambda: step(state, batch, draws))}", flush=True)

    # small input: one step of the same model on the GPU (kernels) and on the
    # CPU (plain versions), same images, draws and artifact field
    h, w, Bs = 32, 96, 2
    gc = torch.Generator().manual_seed(seed + 300)
    small = train_batch(gc, Bs, h, w, "cpu")
    draws = trainer.draw_stage1(gc, tcfg, rcfg, Bs, V, h, w, gp)
    art = 1e-3 * torch.randn(enc.gt_encoder.latent_size, h // gp, w // gp, generator=gc)
    model.zero_grad(set_to_none=True)
    del state, step, before

    def one_step(m, device):
        m.zero_grad(set_to_none=True)
        a = art.to(device).requires_grad_(True)
        d = dataclasses.replace(draws, **{f: getattr(draws, f).to(device) for f in ("pv", "py", "px", "u")})
        loss, _ = trainer.stage1_forward(m, {k: v.to(device) for k, v in small.items()}, d, tcfg, rcfg, lcfg, a)
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in m.named_parameters() if p.grad is not None}
        grads["artifact_field"] = a.grad.float().cpu()
        return loss.item(), grads

    gpu_loss, gpu_grads = one_step(model, "cuda")
    cpu_loss, cpu_grads = one_step(copy.deepcopy(model).to("cpu"), "cpu")
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    if sorted(gpu_grads) != sorted(cpu_grads):
        fail("the GPU and CPU steps gave gradients to different parameters")
    errs = {n: (torch.linalg.vector_norm(gpu_grads[n] - r) / torch.linalg.vector_norm(r)).item()
            for n, r in cpu_grads.items() if torch.linalg.vector_norm(r) > 0}
    worst = max(errs, key=errs.get)
    print(f"phase 5 small-step check ({h}x{w}, batch {Bs}, GPU kernels vs CPU plain, bf16): loss {gpu_loss:.6f} vs "
          f"{cpu_loss:.6f}, rel err {loss_rel:.3e} (bound {TRAIN_LOSS_REL}); gradients of {len(errs)} tensors, "
          f"relative L2 error median {float(np.median(list(errs.values()))):.3e}, worst {errs[worst]:.3e} "
          f"({worst}; bound {TRAIN_GRAD_REL})", flush=True)
    if not (loss_rel <= TRAIN_LOSS_REL and errs[worst] <= TRAIN_GRAD_REL):
        fail("the GPU training step disagrees with the CPU reference on the small input")
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    try:
        from scenedino_torch import kernels
        from scenedino_torch.kernels import build
        from scenedino_torch.utils.timing import card_line
    except ImportError as e:
        fail(f"scenedino_torch is not importable ({e}): run from a checkout of the repository")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {kind}; {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    secs = build.build(build.all_names())
    ptxas = {}
    for name in secs:
        ptxas[name] = [line.split("ptxas info    : ")[-1] for line in build.build_log(name).splitlines()
                       if "Used" in line]
    print(f"phase 1 build: {time.monotonic() - t0:.1f} s wall, per kernel {json.dumps(secs)}; "
          f"ptxas {json.dumps(ptxas)}", flush=True)
    # the backward kernels hold four accumulators a thread: a spill would put them in local memory
    bwd = {("dq" if "bwd_dq" in entry else "dkv"): r
           for entry, r in build.ptxas_report(build.build_log("attention_bwd")).items()}
    print(f"phase 1 K1 backward kernels, registers at launch (a consumer warpgroup then takes the producer's, "
          f"see csrc/attention_bwd.cu) and spills in bytes: {json.dumps(bwd)}", flush=True)
    if sorted(bwd) != ["dkv", "dq"] or any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in bwd.values()):
        fail(f"ptxas spilled in a K1 backward kernel, or its report is missing: {bwd}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = [phase_k1(gen), *phase_k1_bwd(gen), phase_k2(gen), *phase_probe(gen), phase_k4(gen)]
    phase_gather(args.seed)
    serving = phase_slice(args.seed)
    training = phase_train(args.seed)
    for e in entries:
        e["launches"] = serving[e["name"]] + training[e["name"]]
    if sorted(e["name"] for e in entries) != sorted(kernels.WRAPPERS):
        fail("the kernels line does not list every kernel")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
