#!/usr/bin/env python3
"""Drive the PyTorch port (`scenedino_torch`) on one NVIDIA GPU and hold
its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  0 device   the card's name and power limit; TF32 off for fp32 compares
  1 build    nvcc builds every kernel of the path from csrc/ (sm_90a)
  2 K1       attention kernel vs its plain version at ViT-B/8 @192x640
             (1, 1921, 12, 64) bf16; kernel, plain and
             F.scaled_dot_product_attention times (the last only as a
             yardstick: the port never calls it)
  2b K1-bwd  the backward kernels (dq; dk and dv) vs the plain fp32
             backward at the training shape (4, 1921, 12, 64) bf16;
             kernel, plain and scaled_dot_product_attention-backward times
  3 K2       point-render kernel vs its plain version at full width:
             192x640 rays x 32 samples, 384x1280x128 bf16 grid, d_out 65
  4 slice    the flagship field (ViT-B/8 + DPT 256, bf16, seeded random
             weights) answers 3 novel-view requests (encode ->
             build_fast_state -> render_novel_view_fused, 32 samples);
             launch counters show both kernels ran; then one small request
             is checked against the same model run on the CPU
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
  6 kernels  one JSON line: launches (serving and training runs
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
import subprocess
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
# the backward kernels against the plain fp32 backward, per output: this
# fraction of the largest |plain| value plus 1e-3 (P and dS are rounded to
# bf16 for the tensor-core products and the results to bf16)
K1_BWD_REL = 2e-2
# the small-input check: the same bf16 model on the GPU (kernels) and on the
# CPU (plain versions), summed in other orders through 12 blocks and the DPT
SLICE_DEPTH_REL = 1e-2
SLICE_COS = 0.99
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


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi failed ({out.returncode})"


def time_ms(fn, reps=10, inner=1, warmup=2):
    """Median over `reps` of the CUDA-event time of `inner` back-to-back calls, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


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

    B, N, Hh, D = 4, 1921, 12, 64
    q, k, v, do = (torch.randn(B, N, Hh, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    dq, di = attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
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
          f"{ms_dq:.4f} ms, dkv {ms_dkv:.4f} ms, together {ms_dq + ms_dkv:.4f} ms; plain backward "
          f"{plain_ms:.4f} ms; sdpa backward {lib_ms:.4f} ms; bound dq {b_dq:.4f} ms ({by_dq}), dkv "
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


def phase_k2(gen):
    from scenedino_torch.core import rays as rays_mod
    from scenedino_torch.core.sampling import sample_coarse
    from scenedino_torch.kernels.point_render import PointRenderConfig, point_render, point_render_plain

    dev = "cuda"
    Hg, Wg, D, E, C = 2 * H, 2 * W, 128, 65, 39
    cfg = PointRenderConfig()
    r, _ = rays_mod.rays_from_k(novel_pose(dev)[None], intrinsics(dev)[None], W, H, cfg.z_near, cfg.z_far)
    flat = r.reshape(-1, 8).contiguous()
    z = sample_coarse(flat, K, generator=gen).contiguous()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    b2 = randn(E, scale=0.1)
    b2[0] += 0.5
    args = (
        flat, z,
        randn(Hg, Wg, D).to(torch.bfloat16),
        randn(C, D, scale=C ** -0.5).to(torch.bfloat16),
        randn(D, scale=0.1),
        randn(D, E, scale=D ** -0.5).to(torch.bfloat16),
        b2,
        torch.eye(4, device=dev), intrinsics(dev),
        torch.rand(H, W, 3, generator=gen, device=dev).to(torch.bfloat16),
        torch.eye(4, device=dev), intrinsics(dev),
    )
    out = point_render(*args, cfg)
    torch.cuda.synchronize()
    ref = point_render_plain(*args, cfg)
    errs = [(o - p).abs().max().item() for o, p in zip(out, ref)]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    print(f"phase 3 K2 errors: depth {errs[0]:.3e} m, feature {errs[1]:.3e}, rgb {errs[2]:.3e}", flush=True)
    if not (finite and errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL):
        fail(f"K2 point_render disagrees with its plain version (finite={finite}, errors {errs}; "
             f"bounds {K2_DEPTH_TOL}, {K2_FEAT_TOL}, {K2_RGB_TOL})")
    ms = time_ms(lambda: point_render(*args, cfg))
    plain_ms = time_ms(lambda: point_render_plain(*args, cfg))
    R = flat.shape[0]
    flops = 2.0 * R * K * (C * D + D * E)
    nbytes = sum(t.numel() * t.element_size() for t in args) + R * (1 + (E - 1) + 3) * 4
    b, by = bound_ms(flops, nbytes)
    print(f"phase 3 K2 point_render ({R} rays x {K}, grid {Hg}x{Wg}x{D} bf16): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by})", flush=True)
    return {"name": "point_render", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:825", "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


@torch.inference_mode()
def serve(model, img, u, device):
    """One request: encode -> fold -> render the novel camera (no graph)."""
    from scenedino_torch.ops.fast_field import build_fast_state, render_novel_view_fused

    h, w = img.shape[-2:]
    Ks = intrinsics(device)[None, None]
    poses = torch.eye(4, device=device)[None, None]
    state = model.encode(img, Ks, poses, ids_encoder=(0,))
    fs = build_fast_state(model, state, compute_dtype=torch.bfloat16)
    return render_novel_view_fused(fs, model.cfg, novel_pose(device), intrinsics(device), h, w,
                                   u=u, n_coarse=K)


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


def phase_slice(seed):
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model

    conf = {**SCENEDINO_KITTI_360}
    conf["encoder"] = {**conf["encoder"], "dtype": "bfloat16"}
    model = make_model(conf, device="cuda", seed=seed)
    depth_blocks = model.encoder.vit_encoder.vit.cfg.depth
    requests = []
    for i in range(3):
        g = torch.Generator(device="cuda").manual_seed(seed + 100 + i)
        img = torch.rand(1, 1, 3, H, W, generator=g, device="cuda") * 2 - 1
        requests.append((img, torch.rand(H * W, K, generator=g, device="cuda")))

    kernels.reset_launches()
    times = []
    for img, u in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depth, dino, rgb = serve(model, img, u, "cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if depth.shape != (H, W) or dino.shape != (H, W, 64) or rgb.shape != (H, W, 3):
            fail(f"slice output shapes {depth.shape}, {dino.shape}, {rgb.shape}")
        if not all(bool(torch.isfinite(t).all()) for t in (depth, dino, rgb)):
            fail("slice output is not finite")
        # depth is a convex combination of sample depths in [3, 80]; 1e-3 m of fp32 slack
        if not (depth.min().item() >= 3.0 - 1e-3 and depth.max().item() <= 80.0 + 1e-3):
            fail(f"slice depth outside [3, 80]: [{depth.min().item()}, {depth.max().item()}]")
    launches = kernels.launches()
    if launches["attention"] != depth_blocks * len(requests) or launches["point_render"] < len(requests):
        fail(f"the slice did not run through the kernels: launches {launches}")

    # where one request's time goes (synchronized stages)
    from scenedino_torch.ops.fast_field import build_fast_state, render_novel_view_fused

    img, u = requests[0]
    stages = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model.encode(img, intrinsics("cuda")[None, None], torch.eye(4, device="cuda")[None, None])
        torch.cuda.synchronize()
        stages["encode_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fs = build_fast_state(model, state)
        torch.cuda.synchronize()
        stages["fold_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        render_novel_view_fused(fs, model.cfg, novel_pose("cuda"), intrinsics("cuda"), H, W, u=u, n_coarse=K)
        torch.cuda.synchronize()
        stages["render_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"phase 4 slice: 3 requests at {H}x{W}, ms per request {[round(t, 3) for t in times]}; "
          f"stages of one request {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
          f"launches {json.dumps(launches)}", flush=True)

    print(f"phase 4 profile: {profile_device(lambda: serve(model, *requests[1], 'cuda'))}", flush=True)

    # small input: the same model on the GPU (kernels) and on the CPU (plain versions)
    g = torch.Generator().manual_seed(seed + 7)
    h, w = 32, 96
    img = torch.rand(1, 1, 3, h, w, generator=g) * 2 - 1
    u = torch.rand(h * w, K, generator=g)
    gpu = [t.float().cpu() for t in serve(model, img.cuda(), u.cuda(), "cuda")]
    cpu = [t.float() for t in serve(copy.deepcopy(model).to("cpu"), img, u, "cpu")]
    rel = ((gpu[0] - cpu[0]).abs() / cpu[0]).max().item()
    a, b = gpu[1].reshape(-1, 64), cpu[1].reshape(-1, 64)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).median().item()
    print(f"phase 4 small-input check ({h}x{w}, GPU kernels vs CPU plain, bf16): depth max rel err "
          f"{rel:.3e} (bound {SLICE_DEPTH_REL}), feature median cosine {cos:.6f} (bound {SLICE_COS})",
          flush=True)
    if not (rel <= SLICE_DEPTH_REL and cos >= SLICE_COS):
        fail("the GPU slice disagrees with the CPU reference on the small input")
    return launches


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
    expect = {"attention": blocks + t_blocks, "attention_bwd_dq": blocks, "attention_bwd_dkv": blocks,
              "point_render": 0}

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
        from scenedino_torch.kernels import build
    except ImportError as e:
        fail(f"scenedino_torch is not importable ({e}): run from a checkout of the repository")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {kind}; {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    secs = build.build(["attention", "attention_bwd", "point_render"])
    ptxas = {}
    for name in secs:
        log = (build.BUILD_DIR / f"{name}.log").read_text() if (build.BUILD_DIR / f"{name}.log").exists() else ""
        ptxas[name] = [line.split("ptxas info    : ")[-1] for line in log.splitlines() if "Used" in line]
    print(f"phase 1 build: {time.monotonic() - t0:.1f} s wall, per kernel {json.dumps(secs)}; "
          f"ptxas {json.dumps(ptxas)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = [phase_k1(gen), *phase_k1_bwd(gen), phase_k2(gen)]
    serving = phase_slice(args.seed)
    training = phase_train(args.seed)
    for e in entries:
        e["launches"] = serving[e["name"]] + training[e["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
