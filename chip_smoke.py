#!/usr/bin/env python3
"""Drive the PyTorch port (`scenedino_torch`) on one NVIDIA GPU and hold
its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Phases, one line each:
  0 device   the card's name and power limit; TF32 off for fp32 compares
  1 build    nvcc builds every kernel of the paths from csrc/ (sm_90a);
             the registers and spills (none allowed) of the K1 forward and
             backward kernels, of the point kernels' ten instantiations and
             of K6's eight
  2 K1       the attention forward kernel vs its plain versions (output
             and log-sum-exp) at the three shapes its paths give it:
             ViT-B/8 @192x640 serving (1, 1921, 12, 64), the training
             step's student (4, ...) with the log-sum-exp and teacher
             (8, ...), bf16; two launches bitwise equal; kernel, plain and
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
             times, and at P1's its C function called alone (the host's
             floor of a launch)
  3e K6      the encode-view kernel vs its plain version at 192x640 rays
             x 32 samples from a 384x1280x128 folded grid (W_z 13x128, W2
             128x65) through the render's own preamble: the bf16 serving
             state of one frame, then stage 2's fp32 state of 4 frames in
             one launch; then phase 7b's: 4 fp32 frames of 96x192 rays x 32
             samples from a 192x384x64 grid (W2 64x17); then the bf16
             serving state of one 192x640 frame at 48 samples (16 dead rows
             a ray in the kernel's 64-row tiles), and of one 96x192 frame at
             48 samples (W2 64x17: the encode view of a field of
             configs/train_synthetic_convergence.yaml); expectation depth,
             then the weight-median depth; two launches bitwise equal;
             kernel, plain and bound times (no library call computes this
             function); then the serving render stage split into its torch
             preamble and K6
  Bounds: the larger of the bytes moved (each input read once, each
  output written once; of a folded grid only the distinct rows that the
  points' corner lookups read) over 3.35 TB/s and the FLOP over the bf16
  tensor-core peak (K6's fp32 state: three TF32 passes at 495 TFLOP/s, the
  least time for products of fp32 accuracy; beside it the 67 TFLOP/s of
  fp32 outside the tensor cores). Phases 3-3c also print the corner rows the kernels
  read (points x 4 x D x 2 B) and their time at 3.35 TB/s.
  4 slice    the flagship field (ViT-B/8 + DPT 256, bf16, seeded random
             weights) answers 3 novel-view requests (encode ->
             build_fast_state -> render_novel_view_fused, 32 samples),
             3 probe requests (encode_prefolded -> render_novel_view_probe
             at its defaults), 3 SSC voxel queries (encode_prefolded ->
             fast_query_fused over the 2,097,152 voxel centres) and 3
             encode-view renders (encode_prefolded -> render_encode_view,
             K6);
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
  5b fp32    one step of the synthetic smoke recipe (configs/
             train_synthetic_smoke.yaml: fp32, ViT-S/8 cut to width 64,
             depth 3, 2 heads, 48x96, batch 2): its attention takes the
             ViT's plain branch, so the step launches no kernel; it must be
             finite, applied and move every parameter tensor
  6 train run the port's stage-1 run (scenedino_torch.cli.train.run_stage1)
             on configs/train_synthetic_flagship.yaml, read by the port's
             own YAML reader, at full width with the cuts printed on its
             first line: 6 steps (each step's loss and host ms), validation
             renders at 3 and 6 (depth, dino and nvs metrics), checkpoints
             (write ms), peak memory, the K1 launch counts against what the
             steps (remat recomputes the student's blocks) and validations
             need; the checkpoint loaded into a fresh model equals the run's
             state; the run resumed from it to step 9; the validation render
             at 32x64 on the GPU against the CPU; 3 steps and a validation of
             configs/train_synthetic_convergence.yaml (fp32, the fine pass)
  7 stage 2  the port's stage-2 run (cli.train.run_stage2) at full width:
             train_synthetic_flagship.yaml's model (ViT-B/8, DPT 256,
             d_hidden 128, bf16, 192x640) with train_semantic_kitti_360.yaml's
             downstream, loss, optimizer and validation blocks, the synthetic
             dataset at batch 4, resume_from phase 6's run directory; cuts
             printed on its first line. Each step's losses and host ms, the
             seeding's ms, each validation's metrics and ms, peak memory;
             every step finite and applied, the head moved, the field
             bitwise unchanged, the K1 and K6 launch counts the steps, the
             seeding and the validations imply, each validation's pseudo
             assignment written into both cluster heads, the checkpoint
             loaded back equal, a resume to step 9; then downstream_forward
             at 32x64 on the GPU against the CPU with the same draws, on the
             front view (linear probes) and the side view (STEGO terms); a
             loss 0 on both sides in both fails
  7b         3 steps and a validation of
             configs/train_semantic_synthetic_convergence.yaml (fp32, tiny
             ViT, d_hidden 64) from tests/goldens/s1b_field_params.npz
  8 eval     evaluation from phase 7's run directory. 8a: a seeded
             SSCBench-KITTI-360 tree of 3 frames of sequence 09 (376x1408
             PNGs written by the port, the release's P_rect_00 and camera
             -> velodyne, poses, voxel GT of SSCBench ids and 255) through
             cli.evaluate_sscbench.main (encode_prefolded, K4 over 4 blocks
             of 524,288 voxel centres a frame, the head, the
             alpha-weighted argmax, the host accumulation); the table
             finite in [0, 1], each range's occupancy numbers covering its
             valid in-view voxels, 12 K1 and 4 K4 launches a frame; one
             frame with --test-alpha-cutoffs; ties of the alpha-weighted
             argmax take the first class; K4 on each block of one frame
             against point_query_plain (phase 3c's error over each point's
             largest output; the trained field's outputs exceed 1) and the
             labels of both (99.9 % of in-view voxels); K4's times at the
             block; the
             fast path against --slow (printed, not gated). 8b: a seeded
             Cityscapes tree of 3 frames at 1024x2048 through
             cli.evaluate.main with configs/evaluate_semantic_cityscapes.yaml
             and phase 7's model and downstream blocks (encode, the fp32
             fold, K6, the 768-d expansion, four modes); every value finite
             in [0, 1], 12 K1 and 1 K6 launches a frame; once with apply_crf
             on one frame; K6 on one frame against its plain version (fp32
             bounds) and the four modes' labels of both (99.9 %)
  9 reference the reference's checkpoints: for the published
             ssc-kitti-360-dino (configs/train_semantic_kitti_360.yaml's
             model: ViT-B/8) and -dinov2 (configs/
             train_scenedino_kitti_360_dinov2.yaml: ViT-B/14, LayerScale,
             a 37x37 position embedding) architectures, a seeded full-width
             field and head of 19 clusters written as the reference's
             trainer writes checkpoint.pt ({"model": BTSWrapper names}, with
             the artifact field); load_eval_state loads each strictly, bit
             for bit; cli.evaluate_sscbench.main on phase 8a's tree with
             --ckpt <x>.pt --config <yaml> (bf16 through with_amp; 12 K1
             and 4 K4 a frame for v1, 0 K1 for v2's 481 tokens) prints the
             same table and accumulates the same numbers as on the same
             weights saved as a port run; K1 (v1) and K4 (both) against
             their plain versions on the inputs those runs give them; the v2
             encoder on the GPU against the CPU (the 14/16 pre-resize at
             192x640, the fp32 ViT at 64x128); one novel-view request on
             the v2 field (K2) and K2 on its inputs; cli.evaluate.main with
             evaluate_semantic_cityscapes.yaml's variant: dinov2 on phase
             8b's tree (one K6 a frame) and K6 on its first frame; the
             encode times (per frame, and the encoder alone by CUDA events)
             and sec_per_frame of both, beside the card's name and limit
  10 kitti   the KITTI-360 data path. 10a: a seeded tree in the release's
             layout (56 posed frames of one sequence, 376x1408 perspective
             and 1400x1400 fisheye pairs as Paeth-filtered PNGs, the
             release's calibration with the fisheye YAMLs in its
             FileStorage layout, velodyne scans, KITTI-360 labels, the
             repository's SSCBench training lines that the tree holds and 3
             test items), cli.preprocess_kitti_360 resize, an item through
             the cache against the same item resampled on the fly (one 8-bit
             step), the loader's host ms per item (raw, cached) and per batch
             of 4; 10b: cli.train.main on train_scenedino_kitti_360.yaml at
             full width (3 steps, one validation of 2 test items on the
             velodyne depths, a checkpoint; each step's host ms and loader
             wait); 10c: cli.train.main --stage semantic on
             train_semantic_kitti_360.yaml from 10b's run (3 steps, one
             validation on the labels as train ids; the head moved, the field
             bitwise unchanged); 10d: cli.evaluate.main on
             evaluate_semantic_kitti_360.yaml with 10c's model over the 3
             test items (12 K1 and 1 K6 a frame), K6 on the first frame
             against its plain version; 10e, on the host: KITTI_360_v2 items
             (overlap sampling) and SSCBench items with the fisheye views;
             then K1's forward at the shapes 10b-10d gave it that phase 2
             does not time (the stage-1 teacher's 16 frames, stage 2's 4
             frames without the log-sum-exp), as phase 2 times its own
  11 d80 and upsample-gt. 11a: K1 at head dim 80 (csrc/attention_d80.cu,
             the forward; csrc/attention_d80_bwd.cu, dq and dkv):
             the forward without and with the log-sum-exp, dq and dkv
             against their plain versions (phase 2's bounds) at (1, 585,
             16, 80) and (4, 585, 16, 80), I-JEPA-H/14's forward at 192x640
             and four of it, and (4, 1921, 12, 80) and (2, 1921, 12, 80),
             the teacher and the student of 11's D = 80 training step; two launches bitwise equal; kernel,
             plain, SDPA (forward and backward, the backward also as its
             kernels' device time) and bound times, dq + dkv's TFLOP/s
             over their 7 products and share of the SDPA backward. 11b: the
             I-JEPA-H/14 backbone (32 blocks, width 1280, 16 heads of 80, no
             class token) from seeded weights in the reference's layout
             through utils.convert.convert_ssl_vit into make_vit
             ("i_jepa_huge") in bf16: the 192x640 forward, 32 launches of
             the D = 80 forward; its first 2 blocks at 196x518 on the GPU
             against the CPU; then 2 steps of the flagship stage-1 step
             (trainer.make_train_step, bf16, 192x640, batch 2) with
             vit_overrides width 960, 12 heads: heads of 80 through the
             training entry point, each step 24 forward, 12 dq and 12 dkv
             launches at D = 80. 11c: cli.train.main on
             configs/train_scenedino_kitti_360_upsampler.yaml (upsample-gt,
             the multiscale-crop teacher: 4 views of each of the 16 loss
             images a step, a per-pixel target) at full width on phase 10's
             tree and cache: 3 steps and a validation of 2 items; each
             step's host ms and loader wait, peak memory, the launches, the
             losses finite, no step skipped, every student parameter moved,
             the validation finite; the teacher's K1 shape (64, 1921, 12,
             64) timed as phase 2 times its own
  kernels    one JSON line: launches (all serving paths, training, the
             train run, stage 2, evaluation, phases 9, 10 and 11 together), error, times and
             bound per kernel; the K1 forward's, K4's and K6's also at
             their shapes ("shapes": K4 at the evaluation's block, K6 at
             the 2D evaluator's fp32 frame; phase 9's holds of K1, K2, K4
             and K6 under "reference checkpoints")
The line before the last is the card's name and power limit as
nvidia-smi prints them; the last line is {"ok": true, "device": {...}}.
Any failed phase exits non-zero before that line. Needs one CUDA card;
exits non-zero without one, and outside a checkout of the repository.
"""
import argparse
import contextlib
import copy
import dataclasses
import json
import logging
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

H, W, K = 192, 640, 32
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# phase 2's K1 forward shapes: (batch, with the log-sum-exp) at 1921 tokens, 12 heads of 64
K1_PHASE2_SHAPES = ((1, False), (4, True), (8, False))
# bounds of the kernel-vs-plain comparisons
K1_TOL = 2e-2  # bf16 output (ulp 2^-8 at |x| ~ 1) plus P rounded to bf16 for P @ V
K1_LSE_TOL = 1e-3  # fp32 statistics of the same bf16 logits, another order, approximate exp2
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
# phase 6: the flagship run's cuts (dataset items, steps, the resume's last step)
TRAIN_RUN_ITEMS = 8
TRAIN_RUN_STEPS = 6
TRAIN_RUN_RESUME_TO = 9
# phase 7: the stage-2 run's cuts (dataset items, steps, the resume's last step,
# validation items)
STAGE2_ITEMS = 8
STAGE2_STEPS = 6
STAGE2_RESUME_TO = 9
STAGE2_VAL_ITEMS = 4
# downstream_forward at 32x64, GPU against CPU, the flagship's bf16 field with
# the same draws, once on the front view (the only one with segmentation: the
# linear probes' losses) and once on the side view (the draws' own coin and
# view: the crops there are valid, so the STEGO terms are not 0). The render as
# phase 6's (depth p99, feature cosine); the cluster and probe losses are means
# over the 2 x 2048 pixels' bf16-rounded features, held relative; the STEGO
# terms are means over 10 crops of terms near 0 (a few 1e-2), held absolute.
# The errors measured on the card (NVIDIA H100 80GB HBM3, 700.00 W): head
# losses 1.2e-4 relative, STEGO terms 2.0e-5 to 1.7e-4. A loss that is exactly
# 0 on both sides compares nothing, and fails the check
STAGE2_HEAD_LOSS_REL = 2e-3
STAGE2_STEGO_ABS = 1e-3
# the validation render at 32x64, GPU against CPU, bf16: its depths and colours
# are the same kind of sums as phase 4's, over 4 views; the 99th percentile
# allows a few rays whose weights move with bf16 rounding near a surface
EVAL_DEPTH_REL_P99 = 1e-2
EVAL_RGB_ABS = 2e-2
# instantiations of csrc/point_render.cu's kernel: K2 and K4 at 2 hidden x 2
# output widths each, K3 at 2 hidden widths
POINT_KERNELS = 10
# phase 11a: K1 at head dim 80 (csrc/attention_d80.cu, attention_d80_bwd.cu) at
# I-JEPA-H/14's 192x640 forward (13 x 45 = 585 tokens, 16 heads), four of them, and phase
# 11's D = 80 training step (1921 tokens, 12 heads of 80): its teacher on the
# 4 loss images and, last, its student, each with its backward
D80_SHAPES = ((1, 585, 16), (4, 585, 16), (4, 1921, 12), (2, 1921, 12))
# phase 11: the D = 80 training step's cuts (its ViTs: ViT-B/8 with 12 heads
# of 80; batch, steps) and the upsampler recipe's (steps, validation items)
D80_TRAIN_WIDTH, D80_TRAIN_B, D80_TRAIN_STEPS = 960, 2, 2
UPSAMPLER_STEPS, UPSAMPLER_VAL_ITEMS = 3, 2
# phase 11b: the I-JEPA-H/14 ViT's first blocks at 196x518 (14 x 37 = 518
# tokens, so the card takes K1) on the GPU against the CPU, both bf16
IJEPA_CHECK_DEPTH, IJEPA_CHECK_SIZE = 2, (196, 518)


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


def k1_forward_shape(gen, B, with_lse, path, phase="phase 2"):
    """K1's forward at (B, 1921, 12, 64) bf16: output and (where the path
    asks for it) log-sum-exp against the plain versions, two launches
    bitwise equal, kernel, plain, SDPA and bound times; the shape's entry."""
    from scenedino_torch.kernels.attention import attention_fwd, attention_lse_plain, attention_plain
    from scenedino_torch.utils.timing import time_ms

    N, Hh, D = 1921, 12, 64
    q, k, v = (torch.randn(B, N, Hh, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    out, lse = attention_fwd(q, k, v, with_lse=with_lse)
    again = attention_fwd(q, k, v, with_lse=with_lse)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and (lse is None or torch.equal(lse, again[1]))):
        fail(f"K1 forward ({B}, {N}, {Hh}, {D}): two launches on the same inputs differ")
    err = (out.float() - attention_plain(q, k, v).float()).abs().max().item()
    lse_err = (lse - attention_lse_plain(q, k)).abs().max().item() if with_lse else None
    if not (torch.isfinite(out).all() and err <= K1_TOL and (lse_err is None or lse_err <= K1_LSE_TOL)):
        fail(f"K1 forward ({B}, {N}, {Hh}, {D}) disagrees with its plain version: max abs err {err} (bound "
             f"{K1_TOL}), lse {lse_err} (bound {K1_LSE_TOL})")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_ms(lambda: attention_fwd(q, k, v, with_lse=with_lse), inner=10)
    plain_ms = time_ms(lambda: attention_plain(q, k, v), reps=5)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=10)
    flops = 4.0 * B * Hh * N * N * D
    b, by = bound_ms(flops, (4 * B * N * Hh * D * 2) + (B * Hh * N * 4 if with_lse else 0))
    lse_text = f", lse {lse_err:.3e} (bound {K1_LSE_TOL})" if with_lse else ""
    print(f"{phase} K1 forward ({B}, {N}, {Hh}, {D}) bf16, {path}{' with the lse' if with_lse else ''}: "
          f"max_abs_err {err:.3e} (bound {K1_TOL}){lse_text}; two launches bitwise equal; kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s; the kernel takes {ms / lib_ms:.2f} of it), bound {b:.4f} ms "
          f"({by})", flush=True)
    return {"shape": [B, N, Hh, D], "lse": with_lse, "max_abs_err": err, "lse_err": lse_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms}


def phase_k1(gen):
    """The forward at the three shapes its paths give it (`k1_forward_shape`)."""
    shapes = [k1_forward_shape(gen, B, with_lse, path)
              for (B, with_lse), path in zip(K1_PHASE2_SHAPES, ("serving", "student", "teacher"))]
    serving = shapes[0]
    return {"name": "attention", "route": "cuda", "source": "scenedino_torch/csrc/attention.cu",
            "replaces": "scenedino_tpu/models/vit.py:126",
            "max_abs_err": max(e["max_abs_err"] for e in shapes),
            **{key: serving[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shapes": shapes}


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


def corner_traffic(points, D):
    """The corner rows the kernel reads, (points x 4 x D x 2 B), and their
    time at 3.35 TB/s: a yardstick beside the bound, which counts each
    distinct grid row once."""
    n = points * 4 * D * 2
    return f"corner rows {n / 1e9:.3f} GB, {n / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s"


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
          f"grid rows read); {corner_traffic(R * K, D)}", flush=True)
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
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; {rows} distinct grid rows read); "
          f"{corner_traffic(R * Kp, D)}", flush=True)
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
          f"{kb:.4f} ms ({kby}; {rows} distinct grid rows read); {corner_traffic(Rf * Kf, D)}", flush=True)
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
          f"{rows} distinct grid rows; sigma and feature {out_bytes / 1e6:.1f} MB written once); "
          f"{corner_traffic(P, D)}", flush=True)
    return {"name": "point_query", "route": "cuda", "source": "scenedino_torch/csrc/point_render.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:990", "max_abs_err": err_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def phase_gather(seed):
    """The row gather at P1's and P2's shapes, through their tools."""
    from scenedino_torch.kernels import build
    from scenedino_torch.kernels.row_gather import ARGTYPES, row_gather, row_gather_plain
    from scenedino_torch.tools import bench_gather, probe_gather
    from scenedino_torch.utils.timing import time_ms

    if not probe_gather.run("cuda"):
        fail("the row gather at P1's shape is not exact")
    rows, C, n = probe_gather.ROWS, probe_gather.C, probe_gather.BLK
    t1 = torch.arange(rows * C, dtype=torch.float32, device="cuda").reshape(rows, C)
    i1 = torch.from_numpy(np.random.RandomState(0).randint(0, rows, n).astype(np.int32)).cuda()
    # the C function alone through ctypes, pointers and stream taken before: the launch's own floor
    fn = build.function("row_gather", "row_gather", ARGTYPES)
    o1, stream = torch.empty(n, C, device="cuda"), torch.cuda.current_stream().cuda_stream
    ptrs = (t1.data_ptr(), i1.data_ptr(), o1.data_ptr(), n, rows, C * 4, stream)
    p1 = {name: time_ms(f, reps=20, inner=20) for name, f in (
        ("kernel", lambda: row_gather(t1, i1)), ("c_call", lambda: fn(*ptrs)),
        ("empty", lambda: torch.empty((n, C), dtype=t1.dtype, device=t1.device)),
        ("plain", lambda: row_gather_plain(t1, i1)), ("index_select", lambda: torch.index_select(t1, 0, i1)))}
    if not torch.equal(o1, row_gather_plain(t1, i1)):
        fail("the row gather's C function at P1's shape is not exact")
    b1, by1 = bound_ms(0.0, n * C * 4 + nbytes(t1, i1))
    print(f"phase 3d row_gather at P1's shape ({n} rows of a {rows}x{C} fp32 table, exact): kernel "
          f"{p1['kernel']:.4f} ms per call (the wrapper: checks, torch.empty, ctypes, launch; 20 back to back), "
          f"its C function alone through ctypes {p1['c_call']:.4f} ms, the output's torch.empty alone "
          f"{p1['empty']:.4f} ms, plain {p1['plain']:.4f} ms, index_select "
          f"{p1['index_select']:.4f} ms, bound {b1:.5f} ms ({by1})", flush=True)
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


def phase_k6(gen):
    """K6 against its plain version at the shapes its paths give it (the
    render's own preamble from a seeded state): the bf16 serving state of
    one flagship frame, the fp32 stage-2 state of 4 flagship frames in one
    launch (phase 7), the fp32 state of 4 frames of the stage-2 convergence
    recipe (phase 7b: d_hidden 64, d_out 17), and the bf16 serving state of
    one frame at 48 samples (the dead rows of a 64-row tile) at flagship
    width and at the stage-1 convergence recipe's (96x192, d_hidden 64,
    d_out 17)."""
    from scenedino_torch.tools.bench_encode_view import SHAPES, check, render_stage

    shapes = {}
    for shape in SHAPES:
        r = check(gen, shape)
        path = r["path"]
        print(f"phase 3e K6 encode_view ({path}: {r['frames']} x {r['height']}x{r['width']} rays x {r['samples']} "
              f"samples from a {2 * r['height']}x{2 * r['width']}x{r['d_hidden']} grid, {r['dtype']} state, d_out "
              f"{r['d_out']}): errors {json.dumps(r['errors'])} (bounds {json.dumps(r['tolerance'])}); finite "
              f"{r['finite']}; two launches bitwise equal {r['bitwise']}; median depth on a sample depth "
              f"{r['median_on_sample']}, rays whose sample differs from the plain version's {r['median_flips']:.3e} "
              f"(bound 1e-3), by at most {r['median_off']} (bound 1); kernel {r['ms']:.4f} ms (median depth "
              f"{r['median_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}{'; three TF32 passes' if r['fp32_cores_bound_ms'] else ''})"
              + (f", fp32 outside the tensor cores {r['fp32_cores_bound_ms']:.4f} ms" if r["fp32_cores_bound_ms"]
                 else ""), flush=True)
        if not r["ok"]:
            fail(f"K6 encode_view disagrees with its plain version ({path}): {r}")
        shapes[path] = {k: r[k] for k in ("frames", "dtype", "height", "width", "d_hidden", "d_out", "samples",
                                          "ms", "plain_ms", "bound_ms", "bound_by")}
        shapes[path]["max_abs_err"] = max(r["errors"].values())
    split = render_stage(gen, SHAPES[0])
    print(f"phase 3e K6 the serving render stage split (render_encode_view_batched, one 192x640 frame): torch "
          f"preamble {split['preamble_ms']:.4f} ms, K6 {split['kernel_ms']:.4f} ms, the whole render "
          f"{split['render_ms']:.4f} ms; the preamble's {split['preamble_profile']}", flush=True)
    main = shapes["stage 2"]
    return {"name": "encode_view", "route": "cuda", "source": "scenedino_torch/csrc/encode_view.cu",
            "replaces": "scenedino_tpu/ops/fast_field.py:254",
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shapes": shapes}


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
    from scenedino_torch.utils.timing import profile_device, time_ms
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

    # the encode-view render (no feature lookup; K6 per sample)
    reqs = [(img, torch.rand(H * W, K, generator=g, device="cuda"), "cuda") for img, g in zip(imgs, gens)]
    counts, times = run_path("encode-view", reqs, lambda *r: serve_encode_view(model, *r),
                             lambda *o: check_depth("encode-view", *o),
                             {"attention": (blocks, True), "encode_view": (1, True)})
    img, u, _ = reqs[0]
    stages = stages_of([
        ("encode_prefolded_ms", lambda _: encode_prefolded(model, img, Ks, poses)),
        ("render_ms", lambda fs: render_encode_view(fs, model.cfg, H, W, u=u, n_coarse=K)),
    ])
    print(f"phase 4 encode view: 3 renders at {H}x{W}, ms per render {[round(t, 3) for t in times]}; stages of one "
          f"render {json.dumps(stages)}; launches {add(counts)}", flush=True)
    print(f"phase 4 profile (encode view): {profile_device(lambda: serve_encode_view(model, *reqs[1]))}", flush=True)

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
    from scenedino_torch.utils.timing import profile_device

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


def phase_train_fp32(seed):
    """One stage-1 step of the synthetic smoke recipe (configs/
    train_synthetic_smoke.yaml, `SYNTHETIC_SMOKE_TRAIN`): fp32, a ViT-S/8 cut
    to width 64, depth 3, 2 heads (head dim 32, 73 tokens at 48x96), so the
    ViT takes its plain attention branch and no kernel runs; the step must
    be finite, applied and move every parameter tensor."""
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SYNTHETIC_SMOKE_TRAIN as conf, make_model
    from scenedino_torch.training import trainer

    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    (h, w), V, Bt = conf["dataset"]["image_size"], conf["dataset"]["n_views"], conf["batch_size"]
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    enc = model.encoder
    vit = enc.vit_encoder.vit
    gp = enc.gt_patch_size
    g = torch.Generator(device="cuda").manual_seed(seed + 400)
    state = trainer.init_train_state(model, tcfg, artifact_shape=(enc.gt_encoder.latent_size, h // gp, w // gp),
                                     generator=g)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    batch = train_batch(g, Bt, h, w, "cuda")
    draws = trainer.draw_stage1(g, tcfg, rcfg, Bt, V, h, w, gp)
    trainable = [p for group in state.optimizer.param_groups for p in group["params"]]
    before = [p.detach().clone() for p in trainable]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step(state, batch, draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    loss = losses["rec_loss"].item()
    unchanged = sum(torch.equal(a, p) for a, p in zip(before, trainable))
    tokens = 1 + (h // vit.cfg.patch_size) * (w // vit.cfg.patch_size)
    print(f"phase 5b fp32 train step (configs/train_synthetic_smoke.yaml: batch {Bt}, {V} views, {h}x{w}, ViT width "
          f"{vit.cfg.width}, depth {vit.cfg.depth}, {vit.cfg.num_heads} heads, head dim "
          f"{vit.cfg.width // vit.cfg.num_heads}, {tokens} tokens, compute dtype {vit.cfg.dtype or 'fp32'}; its "
          f"training blocks as the config gives them): loss {loss:.6f}, {ms:.3f} ms (first step), applied "
          f"{state.applied}, {len(trainable) - unchanged} of {len(trainable)} parameter tensors moved; launches "
          f"{json.dumps(counts)}", flush=True)
    if not np.isfinite(loss) or losses["nonfinite_consecutive"] != 0 or state.applied != 1:
        fail(f"the fp32 smoke training step was not finite and applied: {losses}")
    if unchanged:
        fail(f"the fp32 smoke training step left {unchanged} of {len(trainable)} parameter tensors unchanged")
    if any(counts.values()):
        fail(f"the fp32 smoke training step launched kernels {counts}: its attention must take the plain branch")
    return counts


class LogRecords(logging.Handler):
    """Keeps the training loop's log records that carry numbers
    (`training.loop` attaches them as record attributes)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def with_attr(self, name):
        return [r for r in self.records if hasattr(r, name)]


def _state_equal(a, b) -> bool:
    """Two train-state dicts (tensors, numbers, strings, nested) equal, tensors bitwise."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(_state_equal, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.cpu(), b.cpu())
    return a == b


def _finite(values) -> bool:
    return all(np.isfinite(float(v)) for v in values)


def phase_train_run(seed, scratch):
    """Phase 6: the port's stage-1 training run (`cli.train.run_stage1`) on
    configs/train_synthetic_flagship.yaml at full width, with the cuts
    printed on its first line; the resume from its checkpoint; three steps
    of configs/train_synthetic_convergence.yaml (the fine pass); the
    validation render at 32x64 on the GPU against the CPU. Returns the
    flagship run's launch counts and its run directory (phase 7's field)."""

    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.training import trainer
    from scenedino_torch.utils import config as yaml_config
    from scenedino_torch.utils.checkpoint import load_checkpoint, train_state_dict

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    conf = yaml_config.load(os.path.join(root, "configs", "train_synthetic_flagship.yaml"))
    tmp = tempfile.mkdtemp(prefix="train_", dir=scratch)
    conf["dataset"]["length"] = TRAIN_RUN_ITEMS
    conf["training"].update(stop_iteration=TRAIN_RUN_STEPS, checkpoint_every=3, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = 3
    vconf["subset"]["args"] = {"start": 0, "end": 3}
    conf["output"]["path"] = os.path.join(tmp, "flagship")
    conf["num_workers"] = 4
    enc_conf = conf["model"]["encoder"]
    print(f"phase 6 train run: configs/train_synthetic_flagship.yaml read by scenedino_torch.utils.config, every width "
          f"as the file gives it ({enc_conf['encoder_arch']} {enc_conf['version']} student and teacher, "
          f"{enc_conf['image_size']}, batch {conf['batch_size']}, "
          f"{conf['dataset']['n_views']} views, {conf['training']['ray_sampler']['args']['ray_batch_size']} rays x "
          f"{conf['renderer']['n_coarse']} samples, with_amp {conf['with_amp']}, grad_checkpointing "
          f"{enc_conf['grad_checkpointing']}); cuts: dataset.length 64 -> {TRAIN_RUN_ITEMS}, stop_iteration "
          f"{TRAIN_RUN_STEPS}, checkpoint_every 1000 -> 3, log_every 50 -> 1, validation every 500 -> 3 over "
          f"subset 0-2 (file: 0-7), output into {tmp}", flush=True)

    log = logging.getLogger("training")
    log.setLevel(logging.INFO)
    records = LogRecords()
    log.addHandler(records)
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        field, state = cli.run_stage1(conf, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = kernels.launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = records.with_attr("losses")
        vals = records.with_attr("validator")
        writes = records.with_attr("checkpoint")
        for r in steps:
            print(f"phase 6 train step {r.iteration}: loss {r.losses['rec_loss']:.6f}; host {r.step_ms:.1f} ms "
                  f"(data wait {r.data_ms:.1f} ms)", flush=True)
        for r in vals:
            print(f"phase 6 validation at {r.iteration} ({r.ms:.1f} ms): "
                  f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
        depth = field.encoder.vit_encoder.vit.cfg.depth
        n_val_batches = len(vals) * 3
        expect = {**{name: 0 for name in kernels.WRAPPERS},
                  # a step: the student's 12 blocks, again under the recompute of
                  # the backward, and the teacher's 12; a validation batch: the
                  # student (view 0) and the teacher (4 views in one call)
                  "attention": TRAIN_RUN_STEPS * 3 * depth + n_val_batches * 2 * depth,
                  "attention_bwd_dq": TRAIN_RUN_STEPS * depth, "attention_bwd_dkv": TRAIN_RUN_STEPS * depth}
        print(f"phase 6 flagship run: {len(steps)} steps in {run_s:.1f} s wall (model build, data, steps, "
              f"validations, checkpoints); checkpoint writes "
              f"{json.dumps({os.path.basename(r.checkpoint): round(r.ms, 1) for r in writes})} ms, "
              f"{os.path.getsize(os.path.join(conf['output']['path'], f'training_checkpoint_{TRAIN_RUN_STEPS}.pt'))} "
              f"bytes each; peak memory "
              f"allocated {peak:.3f} GiB (remat on; phase 5 gives the step without it); launches "
              f"{json.dumps(counts)} (expected {json.dumps(expect)})", flush=True)
        if len(steps) != TRAIN_RUN_STEPS or state.step != TRAIN_RUN_STEPS or state.applied != TRAIN_RUN_STEPS:
            fail(f"the flagship run took {len(steps)} logged steps, state step {state.step}, applied {state.applied}")
        if not _finite(v for r in steps for v in r.losses.values()) or len(vals) != 2 or not all(
                _finite(r.metrics.values()) and "dino_cos_sim" in r.metrics and "nvs_psnr" in r.metrics
                and "depth_abs_rel" in r.metrics for r in vals):
            fail("the flagship run gave a non-finite loss or metric, or a validation is missing")
        if counts != expect:
            fail(f"the flagship run launched {counts}, expected {expect}")

        out = conf["output"]["path"]
        ckpt6 = os.path.join(out, f"training_checkpoint_{TRAIN_RUN_STEPS}.pt")
        snap = train_state_dict(field, state)
        if not os.path.exists(ckpt6) or not _state_equal(snap, torch.load(ckpt6, map_location="cuda",
                                                                              weights_only=True)):
            fail(f"{ckpt6} is missing or differs from the run's final state")

        # the validation render of one item, timed (the second call)
        vbatch = next(cli.make_val_batches_fn(make_datasets(conf["dataset"])[0], [0], 1, cli.VAL_KEYS, "cuda")())
        _, tcfg, rcfg, _ = trainer.configs_from_dict(conf)
        g = torch.Generator(device="cuda").manual_seed(seed + 600)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.stage1_eval_forward(field, vbatch, tcfg, rcfg, generator=g)
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - t0) * 1e3

        # the checkpoint loads into a fresh model and train state, equal to what was saved
        field3, state3, *_ = cli.init_stage1(conf, "cuda")
        load_checkpoint(ckpt6, field3, state3)
        loaded_equal = _state_equal(train_state_dict(field3, state3), snap)
        print(f"phase 6 validation render of one item (1 x {conf['dataset']['n_views']} views at "
              f"{enc_conf['image_size']}, {rcfg.n_coarse} samples, chunks of 16384 rays): {eval_ms:.1f} ms; "
              f"{os.path.basename(ckpt6)} equals the final state and loads into a fresh model equal to it: "
              f"{loaded_equal}, step {state3.step}", flush=True)
        if not loaded_equal or state3.step != TRAIN_RUN_STEPS:
            fail("the checkpoint did not load back to the saved state")
        del field3, state3, field, state, snap

        # resume: continue from the newest checkpoint to RESUME_TO
        records.records.clear()
        conf2 = copy.deepcopy(conf)
        conf2["training"].update(stop_iteration=TRAIN_RUN_RESUME_TO)
        conf2["training"]["continue"] = True
        field, state = cli.run_stage1(conf2, device="cuda")
        resumed = records.with_attr("resumed_from")
        its = [r.iteration for r in records.with_attr("losses")]
        files = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
        periodic = [f for f in files if f.startswith("training_checkpoint_")]
        best = [f for f in files if f.startswith("dino_cos_sim_best_")]
        print(f"phase 6 resume: from {[os.path.basename(r.resumed_from) for r in resumed]} at iteration "
              f"{[r.iteration for r in resumed]}, then iterations {its}, final step {state.step}; checkpoints "
              f"left {files}", flush=True)
        if (len(resumed) != 1 or not resumed[0].resumed_from.endswith(os.path.basename(ckpt6))
                or resumed[0].iteration != TRAIN_RUN_STEPS
                or its != list(range(TRAIN_RUN_STEPS + 1, TRAIN_RUN_RESUME_TO + 1))
                or state.step != TRAIN_RUN_RESUME_TO or periodic != [f"training_checkpoint_{TRAIN_RUN_RESUME_TO}.pt"]
                or len(best) != 1 or not _finite(v for r in records.with_attr("losses") for v in r.losses.values())):
            fail("the resumed run did not continue from the checkpoint as expected")

        # the small-input check of the validation render: the flagship field's weights
        # on the GPU and on the CPU, the same draws
        h, w, V = 32, 64, conf["dataset"]["n_views"]
        gc = torch.Generator().manual_seed(seed + 700)
        small = train_batch(gc, 1, h, w, "cpu")
        u = torch.rand(V * h * w, rcfg.n_coarse, generator=gc)
        gpu = trainer.stage1_eval_forward(field, {k: v.cuda() for k, v in small.items()}, tcfg, rcfg, u=u.cuda())
        cpu_field = copy.deepcopy(field).to("cpu")
        del field, state
        cpu = trainer.stage1_eval_forward(cpu_field, small, tcfg, rcfg, u=u)
        d_rel = ((gpu["depth"].float().cpu() - cpu["depth"]).abs() / cpu["depth"]).flatten()
        rgb_err = (gpu["rgb"].float().cpu() - cpu["rgb"].float()).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(gpu["dino_pred_grid"].float().cpu().flatten(0, -2),
                                                    cpu["dino_pred_grid"].float().flatten(0, -2), dim=-1)
        p99 = torch.quantile(d_rel, 0.99).item()
        print(f"phase 6 small-input check of the validation render ({h}x{w}, {V} views, bf16; the ViT takes its "
              f"plain branch at {1 + (h // 8) * (w // 8)} tokens on both devices): depth rel err p99 {p99:.3e} "
              f"(bound {EVAL_DEPTH_REL_P99}), max {d_rel.max().item():.3e}; rgb max abs err {rgb_err:.3e} (bound "
              f"{EVAL_RGB_ABS}); pooled feature median cosine {cos.median().item():.6f} (bound {SLICE_COS})",
              flush=True)
        if not (p99 <= EVAL_DEPTH_REL_P99 and rgb_err <= EVAL_RGB_ABS and cos.median().item() >= SLICE_COS):
            fail("the GPU validation render disagrees with the CPU reference on the small input")
        del cpu_field

        # the fine pass on the card: 3 steps of the convergence recipe with one validation
        records.records.clear()
        conv = yaml_config.load(os.path.join(root, "configs", "train_synthetic_convergence.yaml"))
        conv["dataset"]["length"] = TRAIN_RUN_ITEMS
        conv["training"].update(stop_iteration=3, checkpoint_every=3, log_every=1)
        conv["validation"]["validation"]["events"][0]["args"]["every"] = 3
        conv["validation"]["validation"]["subset"]["args"] = {"start": 0, "end": 2}
        conv["output"]["path"] = os.path.join(tmp, "convergence")
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, state = cli.run_stage1(conv, device="cuda")
        conv_s = time.perf_counter() - t0
        steps = records.with_attr("losses")
        vals = records.with_attr("validator")
        print(f"phase 6 fine pass (configs/train_synthetic_convergence.yaml, fp32, {conv['renderer']['n_coarse']} + "
              f"{conv['renderer']['n_fine']} samples, {conv['dataset']['image_size']}; cuts: dataset.length 64 -> "
              f"{TRAIN_RUN_ITEMS}, stop_iteration 3, checkpoint_every 3, log_every 1, validation at 3 over subset "
              f"0-1): losses {[round(r.losses['rec_loss'], 6) for r in steps]}, host ms "
              f"{[round(r.step_ms, 1) for r in steps]}; validation "
              f"{json.dumps({k: round(float(v), 6) for r in vals for k, v in r.metrics.items()})}; {conv_s:.1f} s "
              f"wall; launches {json.dumps(kernels.launches())}", flush=True)
        if (len(steps) != 3 or state.applied != 3 or len(vals) != 1
                or not _finite(v for r in steps for v in r.losses.values()) or not _finite(vals[0].metrics.values())):
            fail("the convergence recipe's run was not 3 finite steps with one finite validation")
    finally:
        log.removeHandler(records)
    print(f"phase 6 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, out


def _semantic_config(root, stage1_dir, out):
    """Phase 7's stage-2 config, composed here: train_synthetic_flagship.yaml's
    model, precision, batch and data; train_semantic_kitti_360.yaml's
    downstream, training.loss, optimizer and validation blocks; cuts of scale
    only (no width)."""
    from scenedino_torch.utils import config as yaml_config

    flag = yaml_config.load(os.path.join(root, "configs", "train_synthetic_flagship.yaml"))
    sem = yaml_config.load(os.path.join(root, "configs", "train_semantic_kitti_360.yaml"))
    conf = {k: copy.deepcopy(flag[k]) for k in ("seed", "with_amp", "batch_size", "dataset", "model", "renderer")}
    conf["dataset"]["length"] = STAGE2_ITEMS
    conf["downstream"] = copy.deepcopy(sem["downstream"])
    conf["training"] = {**copy.deepcopy(sem["training"]), "num_epochs": 10, "stop_iteration": STAGE2_STEPS,
                        "checkpoint_every": 3, "log_every": 1}
    conf["validation"] = copy.deepcopy(sem["validation"])
    vconf = conf["validation"]["validation"]
    vconf["subset"] = {"type": "range", "args": {"start": 0, "end": STAGE2_VAL_ITEMS}}
    vconf["events"][0]["args"]["every"] = 3
    conf["resume_from"] = stage1_dir
    conf["output"] = {"path": out}
    conf["num_workers"] = 4
    return conf


def phase_stage2(seed, stage1_dir, scratch):
    """Phase 7: the port's stage-2 run (`cli.train.run_stage2`) at full width
    from phase 6's stage-1 run directory, its checks, the resume, and
    downstream_forward at 32x64 on the GPU against the CPU. Returns the
    run's launch counts."""

    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.losses.stego import stego_loss
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.renderer.nerf import RenderConfig
    from scenedino_torch.training import downstream as down
    from scenedino_torch.utils.checkpoint import load_checkpoint, train_state_dict
    from scenedino_torch.utils.timing import profile_device

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="stage2_", dir=scratch)
    conf = _semantic_config(root, stage1_dir, os.path.join(tmp, "semantic"))
    d, m, enc = conf["downstream"], conf["model"], conf["model"]["encoder"]
    print(f"phase 7 stage 2: cli.train.run_stage2 at full width, composed from train_synthetic_flagship.yaml "
          f"({enc['encoder_arch']} {enc['version']}, DPT {enc['decoder_out_dim']}, d_hidden "
          f"{m['decoder_heads'][0]['args']['d_hidden']}, with_amp {conf['with_amp']}, {enc['image_size']}, batch "
          f"{conf['batch_size']}) and train_semantic_kitti_360.yaml (downstream input_dim {d['input_dim']}, code_dim "
          f"{d['code_dim']}, {d['n_classes']} clusters over {d['gt_classes']} classes, buffer {d['buffer_size']}, "
          f"{d['patch_sample_size']} samples a crop, kNN {d['knn_neighbors']}, mode {d['mode']}, lr "
          f"{conf['training']['optimizer']['args']['lr']}; its loss and validation blocks), resume_from phase 6's "
          f"run; cuts: dataset.length 64 -> {STAGE2_ITEMS}, num_epochs 1 -> 10 (8 items are 2 steps an epoch), "
          f"stop_iteration {STAGE2_STEPS}, validation every 100 -> 3 over items 0-{STAGE2_VAL_ITEMS - 1} (file: a "
          f"random 32), checkpoint_every 5000 -> 3, log_every 250 -> 1; output into {tmp}", flush=True)

    def fresh_head():
        """The head as run_stage2 builds it before seeding: from `seed` on a CPU generator."""
        return SemanticHead(SemanticHeadConfig.from_dict(d), generator=torch.Generator().manual_seed(conf["seed"])).to(
            "cuda")

    records = LogRecords()
    loggers = [logging.getLogger(n) for n in ("training", "validation")]
    for lg in loggers:
        lg.setLevel(logging.INFO)
        lg.addHandler(records)
    try:
        init = fresh_head().state_dict()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        field, head, state = cli.run_stage2(conf, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = kernels.launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = records.with_attr("losses")
        vals = records.with_attr("validator")
        written = records.with_attr("pseudo_assignment")
        seeded = records.with_attr("seed_ms")
        print(f"phase 7 cluster seeding (k-means++ over {d['n_classes']} clusters from the first batch's render): "
              f"{seeded[0].seed_ms:.1f} ms", flush=True)
        for r in steps:
            print(f"phase 7 step {r.iteration}: {json.dumps({k: round(float(v), 6) for k, v in r.losses.items()})}; "
                  f"host {r.step_ms:.1f} ms (data wait {r.data_ms:.1f} ms)", flush=True)
        for r in vals:
            print(f"phase 7 validation at {r.iteration} ({r.ms:.1f} ms): "
                  f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
        blocks = field.encoder.vit_encoder.vit.cfg.depth
        renders = STAGE2_STEPS + 1 + len(vals) * STAGE2_VAL_ITEMS  # steps, the seeding, validation items (batch 1)
        expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": renders * blocks, "encode_view": renders}
        print(f"phase 7 run: {len(steps)} steps in {run_s:.1f} s wall (model build, resume_from, seeding, data, "
              f"steps, validations, checkpoints); peak memory allocated {peak:.3f} GiB; launches {json.dumps(counts)} "
              f"(expected {json.dumps(expect)}: each step, the seeding and each validation item encode one view "
              f"and render it through K6)", flush=True)
        if (len(steps) != STAGE2_STEPS or state.step != STAGE2_STEPS or state.applied != STAGE2_STEPS
                or state.total_notfinite != 0 or not _finite(v for r in steps for v in r.losses.values())):
            fail(f"stage 2 took {len(steps)} steps, state step {state.step}, applied {state.applied}, non-finite "
                 f"{state.total_notfinite}, or a loss was not finite")
        if len(vals) != 2 or not all("stego_cluster_weighted_miou" in r.metrics and _finite(r.metrics.values())
                                     for r in vals):
            fail("a stage-2 validation is missing or not finite")
        if counts != expect:
            fail(f"stage 2 launched {counts}, expected {expect}")
        moved = {k: not torch.equal(v, init[k]) for k, v in head.state_dict().items() if v.is_floating_point()}
        if not all(moved.values()):
            fail(f"stage 2 left head parameters unchanged: {[k for k, v in moved.items() if not v]}")
        frozen = torch.load(cli.find_latest_checkpoint(stage1_dir), map_location="cuda", weights_only=True)["field"]
        if not _state_equal(field.state_dict(), frozen):
            fail("stage 2 changed the frozen field")
        if len(written) != len(vals) or any(
                w.pseudo_assignment[key] != v.arrays[key].tolist() for w, v in zip(written, vals)
                for key in ("direct_cluster_assignment", "stego_cluster_assignment")):
            fail("a validation's pseudo assignment is not what the cluster heads hold after it")
        print(f"phase 7 checks: every step finite and applied; all {len(moved)} head tensors moved; the field "
              f"bitwise equal to {os.path.basename(cli.find_latest_checkpoint(stage1_dir))}; after each validation "
              f"both cluster heads hold its assignment "
              f"{[w.pseudo_assignment['stego_cluster_assignment'] for w in written]} (stego)", flush=True)

        # the loop writes the checkpoint, then validates: the step-6 checkpoint holds
        # the final state but the assignment of the validation at 3 (the reference's order)
        out = conf["output"]["path"]
        ckpt = os.path.join(out, f"training_checkpoint_{STAGE2_STEPS}.pt")
        saved = torch.load(ckpt, map_location="cuda", weights_only=True)
        head2 = fresh_head()
        state2 = down.init_downstream_state(head2, down.DownstreamTrainConfig())
        load_checkpoint(ckpt, head2, state2)
        reloaded = _state_equal(train_state_dict(head2, state2), saved)
        assignments = {f"{name}_head.pseudo_assignment": f"{name}_assignment"
                       for name in ("direct_cluster", "stego_cluster")}

        def without_assignments(tree):
            return {**tree, "head": {k: v for k, v in tree["head"].items() if k not in assignments}}

        final = _state_equal(without_assignments(train_state_dict(head, state)), without_assignments(saved))
        before_last = all(saved["head"][k].tolist() == written[0].pseudo_assignment[v] for k, v in assignments.items())
        print(f"phase 7 checkpoint {os.path.basename(ckpt)} ({os.path.getsize(ckpt)} bytes) loads back equal: "
              f"{reloaded}; equals the final state but for the assignments: {final}; holds the assignment of the "
              f"validation at 3: {before_last}; field snapshot field_params.pt "
              f"{os.path.getsize(os.path.join(out, cli.FIELD_SNAPSHOT))} bytes", flush=True)
        if not (reloaded and final and before_last):
            fail("the stage-2 checkpoint does not hold the run's state, or did not load back to it")
        del head2, state2, saved

        records.records.clear()
        conf2 = copy.deepcopy(conf)
        conf2["training"].update(stop_iteration=STAGE2_RESUME_TO)
        conf2["training"]["continue"] = True
        _, _, state2 = cli.run_stage2(conf2, device="cuda")
        resumed = records.with_attr("resumed_from")
        its = [r.iteration for r in records.with_attr("losses")]
        print(f"phase 7 resume: from {[os.path.basename(r.resumed_from) for r in resumed]} at "
              f"{[r.iteration for r in resumed]}, then iterations {its}, final step {state2.step}", flush=True)
        if (len(resumed) != 1 or resumed[0].iteration != STAGE2_STEPS or state2.step != STAGE2_RESUME_TO
                or its != list(range(STAGE2_STEPS + 1, STAGE2_RESUME_TO + 1))):
            fail("the stage-2 run did not resume from its checkpoint as expected")
        del state2

        # one more step of the first run's head and state, profiled: where a stage-2 step's device time goes
        B = conf["batch_size"]
        batch = next(cli.make_val_batches_fn(make_datasets(conf["dataset"])[0], range(B), B, cli.SEMANTIC_KEYS,
                                             "cuda")())
        scfg = dataclasses.replace(down.DownstreamTrainConfig(), lr=conf["training"]["optimizer"]["args"]["lr"],
                                   render_height=enc["image_size"][0], render_width=enc["image_size"][1],
                                   n_samples=head.cfg.patch_sample_size)
        srcfg = RenderConfig(n_coarse=conf["renderer"]["n_coarse"])
        step = down.make_downstream_train_step(field, head, scfg, srcfg)
        gp = torch.Generator(device="cuda").manual_seed(seed + 900)
        step(state, batch, down.draw_stage2(gp, scfg, head.cfg, srcfg, B, batch["imgs"].shape[1]))  # warm
        draws = down.draw_stage2(gp, scfg, head.cfg, srcfg, B, batch["imgs"].shape[1])
        print(f"phase 7 profile (one stage-2 step, batch {B}): {profile_device(lambda: step(state, batch, draws))}",
              flush=True)

        # downstream_forward at 32x64 on the GPU against the CPU: the same field, head, buffers and draws, on the
        # front view (the linear probes) and on the side view (the STEGO terms)
        h, w = 32, 64
        cfg = dataclasses.replace(down.DownstreamTrainConfig(), render_height=h, render_width=w,
                                  n_samples=head.cfg.patch_sample_size)
        rcfg = RenderConfig(n_coarse=K)
        gc = torch.Generator().manual_seed(seed + 800)
        small = {**train_batch(gc, 2, h, w, "cpu"),
                 "segs": torch.randint(0, head.cfg.gt_classes, (2, 1, h, w), generator=gc)}
        drawn = down.draw_stage2(gc, cfg, head.cfg, rcfg, 2, small["imgs"].shape[1])
        cpu_field, cpu_head = copy.deepcopy(field).to("cpu"), copy.deepcopy(head).to("cpu")
        p99s, coss, head_rel, stego_abs, losses, nonzero = [], [], 0.0, 0.0, {}, set()
        for view, coin in (("front", False), ("side", True)):
            draws = dataclasses.replace(drawn, side_coin=coin)
            res = {}
            for dev in ("cuda", "cpu"):
                f, hd = (field, head) if dev == "cuda" else (cpu_field, cpu_head)
                bufs = down.RingBufferState.create(hd.cfg.buffer_size, hd.cfg.patch_sample_size, hd.cfg.input_dim,
                                                   dev)
                seg, rend, _ = down.downstream_forward(f, hd, {k: v.to(dev) for k, v in small.items()}, bufs,
                                                       _to(draws, dev), cfg, rcfg)
                res[dev] = ({k: float(v.detach()) for k, v in stego_loss(seg).items()},
                            {k: v.float().cpu() for k, v in rend.items()})
            (lg, rg), (lc, rc) = res["cuda"], res["cpu"]
            d_rel = ((rg["depth"] - rc["depth"]).abs() / rc["depth"]).flatten()
            p99s.append(torch.quantile(d_rel, 0.99).item())
            coss.append(torch.nn.functional.cosine_similarity(rg["dino_features"].flatten(0, -2),
                                                              rc["dino_features"].flatten(0, -2), dim=-1)
                        .median().item())
            for k in lc:
                if k == "total_loss":
                    continue
                if k.endswith(("cluster_loss", "linear_loss")):
                    head_rel = max(head_rel, abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6))
                else:
                    stego_abs = max(stego_abs, abs(lg[k] - lc[k]))
                if lg[k] != 0.0 or lc[k] != 0.0:
                    nonzero.add(k)
            losses[view] = {"GPU": {k: round(v, 6) for k, v in lg.items()},
                            "CPU": {k: round(v, 6) for k, v in lc.items()}}
        zero = sorted({k for v in losses.values() for k in v["CPU"] if k != "total_loss"} - nonzero)
        print(f"phase 7 small-input check of downstream_forward ({h}x{w}, batch 2, the run's field and head, the same "
              f"draws, front and side view): depth rel err p99 {max(p99s):.3e} (bound {EVAL_DEPTH_REL_P99}); 768-d "
              f"feature median cosine {min(coss):.6f} (bound {SLICE_COS}); cluster and probe losses max rel err "
              f"{head_rel:.3e} (bound {STAGE2_HEAD_LOSS_REL}); STEGO terms max abs err {stego_abs:.3e} (bound "
              f"{STAGE2_STEGO_ABS}); losses 0 on both sides in both views {zero}; losses {json.dumps(losses)}",
              flush=True)
        if not (max(p99s) <= EVAL_DEPTH_REL_P99 and min(coss) >= SLICE_COS and head_rel <= STAGE2_HEAD_LOSS_REL
                and stego_abs <= STAGE2_STEGO_ABS and not zero):
            fail("the GPU stage-2 forward disagrees with the CPU on the small input, or a loss compared nothing")
    finally:
        for lg in loggers:
            lg.removeHandler(records)
    print(f"phase 7 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, conf["output"]["path"]


def _to(draws, device):
    """A Stage2Draws with every tensor on `device`."""
    from scenedino_torch.models.downstream import HeadDraws

    def mv(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x

    fields = {f.name: mv(getattr(draws, f.name)) for f in dataclasses.fields(draws)}
    fields["head"] = HeadDraws(*(mv(getattr(draws.head, f.name)) for f in dataclasses.fields(draws.head)))
    return type(draws)(**fields)


def phase_stage2_convergence(seed, scratch):
    """Phase 7b: 3 steps and a validation of
    configs/train_semantic_synthetic_convergence.yaml (fp32, tiny ViT,
    d_hidden 64) from tests/goldens/s1b_field_params.npz. Returns its
    launch counts."""

    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.utils import config as yaml_config

    root = os.path.dirname(os.path.abspath(__file__))
    conf = yaml_config.load(os.path.join(root, "configs", "train_semantic_synthetic_convergence.yaml"))
    conf["resume_from"] = os.path.join(root, "tests", "goldens", "s1b_field_params.npz")
    conf["dataset"]["length"] = STAGE2_ITEMS
    conf["training"].update(stop_iteration=3, checkpoint_every=3, log_every=1)
    conf["validation"]["validation"]["events"][0]["args"]["every"] = 3
    conf["validation"]["validation"]["subset"]["args"] = {"start": 0, "end": 2}
    conf["output"]["path"] = tempfile.mkdtemp(prefix="stage2_convergence_", dir=scratch)
    records = LogRecords()
    log = logging.getLogger("training")
    log.addHandler(records)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        field, head, state = cli.run_stage2(conf, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
    finally:
        log.removeHandler(records)
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "encode_view": 3 + 1 + 2}
    print(f"phase 7b stage-2 convergence recipe (configs/train_semantic_synthetic_convergence.yaml, fp32, "
          f"{conf['dataset']['image_size']}, d_hidden {conf['model']['decoder_heads'][0]['args']['d_hidden']}, from "
          f"s1b_field_params.npz; cuts: dataset.length 64 -> {STAGE2_ITEMS}, stop_iteration 3, checkpoint_every 3, "
          f"log_every 1, validation at 3 over items 0-1): total losses "
          f"{[round(float(r.losses['total_loss']), 6) for r in steps]}, host ms {[round(r.step_ms, 1) for r in steps]}; "
          f"validation {json.dumps({k: round(float(v), 6) for r in vals for k, v in r.metrics.items()})}; "
          f"{wall:.1f} s wall; launches {json.dumps(counts)} (expected {json.dumps(expect)}: the ViT's plain branch, "
          f"K6 for the 3 steps, the seeding and 2 validation items)", flush=True)
    if (len(steps) != 3 or state.applied != 3 or len(vals) != 1 or counts != expect
            or not _finite(v for r in steps for v in r.losses.values()) or not _finite(vals[0].metrics.values())):
        fail("the stage-2 convergence recipe's run was not 3 finite applied steps and one finite validation "
             "through K6")
    return counts


# phase 8: the evaluations' cuts (frames of each synthetic tree), the label
# agreement of a kernel's path with its plain version's on the same frame
EVAL_FRAMES = 3
EVAL_LABELS_AGREE = 0.999
SSC_BLOCK = 128 * 128 * 32
SSC_SEQ = "2013_05_28_drive_0009_sync"


def _write_kv(path, rows):
    with open(path, "w") as f:
        for key, value in rows:
            f.write(key + ": " + " ".join(repr(float(x)) for x in np.ravel(value)) + "\n")


def write_sscbench_tree(root, rng):
    """A seeded SSCBench-KITTI-360 tree of EVAL_FRAMES frames of sequence 09
    in the release's layout: 376x1408 front images (the port's PNG writer),
    calib_cam_to_pose.txt, calib_cam_to_velo.txt (the release's camera ->
    velodyne), perspective.txt (the release's P_rect_00 and size), poses.txt,
    and (256, 256, 32) uint8 voxel GT drawn from the SSCBench label ids and
    255 (a ground layer, blocks above it, invalid patches)."""
    from scenedino_torch.datasets.image_io import write_png
    from scenedino_torch.eval.sscbench import CAM2VELO, CAM_K

    calib = os.path.join(root, "calibration")
    img_dir = os.path.join(root, "data_2d_raw", SSC_SEQ, "image_00", "data_rect")
    for d in (calib, img_dir, os.path.join(root, "data_poses", SSC_SEQ), os.path.join(root, "voxel_gt", SSC_SEQ)):
        os.makedirs(d, exist_ok=True)
    _write_kv(os.path.join(calib, "calib_cam_to_pose.txt"),
              [(f"image_0{i}", np.hstack([np.eye(3), [[0.8 * i], [0.3], [-0.1]]])) for i in range(4)])
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write(" ".join(repr(float(x)) for x in CAM2VELO[:3].ravel()) + "\n")
    _write_kv(os.path.join(calib, "perspective.txt"),
              [("P_rect_00", np.hstack([CAM_K, np.zeros((3, 1))])), ("R_rect_00", np.eye(3)),
               ("R_rect_01", np.eye(3)), ("S_rect_00", [1408, 376])])
    poses = []
    for i in range(EVAL_FRAMES):
        write_png(os.path.join(img_dir, f"{i:010d}.png"), rng.integers(0, 256, (376, 1408, 3), dtype=np.uint8))
        poses.append([i] + list(np.hstack([np.eye(3), [[0.0], [0.0], [1.5 * i]]]).ravel()))
        gt = np.zeros((256, 256, 32), np.uint8)
        gt[:, :, :3] = rng.choice(np.array([7, 8, 9, 10], np.uint8), size=(256, 256, 3))
        for _ in range(40):
            x, y, z = rng.integers(0, 240), rng.integers(0, 240), rng.integers(3, 20)
            gt[x:x + 16, y:y + 16, z:z + 8] = rng.choice(np.array([1, 2, 11, 13, 14, 15, 16, 18], np.uint8))
        gt[rng.random((256, 256, 32)) < 0.05] = 255
        np.save(os.path.join(root, "voxel_gt", SSC_SEQ, f"{i:06d}_1_1.npy"), gt)
    np.savetxt(os.path.join(root, "data_poses", SSC_SEQ, "poses.txt"), np.asarray(poses))


def write_cityscapes_tree(root, rng):
    """A seeded Cityscapes tree of EVAL_FRAMES frames at the release's 1024x2048:
    leftImg8bit/val/<city>/*_leftImg8bit.png and gtFine/val/<city>/*_gtFine_labelIds.png."""
    from scenedino_torch.datasets.image_io import write_png

    for i in range(EVAL_FRAMES):
        city = ("frankfurt", "lindau", "munster")[i]
        for d in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, d, "val", city), exist_ok=True)
        base = f"{city}_000000_{i:06d}"
        write_png(os.path.join(root, "leftImg8bit", "val", city, f"{base}_leftImg8bit.png"),
                  rng.integers(0, 256, (1024, 2048, 3), dtype=np.uint8))
        write_png(os.path.join(root, "gtFine", "val", city, f"{base}_gtFine_labelIds.png"),
                  rng.integers(0, 34, (1024, 2048), dtype=np.uint8))


def _logged(fn, loggers=("evaluation",)):
    """fn() with the launch counters zeroed before and read after, the
    loggers' records and the peak memory: (records, launches, peak GiB,
    wall s)."""
    from scenedino_torch import kernels

    records = LogRecords()
    logs = [logging.getLogger(n) for n in loggers]
    for lg in logs:
        lg.setLevel(logging.INFO)
        lg.addHandler(records)
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
    finally:
        for lg in logs:
            lg.removeHandler(records)
    return records, counts, torch.cuda.max_memory_allocated() / 2 ** 30, wall


def _run_logged(fn, argv):
    """fn(argv) through `_logged` with the "evaluation" logger: (result,
    launches, per-frame records, peak GiB, wall s)."""
    out = []
    records, counts, peak, wall = _logged(lambda: out.append(fn(argv)))
    return out[0], counts, records.with_attr("frame"), peak, wall


def _in_unit(values) -> bool:
    return all(np.isfinite(float(v)) and 0.0 <= float(v) <= 1.0 for v in values)


def phase_eval_sscbench(seed, stage2_dir, scratch, device="cuda"):
    """Phase 8a: `cli.evaluate_sscbench.main` on a seeded SSCBench tree with
    phase 7's stage-2 run; then with --test-alpha-cutoffs on one frame; K4
    against its plain version on every block of one frame and the labels
    of both; the fast path against --slow (printed). Returns (the main
    run's launches, K4's block measurement, the tree's root)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate_sscbench as cli
    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.datasets.sscbench import SSCBenchDataset
    from scenedino_torch.eval import sscbench as S
    from scenedino_torch.kernels.point_render import point_query, point_query_plain
    from scenedino_torch.ops import fast_field
    from scenedino_torch.utils.config import load_run_config
    from scenedino_torch.utils.timing import profile_device, time_ms

    root = tempfile.mkdtemp(prefix="sscbench_", dir=scratch)
    t0 = time.perf_counter()
    write_sscbench_tree(root, np.random.default_rng(seed + 80))
    write_s = time.perf_counter() - t0
    config = load_run_config(stage2_dir)
    field, head = eval_model(config, stage2_dir, device)
    depth = field.encoder.vit_encoder.vit.cfg.depth
    argv = ["--data", root, "--voxel-gt", os.path.join(root, "voxel_gt"), "--ckpt", stage2_dir,
            "--config", stage2_dir, "--device", device]
    (table, acc), counts, frames, peak, wall = _run_logged(cli.main, argv)
    blocks = 256 * 256 * 32 // SSC_BLOCK
    enc = config["model"]["encoder"]
    stages = ("read_ms", "encode_ms", "query_ms", "accumulate_ms")
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth,
              "point_query": EVAL_FRAMES * blocks}
    print(f"phase 8a SSCBench: cli.evaluate_sscbench.main on a seeded tree of {EVAL_FRAMES} frames "
          f"(376x1408 PNGs, written in {write_s:.1f} s) with phase 7's run ({enc['encoder_arch']} {enc['version']}, "
          f"DPT {enc['decoder_out_dim']}, with_amp {config.get('with_amp')}, {enc['image_size']}, "
          f"{config['downstream']['n_classes']} clusters), fast path: {json.dumps(table)}; per frame host ms "
          f"{json.dumps([{k: round(getattr(r, k), 1) for k in stages} for r in frames])}; "
          f"{wall:.1f} s wall (model build and load included); peak memory allocated {peak:.3f} GiB; launches "
          f"{json.dumps(counts)} (expected {json.dumps(expect)}: {depth} K1 and {blocks} K4 blocks of {SSC_BLOCK} "
          f"points a frame)", flush=True)
    if not all(_in_unit(table[s].values()) for s in ("12.8", "25.6", "51.2")) or not table["sec_per_frame"] > 0:
        fail(f"the SSCBench table is not finite in [0, 1]: {table}")
    if counts != expect or len(frames) != EVAL_FRAMES:
        fail(f"the SSCBench evaluation launched {counts} over {len(frames)} frames, expected {expect}")
    # every range's occupancy numbers cover the valid in-view voxels of all frames
    dataset = SSCBenchDataset(data_path=root, voxel_gt_path=os.path.join(root, "voxel_gt"))
    fov = S.get_fov_mask()
    valid = {size: 0 for size in S.SIZES}
    for i in range(EVAL_FRAMES):
        target = S.convert_voxels(dataset[i]["voxel_gt"], S.SSCBENCH_TO_LABEL)
        target = np.where(S.identify_additional_invalids(target), 255, target)
        for size in S.SIZES:
            nv = int(size // 0.2)
            sl = np.s_[:nv, 128 - nv // 2:128 + nv // 2, :]
            valid[size] += int(((target[sl] != 255) & fov[sl]).sum())
    covered = {size: sum(acc.results[size][k] for k in ("tp", "fp", "tn", "fn")) for size in S.SIZES}
    print(f"phase 8a occupancy numbers per range (tp + fp + tn + fn) {covered}, valid in-view voxels {valid}",
          flush=True)
    if covered != valid:
        fail("the SSCBench occupancy numbers do not cover the valid in-view voxels")

    (diag, _), _, dframes, _, dwall = _run_logged(cli.main, argv + ["--max-frames", "1", "--test-alpha-cutoffs"])
    print(f"phase 8a --test-alpha-cutoffs on one frame ({dwall:.1f} s, accumulation "
          f"{dframes[0].accumulate_ms:.1f} ms): best cutoffs {json.dumps(diag['best_alpha_cutoffs'])}; tradeoff "
          f"{json.dumps(diag['sigma_tradeoff'][:3])} ...", flush=True)
    if len(diag["best_alpha_cutoffs"]) != 15 or not all(np.isfinite(r["iou"]) for r in diag["sigma_tradeoff"]):
        fail("the sigma-cutoff search is incomplete or not finite")

    # the alpha-weighted argmax on the card: equal weighted scores (a tie, or sigma 0) give the first class
    tie_sigma = torch.tensor([0.0, 1.0, 1.0], device=device)
    tie_scores = torch.tensor([[0.0, 1.0, 1.0], [0.5, 0.5, 0.2], [0.1, 0.3, 0.3]], device=device)
    ties = S.make_grid_predictor(lambda b, _: (tie_sigma[None], tie_scores[None]), chunk_points=3, grow=False,
                                 grid_dim=(3, 1, 1), coherent=False)(torch.zeros(3, 3, device=device), None)[1]
    print(f"phase 8a alpha-weighted argmax of tied scores on the card: {ties.reshape(-1).tolist()} (the first "
          f"class of each tie: [0, 0, 1])", flush=True)
    if ties.reshape(-1).tolist() != [0, 0, 1]:
        fail("the alpha-weighted argmax does not take the first class of a tie on the card")

    # K4 on every block of frame 0 against its plain version on the card, and the labels of the two
    sample = dataset[0]
    frame = [torch.from_numpy(sample[k])[None].to(device) for k in ("imgs", "projs", "poses")]
    pts, fov_flat = S.generate_point_grid()
    pts = torch.from_numpy(pts).to(device)
    fs = cli.make_encode_fn(field, fast=True)(*frame)
    coherent = pts.reshape(256, 256, 32, 3).permute(2, 0, 1, 3).reshape(-1, SSC_BLOCK, 3)
    view = fast_field._single_view(fs, "phase 8a")
    pcfg = fast_field._point_config(field.cfg)
    # errors as phase 3c's; a trained field's outputs exceed 1, where one bf16 flip of h moves an output in
    # proportion to its size: the gate is the error over each point's largest output (at least 1)
    err_abs, err_range, err_scaled, size_at_range = 0.0, 0.0, 0.0, 0.0
    for block in coherent:
        sigma, feat = point_query(block, *view, pcfg)
        ref_s, ref_f = point_query_plain(block, *view, pcfg)
        d = torch.maximum((sigma - ref_s).abs(), (feat - ref_f).abs().amax(-1))
        size = torch.maximum(ref_s, ref_f.abs().amax(-1))
        near = (block[:, 2] >= pcfg.z_near) & (block[:, 2] <= pcfg.z_far)
        err_abs = max(err_abs, d.max().item())
        i = torch.argmax(torch.where(near, d, torch.zeros_like(d)))
        if d[i].item() > err_range:
            err_range, size_at_range = d[i].item(), size[i].item()
        err_scaled = max(err_scaled, (d / torch.clamp_min(size, 1.0)).max().item())
    one_hot = torch.eye(cli.N_CLASSES, device=device)
    mode = "stego_kmeans"

    def plain_query(block, state):
        sigma, feat = point_query_plain(block[0], *view, pcfg)
        return sigma[None], one_hot[field.segment_features(feat, head, mode)[1]][None]

    with torch.no_grad():
        sig_k, seg_k = S.make_grid_predictor(cli.make_query_fn(field, head, mode, True))(pts, fs)
        sig_p, seg_p = S.make_grid_predictor(plain_query)(pts, fs)
    fov3 = torch.from_numpy(fov_flat.reshape(256, 256, 32)).to(device)
    agree = (seg_k == seg_p)[fov3].float().mean().item()
    print(f"phase 8a K4 on frame 0's {blocks} blocks against point_query_plain: error over each point's largest "
          f"output (at least 1) {err_scaled:.3e} (bound {K4_TOL}); max abs error on points in [{pcfg.z_near}, "
          f"{pcfg.z_far}] m {err_range:.3e} at a point whose largest output is {size_at_range:.3f}, on all points "
          f"{err_abs:.3e}; grown sigma max abs difference {(sig_k - sig_p).abs().max().item():.3e}; labels equal on "
          f"{agree:.6f} of the {int(fov3.sum())} in-view voxels (bound {EVAL_LABELS_AGREE})", flush=True)
    if not (err_scaled <= K4_TOL and agree >= EVAL_LABELS_AGREE):
        fail("K4 on the SSCBench blocks disagrees with its plain version, or the labels do")

    # K4 at the block shape: times and the bound (distinct grid rows read, points, sigma and features moved)
    block = coherent[0].contiguous()
    grid, w_code, b1, w2, b2, feat_w2c, feat_k = view
    ms = time_ms(lambda: point_query(block, *view, pcfg))
    plain_ms = time_ms(lambda: point_query_plain(block, *view, pcfg), reps=5)
    P, D, E, C = block.shape[0], grid.shape[-1], w2.shape[-1], w_code.shape[0]
    rows = grid_rows_read(block, grid, feat_w2c, feat_k)
    in_bytes = rows * D * 2 + nbytes(block, w_code, b1, w2, b2, feat_w2c, feat_k)
    out_bytes = P * 4 * E
    b, by = bound_ms(2.0 * P * (C * D + D * E), in_bytes + out_bytes)
    block_entry = {"points": P, "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                   "max_abs_err": err_abs}
    print(f"phase 8a K4 point_query at the evaluation's block ({P} points, the phase-7 field's "
          f"{grid.shape[0]}x{grid.shape[1]}x{D} bf16 folded grid, d_out {E}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by}: {rows} distinct grid rows, inputs {in_bytes / 1e6:.1f} MB, "
          f"sigma and features {out_bytes / 1e6:.1f} MB); {corner_traffic(P, D)}", flush=True)
    predict = S.make_grid_predictor(cli.make_query_fn(field, head, mode, True))
    print(f"phase 8a profile (one frame's grid query: 4 x K4, the 768-d expansion and the head, the argmax, the "
          f"pool): {profile_device(lambda: predict(pts, fs))}", flush=True)

    # the fast path against --slow on the card (printed): both fold in bf16, at different points
    with torch.no_grad():
        state = cli.make_encode_fn(field, fast=False)(*frame)
        sig_s, seg_s = S.make_grid_predictor(cli.make_query_fn(field, head, mode, False), coherent=False)(pts, state)
    print(f"phase 8a fast path against --slow (the unfolded bf16 field in plain torch), frame 0: grown sigma max abs "
          f"difference {(sig_k - sig_s).abs().max().item():.3e} (largest sigma {sig_s.abs().max().item():.3e}); "
          f"labels equal on {(seg_k == seg_s)[fov3].float().mean().item():.6f} of the in-view voxels", flush=True)
    del field, head, fs, state
    return counts, block_entry, root


def _eval_config(root, stage2_dir, data):
    """configs/evaluate_semantic_cityscapes.yaml with phase 7's model,
    precision and downstream blocks (it has none: `variant: dino`), the data
    path set to the seeded tree."""
    from scenedino_torch.utils.config import load, load_run_config

    conf = load(os.path.join(root, "configs", "evaluate_semantic_cityscapes.yaml"))
    run = load_run_config(stage2_dir)
    conf.pop("variant", None)
    conf["model"], conf["with_amp"] = copy.deepcopy(run["model"]), run.get("with_amp", False)
    conf["downstream"] = {**conf.get("downstream", {}), **copy.deepcopy(run["downstream"])}
    conf["dataset"]["data_path"] = data
    return conf


def phase_eval_seg2d(seed, stage2_dir, scratch, device="cuda"):
    """Phase 8b: `cli.evaluate.main` on a seeded Cityscapes tree with phase
    7's run, then once with apply_crf on one frame; the evaluator's K6 render
    against K6's plain version on one frame, and the labels of the four
    modes. Returns the main run's launches, K6's measurement at the frame and the tree's root."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate as cli
    from scenedino_torch.datasets import make_test_dataset
    from scenedino_torch.kernels.encode_view import encode_view, encode_view_plain
    from scenedino_torch.ops.fast_field import build_fast_state, encode_view_inputs
    from scenedino_torch.tools.bench_encode_view import TOL, bound
    from scenedino_torch.utils.config import save_run_config
    from scenedino_torch.utils.timing import time_ms

    root = os.path.dirname(os.path.abspath(__file__))
    data = tempfile.mkdtemp(prefix="cityscapes_", dir=scratch)
    t0 = time.perf_counter()
    write_cityscapes_tree(data, np.random.default_rng(seed + 81))
    write_s = time.perf_counter() - t0
    conf = _eval_config(root, stage2_dir, data)
    conf_dir = tempfile.mkdtemp(prefix="eval_config_", dir=scratch)
    save_run_config(conf_dir, conf)
    out, counts, frames, peak, wall = _run_logged(cli.main, ["--config", conf_dir, "--ckpt", stage2_dir,
                                                              "--device", device])
    depth = conf["model"]["encoder"].get("vit_overrides", {}).get("depth", 12)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth,
              "encode_view": EVAL_FRAMES}
    summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out.items() if isinstance(r, dict)}
    print(f"phase 8b 2D segmentation: cli.evaluate.main on a seeded Cityscapes tree of {EVAL_FRAMES} frames "
          f"(1024x2048 PNGs, written in {write_s:.1f} s), configs/evaluate_semantic_cityscapes.yaml with phase 7's "
          f"model and downstream blocks: {json.dumps(summary)}; per frame host ms "
          f"{json.dumps([{k: round(getattr(r, k), 1) for k in ('read_ms', 'frame_ms')} for r in frames])}; "
          f"{wall:.1f} s wall (model build and load included); peak memory allocated {peak:.3f} GiB; launches "
          f"{json.dumps(counts)} (expected {json.dumps(expect)}: {depth} K1 and one K6 a frame)", flush=True)
    if out["n_frames"] != EVAL_FRAMES or not all(_in_unit(r.values()) for r in summary.values()):
        fail(f"the 2D evaluation is not {EVAL_FRAMES} frames of finite values in [0, 1]: {out}")
    if counts != expect:
        fail(f"the 2D evaluation launched {counts}, expected {expect}")

    conf_crf = copy.deepcopy(conf)
    conf_crf["downstream"]["apply_crf"] = True
    crf_dir = tempfile.mkdtemp(prefix="eval_config_crf_", dir=scratch)
    save_run_config(crf_dir, conf_crf)
    out_crf, _, crf_frames, _, crf_wall = _run_logged(cli.main, ["--config", crf_dir, "--ckpt", stage2_dir,
                                                                 "--max-frames", "1", "--device", device])
    crf_summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out_crf.items() if isinstance(r, dict)}
    print(f"phase 8b apply_crf (the window CRF, one frame, {crf_wall:.1f} s wall; the frame "
          f"{crf_frames[0].frame_ms:.1f} ms against {frames[0].frame_ms:.1f} ms without): "
          f"{json.dumps({m: v for m, v in crf_summary.items() if m.endswith('_crf')})}", flush=True)
    if len(crf_summary) != 8 or not all(_in_unit(r.values()) for r in crf_summary.values()):
        fail(f"the CRF rows are missing or not finite in [0, 1]: {out_crf}")

    # K6 as the evaluator launches it (one frame, the fp32 fold) against its plain version on the same inputs
    from scenedino_torch.eval.seg2d import MODES, Seg2DEvaluator

    field, head = cli.eval_model(conf, stage2_dir, device)
    H, W = conf["dataset"]["image_size"]
    ev = Seg2DEvaluator(field=field, head=head, image_size=(H, W))
    sample = make_test_dataset(conf["dataset"])[0]
    frame = [torch.as_tensor(sample[k])[None].to(device) for k in ("imgs", "projs", "poses")]
    with torch.no_grad():
        state = field.encode(*frame, ids_encoder=(0,))
        fs = build_fast_state(field, state, compute_dtype=torch.float32)
        args, ecfg = encode_view_inputs(fs, field.cfg, H, W, u=ev.draws(0, device)[None], n_coarse=ev.n_coarse)
        out_k = encode_view(*args, ecfg)
        out_p = encode_view_plain(*args, ecfg)
        errs = {name: (a - b).abs().max().item() for name, a, b in zip(("depth", "feature", "rgb"), out_k, out_p)}
        feats = [field.expand_dim(o[1].reshape(H, W, -1)) for o in (out_k, out_p)]
        agree = {m: (head(feats[0], mode=m) == head(feats[1], mode=m)).float().mean().item() for m in MODES}
        rendered = ev.render(*frame, ev.draws(0, device))
        evaluator_err = max((rendered[i].reshape(out_k[i].shape) - out_k[i]).abs().max().item() for i in range(3))
    tol = TOL[torch.float32]
    ms = time_ms(lambda: encode_view(*args, ecfg))
    plain_ms = time_ms(lambda: encode_view_plain(*args, ecfg), reps=3, warmup=1)
    b, by = bound(args, torch.float32)
    print(f"phase 8b K6 on frame 0 as the evaluator launches it (fp32 fold, {H}x{W} rays x {ev.n_coarse}): errors "
          f"{json.dumps(errs)} (bounds {json.dumps(tol)}); the evaluator's own render of the frame differs from this "
          f"launch's by {evaluator_err:.3e} (bound {tol['feature']}); labels equal "
          f"{json.dumps({m: round(v, 6) for m, v in agree.items()})} (bound "
          f"{EVAL_LABELS_AGREE}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; three TF32 "
          f"passes)", flush=True)
    if not (all(errs[k] <= tol[k] for k in tol) and evaluator_err <= tol["feature"]
            and min(agree.values()) >= EVAL_LABELS_AGREE):
        fail("K6 on the 2D evaluation frame disagrees with its plain version, or the labels do")
    del field, head, fs, state
    shape = {"frames": 1, "dtype": "float32", "height": H, "width": W, "d_hidden": args[0].shape[1],
             "d_out": args[4].shape[1], "samples": ev.n_coarse, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
             "bound_by": by, "max_abs_err": max(errs.values())}
    return counts, shape, data


def phase_eval(seed, stage2_dir, scratch, device="cuda"):
    """Phase 8: evaluation on the card (8a SSCBench, 8b 2D segmentation) from
    phase 7's stage-2 run directory. Returns (the two main runs' launches, K4
    at the evaluation's block, K6 at the evaluator's frame, the SSCBench and
    Cityscapes trees' roots)."""
    t_phase = time.perf_counter()
    ssc_counts, k4_block, ssc_root = phase_eval_sscbench(seed, stage2_dir, scratch, device)
    seg_counts, k6_frame, city_root = phase_eval_seg2d(seed, stage2_dir, scratch, device)
    print(f"phase 8 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: ssc_counts[k] + seg_counts[k] for k in ssc_counts}, k4_block, k6_frame, (ssc_root, city_root)


# phase 9: the reference's checkpoints. The configs each variant's SSCBench
# run rebuilds its model from; the v2 encoder's GPU-CPU check: the pre-resize
# (the same float32 matrices, summed in another order) and the fp32 ViT-B/14
# with TF32 off (fp32 sums in other orders through 12 blocks), relative to
# the largest output
REFERENCE_CONFIGS = {"v1": "train_semantic_kitti_360.yaml", "v2": "train_scenedino_kitti_360_dinov2.yaml"}
RESIZE_GPU_TOL = 1e-6
V2_ENCODER_REL = 1e-4


@contextlib.contextmanager
def first_call(module, name):
    """Keep the arguments of the first call of `module.name` (a kernel
    wrapper as its caller sees it) in the yielded list; calls pass through."""
    calls, original = [], getattr(module, name)

    def spy(*args):
        if not calls:
            calls.append(args)
        return original(*args)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def k1_batches():
    """Keep (batch, with the log-sum-exp) of every K1 forward call of the ViT
    in the yielded set (the lse where a gradient is wanted, as
    `kernels.attention.attention` decides); calls pass through."""
    from scenedino_torch.models import vit as vit_mod

    seen, original = set(), vit_mod.attention

    def spy(q, k, v):
        seen.add((q.shape[0], torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)))
        return original(q, k, v)

    vit_mod.attention = spy
    try:
        yield seen
    finally:
        vit_mod.attention = original


def reference_checkpoint(conf, seed, path, device="cuda"):
    """A field and head of `conf` (a config's model and downstream blocks)
    at full width, drawn from `seed` (LayerScale drawn around 0.1, not the
    initial 1e-5), written to `path` as the reference's trainer writes
    checkpoint.pt: {"model": BTSWrapper state dict}, on the host. Returns
    the field's and the head's state_dicts as drawn, and the head."""
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.utils.convert import to_reference_layout

    field = make_model(conf["model"], device=device, seed=seed, training=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in field.named_parameters():
            if name.endswith((".ls1", ".ls2")):
                p.copy_(0.1 + 0.05 * torch.randn(p.shape, generator=gen, device=device))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed + 1)
        head = SemanticHead(SemanticHeadConfig.from_dict(conf.get("downstream", {}))).to(device)
    enc = field.encoder
    H_, W_ = conf["model"].get("encoder", {}).get("image_size", (H, W))
    artifact = 1e-3 * torch.randn(enc.gt_encoder.latent_size, H_ // enc.gt_patch_size, W_ // enc.gt_patch_size,
                                  generator=gen, device=device)
    sd = to_reference_layout(field.state_dict(), head.state_dict(), artifact)
    torch.save({"model": {k: v.cpu() for k, v in sd.items()}}, path)
    return field.state_dict(), head.state_dict(), head


def _bitwise(got, want) -> bool:
    return got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def phase_reference(seed, scratch, ssc_root, city_root, device="cuda"):
    """Phase 9: checkpoints in the reference's torch layout (the published
    ssc-kitti-360-dino and -dinov2 architectures) at full width from `seed`,
    loaded bit for bit; cli.evaluate_sscbench.main on phase 8a's tree with
    each `.pt` against the same weights as a port run (the tables and the
    accumulated numbers identical); cli.evaluate.main with `variant: dinov2`
    on phase 8b's tree; one novel-view request on the v2 field; the v2
    encoder on the GPU against the CPU; K1, K4, K6 and K2 against their plain
    versions on this phase's inputs. Returns (the main runs' launches, the
    holds by kernel)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate as cli_eval
    from scenedino_torch.cli import evaluate_sscbench as cli_ssc
    from scenedino_torch.core.resize import jax_resize
    from scenedino_torch.datasets.sscbench import SSCBenchDataset
    from scenedino_torch.eval import sscbench as S
    from scenedino_torch.kernels.attention import attention_plain
    from scenedino_torch.kernels.encode_view import encode_view_plain
    from scenedino_torch.kernels.point_render import point_query_plain, point_render_plain
    from scenedino_torch.models import vit as vit_mod
    from scenedino_torch.models.encoder import DinoViTEncoder, normalize_input
    from scenedino_torch.ops import fast_field
    from scenedino_torch.tools.bench_encode_view import TOL
    from scenedino_torch.training.downstream import DownstreamTrainConfig, init_downstream_state
    from scenedino_torch.utils.checkpoint import load_eval_state, save_checkpoint
    from scenedino_torch.utils.config import load, save_run_config
    from scenedino_torch.utils.timing import card_line, profile_device, time_ms

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    total = {name: 0 for name in kernels.WRAPPERS}
    holds, encode_ms, spf = {}, {}, {}
    sample = SSCBenchDataset(data_path=ssc_root, voxel_gt_path=os.path.join(ssc_root, "voxel_gt"))[0]
    frame = [torch.from_numpy(sample[k])[None].to(device) for k in ("imgs", "projs", "poses")]
    pts = torch.from_numpy(S.generate_point_grid()[0]).to(device)
    block = pts.reshape(256, 256, 32, 3).permute(2, 0, 1, 3).reshape(-1, SSC_BLOCK, 3)[0].contiguous()
    paths = {}
    for i, (version, config_name) in enumerate(REFERENCE_CONFIGS.items()):
        config_path = os.path.join(root, "configs", config_name)
        conf = load(config_path)
        ckpt = os.path.join(scratch, f"ssc-kitti-360-{version}.pt")
        t0 = time.perf_counter()
        field_sd, head_sd, head = reference_checkpoint(conf, seed + 90 + i, ckpt, device)
        size_gb = os.path.getsize(ckpt) / 1e9
        write_s = time.perf_counter() - t0
        # the same weights as a stage-2 run directory of the port
        run = tempfile.mkdtemp(prefix=f"port_{version}_", dir=scratch)
        torch.save(field_sd, os.path.join(run, "field_params.pt"))
        save_checkpoint(os.path.join(run, "training_checkpoint_0.pt"), head,
                        init_downstream_state(head, DownstreamTrainConfig()))
        del head
        t0 = time.perf_counter()
        got_field, got_head = load_eval_state(ckpt, device=device)
        load_s = time.perf_counter() - t0
        n_ref = len(torch.load(ckpt, map_location="cpu", weights_only=True)["model"])
        exact = _bitwise(got_field, field_sd) and _bitwise(got_head, head_sd)
        print(f"phase 9 {version}: {config_name}'s model, a reference-layout checkpoint of {n_ref} tensors "
              f"({size_gb:.3f} GB, drawn and written in {write_s:.1f} s) loaded strictly by load_eval_state in "
              f"{load_s:.1f} s: {len(got_field)} field and {len(got_head)} head tensors, equal bit for bit to the "
              f"drawn ones: {exact}", flush=True)
        if not exact:
            fail(f"the {version} reference checkpoint did not load bit for bit")
        del got_field, got_head, field_sd, head_sd

        argv = ["--data", ssc_root, "--voxel-gt", os.path.join(ssc_root, "voxel_gt"), "--config", config_path,
                "--device", device]
        (table, acc), counts, frames, peak, wall = _run_logged(cli_ssc.main, argv + ["--ckpt", ckpt])
        (port_table, port_acc), port_counts, _, _, _ = _run_logged(cli_ssc.main, argv + ["--ckpt", run])
        blocks = 256 * 256 * 32 // SSC_BLOCK
        depth = 12 if version == "v1" else 0  # v2: 481 tokens, under K1's 512
        expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": EVAL_FRAMES * depth,
                  "point_query": EVAL_FRAMES * blocks}
        spf[version] = table["sec_per_frame"]
        encode_ms[version] = [round(r.encode_ms, 1) for r in frames]
        same = ({k: v for k, v in table.items() if k != "sec_per_frame"}
                == {k: v for k, v in port_table.items() if k != "sec_per_frame"}
                and all(np.array_equal(acc.results[s][k], port_acc.results[s][k]) for s in S.SIZES
                        for k in acc.results[s]))
        stages = ("read_ms", "encode_ms", "query_ms", "accumulate_ms")
        print(f"phase 9 {version} SSCBench: cli.evaluate_sscbench.main --ckpt {os.path.basename(ckpt)} --config "
              f"{config_name} on phase 8a's {EVAL_FRAMES} frames: {json.dumps(table)}; per frame host ms "
              f"{json.dumps([{k: round(getattr(r, k), 1) for k in stages} for r in frames])}; "
              f"{wall:.1f} s wall; peak {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)}: "
              f"{depth} K1 and {blocks} K4 a frame); the same weights as a port run: table and accumulated numbers "
              f"identical {same}", flush=True)
        if counts != expect or port_counts != expect or len(frames) != EVAL_FRAMES:
            fail(f"the {version} SSCBench evaluation launched {counts} / {port_counts}, expected {expect}")
        if not same or not all(_in_unit(table[s].values()) for s in ("12.8", "25.6", "51.2")):
            fail(f"the {version} reference checkpoint's SSCBench table differs from the port run's or leaves [0, 1]")
        for name, n in counts.items():
            total[name] += n + port_counts[name]

        # the kernels against their plain versions on this checkpoint's inputs
        field, head = cli_eval.eval_model(conf, ckpt, device)
        fs = cli_ssc.make_encode_fn(field, fast=True)(*frame)
        img = frame[0][:, 0]

        def encode_once():
            with torch.inference_mode():
                return field.encoder(img)

        encoder_ms = time_ms(encode_once, reps=5)
        encode_ms[f"{version} encoder (CUDA events)"] = round(encoder_ms, 3)
        print(f"phase 9 {version} profile (the encoder alone, 192x640, bf16): {profile_device(encode_once)}",
              flush=True)
        with torch.no_grad(), first_call(vit_mod, "attention") as k1_calls, \
                first_call(fast_field, "point_query") as k4_calls:
            field.encoder(img)
            fast_field.fast_query_fused(fs, field.cfg, block)
        if version == "v1":
            q, k, v = k1_calls[0]
            err = (vit_mod.attention(q, k, v).float() - attention_plain(q, k, v).float()).abs().max().item()
            holds["attention"] = {"shape": list(q.shape), "max_abs_err": err}
            print(f"phase 9 v1 K1 on the checkpoint's first block {tuple(q.shape)} {q.dtype}: max abs err "
                  f"{err:.3e} (bound {K1_TOL})", flush=True)
            if not err <= K1_TOL:
                fail("K1 disagrees with its plain version on the v1 checkpoint's attention")
        elif k1_calls:
            fail("the v2 encoder (481 tokens) called K1")
        args = k4_calls[0]
        sigma, feat = kernels.point_query(*args)
        ref_s, ref_f = point_query_plain(*args)
        d = torch.maximum((sigma - ref_s).abs(), (feat - ref_f).abs().amax(-1))
        scaled = (d / torch.clamp_min(torch.maximum(ref_s, ref_f.abs().amax(-1)), 1.0)).max().item()
        holds.setdefault("point_query", {})[version] = {"points": block.shape[0], "max_abs_err": d.max().item(),
                                                         "err_over_largest_output": scaled}
        print(f"phase 9 {version} K4 on the first 524,288-point block: error over each point's largest output "
              f"{scaled:.3e} (bound {K4_TOL}), max abs {d.max().item():.3e}", flush=True)
        if not scaled <= K4_TOL:
            fail(f"K4 disagrees with its plain version on the {version} checkpoint's block")
        paths[version] = (ckpt, field, head)
        del fs

    # the v2 encoder on the GPU against the CPU: the pre-resize at 192x640, the fp32 ViT at 64x128
    ckpt, field, head = paths["v2"]
    x = normalize_input(frame[0][:, 0].float())
    resize_err = (jax_resize(x, (168, 560)).cpu() - jax_resize(x.cpu(), (168, 560))).abs().max().item()
    ecfg = field.encoder.cfg  # the same encoder in fp32
    enc32 = DinoViTEncoder(ecfg.encoder_arch, ecfg.version, tuple(ecfg.intermediate_features),
                           vit_overrides=ecfg.vit_overrides).to(device).eval()
    enc32.load_state_dict(field.encoder.vit_encoder.state_dict())
    small = torch.nn.functional.interpolate(frame[0][:, 0].float(), (64, 128), mode="area")
    with torch.no_grad():
        gpu = enc32(small)
        cpu = enc32.cpu()(small.cpu())
    rel = max(((g.cpu() - c).abs().max() / c.abs().max()).item() for g, c in zip(gpu, cpu))
    print(f"phase 9 v2 encoder GPU against CPU: the 14/16 pre-resize 192x640 -> 168x560 max abs err "
          f"{resize_err:.3e} (bound {RESIZE_GPU_TOL}); the fp32 ViT-B/14 at 64x128 (56x112, a 4x8 grid), each grid's "
          f"max abs err over its largest value {rel:.3e} (bound {V2_ENCODER_REL})", flush=True)
    if not (resize_err <= RESIZE_GPU_TOL and rel <= V2_ENCODER_REL):
        fail("the v2 encoder on the GPU disagrees with the CPU")
    del enc32, gpu, cpu

    # one novel-view request on the v2 field (K2), then K2 on its inputs
    g = torch.Generator(device=device).manual_seed(seed + 95)
    u = torch.rand(H * W, K, generator=g, device=device)
    kernels.reset_launches()
    with first_call(fast_field, "point_render") as k2_calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(field, frame[0][:, :1], u, device)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    check_depth("v2 novel-view", *out)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "point_render": 1}
    args = k2_calls[0]
    k2 = kernels.point_render(*args)
    ref = point_render_plain(*args)
    errs = [(a - b).abs().max().item() for a, b in zip(k2, ref)]
    holds["point_render"] = {"rays": args[0].shape[0], "samples": args[1].shape[1], "max_abs_err": max(errs)}
    print(f"phase 9 v2 novel-view request: {serve_ms:.1f} ms, launches {json.dumps(counts)} (expected "
          f"{json.dumps(expect)}); K2 on its inputs: errors depth {errs[0]:.3e} m, feature {errs[1]:.3e}, rgb "
          f"{errs[2]:.3e} (bounds {K2_DEPTH_TOL}, {K2_FEAT_TOL}, {K2_RGB_TOL})", flush=True)
    if counts != expect:
        fail(f"the v2 novel-view request launched {counts}, expected {expect}")
    if not (errs[0] <= K2_DEPTH_TOL and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL):
        fail("K2 disagrees with its plain version on the v2 request")
    for name, n in counts.items():
        total[name] += n
    del field, head, paths

    # the 2D evaluator on the v2 checkpoint: the variant: dinov2 preset (fp32), phase 8b's tree
    conf = load(os.path.join(root, "configs", "evaluate_semantic_cityscapes.yaml"))
    conf["variant"] = "dinov2"
    conf["dataset"]["data_path"] = city_root
    conf_dir = tempfile.mkdtemp(prefix="eval_config_v2_", dir=scratch)
    save_run_config(conf_dir, conf)
    with first_call(fast_field, "encode_view") as k6_calls:
        out, counts, frames, peak, wall = _run_logged(cli_eval.main, ["--config", conf_dir, "--ckpt", ckpt,
                                                                      "--device", device])
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "encode_view": EVAL_FRAMES}
    summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out.items() if isinstance(r, dict)}
    args = k6_calls[0]
    k6 = kernels.encode_view(*args)
    ref = encode_view_plain(*args)
    tol = TOL[torch.float32]  # the preset encodes in fp32 and folds in fp32
    errs = {name: (a - b).abs().max().item() for name, a, b in zip(("depth", "feature", "rgb"), k6, ref)}
    holds["encode_view"] = {"frames": 1, "max_abs_err": max(errs.values())}
    print(f"phase 9 v2 2D segmentation: cli.evaluate.main, evaluate_semantic_cityscapes.yaml with variant: dinov2, "
          f"--ckpt {os.path.basename(ckpt)}, phase 8b's {EVAL_FRAMES} frames: {json.dumps(summary)}; per frame host "
          f"ms {json.dumps([round(r.frame_ms, 1) for r in frames])}; {wall:.1f} s wall; peak {peak:.3f} GiB; "
          f"launches {json.dumps(counts)} (expected {json.dumps(expect)}: the fp32 preset takes the ViT's plain "
          f"attention, one K6 a frame); K6 on its first frame: errors {json.dumps(errs)} (bounds {json.dumps(tol)})",
          flush=True)
    if out["n_frames"] != EVAL_FRAMES or not all(_in_unit(r.values()) for r in summary.values()):
        fail(f"the v2 2D evaluation is not {EVAL_FRAMES} frames of finite values in [0, 1]: {out}")
    if counts != expect:
        fail(f"the v2 2D evaluation launched {counts}, expected {expect}")
    if not all(errs[k] <= tol[k] for k in tol):
        fail("K6 disagrees with its plain version on the v2 2D evaluation frame")
    for name, n in counts.items():
        total[name] += n
    print(f"phase 9 encode: host ms per SSCBench frame v1 {encode_ms['v1']}, v2 {encode_ms['v2']}; the encoder "
          f"alone (CUDA events, 192x640, bf16) v1 {encode_ms['v1 encoder (CUDA events)']} ms, v2 "
          f"{encode_ms['v2 encoder (CUDA events)']} ms; sec_per_frame v1 {spf['v1']:.4f}, v2 {spf['v2']:.4f}; "
          f"{card_line()}; phase 9 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total, holds


# phase 10: the KITTI-360 data path. The seeded tree: one sequence of
# KITTI_FRAMES posed frames at the release's sizes (the training split's items
# reach 41 frames ahead with the recipe's fisheye offsets of up to 40, and the
# resize cache holds every frame but the last); its test items; the cuts of the
# three recipes' runs
KITTI_SEQ = "2013_05_28_drive_0000_sync"
KITTI_FRAMES = 56
KITTI_TEST_IDS = (20, 30, 40)
KITTI_STEPS = 3
KITTI_VAL_ITEMS = 2
# an item through the cache against the same item resampled on the fly: one
# 8-bit step after the [-1, 1] scaling (the cache truncates), and float32
# round-off
KITTI_CACHE_TOL = 2 / 255 + 1e-6
# processes that write the tree and the resize cache (the card's host has 8 cores)
KITTI_WORKERS = 8
# the release's fisheye calibrations (image_02.yaml, image_03.yaml), 1400x1400
KITTI_FISHEYE = {
    "02": (2.2134047507854890, 1.6798235660113681e-02, 1.6548773243373522, 1336.3220825849971, 1335.7883350012958,
           716.94323510126321, 705.76498308221585),
    "03": (2.5535139132482758, 4.9370396274089505e-02, 4.5068455478645308, 1485.4455462304386, 1484.7933577069786,
           698.47345726911731, 698.97203136519401),
}


def _texture(seed, shape, shift):
    """A seeded low-frequency RGB field (H, W, 3) uint8, moved `shift` pixels
    along x: a few sinusoids per channel, so the photometric loss has
    structure to fit."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y = np.arange(h, dtype=np.float32)[:, None] / h
    x = (np.arange(w, dtype=np.float32)[None, :] + shift) / w
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fx, fy, ph = rng.uniform(1, 6, 3), rng.uniform(1, 6, 3), rng.uniform(0, 2 * np.pi, 3)
        img[..., c] = 128 + sum(40 / (k + 1) * np.sin(2 * np.pi * (fx[k] * x + fy[k] * y) + ph[k]) for k in range(3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_kitti_frame(root, i, seed):
    """Frame i of the tree: the two rectified perspective images (376x1408)
    and the two fisheye images (1400x1400), Paeth-filtered PNGs."""
    from scenedino_torch.datasets.image_io import write_png

    raw = os.path.join(root, "data_2d_raw", KITTI_SEQ)
    for cam, folder, shape in (("00", "data_rect", (376, 1408)), ("01", "data_rect", (376, 1408)),
                               ("02", "data_rgb", (1400, 1400)), ("03", "data_rgb", (1400, 1400))):
        write_png(os.path.join(raw, f"image_{cam}", folder, f"{i:010d}.png"),
                  _texture(seed + int(cam), shape, 12.0 * i), filter_type=4)
    return i


def kitti_train_lines(repo_root, max_id):
    """The lines of datasets/kitti_360/splits/sscbench/train_files.txt of the
    tree's sequence whose index is at most `max_id` (l and r entries)."""
    lines = []
    with open(os.path.join(repo_root, "datasets", "kitti_360", "splits", "sscbench", "train_files.txt")) as f:
        for line in f:
            seq, idx, _ = line.split()
            if seq == KITTI_SEQ and int(idx) <= max_id:
                lines.append(line.strip())
            elif seq == KITTI_SEQ and int(idx) > max_id:
                break
    return lines


def write_kitti_tree(root, repo_root, seed, workers=8):
    """A seeded KITTI-360 tree in the release's layout: KITTI_FRAMES frames of
    one sequence (perspective pairs 376x1408, fisheye pairs 1400x1400, the
    port's PNG writer with the Paeth filter, written by `workers` processes),
    calibration (the release's P_rect_00 and camera -> velodyne, phase 8a's
    camera -> pose, the fisheye YAMLs in the release's FileStorage layout),
    poses, velodyne scans and KITTI-360 semantic PNGs of the items' frames,
    and a split directory: the training lines of the repository's SSCBench
    split that the tree holds, and KITTI_TEST_IDS. Returns (the split's
    training lines, seconds)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from scenedino_torch.datasets.image_io import write_png
    from scenedino_torch.eval.sscbench import CAM2VELO, CAM_K

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    calib = os.path.join(root, "calibration")
    raw = os.path.join(root, "data_2d_raw", KITTI_SEQ)
    velo = os.path.join(root, "data_3d_raw", KITTI_SEQ, "velodyne_points", "data")
    sem = os.path.join(root, "data_2d_semantics", "train", KITTI_SEQ, "image_00", "semantic")
    for d in [calib, velo, sem, os.path.join(root, "data_poses", KITTI_SEQ), os.path.join(root, "splits")] + [
            os.path.join(raw, f"image_{cam}", folder) for cam, folder in (("00", "data_rect"), ("01", "data_rect"),
                                                                          ("02", "data_rgb"), ("03", "data_rgb"))]:
        os.makedirs(d, exist_ok=True)
    _write_kv(os.path.join(calib, "calib_cam_to_pose.txt"),
              [(f"image_0{i}", np.hstack([np.eye(3), [[0.8 * i], [0.3], [-0.1]]])) for i in range(4)])
    with open(os.path.join(calib, "calib_cam_to_velo.txt"), "w") as f:
        f.write(" ".join(repr(float(x)) for x in CAM2VELO[:3].ravel()) + "\n")
    _write_kv(os.path.join(calib, "perspective.txt"),
              [("P_rect_00", np.hstack([CAM_K, np.zeros((3, 1))])), ("R_rect_00", np.eye(3)),
               ("R_rect_01", np.eye(3)), ("S_rect_00", [1408, 376])])
    for cam, (xi, k1, k2, g1, g2, u0, v0) in KITTI_FISHEYE.items():
        with open(os.path.join(calib, f"image_{cam}.yaml"), "w") as f:
            f.write(f"%YAML:1.0\n---\nmodel_type: MEI\ncamera_name: image_{cam}\nimage_width: 1400\n"
                    f"image_height: 1400\nmirror_parameters:\n   xi: {xi:.16e}\ndistortion_parameters:\n"
                    f"   k1: {k1:.16e}\n   k2: {k2:.16e}\n   p1: 4.2223943394772046e-04\n"
                    f"   p2: 4.2462134260997584e-04\nprojection_parameters:\n   gamma1: {g1:.16e}\n"
                    f"   gamma2: {g2:.16e}\n   u0: {u0:.16e}\n   v0: {v0:.16e}\n")
    poses = []
    for i in range(KITTI_FRAMES):
        a = 0.004 * i
        poses.append([i] + list(np.array([[np.cos(a), 0, np.sin(a), 0.05 * i], [0, 1, 0, 0.0],
                                          [-np.sin(a), 0, np.cos(a), 0.8 * i]]).ravel()))
    np.savetxt(os.path.join(root, "data_poses", KITTI_SEQ, "poses.txt"), np.asarray(poses))
    train = kitti_train_lines(repo_root, KITTI_FRAMES - 2 - 41)
    with open(os.path.join(root, "splits", "train_files.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(root, "splits", "test_files.txt"), "w") as f:
        f.write("".join(f"{KITTI_SEQ} {i:010d} l\n" for i in KITTI_TEST_IDS))
    # the items' first frames: a velodyne scan (a road plane and walls ahead, x forward) and the labels
    ids = sorted({int(line.split()[1]) for line in train} | set(KITTI_TEST_IDS))
    for i in ids:
        n = 60000
        x = rng.uniform(2, 60, n)
        y = rng.uniform(-12, 12, n)
        z = np.where(rng.random(n) < 0.6, -1.7, rng.uniform(-1.7, 3.0, n))
        y = np.where(z > -1.7, np.sign(y) * rng.uniform(6, 12, n), y)
        np.stack([x, y, z, rng.random(n)], -1).astype(np.float32).tofile(os.path.join(velo, f"{i:010d}.bin"))
        labels = np.zeros((376, 1408), np.uint8)
        labels[:150] = 23  # sky
        labels[150:250] = rng.choice(np.array([11, 21, 26, 17, 13], np.uint8), size=(1, 1408)).repeat(100, 0)
        labels[250:] = rng.choice(np.array([7, 8, 9, 22], np.uint8), size=(1, 1408)).repeat(126, 0)
        write_png(os.path.join(sem, f"{i:010d}.png"), labels, filter_type=2)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_write_kitti_frame, [root] * KITTI_FRAMES, range(KITTI_FRAMES), [seed] * KITTI_FRAMES))
    return train, time.perf_counter() - t0


def _kitti_dataset_block(conf, root):
    conf["dataset"].update(data_path=root, pose_path=os.path.join(root, "data_poses"),
                           split_path=os.path.join(root, "splits"))


def phase_kitti_tree(seed, scratch):
    """Phase 10a: the tree, the preprocess CLI's cache, one item through the
    cache against the same item resampled on the fly, and the loader's host
    ms. Returns (the tree's root, the loader's ms)."""
    from scenedino_torch.cli import preprocess_kitti_360
    from scenedino_torch.datasets.kitti_360 import KITTI360Dataset
    from scenedino_torch.utils.prefetch import ThreadedLoader

    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="kitti360_", dir=scratch)
    train, write_s = write_kitti_tree(root, repo, seed + 100, KITTI_WORKERS)
    t0 = time.perf_counter()
    preprocess_kitti_360.main(["resize", "-d", root, "-r", str(H), str(W), "-f", "0", "-15",
                               "--workers", str(KITTI_WORKERS)])
    cache_s = time.perf_counter() - t0
    size_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs) / 1e6
    print(f"phase 10a tree: {KITTI_FRAMES} frames of {KITTI_SEQ} (376x1408 perspective and 1400x1400 fisheye pairs, "
          f"Paeth-filtered PNGs by the port's writer, {KITTI_WORKERS} processes), the release's calibration with the "
          f"fisheye YAMLs in its FileStorage layout, {len(train)} training lines of the repository's SSCBench split "
          f"({', '.join(train)}), test items {list(KITTI_TEST_IDS)}: written in {write_s:.1f} s, {size_mb:.0f} MB; "
          f"cli.preprocess_kitti_360 resize (192x640, rotation 0x-15, {KITTI_WORKERS} processes) in {cache_s:.1f} s",
          flush=True)

    kw = dict(data_path=root, pose_path=os.path.join(root, "data_poses"),
              split_path=os.path.join(root, "splits", "train_files.txt"), fisheye_offset=(10, 25, 40),
              return_segmentation=True)
    raw, cached = KITTI360Dataset(**kw), KITTI360Dataset(is_preprocessed=True, **kw)
    worst, raw_ms, cached_ms = 0.0, [], []
    for i in range(len(cached)):
        items = []
        for ds, times in ((raw, raw_ms), (cached, cached_ms)) if i == 0 else ((cached, cached_ms),):
            ds._rng_local.rng = np.random.RandomState(seed + i)
            t0 = time.perf_counter()
            items.append(ds[i])
            times.append((time.perf_counter() - t0) * 1e3)
        if len(items) == 2:  # the first item also resampled from the raw frames
            if not np.array_equal(items[0]["poses"], items[1]["poses"]):
                fail("an item's poses through the cache differ from the raw item's")
            worst = max(worst, float(np.abs(items[0]["imgs"] - items[1]["imgs"]).max()))
    # the PNG decode of one file of each kind (the port's reader, host ms)
    from scenedino_torch.datasets.image_io import read_png, write_png

    raw_dir = os.path.join(root, "data_2d_raw", KITTI_SEQ)
    decode = {}
    for name, path in (("fisheye 1400x1400", os.path.join(raw_dir, "image_02", "data_rgb", "0000000001.png")),
                       ("perspective 376x1408", os.path.join(raw_dir, "image_00", "data_rect", "0000000001.png")),
                       ("labels 376x1408", os.path.join(root, "data_2d_semantics", "train", KITTI_SEQ, "image_00",
                                                        "semantic", "0000000001.png")),
                       ("cached 192x640", os.path.join(raw_dir, "image_00", f"data_{H}x{W}", "0000000001.png"))):
        t0 = time.perf_counter()
        pixels = read_png(path)
        decode[name] = round((time.perf_counter() - t0) * 1e3, 1)
    # the port's cache is written without row filters; a cache written with them (as PIL does) decodes so
    paeth = os.path.join(root, "paeth_192x640.png")
    write_png(paeth, pixels, filter_type=4)
    t0 = time.perf_counter()
    read_png(paeth)
    decode["cached 192x640 if Paeth-filtered"] = round((time.perf_counter() - t0) * 1e3, 1)
    plan = [list(range(i, i + 4)) for i in range(0, len(cached) - 3, 4)] * 3
    t0 = time.perf_counter()
    n = sum(1 for _ in ThreadedLoader(cached, plan, num_workers=4))
    batch_ms = (time.perf_counter() - t0) * 1e3 / n
    ms = {"raw_item": float(np.median(raw_ms)), "cached_item": float(np.median(cached_ms)), "batch_of_4": batch_ms}
    print(f"phase 10a loader (host): an item of 8 views at 192x640 with its labels, raw (2 perspective reads and "
          f"resizes, 2 fisheye reads and MEI resamples a timestep) {json.dumps([round(t, 1) for t in raw_ms])} ms, "
          f"through the cache {json.dumps([round(t, 1) for t in cached_ms])} ms; a batch of 4 through the cache by "
          f"ThreadedLoader (4 threads, {n} batches) {batch_ms:.1f} ms; the cached items against the raw ones: max abs "
          f"difference {worst:.3e} (bound {KITTI_CACHE_TOL:.3e}, one 8-bit step in [-1, 1]); one PNG's decode, host "
          f"ms: {json.dumps(decode)}", flush=True)
    if not worst <= KITTI_CACHE_TOL:
        fail("an item read through the cache differs from the same item resampled on the fly")
    return root, ms


def phase_kitti_stage1(root, scratch):
    """Phase 10b: cli.train.main on configs/train_scenedino_kitti_360.yaml at
    full width on the tree. Returns (its launches, its run directory, each
    step's host and loader-wait ms)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_kitti_360.yaml"))
    _kitti_dataset_block(conf, root)
    out = tempfile.mkdtemp(prefix="kitti_s1_", dir=scratch)
    conf["output"]["path"] = out
    conf["training"].update(stop_iteration=KITTI_STEPS, checkpoint_every=KITTI_STEPS, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = KITTI_STEPS
    vconf["subset"]["args"] = {"start": 0, "end": KITTI_VAL_ITEMS}
    cfg_dir = tempfile.mkdtemp(prefix="kitti_s1_config_", dir=scratch)
    path = save_run_config(cfg_dir, conf)
    model_conf = trainer.configs_from_dict(conf)[0]
    enc = model_conf["encoder"]
    print(f"phase 10b stage 1: cli.train.main --config configs/train_scenedino_kitti_360.yaml at full width "
          f"({enc['encoder_arch']} {enc['version']} student and teacher, DPT {enc['decoder_out_dim']}, d_hidden "
          f"{model_conf['decoder_heads'][0]['args']['d_hidden']}, with_amp {conf['with_amp']}, {enc['image_size']}, "
          f"batch {conf['batch_size']}, 8 views, fisheye offsets 10-40, is_preprocessed); cuts: data_path, pose_path "
          f"and split_path -> the seeded tree, stop_iteration {KITTI_STEPS}, validation every 5000 -> {KITTI_STEPS} "
          f"over test items 0-{KITTI_VAL_ITEMS - 1} (file: 0-127), checkpoint_every 10000 -> {KITTI_STEPS}, "
          f"log_every 1, output into {out}", flush=True)
    records, counts, peak, wall = _logged(lambda: cli.main(["--config", path]), ("training", "validation"))
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 10b step {r.iteration}: loss {r.losses['rec_loss']:.6f}; host ms: waiting on the loader "
              f"{r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    for r in vals:
        print(f"phase 10b validation at {r.iteration} ({r.ms:.1f} ms, the velodyne depths): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    depth = 12
    remat = depth if enc.get("grad_checkpointing") else 0
    expect = {**{name: 0 for name in kernels.WRAPPERS},
              "attention": KITTI_STEPS * (2 * depth + remat) + len(vals) * KITTI_VAL_ITEMS * 2 * depth,
              "attention_bwd_dq": KITTI_STEPS * depth, "attention_bwd_dkv": KITTI_STEPS * depth}
    ckpt = os.path.join(out, f"training_checkpoint_{KITTI_STEPS}.pt")
    print(f"phase 10b run: {len(steps)} steps in {wall:.1f} s wall (model build, data, steps, validation, checkpoints);"
          f" peak memory allocated {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)}: a "
          f"step the student's and the teacher's 12 blocks and the backward's 12, a validation item 12 + 12); "
          f"{os.path.basename(ckpt)} written: {os.path.exists(ckpt)}", flush=True)
    if (len(steps) != KITTI_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses["nonfinite_total"] != 0):
        fail("the KITTI-360 stage-1 run did not take its steps finite and applied")
    if len(vals) != 1 or not _finite(vals[0].metrics.values()) or "dino_cos_sim" not in vals[0].metrics or not any(
            k.startswith("depth_") for k in vals[0].metrics):
        fail("the KITTI-360 stage-1 validation is missing a depth or dino metric, or one is not finite")
    if counts != expect:
        fail(f"the KITTI-360 stage-1 run launched {counts}, expected {expect}")
    if not os.path.exists(ckpt):
        fail(f"{ckpt} was not written")
    return counts, out, [(r.step_ms, r.data_ms) for r in steps]


def phase_kitti_stage2(root, stage1_dir, scratch):
    """Phase 10c: cli.train.main --stage semantic on
    configs/train_semantic_kitti_360.yaml from phase 10b's run. Returns
    (its launches, its run directory)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_semantic_kitti_360.yaml"))
    _kitti_dataset_block(conf, root)
    out = tempfile.mkdtemp(prefix="kitti_s2_", dir=scratch)
    conf["output"]["path"] = out
    conf["resume_from"] = stage1_dir
    conf["training"].update(stop_iteration=KITTI_STEPS, checkpoint_every=KITTI_STEPS, log_every=1, num_epochs=10)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = KITTI_STEPS
    vconf["subset"] = {"type": "range", "args": {"start": 0, "end": KITTI_VAL_ITEMS}}
    path = save_run_config(tempfile.mkdtemp(prefix="kitti_s2_config_", dir=scratch), conf)
    d = conf["downstream"]
    print(f"phase 10c stage 2: cli.train.main --stage semantic --config configs/train_semantic_kitti_360.yaml "
          f"(its model: ViT-B/8, DPT 256, with_amp {conf['with_amp']}; downstream {d['n_classes']} clusters, "
          f"buffer {d['buffer_size']}, {d['patch_sample_size']} samples a crop; batch {conf['batch_size']}, "
          f"num_workers {conf['num_workers']}); cuts: the data paths -> the seeded tree, resume_from phase 10b's run, "
          f"num_epochs 1 -> 10 (4 training items are one step an epoch), stop_iteration {KITTI_STEPS}, validation "
          f"every 100 -> {KITTI_STEPS} over test items 0-{KITTI_VAL_ITEMS - 1} (file: a random 32), "
          f"checkpoint_every 5000 -> {KITTI_STEPS}, log_every 250 -> 1; the labels read as train ids", flush=True)
    captured, run_stage2 = [], cli.run_stage2

    def keep(config, device=None):  # the run's field and head, as main's call of run_stage2 returns them
        captured.append(run_stage2(config, device=device))
        return captured[-1]

    cli.run_stage2 = keep
    try:
        records, counts, peak, wall = _logged(lambda: cli.main(["--config", path, "--stage", "semantic"]),
                                              ("training", "validation"))
    finally:
        cli.run_stage2 = run_stage2
    field, head, _ = captured[0]
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 10c step {r.iteration}: {json.dumps({k: round(float(v), 6) for k, v in r.losses.items()})}; "
              f"host ms: waiting on the loader {r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    seg = {}
    for r in vals:
        seg = {k: float(v) for k, v in r.metrics.items() if k.endswith(("_miou", "_acc"))}
        print(f"phase 10c validation at {r.iteration} ({r.ms:.1f} ms, the tree's labels): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    depth = 12
    renders = KITTI_STEPS + 1 + len(vals) * KITTI_VAL_ITEMS
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": renders * depth, "encode_view": renders}
    # the head moved from its draw, and the field is phase 10b's, bit for bit
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig

    init = SemanticHead(SemanticHeadConfig.from_dict(d), generator=torch.Generator().manual_seed(conf["seed"]))
    moved = {k: not torch.equal(v.cpu(), init.state_dict()[k]) for k, v in head.state_dict().items()
             if v.is_floating_point()}
    frozen = torch.load(cli.find_latest_checkpoint(stage1_dir), map_location="cuda", weights_only=True)["field"]
    unchanged = _state_equal(field.state_dict(), frozen)
    del field, head, captured
    print(f"phase 10c run: {len(steps)} steps in {wall:.1f} s wall; peak memory allocated {peak:.3f} GiB; launches "
          f"{json.dumps(counts)} (expected {json.dumps(expect)}: each step, the seeding and each validation item "
          f"encode one view and render it through K6); head tensors moved {sum(moved.values())} of {len(moved)}; "
          f"the field after the run bitwise equal to phase 10b's checkpoint: {unchanged}", flush=True)
    if (len(steps) != KITTI_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses.get("nonfinite_total", 0) != 0):
        fail("the KITTI-360 stage-2 run did not take its steps finite and applied")
    if len(vals) != 1 or not seg or not _in_unit(seg.values()):
        fail(f"the KITTI-360 stage-2 validation's seg metrics are missing or leave [0, 1]: {seg}")
    if counts != expect:
        fail(f"the KITTI-360 stage-2 run launched {counts}, expected {expect}")
    if not all(moved.values()) or not unchanged:
        fail("the KITTI-360 stage 2 left a head tensor unchanged or changed the field")
    return counts, out


def phase_kitti_eval(root, stage2_dir, scratch, device="cuda"):
    """Phase 10d: cli.evaluate.main on configs/evaluate_semantic_kitti_360.yaml
    with phase 10c's model, precision and downstream blocks, over the
    tree's test items; K6 on the first frame against its plain version.
    Returns (its launches, K6's error)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import evaluate as cli
    from scenedino_torch.kernels.encode_view import encode_view_plain
    from scenedino_torch.ops import fast_field
    from scenedino_torch.tools.bench_encode_view import TOL
    from scenedino_torch.utils.config import load, load_run_config, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "evaluate_semantic_kitti_360.yaml"))
    _kitti_dataset_block(conf, root)
    run = load_run_config(stage2_dir)
    conf.pop("variant", None)
    conf["model"], conf["with_amp"] = copy.deepcopy(run["model"]), run.get("with_amp", False)
    conf["downstream"] = {**conf.get("downstream", {}), **copy.deepcopy(run["downstream"])}
    conf_dir = tempfile.mkdtemp(prefix="kitti_eval_config_", dir=scratch)
    save_run_config(conf_dir, conf)
    with first_call(fast_field, "encode_view") as k6_calls:
        out, counts, frames, peak, wall = _run_logged(cli.main, ["--config", conf_dir, "--ckpt", stage2_dir,
                                                                  "--device", device])
    n = len(KITTI_TEST_IDS)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention": n * 12, "encode_view": n}
    summary = {m: {k: round(v, 6) for k, v in r.items()} for m, r in out.items() if isinstance(r, dict)}
    args = k6_calls[0]
    k6, ref = kernels.encode_view(*args), encode_view_plain(*args)
    tol = TOL[torch.float32]
    errs = {name: (a - b).abs().max().item() for name, a, b in zip(("depth", "feature", "rgb"), k6, ref)}
    print(f"phase 10d evaluation: cli.evaluate.main, configs/evaluate_semantic_kitti_360.yaml (raw frames, fisheye "
          f"offset 10) with phase 10c's model, with_amp and downstream blocks, the tree's {n} test items (8 views, "
          f"view 0 encoded), labels as train ids: {json.dumps(summary)}; per frame host ms "
          f"{json.dumps([{k: round(getattr(r, k), 1) for k in ('read_ms', 'frame_ms')} for r in frames])}; "
          f"{wall:.1f} s wall; peak {peak:.3f} GiB; launches {json.dumps(counts)} (expected {json.dumps(expect)}: 12 "
          f"K1 and one K6 a frame); K6 on the first frame against its plain version: {json.dumps(errs)} (bounds "
          f"{json.dumps(tol)})", flush=True)
    if out["n_frames"] != n or len(summary) != 4 or not all(_in_unit(r.values()) for r in summary.values()):
        fail(f"the KITTI-360 evaluation is not {n} frames of finite values in [0, 1]: {out}")
    if counts != expect:
        fail(f"the KITTI-360 evaluation launched {counts}, expected {expect}")
    if not all(errs[k] <= tol[k] for k in tol):
        fail("K6 disagrees with its plain version on the KITTI-360 evaluation frame")
    return counts, max(errs.values())


def phase_kitti_layouts(root):
    """Phase 10e (host): KITTI_360_v2 items (the overlap sampling) and
    SSCBench items with the fisheye views on the same tree."""
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.datasets.kitti_360 import estimate_frustum_overlap
    from scenedino_torch.datasets.sscbench import SSCBenchDataset

    from scenedino_torch.utils.config import load

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_kitti_360.yaml"))["dataset"]
    conf.update(type="KITTI_360_v2", data_path=root, pose_path=os.path.join(root, "data_poses"), data_fc=4,
                split_path=None, data_segmentation=False)
    train, _ = make_datasets(conf)
    overlaps, shapes, ok = [], [], True
    for i in (0, 41):
        train._rng_local.rng = np.random.RandomState(i)
        t0 = time.perf_counter()
        item = train[2 * i]
        ms = (time.perf_counter() - t0) * 1e3
        ok &= item["imgs"].shape == (4, 3, H, W) and all(np.isfinite(item[k]).all() for k in ("imgs", "poses"))
        overlaps.append([round(estimate_frustum_overlap(item["projs"][v], item["poses"][v], item["projs"][0],
                                                        item["poses"][0]), 4) for v in range(1, 4)])
        shapes.append((list(item["imgs"].shape), [int(t) for t in item["ts"]], round(ms, 1)))
    ssc = SSCBenchDataset(data_path=root, sequences=(KITTI_SEQ,), load_fisheye=True)
    for i in (50,):
        item = ssc[i]
        ok &= item["imgs"].shape == (3, 3, H, W) and all(np.isfinite(item[k]).all() for k in ("imgs", "poses"))
        shapes.append(list(item["imgs"].shape))
    print(f"phase 10e layouts (host): type KITTI_360_v2 ({len(train)} datapoints of the full split), 2 items of 4 "
          f"frames through the cache (shape, timesteps, ms): {shapes[:2]}, each frame's overlap with the encoder "
          f"camera {overlaps}; SSCBenchDataset(load_fisheye=True) item 50 (raw fisheyes): {shapes[2:]}; shapes and "
          f"finite values: {ok}",
          flush=True)
    if not ok:
        fail("a KITTI_360_v2 or SSCBench fisheye item has the wrong shape or a non-finite value")


def phase_kitti(seed, scratch):
    """Phase 10: the KITTI-360 data path (10a-10e). Returns the launches of
    10b, 10c and 10d together, K1 at the forward shapes they gave it that
    phase 2 does not time, and the tree's root (phase 11c reads it)."""
    from scenedino_torch.utils.timing import card_line

    t_phase = time.perf_counter()
    root, loader_ms = phase_kitti_tree(seed, scratch)
    with k1_batches() as seen:
        s1_counts, s1_dir, step_ms = phase_kitti_stage1(root, scratch)
        s2_counts, s2_dir = phase_kitti_stage2(root, s1_dir, scratch)
        ev_counts, _ = phase_kitti_eval(root, s2_dir, scratch)
    phase_kitti_layouts(root)
    # K1 at the forward shapes phase 2 does not time: 8 views give the teacher 16 frames a step
    gen = torch.Generator(device="cuda").manual_seed(seed + 110)
    new_shapes = [k1_forward_shape(gen, B, lse, "KITTI-360 path", "phase 10") for B, lse in sorted(seen)
                  if (B, lse) not in K1_PHASE2_SHAPES]
    wait = [round(d / (s + d), 3) for s, d in step_ms]
    print(f"phase 10 loader against the step: an item {loader_ms['cached_item']:.1f} ms through the cache "
          f"({loader_ms['raw_item']:.1f} ms raw), a batch of 4 {loader_ms['batch_of_4']:.1f} ms; stage-1 steps' host "
          f"ms {[round(s, 1) for s, _ in step_ms]} after loader waits of {[round(d, 1) for _, d in step_ms]}: the "
          f"wait's share of each step's wall {wait}; {card_line()}; "
          f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: s1_counts[k] + s2_counts[k] + ev_counts[k] for k in s1_counts}, new_shapes, root


def k1_d80_shape(gen, B, N, Hh):
    """Phase 11a at one shape (B, N, Hh, 80) bf16: the forward without and
    with the log-sum-exp, dq and dkv against the plain versions, two
    launches bitwise equal; kernel, plain, SDPA and bound times."""
    from scenedino_torch.kernels.attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        attention_fwd,
        attention_lse_plain,
        attention_plain,
    )
    from scenedino_torch.utils.timing import device_ms, time_ms

    D = 80
    shape = (B, N, Hh, D)
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    out = attention_fwd(q, k, v)[0]
    out_l, lse = attention_fwd(q, k, v, with_lse=True)
    dq, di = attention_bwd_dq(q, k, v, out_l, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    again = (attention_fwd(q, k, v)[0], attention_bwd_dq(q, k, v, out_l, do, lse)[0],
             *attention_bwd_dkv(q, k, v, do, lse, di))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((out, dq, dk, dv), again)) or not torch.equal(out, out_l):
        fail(f"K1 at D = 80 {shape}: two launches on the same inputs differ")
    err = (out.float() - attention_plain(q, k, v).float()).abs().max().item()
    lse_err = (lse - attention_lse_plain(q, k)).abs().max().item()
    if not (torch.isfinite(out).all() and err <= K1_TOL and lse_err <= K1_LSE_TOL):
        fail(f"K1 forward at D = 80 {shape} disagrees with its plain version: max abs err {err} (bound {K1_TOL}), "
             f"lse {lse_err} (bound {K1_LSE_TOL})")
    errs, bounds = [], []
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), attention_bwd_plain(q, k, v, out_l, do, lse)):
        errs.append((got.float() - r.float()).abs().max().item())
        bounds.append(K1_BWD_REL * r.float().abs().max().item() + 1e-3)
        if not (torch.isfinite(got).all() and errs[-1] <= bounds[-1]):
            fail(f"K1 backward {name} at D = 80 {shape} disagrees with the plain backward: max abs err "
                 f"{errs[-1]} > {bounds[-1]}")
    ms = time_ms(lambda: attention_fwd(q, k, v), inner=10)
    ms_lse = time_ms(lambda: attention_fwd(q, k, v, with_lse=True), inner=10)
    ms_dq = time_ms(lambda: attention_bwd_dq(q, k, v, out_l, do, lse), inner=10)
    ms_dkv = time_ms(lambda: attention_bwd_dkv(q, k, v, do, lse, di), inner=10)
    plain_ms = time_ms(lambda: attention_plain(q, k, v), reps=5)
    plain_bwd_ms = time_ms(lambda: attention_bwd_plain(q, k, v, out_l, do, lse), reps=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), inner=10)
    # the same call's kernels alone (torch.profiler): a small backward's CUDA-event time is the host's autograd
    lib_bwd_dev_ms = device_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True))
    bwd_dev_ms = device_ms(lambda: (attention_bwd_dq(q, k, v, out_l, do, lse),
                                    attention_bwd_dkv(q, k, v, do, lse, di)))
    unit = 2.0 * B * Hh * N * N * D  # one N x N x D product
    t_bytes, s_bytes = B * N * Hh * D * 2, B * Hh * N * 4
    b_fwd, by_fwd = bound_ms(2 * unit, 4 * t_bytes)  # q k v out
    b_lse, by_lse = bound_ms(2 * unit, 4 * t_bytes + s_bytes)
    b_dq, by_dq = bound_ms(3 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v o dO dq; lse, di
    b_dkv, by_dkv = bound_ms(4 * unit, 6 * t_bytes + 2 * s_bytes)  # q k v dO dk dv; lse, di
    b_bwd, by_bwd = bound_ms(5 * unit, 8 * t_bytes + s_bytes)
    print(f"phase 11a K1 at D = 80 {shape} bf16: max_abs_err forward {err:.3e} (bound {K1_TOL}), lse {lse_err:.3e} "
          f"(bound {K1_LSE_TOL}), dq {errs[0]:.3e} (bound {bounds[0]:.3e}), dk {errs[1]:.3e} (bound "
          f"{bounds[1]:.3e}), dv {errs[2]:.3e} (bound {bounds[2]:.3e}); two launches bitwise equal; kernel forward "
          f"{ms:.4f} ms, with the lse {ms_lse:.4f} ms ({2 * unit / ms_lse / 1e9:.1f} TFLOP/s), dq {ms_dq:.4f} ms, "
          f"dkv {ms_dkv:.4f} ms ({7 * unit / (ms_dq + ms_dkv) / 1e9:.1f} TFLOP/s over their 7 products); plain "
          f"forward {plain_ms:.4f} ms, backward {plain_bwd_ms:.4f} ms; sdpa forward {lib_ms:.4f} ms (the kernel "
          f"takes {ms / lib_ms:.2f} of it), backward {lib_bwd_ms:.4f} ms (dq + dkv take "
          f"{(ms_dq + ms_dkv) / lib_bwd_ms:.2f} of it), its kernels' device time {lib_bwd_dev_ms:.4f} ms (dq + dkv's "
          f"{bwd_dev_ms:.4f} take {bwd_dev_ms / lib_bwd_dev_ms:.2f} of it); bound forward {b_fwd:.4f} ms ({by_fwd}), "
          f"with the lse {b_lse:.4f} ms ({by_lse}), dq {b_dq:.4f} ms ({by_dq}), dkv {b_dkv:.4f} ms ({by_dkv}), the "
          f"whole backward at 10 N^2 D B H FLOP {b_bwd:.4f} ms ({by_bwd})", flush=True)
    return {"shape": list(shape), "max_abs_err": err, "lse_err": lse_err, "bwd_errs": errs, "ms": ms,
            "ms_lse": ms_lse, "ms_dq": ms_dq, "ms_dkv": ms_dkv, "plain_ms": plain_ms, "plain_bwd_ms": plain_bwd_ms,
            "library_ms": lib_ms, "library_bwd_ms": lib_bwd_ms, "library_bwd_device_ms": lib_bwd_dev_ms,
            "bwd_device_ms": bwd_dev_ms, "bound_ms": b_fwd, "bound_by": by_fwd,
            "bound_dq_ms": b_dq, "bound_dq_by": by_dq, "bound_dkv_ms": b_dkv, "bound_dkv_by": by_dkv}


def phase_d80_kernels(gen):
    """Phase 11a: the three D = 80 kernels at `D80_SHAPES`; their entries
    (the forward timed at I-JEPA-H/14's serving shape, the backward at the
    D = 80 training step's)."""
    shapes = [k1_d80_shape(gen, *shape) for shape in D80_SHAPES]
    fwd, bwd = shapes[0], shapes[-1]
    route = {"route": "cuda", "shapes": shapes}
    bwd_source = {"source": "scenedino_torch/csrc/attention_d80_bwd.cu", **route}
    return [
        {"name": "attention_d80", "replaces": "scenedino_tpu/models/vit.py:126",
         "max_abs_err": max(e["max_abs_err"] for e in shapes),
         **{key: fwd[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "source": "scenedino_torch/csrc/attention_d80.cu", **route},
        {"name": "attention_d80_bwd_dq", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
         "max_abs_err": max(e["bwd_errs"][0] for e in shapes), "ms": bwd["ms_dq"], "plain_ms": bwd["plain_bwd_ms"],
         "bound_ms": bwd["bound_dq_ms"], "bound_by": bwd["bound_dq_by"], "library_ms": bwd["library_bwd_ms"],
         **bwd_source},
        {"name": "attention_d80_bwd_dkv", "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
         "max_abs_err": max(max(e["bwd_errs"][1:]) for e in shapes), "ms": bwd["ms_dkv"],
         "plain_ms": bwd["plain_bwd_ms"], "bound_ms": bwd["bound_dkv_ms"], "bound_by": bwd["bound_dkv_by"],
         "library_ms": bwd["library_bwd_ms"], **bwd_source},
    ]


def ijepa_reference_weights(gen, depth):
    """Seeded I-JEPA-H/14 weights in the published checkpoint's layout
    ("module." + timm names, a 16 x 16 position embedding, no class token,
    the predictor's head keys that the import drops), on the card: matrices
    and kernels ~ N(0, 1/fan_in), norm weights 1, biases and the position
    embedding ~ N(0, 0.02^2)."""
    from scenedino_torch.models.vit import VIT_PRESETS

    cfg = VIT_PRESETS["i_jepa_huge"]
    dim, p = cfg.width, cfg.patch_size

    def randn(*shape, scale):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    raw = {"patch_embed.proj.weight": randn(dim, 3, p, p, scale=(3 * p * p) ** -0.5),
           "patch_embed.proj.bias": randn(dim, scale=0.02), "pos_embed": randn(1, 256, dim, scale=0.02),
           "norm.weight": torch.ones(dim, device="cuda"), "norm.bias": randn(dim, scale=0.02),
           "fc.weight": randn(2, dim, scale=0.02)}
    for i in range(depth):
        for name, shape in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                            ("mlp.fc2", (dim, 4 * dim))):
            raw[f"blocks.{i}.{name}.weight"] = randn(*shape, scale=shape[1] ** -0.5)
            raw[f"blocks.{i}.{name}.bias"] = randn(shape[0], scale=0.02)
        for name in ("norm1", "norm2"):
            raw[f"blocks.{i}.{name}.weight"] = torch.ones(dim, device="cuda")
            raw[f"blocks.{i}.{name}.bias"] = randn(dim, scale=0.02)
    return {f"module.{k}": v for k, v in raw.items()}


def phase_ijepa(seed):
    """Phase 11b, first part: the I-JEPA-H/14 backbone at 192x640 in bf16.
    Returns its launches."""
    from scenedino_torch import kernels
    from scenedino_torch.models.encoder import normalize_input
    from scenedino_torch.models.vit import VIT_PRESETS, make_vit
    from scenedino_torch.utils.convert import convert_ssl_vit
    from scenedino_torch.utils.timing import time_ms

    cfg = VIT_PRESETS["i_jepa_huge"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 111)
    t0 = time.perf_counter()
    state = convert_ssl_vit("i_jepa_huge", ijepa_reference_weights(gen, cfg.depth))
    model = make_vit("i_jepa_huge", dtype=torch.bfloat16).to("cuda").eval()
    model.load_state_dict(state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = normalize_input(torch.rand(1, 3, H, W, generator=gen, device="cuda") * 2 - 1)
    with torch.inference_mode():
        kernels.reset_launches()
        out = model(x)
        torch.cuda.synchronize()
        counts = kernels.launches()
        ms = time_ms(lambda: model(x), reps=5)
    feats = out["features_normalized"]
    n_tokens = (H // cfg.patch_size) * (W // cfg.patch_size)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention_d80": cfg.depth}
    print(f"phase 11b I-JEPA-H/14 ({cfg.depth} blocks, width {cfg.width}, {cfg.num_heads} heads of "
          f"{cfg.width // cfg.num_heads}, patch {cfg.patch_size}, no class token; {sum(v.numel() for v in state.values())} "
          f"parameters) from seeded weights in the reference's layout through convert_ssl_vit in {load_s:.1f} s; the "
          f"192x640 forward in bf16: {n_tokens} tokens, features {tuple(feats.shape)}, {ms:.2f} ms a forward "
          f"(CUDA events); launches {json.dumps(counts)}", flush=True)
    if tuple(feats.shape) != (1, n_tokens, cfg.width) or not torch.isfinite(feats).all():
        fail(f"the I-JEPA-H/14 forward gave {tuple(feats.shape)} or non-finite features")
    if counts != expect:
        fail(f"the I-JEPA-H/14 forward launched {counts}, expected {expect}")

    # its first blocks at 196x518 (518 tokens: the card takes K1) against the same bf16 ViT on the CPU
    depth = IJEPA_CHECK_DEPTH
    small = {k: v for k, v in state.items() if not (k.startswith("blocks.") and int(k.split(".")[1]) >= depth)}
    cut = make_vit("i_jepa_huge", intermediate_layers=(0,), dtype=torch.bfloat16, overrides={"depth": depth})
    cut.load_state_dict(small)
    xs = normalize_input(torch.rand(1, 3, *IJEPA_CHECK_SIZE, generator=gen, device="cuda") * 2 - 1)
    with torch.inference_mode():
        kernels.reset_launches()
        gpu = cut.to("cuda")(xs)["features_normalized"].float().cpu()
        torch.cuda.synchronize()
        small_counts = kernels.launches()
        cpu = cut.cpu()(xs.cpu())["features_normalized"].float()
    cos = torch.nn.functional.cosine_similarity(gpu, cpu, dim=-1).min().item()
    err = (gpu - cpu).abs().max().item()
    print(f"phase 11b I-JEPA-H/14's first {depth} blocks at {IJEPA_CHECK_SIZE[0]}x{IJEPA_CHECK_SIZE[1]} "
          f"({gpu.shape[1]} tokens), GPU (kernels: {small_counts['attention_d80']} D = 80 launches) against the "
          f"CPU (plain), both bf16: least token cosine {cos:.6f} (bound {SLICE_COS}), max abs err {err:.3e}",
          flush=True)
    if small_counts["attention_d80"] != depth or not cos >= SLICE_COS:
        fail("the I-JEPA-H/14 check at 196x518 did not run through the D = 80 kernel or disagrees with the CPU")
    return counts


def phase_train_d80(seed):
    """Phase 11b, second part: the flagship stage-1 step with heads of 80
    (vit_overrides width 960, 12 heads) through trainer.make_train_step.
    Returns its launches."""
    from scenedino_torch import kernels
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN, make_model
    from scenedino_torch.training import trainer

    conf = copy.deepcopy(SCENEDINO_KITTI_360_TRAIN)
    conf["model"]["encoder"]["vit_overrides"] = {"width": D80_TRAIN_WIDTH, "num_heads": 12}
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(conf)
    gen = torch.Generator(device="cuda").manual_seed(seed + 112)
    model = make_model(model_conf, device="cuda", seed=seed, training=True)
    B, depth = D80_TRAIN_B, model.encoder.vit_encoder.vit.cfg.depth
    state = trainer.init_train_state(model, tcfg, artifact_shape=(D80_TRAIN_WIDTH, H // 8, W // 8), generator=gen)
    step = trainer.make_train_step(model, tcfg, rcfg, lcfg)
    batch = train_batch(gen, B, H, W, "cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    kernels.reset_launches()
    losses, ms = [], []
    for _ in range(D80_TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(state, batch, trainer.draw_stage1(gen, tcfg, rcfg, B, 4, H, W, 8))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["rec_loss"]))
    counts = kernels.launches()
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters() if n in before)
    expect = {**{name: 0 for name in kernels.WRAPPERS}, "attention_d80": D80_TRAIN_STEPS * 2 * depth,
              "attention_d80_bwd_dq": D80_TRAIN_STEPS * depth, "attention_d80_bwd_dkv": D80_TRAIN_STEPS * depth}
    print(f"phase 11b stage-1 step with heads of 80 (configs/train_scenedino_kitti_360.yaml's model, vit_overrides "
          f"width {D80_TRAIN_WIDTH}, 12 heads; bf16, 192x640, batch {B}, V = 4): losses {losses}, host ms "
          f"{[round(m, 1) for m in ms]}, {moved} of {len(before)} trainable tensors moved, applied "
          f"{state.applied}; launches {json.dumps(counts)}", flush=True)
    if not (all(np.isfinite(losses)) and state.applied == D80_TRAIN_STEPS and moved == len(before)):
        fail("the D = 80 training steps were not finite and applied, or a parameter did not move")
    if counts != expect:
        fail(f"the D = 80 training steps launched {counts}, expected {expect}")
    return counts


def phase_upsampler(seed, root, scratch):
    """Phase 11c: cli.train.main on configs/train_scenedino_kitti_360_upsampler.yaml
    on phase 10's tree. Returns (its launches, K1 at the forward shapes it
    gave that phases 2 and 10 do not time)."""
    from scenedino_torch import kernels
    from scenedino_torch.cli import train as cli
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.training import trainer
    from scenedino_torch.utils.config import load, save_run_config

    repo = os.path.dirname(os.path.abspath(__file__))
    conf = load(os.path.join(repo, "configs", "train_scenedino_kitti_360_upsampler.yaml"))
    _kitti_dataset_block(conf, root)
    out = tempfile.mkdtemp(prefix="kitti_up_", dir=scratch)
    conf["output"]["path"] = out
    conf["training"].update(stop_iteration=UPSAMPLER_STEPS, checkpoint_every=UPSAMPLER_STEPS, log_every=1)
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = UPSAMPLER_STEPS
    vconf["subset"]["args"] = {"start": 0, "end": UPSAMPLER_VAL_ITEMS}
    path = save_run_config(tempfile.mkdtemp(prefix="kitti_up_config_", dir=scratch), conf)
    model_conf = trainer.configs_from_dict(conf)[0]
    enc = model_conf["encoder"]
    print(f"phase 11c upsample-gt: cli.train.main --config configs/train_scenedino_kitti_360_upsampler.yaml at full "
          f"width ({enc['encoder_arch']} {enc['version']} student and teacher, DPT {enc['decoder_out_dim']}, "
          f"{enc['mode']} with the {enc['upsampler_arch']} teacher, dino_upscaled, compensate_artifacts "
          f"{model_conf['compensate_artifacts']}, with_amp {conf['with_amp']}, batch {conf['batch_size']}, 8 views); "
          f"cuts: the paths -> phase 10's tree and cache, stop_iteration {UPSAMPLER_STEPS}, validation every 5000 -> "
          f"{UPSAMPLER_STEPS} over test items 0-{UPSAMPLER_VAL_ITEMS - 1} (file: 0-127), checkpoint_every 10000 -> "
          f"{UPSAMPLER_STEPS}, log_every 1", flush=True)
    with k1_batches() as seen:
        records, counts, peak, wall = _logged(lambda: cli.main(["--config", path]), ("training", "validation"))
    steps, vals = records.with_attr("losses"), records.with_attr("validator")
    for r in steps:
        print(f"phase 11c step {r.iteration}: loss {r.losses['rec_loss']:.6f} (dino {r.losses['loss_dino_coarse']:.6f}); "
              f"host ms: waiting on the loader {r.data_ms:.1f}, then the step {r.step_ms:.1f}", flush=True)
    for r in vals:
        print(f"phase 11c validation at {r.iteration} ({r.ms:.1f} ms): "
              f"{json.dumps({k: round(float(v), 6) for k, v in r.metrics.items()})}", flush=True)
    depth = 12
    # a step: the teacher's 12 blocks on all 64 views at once, the student's 12, the backward's 12;
    # a validation item: the student's 12 and the teacher's 12 on its 8 views x 4
    expect = {**{name: 0 for name in kernels.WRAPPERS},
              "attention": UPSAMPLER_STEPS * 2 * depth + len(vals) * UPSAMPLER_VAL_ITEMS * 2 * depth,
              "attention_bwd_dq": UPSAMPLER_STEPS * depth, "attention_bwd_dkv": UPSAMPLER_STEPS * depth}
    ckpt_path = os.path.join(out, f"training_checkpoint_{UPSAMPLER_STEPS}.pt")
    fresh = make_model(model_conf, device="cuda", seed=conf.get("seed", 0), training=True)
    field = torch.load(ckpt_path, map_location="cuda", weights_only=True)["field"]
    student = [n for n, p in fresh.named_parameters() if p.requires_grad]
    still = [n for n in student if torch.equal(field[n], fresh.get_parameter(n))]
    print(f"phase 11c run: {len(steps)} steps in {wall:.1f} s wall (model build, data, steps, validation, "
          f"checkpoint); peak memory allocated {peak:.3f} GiB; launches {json.dumps(counts)} (expected "
          f"{json.dumps(expect)}); K1 forward batches seen {sorted(seen)}; {len(student) - len(still)} of "
          f"{len(student)} student tensors moved", flush=True)
    if (len(steps) != UPSAMPLER_STEPS or not _finite(v for r in steps for v in r.losses.values())
            or steps[-1].losses["nonfinite_total"] != 0):
        fail("the upsample-gt run did not take its steps finite and applied")
    if len(vals) != 1 or not _finite(vals[0].metrics.values()) or "dino_cos_sim" not in vals[0].metrics:
        fail("the upsample-gt validation is missing its dino metric, or a metric is not finite")
    if still:
        fail(f"student parameters did not move in the upsample-gt run: {still[:8]}")
    if counts != expect:
        fail(f"the upsample-gt run launched {counts}, expected {expect}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 113)
    timed = {(16, False)} | set(K1_PHASE2_SHAPES)  # phases 2 and 10 time these
    shapes = [k1_forward_shape(gen, B, lse, "upsample-gt recipe", "phase 11c") for B, lse in sorted(seen)
              if (B, lse) not in timed]
    return counts, shapes


def phase_d80_and_upsample_gt(seed, root, scratch):
    """Phase 11b and 11c (11a ran with the other kernel phases). Returns
    their launches together and K1 at the upsample-gt recipe's new shapes."""
    from scenedino_torch.utils.timing import card_line

    t0 = time.perf_counter()
    ijepa = phase_ijepa(seed)
    train = phase_train_d80(seed)
    up, shapes = phase_upsampler(seed, root, scratch)
    print(f"phase 11 wall time (11b and 11c) {time.perf_counter() - t0:.1f} s; {card_line()}", flush=True)
    return {k: ijepa[k] + train[k] + up[k] for k in ijepa}, shapes


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    try:
        from scenedino_torch import kernels
        from scenedino_torch.kernels import build
        from scenedino_torch.tools import bench_attention_bwd, bench_encode_view
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
    # the K1 kernels hold their accumulators in registers: a spill would put them in local memory
    k1 = {("fwd" if "fwd" in entry else "dq" if "bwd_dq" in entry else "dkv"): r
          for name in ("attention", "attention_bwd") for entry, r in build.ptxas_report(build.build_log(name)).items()}
    print(f"phase 1 K1 kernels (forward, backward dq and dkv), registers at launch (a consumer warpgroup then takes "
          f"the producer's, see csrc/attention.cu and attention_bwd.cu) and spills in bytes: {json.dumps(k1)}",
          flush=True)
    if sorted(k1) != ["dkv", "dq", "fwd"] or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                                                 for r in k1.values()):
        fail(f"ptxas spilled in a K1 kernel, or its report is missing: {k1}")
    d80 = {("fwd" if "fwd" in entry else entry): r
           for entry, r in build.ptxas_report(build.build_log("attention_d80")).items()}
    d80.update(bench_attention_bwd.backward_report(build.build_log("attention_d80_bwd")))
    print(f"phase 1 K1 kernels at head dim 80 (csrc/attention_d80.cu: the forward, 128 threads a block; "
          f"csrc/attention_d80_bwd.cu: dq and dkv, registers at launch, then setmaxnreg's split of the producer "
          f"warpgroup and each consumer warpgroup), registers and spills in bytes: {json.dumps(d80)}", flush=True)
    if sorted(d80) != ["dkv", "dq", "fwd"] or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                                                  for r in d80.values()):
        fail(f"ptxas spilled in a D = 80 K1 kernel, or its report is missing: {d80}")
    # the point kernels (K2, K3, K4) in each of their hidden and output widths: mode, DC, EC, ET
    pk = {",".join(re.findall(r"Li(\d+)E", name.split("point_kernel")[-1])): r
          for name, r in build.ptxas_report(build.build_log("point_render")).items() if "point_kernel" in name}
    print(f"phase 1 point kernels by template arguments (mode 0 K2, 1 K3, 2 K4; hidden chunks of 64; output chunks "
          f"of 64; output tail), registers and spills in bytes: {json.dumps(pk)}", flush=True)
    if len(pk) != POINT_KERNELS or any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in pk.values()):
        fail(f"ptxas spilled in a point kernel, or a report is missing ({len(pk)} of {POINT_KERNELS}): {pk}")
    ev = bench_encode_view.ptxas()
    print(f"phase 1 K6 encode_view kernels by template arguments (TF32: 1 for the fp32 state's three passes; "
          f"hidden chunks of 64; output chunks of 64; output tail), registers and spills in bytes: "
          f"{json.dumps(ev)}", flush=True)
    if bench_encode_view.spilled(ev):
        fail(f"ptxas spilled in K6, or a report is missing ({len(ev)} of {bench_encode_view.INSTANTIATIONS}): {ev}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = [phase_k1(gen), *phase_k1_bwd(gen), phase_k2(gen), *phase_probe(gen), phase_k4(gen), phase_k6(gen),
               *phase_d80_kernels(gen)]
    phase_gather(args.seed)
    serving = phase_slice(args.seed)
    training = phase_train(args.seed)
    phase_train_fp32(args.seed)
    # the training phases' run directories (checkpoints of GBs) live and go with one temporary directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as scratch:
        train_run, stage1_dir = phase_train_run(args.seed, scratch)
        stage2, stage2_dir = phase_stage2(args.seed, stage1_dir, scratch)
        stage2_conv = phase_stage2_convergence(args.seed, scratch)
        evaluation, k4_block, k6_frame, trees = phase_eval(args.seed, stage2_dir, scratch)
        reference, holds = phase_reference(args.seed, scratch, *trees)
        kitti, k1_kitti, kitti_root = phase_kitti(args.seed, scratch)
        d80_paths, k1_upsampler = phase_d80_and_upsample_gt(args.seed, kitti_root, scratch)
    paths = (serving, training, train_run, stage2, stage2_conv, evaluation, reference, kitti, d80_paths)
    for e in entries:
        e["launches"] = sum(p[e["name"]] for p in paths)
        if e["name"] == "point_query":
            e["shapes"] = {"SSCBench evaluation block": k4_block}
            e["max_abs_err"] = max(e["max_abs_err"], k4_block["max_abs_err"])
        elif e["name"] == "encode_view":
            e["shapes"]["2D evaluation"] = k6_frame
            e["max_abs_err"] = max(e["max_abs_err"], k6_frame["max_abs_err"])
        if e["name"] == "attention":
            e["shapes"] += [{"path": "KITTI-360", **shape} for shape in k1_kitti]
            e["shapes"] += [{"path": "upsample-gt recipe", **shape} for shape in k1_upsampler]
            e["max_abs_err"] = max([e["max_abs_err"]] + [shape["max_abs_err"] for shape in k1_kitti + k1_upsampler])
        if e["name"] in holds:
            if isinstance(e.get("shapes"), list):
                e["shapes"].append({"path": "reference checkpoints", **holds[e["name"]]})
            else:
                e.setdefault("shapes", {})["reference checkpoints"] = holds[e["name"]]
    if sorted(e["name"] for e in entries) != sorted(kernels.WRAPPERS):
        fail("the kernels line does not list every kernel")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shapes"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e} for e in entries]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
