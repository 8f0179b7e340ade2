"""SSCBench-KITTI-360 voxel evaluation (counterpart of
`scenedino_tpu/cli/evaluate_sscbench.py`; reference
`sscbench/evaluate_model_sscbench.py`):

    python -m scenedino_torch.cli.evaluate_sscbench --data <kitti360 root> --voxel-gt <voxel gt dir> \\
        --ckpt <stage-2 run> --config <stage-2 run or yaml> [--prediction-mode stego_kmeans] [--max-frames N]
    python -m scenedino_torch.cli.evaluate_sscbench --data <kitti360 root> --voxel-gt <voxel gt dir> \\
        --ckpt <checkpoint.pt of the reference> [--variant dinov2 | --config <yaml>]

`--ckpt` is anything `utils.checkpoint.load_eval_state` reads with a
head; `--config` rebuilds the trained model, else the `--variant` preset
(`dino`: ViT-B/8, `dinov2`: ViT-B/14; fp32) at 192x640.
`--mode s4c` evaluates the S4C baseline instead (`models.factory.
s4c_baseline_config`: a Monodepth2 encoder, a d_hidden 64 head whose 19
feature channels are class logits) with the field weights of `--ckpt`
(no head): each block's scores are the softmax of the logits, K4 at
d_hidden 64 and 20 outputs on the fast path.

Each frame: encode the front image, query the 256x256x32 voxel grid
through the field and the semantic head, accumulate occupancy and
per-class numbers over the ranges 12.8 / 25.6 / 51.2 m; then the direct
and Hungarian mIoU tables, printed as JSON with the reference's keys. The
fast path (default) is `encode_prefolded` (K1 in the ViT) and K4 over each
block of 524,288 voxel centres, the head on each block's features, and the
alpha-weighted argmax; `--slow` queries the unfolded field in plain torch.
`--pipelined` runs `eval.sscbench.make_pipelined_grid_step`: one step
queries frame N's grid and encodes frame N+1 (the same grids; the
bootstrap encode of frame 0 counts towards `sec_per_frame`).
`--data-parallel` evaluates a group of frames at a time over every
visible card, one frame a card (`eval.sscbench.make_sharded_frame_predictor`);
the frames reach the accumulator in dataset order, so the tables are the
sequential run's. With one device it evaluates in turn, and it takes
precedence over `--pipelined`, as in the reference (`--device cpu` is
one device).
Runs on the GPU unless `--device` names another device; without a GPU it
raises. Each frame's host ms (read, encode, query, accumulation; read,
step, accumulation when pipelined; its group's read and step when
data-parallel) is logged.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from scenedino_torch import resolve_device
from scenedino_torch.parallel.mesh import make_mesh, replicate

N_CLASSES = 19
logger = logging.getLogger("evaluation")


def make_query_fn(field, head, prediction_mode: str, fast: bool):
    """The per-block query (`net.forward(pts, predict_segmentation=True)`,
    bts.py:553-593): (block (1, P, 3), qstate) -> (sigma (1, P), the one-hot
    of the head's label (1, P, 19)). qstate is the frame's `FastFieldState`
    (fast) or `SceneState` (slow). prediction_mode "s4c" (the S4C
    baseline, no head): the scores are the fp32 softmax of the field's 19
    feature channels (reference evaluate_model_sscbench.py:727-731)."""
    from scenedino_torch.ops.fast_field import fast_query_fused

    if prediction_mode == "s4c":
        def probs(logits):
            return torch.softmax(logits.float(), -1)

        def s4c_query_fn(block, qstate):
            if fast:
                sigma, p = fast_query_fused(qstate, field.cfg, block[0], seg_fn=probs)
                return sigma[None], p[None]
            _, _, sigma, logits = field(qstate, block, only_density=True)
            return sigma, probs(logits)

        return s4c_query_fn
    if head is None:
        raise RuntimeError("the checkpoint has no semantic head")

    def one_hot(seg):  # zero rows for labels beyond the 19 classes, as jax.nn.one_hot
        return (seg[..., None] == torch.arange(N_CLASSES, device=seg.device)).float()

    def query_fn(block, qstate):
        if fast:
            sigma, seg = fast_query_fused(qstate, field.cfg, block[0],
                                          seg_fn=lambda d: field.segment_features(d, head, prediction_mode)[1])
            return sigma[None], one_hot(seg[None])
        _, sigma, seg = field.query_segmentation(qstate, block, head, prediction_mode)
        return sigma, one_hot(seg)

    return query_fn


def make_encode_fn(field, fast: bool):
    """Frame -> query state: the poses rebased on the first view, then
    `encode_prefolded` (fast; the folded grid in bf16, as the reference's)
    or `SceneField.encode` (slow)."""
    from scenedino_torch.ops.fast_field import encode_prefolded

    @torch.no_grad()
    def encode(imgs, projs, poses):
        poses = torch.linalg.inv_ex(poses[:, :1]).inverse @ poses
        if fast:
            return encode_prefolded(field, imgs, projs, poses, ids_encoder=(0,), ids_render=(0,))
        return field.encode(imgs, projs, poses, ids_encoder=(0,), ids_render=(0,))

    return encode


def main(argv: Optional[Sequence[str]] = None):
    """Run the evaluation; returns (the printed table, the `SSCAccumulator`)."""
    ap = argparse.ArgumentParser(description="SSCBench-KITTI-360 voxel evaluation of the PyTorch port.")
    ap.add_argument("--data", required=True)
    ap.add_argument("--voxel-gt", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--variant", default="dino", choices=["dino", "dinov2"])
    ap.add_argument("--mode", "-m", default="scenedino", choices=["scenedino", "s4c"])
    ap.add_argument("--resolution", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="input resolution (default: the config's image_size, else 192 640)")
    ap.add_argument("--config", default=None, help="a run directory or YAML to rebuild the trained model from "
                                                   "(default: the --variant preset)")
    ap.add_argument("--prediction-mode", default="stego_kmeans",
                    choices=["stego_kmeans", "direct_linear", "direct_kmeans", "stego_linear"])
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--calib", default=None, help="semantic-KITTI-style calib.txt (default: the release's values)")
    ap.add_argument("--slow", action="store_true", help="query the unfolded field (the reference's path)")
    ap.add_argument("--test-alpha-cutoffs", action="store_true",
                    help="the per-class sigma-cutoff search and the precision/recall tradeoff")
    ap.add_argument("--data-parallel", action="store_true",
                    help="frame-parallel over the cards, one frame a card; one card evaluates the frames in turn")
    ap.add_argument("--pipelined", action="store_true",
                    help="query frame N and encode frame N+1 in one step (the same grids)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.datasets.sscbench import SSCBenchDataset
    from scenedino_torch.eval import sscbench as S
    from scenedino_torch.utils.config import load_run_config

    device = resolve_device(args.device)
    if args.mode == "s4c":  # the S4C baseline through the same grid pipeline
        from scenedino_torch.models.factory import make_model, s4c_baseline_config
        from scenedino_torch.utils.checkpoint import load_eval_state

        if not os.path.exists(args.ckpt):  # no S4C weights ship with the repository
            raise FileNotFoundError(f"no S4C checkpoint at {args.ckpt!r}")
        H, W = args.resolution or (192, 640)
        field, head = make_model(s4c_baseline_config(), device=device), None
        field.load_state_dict(load_eval_state(args.ckpt, device=device)[0])
        field.eval().requires_grad_(False)
    else:
        config = load_run_config(args.config) if args.config else {"variant": args.variant}
        H, W = config.get("dataset", {}).get("image_size", (192, 640))
        if args.resolution is not None:
            H, W = args.resolution
        field, head = eval_model(config, args.ckpt, device, (H, W))
    prediction_mode = "s4c" if args.mode == "s4c" else args.prediction_mode
    dataset = SSCBenchDataset(data_path=args.data, voxel_gt_path=args.voxel_gt, target_image_size=(H, W))

    calib = S.read_calib(args.calib)
    pts, fov_mask = S.generate_point_grid(calib=calib)
    fov3 = fov_mask.reshape(256, 256, 32)
    pts = torch.from_numpy(pts).to(device)
    fast = not args.slow
    encode = make_encode_fn(field, fast)
    predict = S.make_grid_predictor(make_query_fn(field, head, prediction_mode, fast), coherent=fast)

    acc = S.SSCAccumulator()
    diag = S.SigmaDiagnostics() if args.test_alpha_cutoffs else None
    n = len(dataset) if args.max_frames is None else min(args.max_frames, len(dataset))
    t_total = 0.0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def frame_inputs(i):
        sample = dataset[i]
        return sample, tuple(torch.from_numpy(sample[k])[None].to(device) for k in ("imgs", "projs", "poses"))

    def sequential():
        """(sample, sigmas, segs, timed seconds, host ms) of each frame in turn."""
        pipelined = args.pipelined and n > 1
        if pipelined:
            step = S.make_pipelined_grid_step(encode, predict)
            cur = frame_inputs(0)
            sync()
            t1 = time.perf_counter()
            qstate = encode(*cur[1])  # the bootstrap encode is the run's cost too
            sync()
            boot = time.perf_counter() - t1
        for i in range(n):
            t0 = time.perf_counter()
            if pipelined:
                # feed frame i + 1 (the last step re-feeds frame i, its encode unused); the grids are frame i's
                sample = cur[0]
                cur = frame_inputs(i + 1) if i + 1 < n else cur
                sync()
                t1 = time.perf_counter()
                with torch.no_grad():
                    qstate, (sigmas, segs) = step(qstate, pts, *cur[1])
                    sigmas, segs = sigmas.cpu().numpy(), segs.cpu().numpy()
                t3 = time.perf_counter()
                ms = {"read_ms": (t1 - t0) * 1e3, "step_ms": (t3 - t1) * 1e3}
            else:
                sample, (imgs, projs, poses) = frame_inputs(i)
                sync()
                t1 = time.perf_counter()
                with torch.no_grad():
                    qstate = encode(imgs, projs, poses)
                    sync()
                    t2 = time.perf_counter()
                    sigmas, segs = predict(pts, qstate)
                    sigmas, segs = sigmas.cpu().numpy(), segs.cpu().numpy()
                t3 = time.perf_counter()
                ms = {"read_ms": (t1 - t0) * 1e3, "encode_ms": (t2 - t1) * 1e3, "query_ms": (t3 - t2) * 1e3}
            yield sample, sigmas, segs, t3 - t1 + (boot if pipelined and i == 0 else 0.0), ms

    def frame_parallel(devices):
        """The same, a group of frames a step, frame j of a group on device j
        (exact); a group's step time is its first frame's."""
        fields = replicate(field, devices)
        heads = replicate(head, devices) if head is not None else dict.fromkeys(fields)

        def frame_fns(d):
            return (make_encode_fn(fields[d], fast),
                    S.make_grid_predictor(make_query_fn(fields[d], heads[d], prediction_mode, fast),
                                          coherent=fast))

        step = S.make_sharded_frame_predictor(frame_fns, devices)
        for g0 in range(0, n, len(devices)):
            t0 = time.perf_counter()
            samples = [dataset[i] for i in range(g0, min(g0 + len(devices), n))]
            inputs = [torch.from_numpy(np.stack([s[k] for s in samples])) for k in ("imgs", "projs", "poses")]
            t1 = time.perf_counter()
            with torch.no_grad():
                sigmas, segs = (t.cpu().numpy() for t in step(pts, *inputs))
            t3 = time.perf_counter()
            ms = {"read_ms": (t1 - t0) * 1e3, "group_step_ms": (t3 - t1) * 1e3}
            for j, sample in enumerate(samples):
                yield sample, sigmas[j], segs[j], (t3 - t1) if j == 0 else 0.0, ms

    devices = make_mesh(device=device) if args.data_parallel else [device]
    for i, (sample, sigmas, segs, seconds, ms) in enumerate(
            frame_parallel(devices) if len(devices) > 1 else sequential()):
        t3 = time.perf_counter()
        acc.add_frame(sigmas, segs, sample["voxel_gt"], fov3)
        if diag is not None:
            diag.add_frame(sigmas, segs, sample["voxel_gt"], fov3)
        t_total += seconds
        ms = {**ms, "accumulate_ms": (time.perf_counter() - t3) * 1e3}
        logger.info("frame %d/%d: %s", i + 1, n, ", ".join(f"{k} {v:.1f}" for k, v in ms.items()),
                    extra={"frame": i, **ms})
        if (i + 1) % 50 == 0:
            part = acc.summarize()[51.2]
            logger.info("frame %d/%d occIoU %.3f mIoU %.3f (%.2f s/frame)", i + 1, n, part["occ_iou"],
                        part["hungarian_miou"], t_total / (i + 1))

    results = acc.summarize()
    table = {str(size): {k: r[k] for k in ("occ_iou", "direct_miou", "hungarian_miou")}
             for size, r in results.items()}
    table["sec_per_frame"] = t_total / max(n, 1)
    if diag is not None:
        table["best_alpha_cutoffs"] = {str(k): v for k, v in diag.best_cutoffs().items()}
        table["sigma_tradeoff"] = [{"sigma": s_, "precision": p_, "recall": r_, "iou": i_}
                                   for s_, p_, r_, i_ in diag.tradeoff_curve()]
    print(json.dumps(table, indent=2))
    return table, acc


if __name__ == "__main__":
    main()
