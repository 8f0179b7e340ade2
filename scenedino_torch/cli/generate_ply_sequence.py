"""Per-frame voxel PLY sequence export (counterpart of
`scenedino_tpu/cli/generate_ply_sequence.py`; reference
`sscbench/generate_ply_sequence.py`):

    python -m scenedino_torch.cli.generate_ply_sequence --data <kitti360 root> --ckpt <stage-2 run or .pt> \\
        --out <dir> [--config <run dir or yaml>] [--voxel-size 0.1] [--sigma-cutoff 0.25] \\
        [--sizes 12.8 25.6 51.2] [--ids 10 20 30] [--max-frames N] [--slow | --pipelined] [--device cpu]

Per frame: encode the front image, query a voxel grid (0.1 m by default)
over SSCBench's 51.2 x 51.2 x 6.4 m through the field and the semantic
head with the alpha-weighted argmax and no max-pool growth, keep sigma >
--sigma-cutoff, the field of view (unless --no-fov-only) and the visible
voxels (`eval.sscbench.remove_invisible`), and write one class-coloured
cube-mesh PLY per size into `<out>/<int(size)>/<frame:06d>.ply`: the
first size / voxel voxels in depth, as many centred laterally, and every
height, the crop's world origin shifted by its lateral start.

The fast path (default) is `encode_prefolded` (K1 in the ViT) and K4 over
blocks of 524,288 voxel centres (the grid padded with its first centre to
whole blocks), the head on each block's features; `--slow` queries the
unfolded field in plain torch; `--pipelined` runs
`eval.sscbench.make_pipelined_grid_step` (the same grids). `--config`
rebuilds the trained model, else the `--variant` preset. Runs on the GPU
unless `--device` names another device; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from scenedino_torch import resolve_device

CHUNK = 128 * 128 * 32  # voxel centres a query block takes
logger = logging.getLogger("ply_sequence")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Write the sequence; returns {"paths": written files in order,
    "frame_ms": each frame's host ms, "sec_per_frame": the run's mean
    (with the bootstrap encode when pipelined)}."""
    ap = argparse.ArgumentParser(description="Per-frame voxel PLY sequence of the PyTorch port.")
    ap.add_argument("--data", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--variant", default="dino", choices=["dino", "dinov2"])
    ap.add_argument("--prediction-mode", default="stego_kmeans",
                    choices=["stego_kmeans", "direct_linear", "direct_kmeans", "stego_linear"])
    ap.add_argument("--voxel-size", type=float, default=0.1)
    ap.add_argument("--sigma-cutoff", type=float, default=0.25)
    ap.add_argument("--sizes", type=float, nargs="+", default=[12.8, 25.6, 51.2])
    ap.add_argument("--fov-only", action="store_true", default=True)
    ap.add_argument("--no-fov-only", dest="fov_only", action="store_false")
    ap.add_argument("--ids", type=int, nargs="*", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--calib", default=None, help="semantic-KITTI-style calib.txt (default: the release's values)")
    ap.add_argument("--slow", action="store_true", help="query the unfolded field (the reference's path)")
    ap.add_argument("--pipelined", action="store_true",
                    help="query frame N and encode frame N+1 in one step (the same grids)")
    ap.add_argument("--config", default=None, help="a run directory or YAML to rebuild the trained model from "
                                                   "(default: the --variant preset)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.cli.evaluate_sscbench import make_encode_fn, make_query_fn
    from scenedino_torch.datasets.labels import TRAIN_CLASS_COLORS
    from scenedino_torch.datasets.sscbench import SSCBenchDataset
    from scenedino_torch.eval import sscbench as S
    from scenedino_torch.eval.voxel_io import save_as_voxel_ply
    from scenedino_torch.utils.config import load_run_config

    device = resolve_device(args.device)
    config = load_run_config(args.config) if args.config else {"variant": args.variant}
    img_size = tuple(config.get("dataset", {}).get("image_size", (192, 640)))
    field, head = eval_model(config, args.ckpt, device, img_size)
    dataset = SSCBenchDataset(data_path=args.data, voxel_gt_path=None, target_image_size=img_size)

    vs = args.voxel_size
    pts, fov_mask = S.generate_point_grid(voxel_size=vs, calib=S.read_calib(args.calib))
    grid_dim = tuple(int(np.ceil(s / vs)) for s in S.SCENE_SIZE)
    fov3 = fov_mask.reshape(grid_dim)
    pts = torch.from_numpy(pts).to(device)
    pad = (-pts.shape[0]) % CHUNK  # whole blocks: the tail repeats the first centre and is dropped
    if pad:
        pts = torch.cat([pts, pts[:1].expand(pad, 3)])
    for size in args.sizes:
        os.makedirs(os.path.join(args.out, str(int(size))), exist_ok=True)

    fast = not args.slow
    encode = make_encode_fn(field, fast)
    predict = S.make_grid_predictor(make_query_fn(field, head, args.prediction_mode, fast), chunk_points=CHUNK,
                                    grow=False, grid_dim=grid_dim, voxel_size=vs)
    ids = list(args.ids) if args.ids is not None else list(range(len(dataset)))
    if args.max_frames:
        ids = ids[:args.max_frames]

    def frame_inputs(i):
        sample = dataset[int(i)]
        return tuple(torch.from_numpy(sample[k])[None].to(device) for k in ("imgs", "projs", "poses"))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_total, paths, frame_ms = 0.0, [], []
    pipelined = args.pipelined and len(ids) > 1
    if pipelined:
        step = S.make_pipelined_grid_step(encode, predict)
        cur = frame_inputs(ids[0])
        sync()
        t0 = time.perf_counter()
        qstate = encode(*cur)  # the bootstrap encode is the run's cost too
        sync()
        t_total += time.perf_counter() - t0
    for count, i in enumerate(ids):
        with torch.no_grad():
            if pipelined:
                # feed the next frame (the last step re-feeds this one, its encode unused); the grids are frame i's
                nxt = frame_inputs(ids[count + 1]) if count + 1 < len(ids) else cur
                sync()
                t0 = time.perf_counter()
                qstate, (sigmas, segs) = step(qstate, pts, *nxt)
                cur = nxt
            else:
                inp = frame_inputs(i)
                sync()
                t0 = time.perf_counter()
                sigmas, segs = predict(pts, encode(*inp))
            sigmas, segs = sigmas.cpu().numpy(), segs.cpu().numpy()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        t_total += frame_ms[-1] / 1e3

        occupied = sigmas > args.sigma_cutoff
        if args.fov_only:
            occupied &= fov3
        occupied = S.remove_invisible(occupied)
        colors = TRAIN_CLASS_COLORS[np.clip(segs, 0, 19)]
        for size in args.sizes:
            nv = int(size / vs)
            y0 = grid_dim[1] // 2 - nv // 2
            sl = np.s_[:nv, y0:y0 + nv, :]
            # the crop's world origin moves by its lateral start (evaluate_model_sscbench.py:447-463)
            origin = (S.VOX_ORIGIN[0], S.VOX_ORIGIN[1] + y0 * vs, S.VOX_ORIGIN[2])
            path = os.path.join(args.out, str(int(size)), f"{int(i):06d}.ply")
            save_as_voxel_ply(path, occupied[sl], origin=origin, voxel_size=vs, colors=colors[sl])
            paths.append(path)
        logger.info("frame %d (%d/%d) %.1f ms, %.2f s/frame", i, count + 1, len(ids), frame_ms[-1],
                    t_total / (count + 1))
    return {"paths": paths, "frame_ms": frame_ms, "sec_per_frame": t_total / max(len(ids), 1)}


if __name__ == "__main__":
    main()
