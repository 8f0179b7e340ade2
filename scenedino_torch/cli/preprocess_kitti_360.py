"""KITTI-360 preprocessing (counterpart of
`scenedino_tpu/cli/preprocess_kitti_360.py`; reference
`datasets/kitti_360/preprocess_kitti_360.py` and
`compute_kitti_360_bbox_split.py`):

    python -m scenedino_torch.cli.preprocess_kitti_360 resize -d <kitti_root> [-r 192 640] [-f 0 -15] [--only_fisheye] [--workers N]
    python -m scenedino_torch.cli.preprocess_kitti_360 bbox-split -d <kitti_root> -o <out_dir> [--offset 20]

`resize` resamples every frame once, as the loader would (the stereo pair
resized, the fisheye pair resampled to the pinhole view through the MEI
model), and writes the cache that `is_preprocessed: true` reads:
`data_2d_raw/<seq>/image_0{0,1}/data_<H>x<W>/<id>.png` and
`image_0{2,3}/data_<H>x<W>_<r0>x<r1>/<id>.png`, with the port's PNG writer.
Each frame's cache holds its own views (fisheye offset 0). A frame whose
perspective cache exists is skipped. `--workers` shares the frames among
that many processes; the files are the same.

`bbox-split` writes train/val/test split files from the 2D-semantics
frame lists: every `offset`-th validation frame is a test frame, and the
hand-picked CUT list of test frames is dropped.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ProcessPoolExecutor
import multiprocessing
from pathlib import Path

import numpy as np

from scenedino_torch.datasets.image_io import write_png

# hand-picked bad test frames (compute_kitti_360_bbox_split.py:7-14)
CUT = [7, 9, 10, 15, 19, 31, 43, 69, 87, 107, 118, 154, 156, 167, 168, 170, 171, 172, 173, 174, 178, 179, 180, 181,
       182, 183, 184, 185, 187, 188, 193, 194, 195, 196, 201, 202, 203, 209, 210, 212, 213, 214, 215, 216, 217, 218,
       219, 220, 221, 222, 224, 225, 226, 229, 230, 231, 234, 235, 236, 237, 238, 256, 257, 258, 267, 278, 283, 293,
       294, 295, 296, 297, 298, 299, 310, 315, 317, 318, 322, 323, 324, 325, 326, 327, 328, 329, 330, 331, 332, 333,
       334, 335, 336, 337, 340, 341, 349, 353, 354, 361, 362, 365, 366, 368, 371, 372, 376, 380, 386, 387, 394, 402,
       403, 404, 411, 414, 415, 416, 420, 438, 441, 448, 452, 456, 473, 474, 475, 476, 477, 478, 479, 480, 481, 482,
       484, 485, 486, 487, 488, 489, 490, 491, 492, 493, 494, 495, 496, 497, 498, 499, 519, 520, 554, 562, 593, 594,
       596]


def to_uint8(img_chw: np.ndarray) -> np.ndarray:
    """A loader view, (3, H, W) in [-1, 1], as (H, W, 3) uint8, truncated as
    the reference converts it (preprocess_kitti_360.py:67-76)."""
    arr = (np.transpose(img_chw, (1, 2, 0)) * 0.5 + 0.5) * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def _resize_dataset(data_path: Path, res, rot):
    from scenedino_torch.datasets.kitti_360 import KITTI360Dataset

    return KITTI360Dataset(data_path=str(data_path), pose_path=str(data_path / "data_poses"), split_path=None,
                           target_image_size=res, frame_count=1, return_stereo=True, return_fisheye=True,
                           fisheye_offset=0, fisheye_rotation=rot, color_aug=False)


def _cache_frames(data_path: Path, res, rot, only_fisheye: bool, indices) -> int:
    """Write the cache of the datapoints `indices` of the resize dataset;
    returns the number of frames written."""
    ds = _resize_dataset(data_path, res, rot)
    n_done = 0
    for i in indices:
        seq, fid, _ = ds._datapoints[i]
        img_id = ds._img_ids[seq][fid]
        raw = data_path / "data_2d_raw" / seq
        dirs = [raw / "image_00" / f"data_{res[0]}x{res[1]}", raw / "image_01" / f"data_{res[0]}x{res[1]}",
                raw / "image_02" / f"data_{res[0]}x{res[1]}_{rot[0]}x{rot[1]}",
                raw / "image_03" / f"data_{res[0]}x{res[1]}_{rot[0]}x{rot[1]}"]
        if (dirs[0] / f"{img_id:010d}.png").exists():
            continue
        imgs = np.asarray(ds[i]["imgs"])
        for d in dirs:
            d.mkdir(exist_ok=True, parents=True)
        for view in (range(2, 4) if only_fisheye else range(4)):
            write_png(dirs[view] / f"{img_id:010d}.png", to_uint8(imgs[view]))
        n_done += 1
        if n_done % 100 == 0:
            print(f"{n_done} frames cached", flush=True)
    return n_done


def run_resize(args):
    data_path = Path(args.data_path)
    res, rot = tuple(args.resolution), tuple(args.fisheye_rotation)
    # each frame's own views, keyed by its own id: the training offsets (10..40)
    # would key a frame's cache to another frame's fisheyes
    ds = _resize_dataset(data_path, res, rot)
    left = [i for i, (_, _, is_right) in enumerate(ds._datapoints) if not is_right]
    workers = max(1, min(args.workers, len(left)))
    if workers == 1:
        n_done = _cache_frames(data_path, res, rot, args.only_fisheye, left)
    else:
        # processes, not threads: the PNG codec and the resampler hold the GIL
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            n_done = sum(pool.map(_cache_frames, *zip(*[(data_path, res, rot, args.only_fisheye, left[w::workers])
                                                         for w in range(workers)])))
    print(f"done: {n_done} frames cached")


def check_integrity(data_path: Path, seq: str, img_id: int) -> bool:
    persp = data_path / "data_2d_raw" / seq / "image_00" / "data_rect" / f"{img_id:010d}.png"
    fish = data_path / "data_2d_raw" / seq / "image_02" / "data_rgb" / f"{img_id:010d}.png"
    return fish.exists() and persp.exists()


def run_bbox_split(args):
    data_path = Path(args.data_path)
    out_path = Path(args.out_path)
    offset = args.offset
    out_path.mkdir(parents=True, exist_ok=True)
    frames = data_path / "data_2d_semantics" / "train"
    train_lines = (frames / "2013_05_28_drive_train_frames.txt").read_text().splitlines()
    val_lines = (frames / "2013_05_28_drive_val_frames.txt").read_text().splitlines()

    def parse(line):
        parts = line.split(" ")[0].split("/")
        return parts[1], int(parts[-1][-14:-4])

    train_files, val_files, test_files = [], [], []
    invalid = 0
    for line in train_lines:
        sequence, img_id = parse(line)
        if not check_integrity(data_path, sequence, img_id):
            invalid += 1
            continue
        train_files.append(f"{sequence} {img_id:010d} l")
        train_files.append(f"{sequence} {img_id:010d} r")
    for i, line in enumerate(val_lines):
        sequence, img_id = parse(line)
        is_test = (i % offset) == 0
        if not check_integrity(data_path, sequence, img_id):
            invalid += 1
            continue
        (test_files if is_test else val_files).append(f"{sequence} {img_id:010d} l")

    print(f"Found: Train={len(train_files)}, Val={len(val_files)}, Test={len(test_files)} test files.")
    print(f"Found: {invalid} invalids.")
    test_files = [s for i, s in enumerate(test_files) if i not in CUT]
    print(f"{len(CUT)} test files removed. {len(test_files)} remaining.")
    (out_path / "train_files.txt").write_text("\n".join(train_files))
    (out_path / "val_files.txt").write_text("\n".join(val_files))
    (out_path / "test_files.txt").write_text("\n".join(test_files))


def main(argv=None):
    ap = argparse.ArgumentParser("KITTI-360 preprocessing")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("resize", help="pre-resample frames to the target resolution")
    p.add_argument("--data_path", "-d", required=True)
    p.add_argument("--resolution", "-r", nargs=2, type=int, default=(192, 640))
    p.add_argument("--fisheye_rotation", "-f", nargs=2, type=int, default=(0, -15))
    p.add_argument("--only_fisheye", "-o", action="store_true")
    p.add_argument("--workers", type=int, default=1, help="processes that share the frames")
    p.set_defaults(fn=run_resize)
    p = sub.add_parser("bbox-split", help="build train/val/test split txts")
    p.add_argument("--data_path", "-d", required=True)
    p.add_argument("--out_path", "-o", required=True)
    p.add_argument("--offset", type=int, default=20)
    p.set_defaults(fn=run_bbox_split)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
