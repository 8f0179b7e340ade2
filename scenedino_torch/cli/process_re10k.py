"""RealEstate10K preprocessing (counterpart of
`scenedino_tpu/cli/process_re10k.py`; reference
`datasets/realestate10k/process_realestate10k.py`,
`process_mine_split.py` and `download_realestate10k.py`):

    python -m scenedino_torch.cli.process_re10k process -m train -d <re10k_root>
    python -m scenedino_torch.cli.process_re10k mine-split -d <re10k_root> -o <out_dir> -s <pairs_json_dir>
    python -m scenedino_torch.cli.process_re10k download -m train -d <re10k_root> [-o <frames_dir>]

`process` folds the release's per-sequence camera files
(`<root>/<mode>/<seq>.txt`: a URL line, then per frame a microsecond
timestamp, 6 intrinsics and a 3x4 world-to-camera pose) into
`<root>/<mode>.pickle` of {seq: {timestamps, intrinsics, poses}}, skipping
the sequences listed in `failed_videos_<mode>.txt`.

`mine-split` maps the Tulsiani et al. `test_pairs.json` and
`validation_pairs.json` (one JSON object a line) onto `<seq> <row>` lines
of `test_files.txt` and `val_files.txt`, the row found by searchsorted on
`test.pickle`'s timestamps.

`download` writes `<root>/download_manifest_<mode>.json`, the work list of
the fetch (per video its URL, sequences and per frame the ffmpeg seek and
the output path), and stops: fetching the videos is not part of the port.
"""
from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np


def load_seq_data(mode_path: Path, failures_path: Path):
    """{seq: {timestamps, intrinsics, poses}} from the camera files
    (process_realestate10k.py:10-45)."""
    failures = set()
    if failures_path.exists():
        failures = set(line.strip() for line in failures_path.read_text().splitlines())
    skipped = 0
    seq_data = {}
    for seq_file in sorted(mode_path.glob("*.txt")):
        if seq_file.stem in failures:
            skipped += 1
            continue
        raw = np.loadtxt(seq_file, dtype=float, skiprows=1).reshape((-1, 19))
        seq_data[seq_file.stem] = {"timestamps": raw[:, 0].astype(int), "intrinsics": raw[:, 1:7],
                                   "poses": raw[:, 7:].reshape((-1, 3, 4))}
    print(f"Skipped {skipped} sequences because the video download had failed.")
    return seq_data


def run_process(args):
    data_path = Path(args.data_path)
    if args.mode not in ("test", "train"):
        raise ValueError(f"Invalid split mode: {args.mode}")
    data = load_seq_data(data_path / args.mode, data_path / f"failed_videos_{args.mode}.txt")
    with open(data_path / f"{args.mode}.pickle", "wb") as f:
        pickle.dump(data, f)
    print(f"wrote {data_path / (args.mode + '.pickle')} with {len(data)} sequences")


def run_mine_split(args):
    """process_mine_split.py:13-62."""
    data_path, out_path, split_path = Path(args.data_path), Path(args.out_path), Path(args.split_path)
    out_path.mkdir(parents=True, exist_ok=True)
    with open(data_path / "test.pickle", "rb") as f:
        seq_data = pickle.load(f)

    def key_and_row(sample):
        key = sample["sequence_id"]
        if key not in seq_data:
            return None
        timestamp = int(sample["src_img_obj"]["frame_ts"])
        return key, int(np.searchsorted(seq_data[key]["timestamps"], timestamp))

    for mode, split_file in (("val", "validation_pairs.json"), ("test", "test_pairs.json")):
        lines = (split_path / split_file).read_text().splitlines()
        samples = [json.loads(line) for line in lines if line.strip()]
        pairs = [p for p in map(key_and_row, samples) if p is not None]
        print(f"{mode}: {len(samples)} samples, kept {len(pairs)}")
        (out_path / f"{mode}_files.txt").write_text("\n".join(f"{key} {row}" for key, row in pairs))


def _seek_string(timestamp_us: int) -> str:
    """A microsecond timestamp -> ffmpeg's HH:MM:SS.mmm
    (download_realestate10k.py:38-47)."""
    ms = int(timestamp_us / 1000)
    return (f"{int(ms / 3600000):02d}:{int(ms % 3600000 / 60000):02d}:"
            f"{int(ms % 3600000 % 60000 / 1000):02d}.{int(ms % 3600000 % 60000 % 1000):03d}")


def build_download_manifest(mode_path: Path, out_root: Path):
    """The sequences grouped by video URL (the first line of each camera
    file), each frame with its seek and output path
    (download_realestate10k.py:60-102)."""
    videos = {}
    for txt_file in sorted(mode_path.glob("*.txt")):
        lines = txt_file.read_text().splitlines()
        if not lines:
            continue
        url = lines[0].strip()
        timestamps = [int(line.split(" ")[0]) for line in lines[1:] if line.strip()]
        entry = videos.setdefault(url, {"url": url, "sequences": []})
        entry["sequences"].append({
            "name": txt_file.stem,
            "frames": [{"timestamp": t, "seek": _seek_string(t), "out": str(out_root / txt_file.stem / f"{t}.jpg")}
                       for t in timestamps],
        })
    return list(videos.values())


def run_download(args):
    data_path = Path(args.data_path)
    mode_path = data_path / args.mode
    if not mode_path.is_dir():
        raise FileNotFoundError(f"no camera-txt dir at {mode_path}")
    out_root = Path(args.out_path) if args.out_path else data_path / "frames" / args.mode
    manifest = build_download_manifest(mode_path, out_root)
    manifest_path = data_path / f"download_manifest_{args.mode}.json"
    manifest_path.write_text(json.dumps(manifest, indent=1))
    n_seqs = sum(len(v["sequences"]) for v in manifest)
    print(f"wrote {manifest_path}: {len(manifest)} videos / {n_seqs} sequences")
    print("fetching the videos is not part of the port: per video `yt-dlp -f 'bv*[height<=360]' -o <tmp> <url>`, "
          "then per frame `ffmpeg -ss <seek> -i <tmp> -vframes 1 -f image2 <out>`, then the `process` subcommand")


def main(argv=None):
    ap = argparse.ArgumentParser("RealEstate10K preprocessing")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("process", help="fold camera txts into <mode>.pickle")
    p.add_argument("--mode", "-m", required=True)
    p.add_argument("--data_path", "-d", required=True)
    p.set_defaults(fn=run_process)
    p = sub.add_parser("mine-split", help="build val/test split txts from pairs json")
    p.add_argument("--data_path", "-d", required=True)
    p.add_argument("--out_path", "-o", required=True)
    p.add_argument("--split_path", "-s", required=True)
    p.set_defaults(fn=run_mine_split)
    p = sub.add_parser("download", help="write the video download manifest (the fetch is not part of the port)")
    p.add_argument("--mode", "-m", required=True)
    p.add_argument("--data_path", "-d", required=True)
    p.add_argument("--out_path", "-o", default=None)
    p.set_defaults(fn=run_download)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
