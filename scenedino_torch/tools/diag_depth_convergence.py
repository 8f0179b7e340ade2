"""Where the depth error of a stage-1 run lives: abs_rel by ground-truth
depth bin and by region (counterpart of `tools/diag_depth_convergence.py`).

    python -m scenedino_torch.tools.diag_depth_convergence out/convergence_s1b [--items 4] [--device cpu]

Loads the newest `training_checkpoint_<it>.pt` of a stage-1 run directory
of the port with the run's own `training_config.yaml` (read by
`utils.config`), renders full-frame depth for the first `--items` training
items with `stage1_eval_forward` at the config's base sample counts,
converts ray distance to camera z, and prints abs_rel by ground-truth
depth bin (mean, median, p90: the median is the tail-robust figure, see
docs/convergence/) and by region (ground, boxes; the sky has no ground
truth). The render's draws come from a generator on the device seeded
with 0. The predictions, ground truth and labels are written to
`<run_dir>/diag_depth.npz`. Runs on the card unless `--device` says
otherwise.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

BINS = (3.0, 6.0, 10.0, 15.0, 20.0, 30.0, 45.0, 80.0)


def abs_rel_table(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray], segs: Sequence[np.ndarray]) -> Dict:
    """{"bins": [(lo, hi, mean, median, p90, n)], "ground" / "box" / "all":
    (mean, median, p90, n)} of |gt - max(pred, 1e-3)| / gt over the pixels
    with ground truth; ground is label 0, boxes labels >= 2."""
    bin_vals: List[List[np.ndarray]] = [[] for _ in range(len(BINS) - 1)]
    regions: Dict[str, List[np.ndarray]] = {"ground": [], "box": []}
    for pred, gt, seg in zip(preds, gts, segs):
        valid = gt > 0
        rel = np.abs(gt - np.clip(pred, 1e-3, None)) / np.maximum(gt, 1e-8)
        for b in range(len(BINS) - 1):
            bin_vals[b].append(rel[valid & (gt >= BINS[b]) & (gt < BINS[b + 1])])
        regions["ground"].append(rel[valid & (seg == 0)])
        regions["box"].append(rel[valid & (seg >= 2)])

    def stats(v: np.ndarray):
        return float(v.mean()), float(np.median(v)), float(np.percentile(v, 90)), int(v.size)

    out: Dict = {"bins": []}
    for b in range(len(BINS) - 1):
        v = np.concatenate(bin_vals[b])
        if v.size:
            out["bins"].append((BINS[b], BINS[b + 1], *stats(v)))
    for name, chunks in regions.items():
        out[name] = stats(np.concatenate(chunks))
    out["all"] = stats(np.concatenate([np.concatenate(c) for c in regions.values()]))
    return out


def predict_depths(field, dataset, tcfg, rcfg, items: int, generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[torch.Tensor]] = None):
    """(z depth of view 0, its ground truth, its labels) of each of the
    first `items` dataset items: `stage1_eval_forward` of the item alone,
    the strata `draws[i]` where given, else drawn from `generator`."""
    from scenedino_torch.core.geometry import distance_to_z
    from scenedino_torch.training.trainer import stage1_eval_forward

    device = next(field.parameters()).device
    preds, gts, segs = [], [], []
    for i in range(items):
        item = dataset[i]
        batch = {k: torch.as_tensor(np.asarray(item[k]))[None].to(device) for k in ("imgs", "poses", "projs")}
        data = stage1_eval_forward(field, batch, tcfg, rcfg, u=None if draws is None else draws[i].to(device),
                                   generator=generator)
        preds.append(distance_to_z(data["depth"], data["projs"])[0, 0].float().cpu().numpy())
        gts.append(np.asarray(item["depths"][0]))
        segs.append(np.asarray(item["segs"][0]))
    return preds, gts, segs


def load_run(run_dir: str, device):
    """(field with the newest checkpoint's weights, TrainConfig, RenderConfig
    at the base sample counts, the training dataset, the checkpoint) of a
    stage-1 run directory."""
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.training import trainer
    from scenedino_torch.training.loop import find_latest_checkpoint
    from scenedino_torch.utils.config import load

    config = load(os.path.join(run_dir, "training_config.yaml"))
    latest = find_latest_checkpoint(run_dir)
    if latest is None:
        raise FileNotFoundError(f"no training_checkpoint_<it>.pt under {run_dir}")
    model_conf, tcfg, rcfg, _ = trainer.configs_from_dict(config)
    field = make_model(model_conf, device=device, training=True)
    field.load_state_dict(torch.load(latest, map_location=device, weights_only=True)["field"])
    field.eval()
    train_ds, _ = make_datasets(config["dataset"])
    return field, tcfg, rcfg, train_ds, latest


def print_table(table: Dict) -> None:
    print("abs_rel by GT-depth bin (the median is the tail-robust figure; the mean is dominated by the sub-Nyquist "
          "near-horizon ground, see docs/convergence/):")
    for lo, hi, mean, med, p90, n in table["bins"]:
        print(f"  [{lo:5.1f}, {hi:5.1f}) m: mean {mean:.4f}  median {med:.4f}  p90 {p90:.4f}   (n={n})")
    for name in ("ground", "box", "all"):
        mean, med, p90, n = table[name]
        print(f"{name:>7}: abs_rel mean {mean:.4f}  median {med:.4f}  p90 {p90:.4f}  (n={n})")


def main(argv: Optional[Sequence[str]] = None) -> int:
    from scenedino_torch import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("--items", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    try:
        field, tcfg, rcfg, dataset, latest = load_run(args.run_dir, device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"checkpoint: {latest}")
    preds, gts, segs = predict_depths(field, dataset, tcfg, rcfg, args.items,
                                      generator=torch.Generator(device=device).manual_seed(0))
    dump = os.path.join(args.run_dir, "diag_depth.npz")
    np.savez(dump, K=dataset.K, **{f"{k}{i}": v for i, (p, g, s) in enumerate(zip(preds, gts, segs))
                                    for k, v in (("pred", p), ("gt", g), ("seg", s))})
    print(f"dumped pred/gt/seg to {dump}")
    print_table(abs_rel_table(preds, gts, segs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
