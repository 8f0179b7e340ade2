"""The probe-serving quality bound on the trained field (counterpart of the
bound of `tests/test_probe_quality_trained.py` and, for the committed
fixture, of `tools/probe_quality_trained.py`):

    python -m scenedino_torch.tools.probe_quality_trained [--device cpu] [--seed N]

The committed stage-1 field `tests/goldens/s1b_field_params.npz` (the run
whose per-bin depth tolerances pass, docs/convergence/README.md) loads into
the port through `utils.convert.load_jax_params` (strict, over
`from_jax_params`; the training-only leaves are skipped). On the last item
of configs/train_synthetic_convergence.yaml's synthetic dataset and a
held-out novel camera, at the 96x192 serving raster, it renders a gold of
128 stratified samples through `render_novel_view_fused` (K2 on the card,
two of its 64-point tiles a ray), as the reference's gold is its fused
renderer, the exact 32-sample render and the probe-guided render at its
defaults, and holds the reference's bound: the probe's
median and 95th-percentile depth error within 3.5x the exact render's
(+1e-6), its median below 0.25, its feature cosine to the gold median
above 0.999 and 5th percentile above 0.99. The state is fp32 on the CPU (the
plain versions) and bf16 on the card (K2 for the gold and the exact
render; K3, the row gather and K2 for the probe). Prints one JSON line; exits 1
outside the bound.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "s1b_field_params.npz")
CONFIG = os.path.join(ROOT, "configs", "train_synthetic_convergence.yaml")
H, W = 96, 192  # the serving raster: the stride-4 probe starves at a smaller one


def probe_errors(device="cpu", seed: int = 0):
    """(the probe render's depth error to the gold, the exact render's, the
    probe's feature cosine to the gold), per pixel, as numpy, and the
    launches of the three renders (name -> count)."""
    from scenedino_torch import kernels
    from scenedino_torch.datasets import make_datasets
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.ops import fast_field as ff
    from scenedino_torch.utils.config import load
    from scenedino_torch.utils.convert import load_jax_params

    device = torch.device(device)
    config = load(CONFIG)
    npz = np.load(GOLDEN)
    model = make_model(config["model"], device=device)
    load_jax_params(model, {k: npz[k] for k in npz.files})
    model.eval().requires_grad_(False)
    train_ds, _ = make_datasets(config["dataset"])
    item = train_ds[len(train_ds) - 1]  # the tail item: outside the validation subset

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    imgs, projs, poses = (t(item[k])[None, :1] for k in ("imgs", "projs", "poses"))
    c, s = np.cos(0.05), np.sin(0.05)
    novel = np.array([[c, 0, s, 0.27], [0, 1, 0, -0.06], [-s, 0, c, 0.6], [0, 0, 0, 1]], np.float32)
    pose, k = t(item["poses"][0] @ novel), t(item["projs"][0])
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16  # the kernels take the bf16 state
    with torch.no_grad():
        fs = ff.build_fast_state(model, model.encode(imgs, projs, poses, ids_encoder=(0,)), compute_dtype=dtype)
        kernels.reset_launches()
        gen = torch.Generator(device=device)
        dg, fg, _ = ff.render_novel_view_fused(fs, model.cfg, pose, k, H, W, generator=gen.manual_seed(seed),
                                               n_coarse=128)
        de, _, _ = ff.render_novel_view_fused(fs, model.cfg, pose, k, H, W, generator=gen.manual_seed(seed + 1),
                                              n_coarse=32)
        dp, fp, _ = ff.render_novel_view_probe(fs, model.cfg, pose, k, H, W, generator=gen.manual_seed(seed + 2))
        counts = kernels.launches()
    dg, de, dp, fg, fp = (x.float().cpu().numpy() for x in (dg, de, dp, fg, fp))
    if not (np.isfinite(dp).all() and np.isfinite(fp).all()):
        raise FloatingPointError("the probe render is not finite")
    cos = (fp * fg).sum(-1) / np.maximum(np.linalg.norm(fp, axis=-1) * np.linalg.norm(fg, axis=-1), 1e-9)
    return np.abs(dp - dg), np.abs(de - dg), cos, counts


def bound(err_p, err_e, cos):
    """The bound's numbers and the list of its clauses that fail
    (tests/test_probe_quality_trained.py:104-110)."""
    stats = {"probe_median": float(np.median(err_p)), "exact_median": float(np.median(err_e)),
             "probe_p95": float(np.percentile(err_p, 95)), "exact_p95": float(np.percentile(err_e, 95)),
             "cos_median": float(np.median(cos)), "cos_p5": float(np.percentile(cos, 5))}
    failed = [name for name, ok in (
        ("median within 3.5x the exact", stats["probe_median"] <= stats["exact_median"] * 3.5 + 1e-6),
        ("p95 within 3.5x the exact", stats["probe_p95"] <= stats["exact_p95"] * 3.5 + 1e-6),
        ("median below 0.25", stats["probe_median"] < 0.25),
        ("cosine median above 0.999", stats["cos_median"] > 0.999),
        ("cosine p5 above 0.99", stats["cos_p5"] > 0.99)) if not ok]
    return stats, failed


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="The probe-serving bound on the committed trained field.")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from scenedino_torch import resolve_device

    err_p, err_e, cos, counts = probe_errors(resolve_device(args.device), args.seed)
    stats, failed = bound(err_p, err_e, cos)
    print(json.dumps({**stats, "failed": failed, "launches": counts}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
