"""2D unsupervised segmentation evaluation (counterpart of
`scenedino_tpu/cli/evaluate.py`; reference `eval.py` with
`unified_evaluator.py`):

    python -m scenedino_torch.cli.evaluate --config configs/evaluate_semantic_cityscapes.yaml --ckpt <stage-2 run>
    python -m scenedino_torch.cli.evaluate --config <run dir or yaml> --ckpt <stage-2 run> --device cpu

`--config` is a YAML file or a run directory holding training_config.yaml
(read by `utils.config`). With a `model:` block the trained model is
rebuilt from it (its `with_amp` encodes in bf16, as the port's training
does), else the `variant:` preset (`dino`, ViT-B/8, the default; `dinov2`,
ViT-B/14) at the dataset's image size. The checkpoint (`--ckpt`, else the
config's `checkpoint:`) is anything `utils.checkpoint.load_eval_state`
reads that holds a head: a stage-2 run of the port, a JAX `.npz`, or a
`.pt` in the reference's torch layout (its published checkpoints). Runs
on the GPU unless `--device` names another device; without a GPU it
raises.
`downstream.apply_crf: true` adds the CRF's "<mode>_crf" rows: the window
CRF, or with `downstream.crf_method: exact` the exact permutohedral CRF on
the host.
`--data-parallel` evaluates a group of frames at a time over every
visible card, one frame a card (`Seg2DEvaluator.run_sharded`: the same
metrics); with one card, or with `--device cpu`, it evaluates in turn.
The KITTI-360 kinds (configs/evaluate_semantic_kitti_360.yaml) score the
test split's view 0 against its labels mapped to the 19 train ids
(`datasets.TrainIdSegs`).
Prints each mode's mIoU, weighted mIoU and accuracy as JSON.
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
from typing import Optional, Sequence, Tuple

import torch

from scenedino_torch import resolve_device
from scenedino_torch.parallel.mesh import make_mesh


def eval_model(config: dict, ckpt: Optional[str], device, image_size=(192, 640)) -> Tuple[torch.nn.Module, Optional[
        torch.nn.Module]]:
    """(field, head or None) for evaluation: the field from the config's
    `model:` block (its training `with_amp` as a bf16 encoder) or the
    `variant:` preset ("dino" or "dinov2") at `image_size`, the head from
    its `downstream:` block (the preset's defaults without a model block, as
    the reference);
    both frozen, in eval mode, with the weights of `ckpt` loaded strictly
    (None: the seeded random weights of a fresh model and head, as the
    demo takes them without a checkpoint)."""
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.models.factory import make_model, variant_config
    from scenedino_torch.utils.checkpoint import load_eval_state

    if "model" in config:
        model_conf = copy.deepcopy(config["model"])
        model_conf["encoder"] = dict(model_conf.get("encoder", {}))
        if config.get("with_amp", False) and not model_conf["encoder"].get("dtype"):
            model_conf["encoder"]["dtype"] = "bfloat16"
        head_cfg = SemanticHeadConfig.from_dict(config.get("downstream", {}))
    else:
        model_conf = variant_config(config.get("variant", "dino"), image_size)
        head_cfg = SemanticHeadConfig()
    field = make_model(model_conf, device=device, training=True)
    head = SemanticHead(head_cfg, generator=torch.Generator().manual_seed(0)).to(device)
    if ckpt is not None:
        field_sd, head_sd = load_eval_state(ckpt, device=device)
        field.load_state_dict(field_sd)
        if head_sd is None:
            head = None
        else:
            head.load_state_dict(head_sd)
    field.eval().requires_grad_(False)
    if head is not None:
        head.eval().requires_grad_(False)
    return field, head


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="2D unsupervised segmentation evaluation of the PyTorch port.")
    ap.add_argument("--config", required=True, help="a YAML file or a run directory")
    ap.add_argument("--ckpt", default=None, help="a stage-2 run directory or checkpoint (default: the config's "
                                                 "`checkpoint:`)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--data-parallel", action="store_true",
                    help="frame-parallel over the cards, one frame a card; one card evaluates the frames in turn")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from scenedino_torch.datasets import make_test_dataset, with_train_ids
    from scenedino_torch.eval.seg2d import Seg2DEvaluator
    from scenedino_torch.utils.config import load_run_config

    device = resolve_device(args.device)
    config = load_run_config(args.config)
    ckpt = args.ckpt or config.get("checkpoint")
    if not ckpt:
        ap.error("--ckpt required (or set `checkpoint:` in the config)")
    dataset = with_train_ids(make_test_dataset(config["dataset"]), config["dataset"])
    H, W = config["dataset"].get("image_size", (192, 640))
    field, head = eval_model(config, ckpt, device, (H, W))
    if head is None:
        raise ValueError(f"{ckpt!r} has no semantic head: 2D segmentation evaluation needs a stage-2 checkpoint")
    evaluator = Seg2DEvaluator(field=field, head=head, image_size=(H, W),
                               n_classes=max(head.cfg.n_classes, head.cfg.gt_classes), apply_crf=head.cfg.apply_crf,
                               crf_method=config.get("downstream", {}).get("crf_method", "window"),
                               seed=config.get("seed", 0))
    devices = make_mesh(device=device) if args.data_parallel else [device]
    if len(devices) > 1:
        results = evaluator.run_sharded(dataset, devices, max_frames=args.max_frames)
    else:
        results = evaluator.run(dataset, max_frames=args.max_frames)
    out = {mode: {k: r[k] for k in ("miou", "weighted_miou", "acc")} for mode, r in results.items()
           if isinstance(r, dict)}
    out["n_frames"] = results["n_frames"]
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
