"""Stage-1 training from a config file (counterpart of `scenedino_tpu/cli/train.py`).

    python -m scenedino_torch.cli.train --config configs/train_synthetic_flagship.yaml
    python -m scenedino_torch.cli.train --config <config> --device cpu

The config is read by `utils.config` (no PyYAML). The run trains on the
GPU unless `--device` names another device; without a GPU it raises
unless `--device cpu` is given. It writes training_config.yaml, the
checkpoints and TensorBoard scalars under `output.path`, validates as the
`validation:` block says, and resumes from the newest checkpoint with
`training.continue: true`. Each step's draws come from one
`torch.Generator` on the device seeded from `seed`; the data order from a
numpy RandomState seeded from it. One device: the reference's data-parallel
mesh is not ported. `--stage semantic` (stage 2) is not ported yet.
"""
from __future__ import annotations

import argparse
import logging
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from scenedino_torch import resolve_device
from scenedino_torch.datasets import make_datasets
from scenedino_torch.models.factory import make_model
from scenedino_torch.training import trainer
from scenedino_torch.training.loop import LoopConfig, fit
from scenedino_torch.training.validation import Validator, make_stage1_validator, subset_indices
from scenedino_torch.utils.config import load, save_run_config
from scenedino_torch.utils.prefetch import ThreadedLoader, device_prefetch, to_device

TRAIN_KEYS = ("imgs", "poses", "projs")
VAL_KEYS = ("imgs", "poses", "projs", "depths")


def batch_iterator(dataset, batch_size: int, key_seed: int = 0, shuffle: bool = True, drop_last: bool = True,
                   num_workers: int = 4):
    """A factory of epochs: each call yields one epoch's collated host
    batches, a fresh permutation from one RandomState(key_seed) per epoch,
    loaded by `num_workers` threads."""
    n = len(dataset)
    rng = np.random.RandomState(key_seed)

    def it():
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - (batch_size - 1 if drop_last else 0)
        plan = [[int(j) for j in order[i:i + batch_size]] for i in range(0, stop, batch_size)]
        yield from ThreadedLoader(dataset, plan, num_workers=num_workers)

    return it


def make_val_batches_fn(dataset, indices, batch_size: int, keys: Sequence[str], device):
    """Validation batches over `indices` in order (full batches only), as
    tensors on `device`."""
    indices = np.asarray(indices)

    def it():
        for i in range(0, len(indices) - (batch_size - 1), batch_size):
            samples = [dataset[int(j)] for j in indices[i:i + batch_size]]
            yield to_device({k: np.stack([s[k] for s in samples]) for k in keys if k in samples[0]}, device)

    return it


def build_validators(config: dict, dataset, keys: Sequence[str], field, tcfg, rcfg,
                     device) -> Optional[Dict[str, Validator]]:
    """`validation:` blocks -> {name: stage-1 Validator}; each validator's
    batch size is its own `batch_size` (1 by default)."""
    vconf_all = config.get("validation") or {}
    if not vconf_all:
        return None
    validators = {}
    for name, vconf in vconf_all.items():
        idx = subset_indices(vconf.get("subset"), len(dataset), seed=config.get("seed", 0))
        batches_fn = make_val_batches_fn(dataset, idx, vconf.get("batch_size", 1), keys, device)
        validators[name] = make_stage1_validator(name, vconf, field, tcfg, rcfg, batches_fn)
    return validators


def init_stage1(config: dict, device) -> Tuple:
    """(field, train state, generator, TrainConfig, RenderConfig,
    ReconstructionLossConfig) of a run, before any step: the model from
    `seed`, then the generator seeded from `seed` on the device, the
    artifact field drawn from it."""
    device = resolve_device(device)
    seed = config.get("seed", 0)
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(config)
    field = make_model(model_conf, device=device, seed=seed, training=True)
    enc = field.encoder
    H, W = model_conf["encoder"].get("image_size", (192, 640))
    gp = enc.gt_patch_size
    generator = torch.Generator(device=device).manual_seed(seed)
    state = trainer.init_train_state(field, tcfg, artifact_shape=(enc.gt_encoder.latent_size, H // gp, W // gp),
                                     generator=generator)
    return field, state, generator, tcfg, rcfg, lcfg


def run_stage1(config: dict, device=None):
    """Train stage 1 as `config` says; returns (field, train state)."""
    field, state, generator, tcfg, rcfg, lcfg = init_stage1(config, device)
    device = generator.device
    train_ds, val_ds = make_datasets(config["dataset"])
    gp = field.encoder.gt_patch_size
    step = trainer.make_train_step(field, tcfg, rcfg, lcfg)

    def train_step(state, batch: Dict[str, torch.Tensor], gen: torch.Generator):
        B, V, _, H, W = batch["imgs"].shape
        return step(state, batch, trainer.draw_stage1(gen, tcfg, rcfg, B, V, H, W, gp))

    batch_size = config.get("batch_size", 4)
    batches = batch_iterator(train_ds, batch_size, key_seed=config.get("seed", 0),
                             num_workers=config.get("num_workers", 4))

    def data_iter() -> Iterable[Dict[str, torch.Tensor]]:
        yield from device_prefetch(batches(), put=lambda b: to_device(b, device, TRAIN_KEYS), buffer_size=2)

    tconf = config.get("training", {})
    cfg = LoopConfig(
        output_path=config.get("output", {}).get("path", "out/run"),
        num_epochs=tconf.get("num_epochs", 50),
        checkpoint_every=tconf.get("checkpoint_every", 10000),
        log_every=tconf.get("log_every", 100),
        stop_iteration=tconf.get("stop_iteration"),
        resume=tconf.get("continue", False),
        profile_start=tconf.get("profile_start"),
        profile_stop=tconf.get("profile_stop"),
    )
    model_conf = trainer.configs_from_dict(config)[0]
    save_run_config(cfg.output_path, {**config, "model": model_conf})
    validators = build_validators(config, val_ds, VAL_KEYS, field, tcfg, rcfg, device)
    fit(field, state, train_step, data_iter, cfg, generator, validators=validators,
        steps_per_epoch=tconf.get("epoch_length"))
    return field, state


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Stage-1 training of the PyTorch port from a YAML config.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--stage", default="nvs", choices=["nvs", "semantic"])
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = load(args.config)
    if args.stage != "nvs":
        raise NotImplementedError("stage 2 (--stage semantic) is not ported yet")
    run_stage1(config, device=args.device)


if __name__ == "__main__":
    main()
