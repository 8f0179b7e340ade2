"""Training from a config file (counterpart of `scenedino_tpu/cli/train.py`).

    python -m scenedino_torch.cli.train --config configs/train_synthetic_flagship.yaml
    python -m scenedino_torch.cli.train --config <config> --device cpu
    python -m scenedino_torch.cli.train --config configs/train_semantic_synthetic_convergence.yaml --stage semantic
    python -m scenedino_torch.cli.train --config configs/train_scenedino_kitti_360.yaml
    python -m scenedino_torch.cli.train --config configs/train_scenedino_kitti_360_upsampler.yaml
    python -m scenedino_torch.cli.train --config configs/train_semantic_kitti_360.yaml --stage semantic
    python -m scenedino_torch.cli.train --config configs/train_scenedino_re10k.yaml

The config is read by `utils.config` (no PyYAML). The run trains on the
GPU unless `--device` names another device; without a GPU it raises
unless `--device cpu` is given. It writes training_config.yaml, the
checkpoints and TensorBoard scalars under `output.path`, validates as the
`validation:` blocks say, and resumes from the newest checkpoint with
`training.continue: true`. Each step's draws come from one
`torch.Generator` on the device seeded from `seed`; the data order from a
numpy RandomState seeded from it, the items loaded by `num_workers` threads
(4 by default). The KITTI-360 recipes read a tree in the release's layout
(`dataset.data_path`, `pose_path`, `split_path`); with `is_preprocessed:
true` run `scenedino_torch.cli.preprocess_kitti_360 resize` on it once
first. The RealEstate10K recipe reads `dataset.data_path`, a
`<split>.pickle` beside `frames_720/<split>/` (`scenedino_torch.cli.process_re10k
process` writes it from the release's camera files).
`gradient_accum_factor` accumulates that many batches a step and
`renderer.sched` ramps the sample counts, as the reference's CLI reads them.

Stage 1 trains data-parallel under `torchrun`, one process a card (NCCL;
with `--device cpu`, gloo), the batch `batch_size` the global one:

    torchrun --nproc_per_node 4 -m scenedino_torch.cli.train --config <config>
    torchrun --nproc_per_node 2 -m scenedino_torch.cli.train --config <config> --device cpu

Each rank loads its slice of every global batch, draws the global step's
draws and keeps its rows, and averages the gradients (`parallel.data_parallel`);
rank 0 alone writes checkpoints, scalars and validations. Stage 2 trains
so too (`torchrun ... --stage semantic`): the ring buffers take every
rank's crops and the ratio losses divide by the global counts
(`training.downstream`), and rank 0 seeds the cluster centres on the
global first batch and gives them to the others.

`--stage nvs` (the default) trains the field (stage 1). `--stage semantic`
distills a frozen field into the semantic head (stage 2, `run_stage2`):
the field comes from `resume_from` (a stage-1 run directory or checkpoint
of the port, a field snapshot, a JAX variables tree saved as a flat
`.npz`, or a `.pt` in the reference's torch layout), the cluster centres
are seeded from the first batch, and each validation writes its pseudo
assignment back into the cluster heads. `downstream.mode: "2d"` trains on
the head's five crops of the rendered map and samples no 3D crops (the
reference's CLI leaves its train config at 3d and samples crops that the
2d head then ignores).
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from scenedino_torch import resolve_device
from scenedino_torch.datasets import make_datasets, with_train_ids
from scenedino_torch.models.factory import make_model
from scenedino_torch.training import trainer
from scenedino_torch.training.loop import LoopConfig, find_latest_checkpoint, fit
from scenedino_torch.training.validation import (
    Validator,
    make_stage1_validator,
    make_stage2_validator,
    make_update_model_fn,
    subset_indices,
)
from scenedino_torch.utils.checkpoint import FIELD_SNAPSHOT, is_field_state, resolve_run_path
from scenedino_torch.utils.config import load, save_run_config
from scenedino_torch.utils.prefetch import ThreadedLoader, device_prefetch, to_device

# the items' keys that go to the device; the rest ("ts", "index", the ragged
# "3d_bboxes" of a KITTI-360 item) stay on the host
TRAIN_KEYS = ("imgs", "poses", "projs")
VAL_KEYS = ("imgs", "poses", "projs", "depths")
SEMANTIC_KEYS = ("imgs", "poses", "projs", "segs")
logger = logging.getLogger("training")


def batch_iterator(dataset, batch_size: int, key_seed: int = 0, shuffle: bool = True, drop_last: bool = True,
                   num_workers: int = 4, rows: slice = slice(None)):
    """A factory of epochs: each call yields one epoch's collated host
    batches, a fresh permutation from one RandomState(key_seed) per epoch,
    loaded by `num_workers` threads; `rows` of each batch of `batch_size`
    (a data-parallel rank's slice)."""
    n = len(dataset)
    rng = np.random.RandomState(key_seed)

    def it():
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - (batch_size - 1 if drop_last else 0)
        plan = [[int(j) for j in order[i:i + batch_size]][rows] for i in range(0, stop, batch_size)]
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


def build_validators(config: dict, dataset, keys: Sequence[str], device, make) -> Optional[Dict[str, Validator]]:
    """`validation:` blocks -> {name: make(name, block, batches_fn)}; each
    validator's batch size is its own `batch_size` (1 by default)."""
    vconf_all = config.get("validation") or {}
    if not vconf_all:
        return None
    validators = {}
    for name, vconf in vconf_all.items():
        idx = subset_indices(vconf.get("subset"), len(dataset), seed=config.get("seed", 0))
        batches_fn = make_val_batches_fn(dataset, idx, vconf.get("batch_size", 1), keys, device)
        validators[name] = make(name, vconf, batches_fn)
    return validators


def init_stage1(config: dict, device, dp=None) -> Tuple:
    """(field, train state, generator, TrainConfig, RenderConfig,
    ReconstructionLossConfig) of a run, before any step: the model from
    `seed`, then the generator seeded from `seed` on the device, the
    artifact field (the teacher's width on its grid; none with
    `compensate_artifacts: false`) drawn from it. Under data parallelism
    (`dp`) every rank takes rank 0's parameters and artifact field."""
    device = resolve_device(device)
    seed = config.get("seed", 0)
    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(config)
    field = make_model(model_conf, device=device, seed=seed, training=True)
    enc = field.encoder
    H, W = model_conf["encoder"].get("image_size", (192, 640))
    gp = enc.gt_patch_size
    generator = torch.Generator(device=device).manual_seed(seed)
    state = trainer.init_train_state(field, tcfg, artifact_shape=(enc.teacher.latent_size, H // gp, W // gp),
                                     generator=generator)
    if dp is not None:
        dp.broadcast_([*field.parameters(), *field.buffers()]
                      + ([state.artifact_field] if state.artifact_field is not None else []))
    return field, state, generator, tcfg, rcfg, lcfg


def run_stage1(config: dict, device=None, sweep_trial=None):
    """Train stage 1 as `config` says; returns (field, train state). Under
    `torchrun` (WORLD_SIZE > 1) each process trains its share of the
    global batch, data-parallel. `sweep_trial` is a sweep's trial
    (`cli.sweep`), given the best score of the validator
    `training.sweep_validator` ("validation") after each of its passes."""
    from scenedino_torch.parallel.data_parallel import from_environment, local_device

    device = local_device(resolve_device(device))
    dp = from_environment(device)
    try:
        return _run_stage1(config, device, dp, sweep_trial)
    finally:
        if dp is not None:
            torch.distributed.destroy_process_group()


def _run_stage1(config: dict, device, dp, sweep_trial=None):
    field, state, generator, tcfg, rcfg, lcfg = init_stage1(config, device, dp)
    device = generator.device
    train_ds, val_ds = make_datasets(config["dataset"])
    gp, crop_views = field.encoder.gt_patch_size, field.encoder.crop_views
    batch_size = config.get("batch_size", 4)
    mine = slice(None) if dp is None else dp.rows(batch_size)

    def make_step(rc):
        step = trainer.make_train_step(field, tcfg, rc, lcfg, average_gradients=None if dp is None else dp.average_)

        def train_step(state, batch: Dict[str, torch.Tensor], gen: torch.Generator):
            B, V, _, H, W = batch["imgs"].shape
            draws = trainer.draw_stage1(gen, tcfg, rc, B if dp is None else batch_size, V, H, W, gp, crop_views)
            if dp is None:
                return step(state, batch, draws)
            return dp.reduce_losses(step(state, batch, dp.shard_draws(draws, batch_size)))

        return train_step

    sched = config.get("renderer", {}).get("sched") or []
    train_step = trainer.ScheduledTrainStep(make_step, rcfg, sched) if sched else make_step(rcfg)
    batches = batch_iterator(train_ds, batch_size, key_seed=config.get("seed", 0),
                             num_workers=config.get("num_workers", 4), rows=mine)

    def data_iter() -> Iterable[Dict[str, torch.Tensor]]:
        yield from device_prefetch(batches(), put=lambda b: to_device(b, device, TRAIN_KEYS), buffer_size=2)

    tconf = config.get("training", {})
    cfg = _loop_config(config, "out/run", 50, 10000, 100)
    model_conf = trainer.configs_from_dict(config)[0]
    main_process = dp is None or dp.main
    if main_process:
        save_run_config(cfg.output_path, {**config, "model": model_conf})
    validators = build_validators(config, val_ds, VAL_KEYS, device,
                                  lambda name, vconf, fn: make_stage1_validator(name, vconf, field, tcfg, rcfg, fn))
    fit(field, state, train_step, data_iter, cfg, generator, validators=validators if main_process else None,
        steps_per_epoch=tconf.get("epoch_length"), main_process=main_process,
        sync_generator=None if dp is None else dp.sync_generator, sweep_trial=sweep_trial,
        sweep_validator=tconf.get("sweep_validator", "validation"))
    return field, state


def _loop_config(config: dict, default_path: str, default_epochs: int, default_ckpt: int,
                 default_log: int) -> LoopConfig:
    tconf = config.get("training", {})
    return LoopConfig(
        output_path=config.get("output", {}).get("path", default_path),
        num_epochs=tconf.get("num_epochs", default_epochs),
        checkpoint_every=tconf.get("checkpoint_every", default_ckpt),
        log_every=tconf.get("log_every", default_log),
        stop_iteration=tconf.get("stop_iteration"),
        resume=tconf.get("continue", False),
        profile_start=tconf.get("profile_start"),
        profile_stop=tconf.get("profile_stop"),
    )


def load_field(field, resume_from: str) -> str:
    """Load the frozen field of stage 2 from `resume_from`, strictly:
    a port stage-1 run directory (its newest `training_checkpoint_<it>.pt`,
    else a `field_params.pt` snapshot), a `training_checkpoint_<it>.pt`, a
    field snapshot (`utils.checkpoint.save_field_snapshot`), a JAX
    variables tree saved as a flat `.npz` ("params/encoder/..." keys, as
    tests/goldens/s1b_field_params.npz), or a checkpoint in the reference's
    torch layout (its published weights among them; the counterpart of
    converting one, then resuming from the result,
    scenedino_tpu/cli/train.py:296-312). Anything else raises, rather than
    distill a random field. Returns the file read."""
    from scenedino_torch.utils.convert import load_jax_params, reference_checkpoint_of

    path = resolve_run_path(resume_from)
    if path.endswith(".npz"):
        with np.load(path) as z:
            load_jax_params(field, {k: z[k] for k in z.files})
        return path
    device = next(field.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    reference = reference_checkpoint_of(ckpt)
    if reference is not None:
        ckpt = reference.field
    elif isinstance(ckpt, dict) and isinstance(ckpt.get("field"), dict):
        ckpt = ckpt["field"]  # a stage-1 train state
    if not is_field_state(ckpt):
        keys = sorted(ckpt)[:6] if isinstance(ckpt, dict) else type(ckpt).__name__
        raise ValueError(f"resume_from={path!r}: unrecognized checkpoint layout ({keys}); refusing to train the "
                         "semantic head against a random field")
    field.load_state_dict(ckpt)
    return path



def init_stage2(config: dict, device):
    """(field, head, train state, generator, DownstreamTrainConfig,
    RenderConfig, StegoLossConfig) of a stage-2 run before its first step:
    the field from `seed` then `resume_from`, frozen; the head from `seed`
    (a CPU generator, the same weights on every device); the generator on
    the device seeded from `seed`."""
    from scenedino_torch.losses.stego import StegoLossConfig
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.renderer.nerf import RenderConfig
    from scenedino_torch.training.downstream import DownstreamTrainConfig, init_downstream_state

    device = resolve_device(device)
    seed = config.get("seed", 0)
    model_conf = {**config.get("model", {}), "encoder": dict(config.get("model", {}).get("encoder", {}))}
    if config.get("with_amp", False) and not model_conf["encoder"].get("dtype"):
        model_conf["encoder"]["dtype"] = "bfloat16"  # with_amp: the frozen encode in bf16
    field = make_model(model_conf, device=device, seed=seed, training=True)
    if config.get("resume_from"):
        load_field(field, config["resume_from"])
    field.eval().requires_grad_(False)

    head_cfg = SemanticHeadConfig.from_dict(config.get("downstream", {}))
    head = SemanticHead(head_cfg, generator=torch.Generator().manual_seed(seed)).to(device)
    H, W = config["dataset"].get("image_size", (192, 640))
    tconf = config.get("training", {})
    cfg = DownstreamTrainConfig(
        lr=tconf.get("optimizer", {}).get("args", {}).get("lr", 5e-4),
        render_height=H, render_width=W,
        n_samples=head_cfg.patch_sample_size,  # a crop's samples fill one ring-buffer row
        sample_radius=config.get("model", {}).get("sample_radius_3d", 0.5),
        mode=head_cfg.mode,
        use_fast_render=tconf.get("use_fast_render", True),
    )
    rcfg = RenderConfig(n_coarse=config.get("renderer", {}).get("n_coarse", 32))
    generator = torch.Generator(device=device).manual_seed(seed)
    state = init_downstream_state(head, cfg)
    return field, head, state, generator, cfg, rcfg, StegoLossConfig.from_dict(tconf.get("loss"))


def run_stage2(config: dict, device=None, sweep_trial=None):
    """Train stage 2 as `config` says (the reference's run_stage2,
    cli/train.py:257-452); returns (field, head, train state). Under
    `torchrun` (WORLD_SIZE > 1) each process trains its share of the global
    batch, data-parallel. `sweep_trial` as `run_stage1` takes it."""
    from scenedino_torch.parallel.data_parallel import from_environment, local_device

    device = local_device(resolve_device(device))
    dp = from_environment(device)
    try:
        return _run_stage2(config, device, dp, sweep_trial)
    finally:
        if dp is not None:
            torch.distributed.destroy_process_group()


def _run_stage2(config: dict, device, dp, sweep_trial=None):
    from scenedino_torch.training.downstream import (
        draw_seed,
        draw_stage2,
        make_downstream_train_step,
        seed_cluster_centers_everywhere,
        shard_stage2_draws,
    )
    from scenedino_torch.utils.checkpoint import save_field_snapshot

    field, head, state, generator, cfg, rcfg, loss_cfg = init_stage2(config, device)
    device = generator.device
    # KITTI-360 labels as train ids, as the reference's head takes them (datasets.TrainIdSegs)
    train_ds, val_ds = (with_train_ids(ds, config["dataset"]) for ds in make_datasets(config["dataset"]))
    batch_size = config.get("batch_size", 1)
    mine = slice(None) if dp is None else dp.rows(batch_size)
    main_process = dp is None or dp.main

    # the cluster centres from the global first batch (semantic_head.py:329-348)
    init_type = config.get("downstream", {}).get("cluster_init", "kmeans++")
    num_workers = config.get("num_workers", 4)
    seed_draws = draw_seed(generator, cfg, head.cfg, rcfg, batch_size, init_type)
    t0 = time.perf_counter()
    seed_cluster_centers_everywhere(
        field, head, lambda: to_device(next(iter(batch_iterator(train_ds, batch_size, num_workers=num_workers)())),
                                       device, SEMANTIC_KEYS), seed_draws, cfg, rcfg, dp)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seed_ms = (time.perf_counter() - t0) * 1e3
    logger.info("cluster centres seeded (%s) in %.1f ms", init_type, seed_ms, extra={"seed_ms": seed_ms})

    step = make_downstream_train_step(field, head, cfg, rcfg, loss_cfg, dp=dp)

    def train_step(state, batch: Dict[str, torch.Tensor], gen: torch.Generator):
        V = batch["imgs"].shape[1]
        if dp is None:
            return step(state, batch, draw_stage2(gen, cfg, head.cfg, rcfg, batch["imgs"].shape[0], V))
        draws = shard_stage2_draws(draw_stage2(gen, cfg, head.cfg, rcfg, batch_size, V), dp, batch_size, head, cfg)
        return dp.reduce_losses(step(state, batch, draws))

    batches = batch_iterator(train_ds, batch_size, key_seed=config.get("seed", 0), num_workers=num_workers,
                             rows=mine)

    def data_iter() -> Iterable[Dict[str, torch.Tensor]]:
        yield from device_prefetch(batches(), put=lambda b: to_device(b, device, SEMANTIC_KEYS), buffer_size=2)

    loop_cfg = _loop_config(config, "out/semantic", 10, 5000, 100)
    validators = None
    if main_process:
        save_run_config(loop_cfg.output_path, config)
        save_field_snapshot(os.path.join(loop_cfg.output_path, FIELD_SNAPSHOT), field)
        validators = build_validators(
            config, val_ds or train_ds, SEMANTIC_KEYS, device,
            lambda name, vconf, fn: make_stage2_validator(name, vconf, field, head, cfg, rcfg, fn))
    fit(head, state, train_step, data_iter, loop_cfg, generator, validators=validators,
        steps_per_epoch=config.get("training", {}).get("epoch_length"),
        update_model_fn=make_update_model_fn() if validators else None, main_process=main_process,
        sync_generator=None if dp is None else dp.sync_generator, sweep_trial=sweep_trial,
        sweep_validator=config.get("training", {}).get("sweep_validator", "validation"))
    return field, head, state


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Training of the PyTorch port from a YAML config (stage 1 or 2).")
    ap.add_argument("--config", required=True)
    ap.add_argument("--stage", default="nvs", choices=["nvs", "semantic"])
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = load(args.config)
    if args.stage == "nvs":
        run_stage1(config, device=args.device)
    else:
        run_stage2(config, device=args.device)


if __name__ == "__main__":
    main()
