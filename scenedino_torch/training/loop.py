"""The training loop (counterpart of `scenedino_tpu/training/loop.py`):
steps, logging, periodic and best-metric checkpoints, validation, resume,
the non-finite policy, the model-update hook and a profiler window.

`fit` drives `train_step(state, batch, generator) -> losses`, which updates
the trained module (stage 1's field, stage 2's semantic head) and `state`
in place; a `train_step` with `for_iteration(it)` (the sample-count
schedule, `trainer.ScheduledTrainStep`) gives the step of each iteration.
Checkpoints are `utils.checkpoint` files named as the reference names its
directories: `training_checkpoint_<it>.pt` (the newest one kept)
and `<metric>_best_<it>.pt` (one per metric). Log records carry their
numbers as attributes (`losses`, `data_ms`, `step_ms` of a step, where
step_ms counts the steps since the last log up to their losses on the
host; `validator`, `metrics` (scalars), `arrays` (the other values but
the "images" panels, which go to TensorBoard), `ms` of a validation;
`checkpoint`, `ms` of a write) for a caller that reads them.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from scenedino_torch.utils.checkpoint import load_checkpoint, save_checkpoint

logger = logging.getLogger("training")


@dataclasses.dataclass
class LoopConfig:
    output_path: str = "out/run"
    num_epochs: int = 50
    checkpoint_every: int = 10000
    log_every: int = 100
    validate_every: int = 10000
    stop_iteration: Optional[int] = None
    resume: bool = False
    # a torch.profiler trace of iterations [profile_start, profile_stop)
    # into <output_path>/profile
    profile_start: Optional[int] = None
    profile_stop: Optional[int] = None


class MetricLogger:
    """TensorBoard scalars through `torch.utils.tensorboard`; writes nothing
    when it cannot be imported (it needs the tensorboard package)."""

    def __init__(self, logdir: Optional[str]):
        self.writer = None
        if logdir is None:  # writes nothing
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.warning("torch.utils.tensorboard unavailable; scalar logging disabled")
            return
        self.writer = SummaryWriter(logdir)

    def scalars(self, tag: str, values: Dict[str, Any], step: int):
        if self.writer is None:
            return
        for k, v in values.items():
            try:
                self.writer.add_scalar(f"{tag}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def images(self, tag: str, values: Dict[str, Any], step: int):
        """(H, W, 3) float panels in [0, 1] (the reference's VisualizationHandler)."""
        if self.writer is None:
            return
        for k, v in values.items():
            self.writer.add_image(f"{tag}/{k}", np.asarray(v), step, dataformats="HWC")

    def close(self):
        if self.writer is not None:
            self.writer.close()


def _numbered(output_path: str, prefix: str):
    """(iteration, path) of the files <prefix><it>.pt in output_path, oldest first."""
    found = []
    for p in Path(output_path).glob(f"{prefix}*.pt"):
        tail = p.name[len(prefix):-3]
        if tail.isdigit():
            found.append((int(tail), p))
    return sorted(found)


def find_latest_checkpoint(output_path: str) -> Optional[str]:
    """The newest `training_checkpoint_<it>.pt` in output_path, or None."""
    ckpts = _numbered(output_path, "training_checkpoint_")
    return str(ckpts[-1][1]) if ckpts else None


def _write_checkpoint(output_path: str, prefix: str, it: int, field, state) -> str:
    """<prefix><it>.pt, then the older files of the prefix removed (n_saved = 1)."""
    path = os.path.join(output_path, f"{prefix}{it}.pt")
    t0 = time.perf_counter()
    save_checkpoint(path, field, state)
    ms = (time.perf_counter() - t0) * 1e3
    for old_it, old in _numbered(output_path, prefix):
        if old_it != it:
            old.unlink()
    logger.info("checkpoint %s written in %.1f ms", path, ms, extra={"checkpoint": path, "ms": ms})
    return path


def _save_best_checkpoint(output_path: str, metric: str, it: int, score: float, field, state) -> None:
    """`<metric>_best_<it>.pt`, one per metric."""
    path = _write_checkpoint(output_path, f"{metric}_best_", it, field, state)
    logger.info("new best %s=%.5f at iter %d -> %s", metric, score, it, path)


def run_validation(field, state, it: int, validators: Dict[str, Any], generator: torch.Generator,
                   tb: MetricLogger, cfg: LoopConfig, best: Dict[str, float], force: bool = False,
                   update_model_fn: Optional[Callable] = None) -> None:
    """Run the validators due at iteration `it`. After each run,
    `update_model_fn(field, state, metrics)` (the pseudo-assignment
    write-back) where its `save_best` asks for it, or for a validator
    without `save_best`; then a best checkpoint where the signed `save_best`
    metric improves, so it holds the written model (base_trainer.py:446-474)."""
    for name, v in validators.items():
        every = getattr(v, "every", None) or cfg.validate_every
        if not force and it % every != 0:
            continue
        t0 = time.perf_counter()
        metrics = v(state, generator)
        ms = (time.perf_counter() - t0) * 1e3
        panels = metrics.get("images", {})
        scalars = {k: m for k, m in metrics.items() if k != "images" and np.ndim(m) == 0}
        arrays = {k: m for k, m in metrics.items() if k != "images" and np.ndim(m) > 0}
        tb.scalars(f"val/{name}", scalars, it)
        tb.images(f"val/{name}", panels, it)
        logger.info("val[%s] iter %d (%.1f ms): %s", name, it, ms, {k: round(float(x), 5) for k, x in scalars.items()},
                    extra={"validator": name, "iteration": it, "metrics": scalars, "arrays": arrays, "ms": ms})
        sb = getattr(v, "save_best", None)
        if update_model_fn is not None and (sb is None or sb.update_model):
            update_model_fn(field, state, metrics)
        if sb is None:
            continue
        if sb.metric not in metrics:
            logger.warning("save_best metric %r missing from validator %s output", sb.metric, name)
            continue
        score = sb.sign * float(metrics[sb.metric])
        if score > best.get(name, -np.inf):
            best[name] = score
            if not sb.dry_run:
                _save_best_checkpoint(cfg.output_path, sb.metric, it, score, field, state)


class TrialPruned(Exception):
    """Aborts a sweep trial (optuna.TrialPruned's stand-in where optuna is
    not installed)."""


def fit(field, state, train_step: Callable, data_iter_fn: Callable[[], Iterable], cfg: LoopConfig,
        generator: torch.Generator, validators: Optional[Dict[str, Any]] = None,
        steps_per_epoch: Optional[int] = None, update_model_fn: Optional[Callable] = None,
        main_process: bool = True, sync_generator: Optional[Callable[[torch.Generator], None]] = None,
        sweep_trial: Optional[Any] = None, sweep_validator: str = "validation"):
    """Run the loop from `state.step` (or the newest checkpoint, with
    `cfg.resume`); returns `state`. `field` is the trained module, the one
    the checkpoints save with `state`.

    Every `log_every` iterations the losses come to the host: a non-finite
    loss ("rec_loss", else "total_loss") raises `FloatingPointError` unless
    the step's update was skipped (`nonfinite_gave_up` is 0), in which case
    it warns and goes on. `update_model_fn` is `run_validation`'s hook.
    A data-parallel rank other than the first passes `main_process=False`:
    it trains and logs, and writes no scalars, checkpoints or validations;
    `sync_generator(generator)`, called after each iteration's validations,
    then gives every rank the first rank's generator, which its validations
    drew from.

    `sweep_trial` (an optuna-style trial of a hyperparameter sweep,
    `cli.sweep`): after each pass of the `sweep_validator` validator it is
    given that validator's best signed `save_best` score so far
    (`report(score, it)`), and where `should_prune()` says so the run ends
    with optuna.TrialPruned, or `TrialPruned` without optuna
    (base_trainer.py:131-134).
    """
    os.makedirs(cfg.output_path, exist_ok=True)
    tb = MetricLogger(os.path.join(cfg.output_path, "tb")) if main_process else MetricLogger(None)
    if not main_process:
        validators = None
    if cfg.resume:
        latest = find_latest_checkpoint(cfg.output_path)
        if latest:
            load_checkpoint(latest, field, state)
            logger.info("resuming from %s at iteration %d", latest, state.step,
                        extra={"resumed_from": latest, "iteration": state.step})
    it = state.step
    best: Dict[str, float] = {}
    t_data = t_step = 0.0
    prof = None
    try:
        for _ in range(cfg.num_epochs):
            t0 = time.perf_counter()
            for batch in data_iter_fn():
                t_data += time.perf_counter() - t0
                t0 = time.perf_counter()
                if cfg.profile_start is not None and it == cfg.profile_start and prof is None:
                    prof = _start_profiler()
                step_fn = train_step.for_iteration(it) if hasattr(train_step, "for_iteration") else train_step
                losses = step_fn(state, batch, generator)
                it += 1
                if prof is not None and cfg.profile_stop is not None and it >= cfg.profile_stop:
                    _stop_profiler(prof, cfg.output_path)
                    prof = None
                log = it % cfg.log_every == 0
                if log:
                    losses = {k: float(v) for k, v in losses.items()}  # waits for the steps since the last log
                t_step += time.perf_counter() - t0
                if log:
                    if not np.isfinite(losses.get("rec_loss", losses.get("total_loss", 0.0))):
                        gave_up = losses.get("nonfinite_gave_up")
                        if gave_up is None or gave_up > 0:
                            raise FloatingPointError(f"non-finite loss at iter {it}: {losses}")
                        logger.warning("non-finite loss at iter %d, update skipped (consecutive=%d total=%d): %s",
                                       it, int(losses["nonfinite_consecutive"]), int(losses["nonfinite_total"]),
                                       losses)
                    data_ms, step_ms = t_data * 1e3, t_step * 1e3
                    tb.scalars("train", losses, it)
                    tb.scalars("timing", {"t_data": t_data, "t_step": t_step}, it)
                    logger.info("iter %d: %s; data %.1f ms, step %.1f ms", it,
                                {k: round(v, 5) for k, v in losses.items()}, data_ms, step_ms,
                                extra={"iteration": it, "losses": losses, "data_ms": data_ms, "step_ms": step_ms})
                    t_data = t_step = 0.0
                if main_process and it % cfg.checkpoint_every == 0:
                    _write_checkpoint(cfg.output_path, "training_checkpoint_", it, field, state)
                if validators:
                    run_validation(field, state, it, validators, generator, tb, cfg, best,
                                   update_model_fn=update_model_fn)
                    v = validators.get(sweep_validator)
                    due = v is not None and it % (getattr(v, "every", None) or cfg.validate_every) == 0
                    if sweep_trial is not None and due and sweep_validator in best:
                        sweep_trial.report(best[sweep_validator], it)
                        if sweep_trial.should_prune():
                            try:
                                import optuna
                            except ImportError:
                                raise TrialPruned(f"pruned at iter {it}") from None
                            raise optuna.TrialPruned()
                if sync_generator is not None:
                    sync_generator(generator)
                if cfg.stop_iteration and it >= cfg.stop_iteration:
                    logger.info("stop_iteration %d reached", cfg.stop_iteration)
                    return state
                t0 = time.perf_counter()
                if steps_per_epoch and it % steps_per_epoch == 0:
                    break
    finally:
        if prof is not None:
            _stop_profiler(prof, cfg.output_path)
        tb.close()
    return state


def _start_profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof: torch.profiler.profile, output_path: str) -> None:
    prof.stop()
    out = os.path.join(output_path, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    logger.info("profiler trace written to %s", out)
