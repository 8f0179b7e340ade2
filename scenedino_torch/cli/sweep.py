"""Hyperparameter sweep over the training CLI (counterpart of
`scenedino_tpu/cli/sweep.py`; the reference runs optuna studies against
its trainer's trial hook, base_trainer.py:131-134).

    python -m scenedino_torch.cli.sweep --spec sweep.yaml [--backend random|optuna] [--seed 0] [--device cpu]

Two backends:
  * random (the default): uniform or log-uniform draws from
    `random.Random(seed)`, in the spec's parameter order, trial after
    trial, as the JAX package draws them, so one spec and seed give the
    same trials in both packages; a trial is pruned when its running best
    trails the median of the earlier trials' running bests at the same
    iteration (MedianPruner);
  * optuna, where it is installed: a study with a median pruner.

Each trial is a run of `cli.train.run_stage1` (stage nvs) or `run_stage2`
(semantic) on the base config with the drawn values set, its output in
`<output.path>/trial_<i>`, reporting the best score of the validator the
spec's `metric` names after each of its passes.

Spec (YAML, read by `utils.config`):

  base: configs/train_scenedino_kitti_360.yaml
  trials: 8
  stage: nvs                      # nvs | semantic
  metric: validation              # the validator whose best score ranks trials
  params:
    training.optimizer.args.lr: {min: 1.0e-5, max: 1.0e-3, log: true}
    batch_size: [2, 4]            # categorical
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
import math
import random
import statistics
from typing import Optional, Sequence

logger = logging.getLogger("sweep")


def set_by_path(config: dict, dotted: str, value) -> None:
    node = config
    keys = dotted.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def draw(spec, rng: random.Random):
    """A list: one of its items; {min, max[, log]}: a uniform (log-uniform) float."""
    if isinstance(spec, list):
        return rng.choice(spec)
    lo, hi = float(spec["min"]), float(spec["max"])
    if spec.get("log"):
        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    return rng.uniform(lo, hi)


class RandomSearchTrial:
    """The optuna trial protocol of the random backend: prune when this
    trial's latest running best trails the median of the earlier trials'
    running bests at the same step (MedianPruner; their final scores would
    prune nearly every trial at its first validation)."""

    def __init__(self, history):
        self.history = history  # the earlier trials' report lists
        self.reports = []

    def report(self, value, step) -> None:
        self.reports.append((step, float(value)))

    def should_prune(self) -> bool:
        if len(self.history) < 2 or not self.reports:
            return False
        step, value = self.reports[-1]
        peers = [max(vals) for vals in ([v for s, v in h if s <= step] for h in self.history) if vals]
        if len(peers) < 2:
            return False
        return value < statistics.median(peers)

    @property
    def best(self) -> float:
        return max((v for _, v in self.reports), default=float("-inf"))


def run_sweep(spec: dict, backend: str = "random", seed: int = 0, device=None) -> dict:
    """Run the spec's trials on `device` (the train CLI's default: CUDA).
    The random backend returns {"trials": [{trial, status, best, <param>:
    value}], "best": the completed trial with the highest best}; optuna's
    {"best_params", "best_value"}."""
    from scenedino_torch.cli import train
    from scenedino_torch.training.loop import TrialPruned
    from scenedino_torch.utils.config import load

    base = load(spec["base"])
    stage_fn = train.run_stage1 if spec.get("stage", "nvs") == "nvs" else train.run_stage2
    n_trials = int(spec.get("trials", 8))
    params = spec.get("params", {})
    rng = random.Random(seed)

    def one_trial(i, trial, overrides, reraise_pruned=False) -> str:
        config = copy.deepcopy(base)
        for k, v in overrides.items():
            set_by_path(config, k, v)
        set_by_path(config, "training.sweep_validator", spec.get("metric", "validation"))
        out = config.setdefault("output", {})
        out["path"] = f"{out.get('path', 'out/sweep')}/trial_{i:03d}"
        try:
            stage_fn(config, sweep_trial=trial, device=device)
        except Exception as e:
            # optuna records a trial as pruned only if TrialPruned reaches study.optimize
            if not (isinstance(e, TrialPruned) or type(e).__name__ == "TrialPruned") or reraise_pruned:
                raise
            return "pruned"
        return "complete"

    if backend == "optuna":
        import optuna

        class _Recorder:
            """Forwards to the optuna trial and keeps the best reported score
            (the objective optuna maximizes)."""

            def __init__(self, t):
                self.t = t
                self.best = float("-inf")

            def report(self, value, step):
                self.best = max(self.best, float(value))
                self.t.report(value, step)

            def should_prune(self):
                return self.t.should_prune()

        def objective(trial):
            overrides = {}
            for k, p in params.items():
                if isinstance(p, list):
                    overrides[k] = trial.suggest_categorical(k, p)
                else:
                    overrides[k] = trial.suggest_float(k, p["min"], p["max"], log=bool(p.get("log")))
            rec = _Recorder(trial)
            one_trial(trial.number, rec, overrides, reraise_pruned=True)
            return rec.best

        study = optuna.create_study(direction="maximize", pruner=optuna.pruners.MedianPruner())
        study.optimize(objective, n_trials=n_trials)
        return {"best_params": study.best_params, "best_value": study.best_value}

    results, history = [], []
    for i in range(n_trials):
        overrides = {k: draw(p, rng) for k, p in params.items()}
        trial = RandomSearchTrial(history)
        status = one_trial(i, trial, overrides)
        if trial.reports:  # a pruned trial's reports count toward the median too
            history.append(list(trial.reports))
        results.append({"trial": i, "status": status, "best": trial.best, **overrides})
        logger.info("trial %d %s best=%.5f %s", i, status, trial.best, overrides)
    completed = [r for r in results if r["status"] == "complete"]  # a pruned trial never wins
    return {"trials": results, "best": max(completed or results, key=lambda r: r["best"])}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="Hyperparameter sweep over the PyTorch port's training CLI.")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--backend", default="random", choices=["random", "optuna"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    from scenedino_torch.utils.config import load

    logging.basicConfig(level=logging.INFO)
    out = run_sweep(load(args.spec), backend=args.backend, seed=args.seed, device=args.device)
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
