"""The sweep CLI (`scenedino_torch/cli/sweep.py`) and the loop's sweep
hooks (`training/loop.fit(sweep_trial=...)`) against the JAX package's.

- `set_by_path` and `draw` from `random.Random(seed)`: the same values in
  the same order as JAX's, categorical, uniform and log-uniform.
- `run_sweep`, random backend, with a stand-in stage function on both sides
  (as tests/test_sweep.py:22-64 stubs it; stage nvs and semantic): the same
  trials (each drawn value), statuses, bests and winner, 8 trials.
- `fit` reporting after each validation pass the validator's best signed
  score and pruning where the trial says, on stand-in steps and
  validators: the same reports and the same pruned iteration as JAX's
  `fit` (TrialPruned without optuna).
- the optuna backend behind its import gate, as JAX's.
"""
import random
import types

import jax
import numpy as np
import pytest
import torch
import yaml

import scenedino_tpu.cli.sweep as J
import scenedino_tpu.cli.train as jtrain
import scenedino_tpu.training.loop as jloop
from scenedino_torch.cli import sweep as S
from scenedino_torch.cli import train as ttrain
from scenedino_torch.training import loop as tloop

PARAMS = {"training.optimizer.args.lr": {"min": 1e-5, "max": 1e-3, "log": True},
          "model.encoder.dropout": {"min": 0.0, "max": 0.5},
          "batch_size": [2, 4, 8]}


def test_set_by_path_and_draw_match_jax():
    a, b = {"training": {"x": 1}}, {"training": {"x": 1}}
    S.set_by_path(a, "training.optimizer.args.lr", 3e-4)
    J.set_by_path(b, "training.optimizer.args.lr", 3e-4)
    assert a == b and a["training"]["optimizer"]["args"]["lr"] == 3e-4
    ours, ref = random.Random(3), random.Random(3)
    for _ in range(20):
        for spec in PARAMS.values():
            assert S.draw(spec, ours) == J.draw(spec, ref)


def _stage(pruned_cls):
    """A stand-in stage: scores peak at lr = 3e-4, two validation passes."""

    def stage(config, sweep_trial=None, **_):
        lr = config["training"]["optimizer"]["args"]["lr"]
        score = -abs(np.log(lr / 3e-4)) - 0.01 * config["batch_size"]
        sweep_trial.report(score * 2, 1)
        if sweep_trial.should_prune():
            raise pruned_cls()
        sweep_trial.report(score, 2)

    return stage


@pytest.mark.parametrize("stage", ["nvs", "semantic"])
def test_run_sweep_matches_jax(tmp_path, monkeypatch, stage):
    base = {"training": {"optimizer": {"args": {"lr": 1e-4}}}, "output": {"path": str(tmp_path)}, "batch_size": 4}
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(base))
    name = "run_stage1" if stage == "nvs" else "run_stage2"
    seen = {"jax": [], "torch": []}

    def recording(stage_fn, log):
        def run(config, **kw):
            log.append((config["output"]["path"], config["training"]["sweep_validator"]))
            return stage_fn(config, **kw)

        return run

    monkeypatch.setattr(jtrain, name, recording(_stage(jloop.TrialPruned), seen["jax"]))
    monkeypatch.setattr(ttrain, name, recording(_stage(tloop.TrialPruned), seen["torch"]))
    spec = {"base": str(tmp_path / "base.yaml"), "trials": 8, "stage": stage, "metric": "val2", "params": PARAMS}
    ours, ref = S.run_sweep(spec, seed=1, device="cpu"), J.run_sweep(spec, seed=1)
    assert ours == ref
    assert seen["torch"] == seen["jax"] and seen["torch"][3] == (f"{tmp_path}/trial_003", "val2")
    statuses = [t["status"] for t in ours["trials"]]
    assert "pruned" in statuses and "complete" in statuses
    assert ours["best"]["status"] == "complete"


class _Validator:
    def __init__(self, scores, every=1):
        self.scores, self.every = scores, every
        self.save_best = types.SimpleNamespace(metric="score", sign=1.0, update_model=False, dry_run=True)

    def fn(self, *_):
        return {"score": self.scores.pop(0)}

    def __call__(self, *a):
        return self.fn(*a)


class _NoLogger:
    def __init__(self, *_):
        pass

    def __getattr__(self, _):
        return lambda *a, **k: None


def test_fit_reports_and_prunes_like_jax(tmp_path, monkeypatch):
    """Scores 0.2, 0.5, 0.4, ...: the running best is reported after each
    pass of "validation" (not of "other"); two earlier trials' histories
    prune at iteration 2 (0.5 under their median 0.55). No TensorBoard
    writer (stubbed on both sides)."""
    monkeypatch.setattr(jloop, "MetricLogger", _NoLogger)
    monkeypatch.setattr(tloop, "MetricLogger", _NoLogger)
    scores = [0.2, 0.5, 0.4, 0.3, 0.9, 0.9]
    history = [[(1, 0.3), (2, 0.5), (3, 0.8), (4, 0.9)], [(1, 0.1), (2, 0.6), (3, 0.7), (4, 0.8)]]
    runs = {}
    for pkg in ("jax", "torch"):
        trial = S.RandomSearchTrial([list(h) for h in history])
        cfg = (jloop if pkg == "jax" else tloop).LoopConfig(output_path=str(tmp_path / pkg), num_epochs=1,
                                                             log_every=1, checkpoint_every=100)
        validators = {"validation": _Validator(list(scores)), "other": _Validator([0.0] * 6, every=2)}
        state = types.SimpleNamespace(step=0)
        batches = lambda: iter(range(6))  # noqa: E731
        with pytest.raises(Exception) as e:
            if pkg == "jax":
                jloop.fit(state, lambda s, b, k: (s, {"total_loss": 1.0}), batches, cfg, jax.random.PRNGKey(0),
                          validators=validators, sweep_trial=trial)
            else:
                tloop.fit(torch.nn.Linear(1, 1), state, lambda s, b, g: {"total_loss": torch.tensor(1.0)}, batches,
                          cfg, torch.Generator(), validators=validators, sweep_trial=trial)
        assert type(e.value).__name__ == "TrialPruned"
        runs[pkg] = (trial.reports, str(e.value))
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0] == [(1, 0.2), (2, 0.5)] and "iter 2" in runs["torch"][1]


def test_optuna_backend_is_gated_as_in_jax(tmp_path):
    (tmp_path / "base.yaml").write_text(yaml.safe_dump({"output": {"path": str(tmp_path)}}))
    spec = {"base": str(tmp_path / "base.yaml"), "trials": 1, "params": {}}
    try:
        import optuna  # noqa: F401

        pytest.skip("optuna installed")
    except ImportError:
        for run in (S.run_sweep, J.run_sweep):
            with pytest.raises(ImportError, match="optuna"):
                run(spec, backend="optuna")
