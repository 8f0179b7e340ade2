"""Learning-rate schedules (counterpart of `scenedino_tpu/training/scheduler.py:13-25`):
"fix" (constant) and "step" (staircase: lr * gamma^floor(step / step_size))."""
from __future__ import annotations

from typing import Callable


def make_schedule(config: dict, base_lr: float) -> Callable[[int], float]:
    """Config dict {type, step_size, gamma} -> step -> lr. `step` counts
    the updates applied before this one, as optax's schedule count does."""
    kind = (config or {}).get("type", "fix")
    if kind == "fix":
        return lambda step: base_lr
    if kind == "step":
        size, gamma = config["step_size"], config["gamma"]
        return lambda step: base_lr * gamma ** (step // size)
    raise NotImplementedError(f"Unknown learning rate scheduler type: {kind}")
