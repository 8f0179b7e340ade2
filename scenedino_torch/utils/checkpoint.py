"""Training checkpoints (counterpart of `scenedino_tpu/utils/checkpoint.py:27-43`):
`torch.save` / `torch.load` of the whole train state.

A checkpoint holds the field's parameters (`state_dict`, the frozen
teacher included), the optimizer's state (both Adam groups' moments, step
counts and rates), the artifact field and its optimizer, the step and
applied-update counts, and the non-finite counters. The run's random
generator is not saved, as the reference saves no PRNG key.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from scenedino_torch.training.trainer import TrainState

_COUNTERS = ("step", "applied", "notfinite_count", "total_notfinite")


def train_state_dict(field: torch.nn.Module, state: TrainState) -> Dict[str, Any]:
    """Everything a run resumes from, as tensors and Python numbers."""
    out: Dict[str, Any] = {
        "field": field.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        **{k: getattr(state, k) for k in _COUNTERS},
    }
    if state.artifact_field is not None:
        out["artifact_field"] = state.artifact_field.detach()
        out["artifact_optimizer"] = state.artifact_optimizer.state_dict()
    return out


def save_checkpoint(path: str, field: torch.nn.Module, state: TrainState) -> None:
    """Write the train state to `path` (through a temporary file, so a
    reader never sees a partial checkpoint)."""
    tmp = f"{path}.tmp"
    torch.save(train_state_dict(field, state), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, field: torch.nn.Module, state: TrainState) -> None:
    """Restore `field` and `state` in place from `path`: parameters,
    optimizer states and counters take the saved values; the artifact
    field keeps its tensor (its optimizer holds it) and takes the saved
    values. A checkpoint with or without an artifact field must match the
    state's."""
    device = next(field.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    if ("artifact_field" in ckpt) != (state.artifact_field is not None):
        raise ValueError(f"{path}: the checkpoint's artifact field does not match the train state's")
    field.load_state_dict(ckpt["field"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.artifact_field is not None:
        with torch.no_grad():
            state.artifact_field.copy_(ckpt["artifact_field"])
        state.artifact_optimizer.load_state_dict(ckpt["artifact_optimizer"])
    for k in _COUNTERS:
        setattr(state, k, int(ckpt[k]))
