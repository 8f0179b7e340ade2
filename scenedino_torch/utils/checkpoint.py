"""Training checkpoints (counterpart of `scenedino_tpu/utils/checkpoint.py:27-43`):
`torch.save` / `torch.load` of the whole train state.

A stage-1 checkpoint holds the field's parameters (`state_dict`, the
frozen teacher included), the optimizer's state (both Adam groups'
moments, step counts and rates), the artifact field and its optimizer,
the step and applied-update counts, the non-finite counters and, with
gradient accumulation, the accumulator and its micro-step count. A
stage-2 checkpoint holds the semantic head's parameters and buffers (the
pseudo assignments), its optimizer (the STEGO and heads groups), the ring
buffers (`patch_buffer`, `gap_buffer`, `idx`, `filled`), the counts and
the counters; the frozen field is written once a run
(`save_field_snapshot`), as the reference writes `field_params`. The
run's random generator is not saved, as the reference saves no PRNG key.

`load_eval_state` resolves what the evaluation CLIs are given into the
field's and the head's weights, the reference's own torch checkpoints
(its published weights among them) included.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from scenedino_torch.training.downstream import DownstreamTrainState

_COUNTERS = ("step", "applied", "notfinite_count", "total_notfinite")
_RING = ("idx", "filled")


def train_state_dict(module: torch.nn.Module, state) -> Dict[str, Any]:
    """Everything a run resumes from, as tensors and Python numbers: the
    trained module (stage 1's field or stage 2's head) and `state`."""
    key = "head" if isinstance(state, DownstreamTrainState) else "field"
    out: Dict[str, Any] = {
        key: module.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        **{k: getattr(state, k) for k in _COUNTERS},
    }
    if isinstance(state, DownstreamTrainState):
        b = state.buffers
        out["buffers"] = {"patch_buffer": b.patch_buffer, "gap_buffer": b.gap_buffer, "idx": b.idx,
                          "filled": b.filled}
    else:
        if state.artifact_field is not None:
            out["artifact_field"] = state.artifact_field.detach()
            out["artifact_optimizer"] = state.artifact_optimizer.state_dict()
        if state.acc_grads is not None:
            out["acc_grads"] = [a.detach() for a in state.acc_grads]
            out["mini_step"] = state.mini_step
    return out


def _save(path: str, value: Any) -> None:
    """torch.save through a temporary file, so a reader never sees a partial file."""
    tmp = f"{path}.tmp"
    torch.save(value, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, module: torch.nn.Module, state) -> None:
    """Write the train state to `path`."""
    _save(path, train_state_dict(module, state))


def load_checkpoint(path: str, module: torch.nn.Module, state) -> None:
    """Restore `module` and `state` in place from `path`: parameters,
    buffers, optimizer states and counters take the saved values. A stage-1
    artifact field keeps its tensor (its optimizer holds it) and takes the
    saved values; a checkpoint with or without one must match the state's.
    A stage-2 checkpoint's ring buffers are copied into the state's."""
    device = next(module.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    stage2 = isinstance(state, DownstreamTrainState)
    if ("head" in ckpt) != stage2:
        raise ValueError(f"{path}: a stage-{1 + ('head' in ckpt)} checkpoint cannot resume a stage-{1 + stage2} run")
    if not stage2 and ("artifact_field" in ckpt) != (state.artifact_field is not None):
        raise ValueError(f"{path}: the checkpoint's artifact field does not match the train state's")
    module.load_state_dict(ckpt["head" if stage2 else "field"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if stage2:
        b, saved = state.buffers, ckpt["buffers"]
        b.patch_buffer.copy_(saved["patch_buffer"])
        b.gap_buffer.copy_(saved["gap_buffer"])
        for k in _RING:
            setattr(b, k, int(saved[k]))
    else:
        if state.artifact_field is not None:
            with torch.no_grad():
                state.artifact_field.copy_(ckpt["artifact_field"])
            state.artifact_optimizer.load_state_dict(ckpt["artifact_optimizer"])
        state.acc_grads = [a.clone() for a in ckpt["acc_grads"]] if "acc_grads" in ckpt else None
        state.mini_step = int(ckpt.get("mini_step", 0))
    for k in _COUNTERS:
        setattr(state, k, int(ckpt[k]))


def save_field_snapshot(path: str, field: torch.nn.Module) -> None:
    """The frozen field of a stage-2 run (`field_params` of the reference's
    run_stage2, cli/train.py:395-407), so the run directory alone rebuilds
    the whole model."""
    _save(path, field.state_dict())


FIELD_SNAPSHOT = "field_params.pt"


def is_field_state(sd) -> bool:
    """Whether `sd` is a field's state_dict (keys under encoder. or heads.)."""
    return isinstance(sd, dict) and any(str(k).startswith(("encoder.", "heads.")) for k in sd)


def resolve_run_path(path: str) -> str:
    """A run directory -> its newest `training_checkpoint_<it>.pt`, else its
    field snapshot; any other path as given. A directory with neither raises."""
    from scenedino_torch.training.loop import find_latest_checkpoint

    if not os.path.isdir(path):
        return path
    snapshot = os.path.join(path, FIELD_SNAPSHOT)
    found = find_latest_checkpoint(path) or (snapshot if os.path.exists(snapshot) else None)
    if found is None:
        raise ValueError(f"{path!r}: no training_checkpoint_<it>.pt or {FIELD_SNAPSHOT} in it")
    return found


def _from_jax_npz(path: str):
    """A flat JAX variables tree: the field's parameters, and the head's
    under params/downstream and state/downstream (the reference's layout)."""
    import numpy as np

    from scenedino_torch.utils.convert import from_jax_params, head_state_from_jax

    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    field = {k: v for k, v in flat.items() if k.startswith("params/") and not k.startswith("params/downstream/")}
    head = {k.replace("/downstream/", "/", 1): v for k, v in flat.items()
            if k.startswith(("params/downstream/", "state/downstream/"))}
    if not field:
        raise ValueError(f"{path}: no params/ leaves of a field")
    return from_jax_params(field)[0], (head_state_from_jax(head) if head else None)


def load_eval_state(ckpt_path: str, device="cpu") -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """(field state_dict, head state_dict or None) from what an evaluation
    is pointed at (the counterpart of scenedino_tpu/utils/checkpoint.py:72-130):

      * a stage-2 run directory of the port: the head of its newest
        `training_checkpoint_<it>.pt`, the field of its `field_params.pt`;
        also such a checkpoint file, with the snapshot beside it;
      * a stage-1 run directory of the port (its newest checkpoint, else a
        field snapshot), a stage-1 checkpoint or a field snapshot: no head;
      * a JAX variables tree saved as a flat `.npz` ("params/..." keys,
        the head under params/downstream and state/downstream);
      * a checkpoint in the reference's torch layout, its published ones
        among them (`utils.convert.reference_checkpoint_of`, strict): the
        head where it has one.

    Anything else raises, rather than evaluate random weights."""
    from scenedino_torch.utils.convert import reference_checkpoint_of

    path = resolve_run_path(ckpt_path)
    if path.endswith(".npz"):
        return _from_jax_npz(path)
    ckpt = torch.load(path, map_location=device, weights_only=True)
    reference = reference_checkpoint_of(ckpt)
    if reference is not None:
        return reference.field, reference.head
    if isinstance(ckpt, dict) and isinstance(ckpt.get("head"), dict):
        snapshot = os.path.join(os.path.dirname(os.path.abspath(path)), FIELD_SNAPSHOT)
        if not os.path.exists(snapshot):
            raise FileNotFoundError(f"stage-2 checkpoint {path!r} has no field snapshot at {snapshot!r}: point the "
                                    "evaluation at the run directory that the stage-2 run wrote")
        return torch.load(snapshot, map_location=device, weights_only=True), ckpt["head"]
    if isinstance(ckpt, dict) and isinstance(ckpt.get("field"), dict):
        ckpt = ckpt["field"]
    if not is_field_state(ckpt):
        keys = sorted(ckpt)[:6] if isinstance(ckpt, dict) else type(ckpt).__name__
        raise ValueError(f"{path!r}: unrecognized checkpoint layout ({keys})")
    return ckpt, None
