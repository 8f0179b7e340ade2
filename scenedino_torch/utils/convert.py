"""Map a JAX (flax) parameter tree onto the port's `state_dict`.

Accepts the nested tree (`{"params": {...}}` or its inner dict) or the
flat form with "/"-joined keys ("params/encoder/decoder/conv_0/kernel",
as in tests/goldens/s1b_field_params.npz). Layouts:

  Dense kernel (in, out)                 -> Linear weight (out, in)
  Conv kernel HWIO                       -> Conv2d weight OIHW
  ConvTranspose kernel (kh, kw, out, in) -> ConvTranspose2d weight (in, out, kh, kw)
      (flax transpose_kernel=True is the gradient of a conv, as torch's is)
  LayerNorm scale                        -> weight

Module paths keep the JAX names except `VisionTransformer_0` -> `vit`,
`blocks_<i>` -> `blocks.<i>` and `heads_<name>` -> `heads.<name>`.
The mapping is strict: every leaf maps to one port tensor. A serving
model holds no training-only subtree (TRAINING_ONLY: the frozen teacher,
the FeatUp downsampler, the 64 -> 768 expansion); `load_jax_params`
skips those subtrees for it and returns them by name. The artifact field
of a train state is an array beside the tree (`artifact_from_jax`).
`load_jax_head` loads stage 2's `SemanticHead` variables: its parameters
and its `state` collection (the pseudo assignments, integer buffers);
`head_state_from_jax` gives them as a `state_dict`.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# used by training only (frozen teacher, feature downsampler, 64 -> 768
# expansion); a serving model does not build them
TRAINING_ONLY = ("encoder/gt_encoder", "encoder/downsampler", "encoder/dim_reduction")


def flatten_params(tree: Mapping) -> Dict[str, np.ndarray]:
    """Nested or flat parameter tree -> {"a/b/leaf": array}, without the
    leading "params" collection."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, path)
            else:
                flat[path] = np.asarray(value)

    walk(tree, "")
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    return flat


def _torch_key(path: str) -> str:
    parts = []
    for seg in path.split("/"):
        if seg == "VisionTransformer_0":
            seg = "vit"
        elif re.fullmatch(r"blocks_\d+", seg):
            seg = "blocks." + seg.split("_")[1]
        elif seg.startswith("heads_"):
            seg = "heads." + seg[len("heads_"):]
        parts.append(seg)
    leaf = parts[-1]
    if leaf in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _torch_value(path: str, value: np.ndarray) -> torch.Tensor:
    if path.rsplit("/", 1)[-1] == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{path}: unexpected kernel rank {value.ndim}")
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def from_jax_params(params: Mapping, skip=()) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Returns (state_dict, skipped): the port's tensors by name, and the
    JAX leaf paths under the `skip` subtrees."""
    state: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    for path, value in sorted(flatten_params(params).items()):
        if any(path == s or path.startswith(s + "/") for s in skip):
            skipped.append(path)
            continue
        key = _torch_key(path)
        if key in state:
            raise ValueError(f"two JAX leaves map to {key}")
        state[key] = _torch_value(path, value)
    return state, skipped


def load_jax_params(module: torch.nn.Module, params: Mapping, skip=None) -> List[str]:
    """Load a JAX tree into `module`, strictly: every mapped leaf must be a
    tensor of the module and every tensor of the module must be given.
    `skip=None` skips the TRAINING_ONLY subtrees the module does not hold
    (all of them for a serving model, none for a training model).
    Returns the skipped leaf paths."""
    if skip is None:
        names = {name for name, _ in module.named_modules()}
        skip = tuple(p for p in TRAINING_ONLY if p.replace("/", ".") not in names)
    state, skipped = from_jax_params(params, skip)
    module.load_state_dict(state, strict=True)
    return skipped


def artifact_from_jax(artifact_field) -> torch.Tensor:
    """A train state's artifact field (Cd, Gh, Gw): same layout, fp32."""
    return torch.from_numpy(np.array(artifact_field, dtype=np.float32, order="C"))


def head_state_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX `SemanticHead` variables tree ({"params": ..., "state": ...},
    nested or flat with "/"-joined keys) as the port head's `state_dict`:
    the state collection's `pseudo_assignment` leaves become int64 buffers."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, path)
            else:
                flat[path] = np.asarray(value)

    walk(variables, "")
    state: Dict[str, torch.Tensor] = {}
    for path, value in sorted(flat.items()):
        collection, _, rest = path.partition("/")
        if collection == "params":
            state[_torch_key(rest)] = _torch_value(rest, value)
        elif collection == "state":
            state[_torch_key(rest)] = torch.from_numpy(value.astype(np.int64))
        else:
            raise ValueError(f"{path}: a SemanticHead tree holds the collections 'params' and 'state'")
    return state


def load_jax_head(head: torch.nn.Module, variables: Mapping) -> None:
    """Load a JAX `SemanticHead` variables tree into `head`, strictly: every
    leaf maps to one parameter or buffer and every one is given."""
    head.load_state_dict(head_state_from_jax(variables), strict=True)
