"""Map a JAX (flax) parameter tree, or a checkpoint in the reference's
torch layout, onto the port's `state_dict`.

Accepts the nested tree (`{"params": {...}}` or its inner dict) or the
flat form with "/"-joined keys ("params/encoder/decoder/conv_0/kernel",
as in tests/goldens/s1b_field_params.npz). Layouts:

  Dense kernel (in, out)                 -> Linear weight (out, in)
  Conv kernel HWIO                       -> Conv2d weight OIHW
  ConvTranspose kernel (kh, kw, out, in) -> ConvTranspose2d weight (in, out, kh, kw)
      (flax transpose_kernel=True is the gradient of a conv, as torch's is)
  LayerNorm scale                        -> weight

Module paths keep the JAX names except `VisionTransformer_0` -> `vit`,
`blocks_<i>` -> `blocks.<i>`, `heads_<name>` -> `heads.<name>` and, in
the simple-feature-pyramid decoder, `Monodepth2Decoder_0` -> `monodepth2`
and a conv block's `Conv_0` -> `conv`. Monodepth2's frozen batch norms
(`models.monodepth2.FrozenBatchNorm`: scale, bias and the stored mean and
var, all in the "params" collection) map by name, the scale to `weight`.
The field heads' residual blocks (`block_<i>/fc_0`, `fc_1`, `shortcut`),
latent layers (`lin_z_<i>`) and the "mlp" ImplicitNet's `lin_<i>`, the
S4C field's Monodepth2 encoder and LPIPS (`trunk/conv<j>`, the heads
`lin<k>`) keep their JAX names, as do the modules of the last slice: the
dummy encoders (`feat`, `gt_feat`), the multi-view heads (`emb_encoder`,
`independent_token/readout_token`, `attn/layer_<i>/in_proj`, ...,
`density_<k>`, the inner `mlp` / `mlp2` ResnetFCs), IBRNet's NeuRay core
(`core/<mlp>_<i>`), pixelNeRF's trunk (`model/layer<s>_<b>`, frozen batch
norms with `mean` / `var`) and RAFT (`feature_encoder`, `context_encoder`
with its frozen batch-norm statistics, `update/...`, `mask_predictor`).
The mapping is strict: every leaf maps to one port tensor. A serving
model holds no training-only subtree (TRAINING_ONLY: the frozen teacher,
the FeatUp downsampler, the 64 -> 768 expansion); `load_jax_params`
skips those subtrees for it and returns them by name. The artifact field
of a train state is an array beside the tree (`artifact_from_jax`).
`load_jax_head` loads stage 2's `SemanticHead` variables: its parameters
and its `state` collection (the pseudo assignments, integer buffers);
`head_state_from_jax` gives them as a `state_dict`.

The reference's torch layout (its published checkpoints, the counterpart
of `scenedino_tpu/utils/checkpoint.py:159-528`): both sides are torch, so
every tensor keeps its layout and only its name changes, apart from the
STEGO head's 1x1 convolutions, (out, in, 1, 1) -> Linear (out, in), and
the pseudo assignments, which become int64 buffers.
`convert_scenedino_checkpoint` maps a BTSWrapper state dict to the field's
and the head's `state_dict`, strictly (`reference_checkpoint_of` finds it
in a loaded checkpoint; `to_reference_layout` is its inverse);
`convert_vit` maps a timm DINO / DINOv2 ViT, and `adapt_ssl_state_dict`
with `convert_ssl_vit` a published self-supervised ViT of the reference's
zoo (MAE, vMAE, SynCLR, MoCo-v3, MSN, Self-Patch, I-JEPA), to a
`VisionTransformer`'s.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Tuple

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


# unnamed flax submodules of the monodepth2 decoder (dpt.py:188, monodepth2.py:38)
_RENAMED = {"Monodepth2Decoder_0": "monodepth2", "Conv_0": "conv"}


def _torch_key(path: str) -> str:
    parts = []
    for seg in path.split("/"):
        if seg == "VisionTransformer_0":
            seg = "vit"
        elif re.fullmatch(r"blocks_\d+", seg):
            seg = "blocks." + seg.split("_")[1]
        elif seg.startswith("heads_"):
            seg = "heads." + seg[len("heads_"):]
        elif seg in _RENAMED:
            seg = _RENAMED[seg]
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


# ------------------------------------------------- the reference's torch layout
def _tensor(value) -> torch.Tensor:
    """A checkpoint value as a tensor: floating values in float32 (exact
    for float32 input), integers as int64."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
    return t.float() if t.is_floating_point() else t.long()


def _rename(sd: Mapping, src: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    """A torch Linear, Conv2d, ConvTranspose2d or LayerNorm under `src`:
    its weight (and bias, where it has one) under `dst`, layouts unchanged."""
    out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])


def _prefixed(prefix: str, sub: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sub.items()}


def convert_vit(sd: Mapping, prefix: str, depth: int = 12, num_registers: int = 0, layerscale: bool = False,
                class_token: bool = True) -> Dict[str, torch.Tensor]:
    """A timm DINO / DINOv2 ViT under `prefix` -> the port's
    `VisionTransformer` state_dict (checkpoint.py:191). Registers come from
    `reg_token` or `register_tokens`, LayerScale from `.gamma` or `.weight`."""
    out: Dict[str, torch.Tensor] = {}
    _rename(sd, f"{prefix}.patch_embed.proj", "patch_embed", out)
    if class_token:
        out["cls_token"] = _tensor(sd[f"{prefix}.cls_token"])
    if num_registers:
        key = f"{prefix}.reg_token" if f"{prefix}.reg_token" in sd else f"{prefix}.register_tokens"
        out["reg_token"] = _tensor(sd[key])
    out["pos_embed"] = _tensor(sd[f"{prefix}.pos_embed"])
    for i in range(depth):
        b, d = f"{prefix}.blocks.{i}", f"blocks.{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            _rename(sd, f"{b}.{name}", f"{d}.{name}", out)
        if layerscale:
            for ls in ("ls1", "ls2"):
                v = sd.get(f"{b}.{ls}.gamma", sd.get(f"{b}.{ls}.weight"))
                if v is None:
                    raise KeyError(f"layerscale inferred but {b}.{ls}.gamma/.weight missing from the checkpoint "
                                   "(truncated state dict?)")
                out[f"{d}.{ls}"] = _tensor(v)
    _rename(sd, f"{prefix}.norm", "norm", out)
    return out


def adapt_ssl_state_dict(kind: str, sd: Mapping) -> Dict[str, torch.Tensor]:
    """A published self-supervised ViT's state dict (already out of its
    'model' / 'state_dict' envelope) in timm's key layout
    (checkpoint.py:228, the reference zoo's surgery, vit.py:192-591):
    prefix strips, the momentum encoder of MoCo-v3, and vMAE's folds
    (spatial + mean temporal pos-embed behind the class one, the tubelet's
    first time slice of the patch embedding, q/k/v concatenated to qkv)."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    if kind == "mae_base":  # timm's .mae checkpoint: already timm's layout
        return sd
    if kind == "synclr_base":  # vit.py:420
        return {k[len("module.visual."):]: v for k, v in sd.items() if k.startswith("module.visual.")}
    if kind == "mocov3_base":  # vit.py:449-453: the momentum encoder without its head
        pre = "module.momentum_encoder."
        return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre) and "head." not in k}
    if kind in ("msn_base", "self_patch_small", "i_jepa_huge"):  # vit.py:485-488, 528-530, 575
        out = {}
        for k, v in sd.items():
            k = k[len("module."):] if k.startswith("module.") else k
            if not k.startswith(("fc.", "head.", "fc_norm.")):
                out[k] = v
        return out
    if kind == "vmae_large":  # vit.py:219-246
        out = {k: v for k, v in sd.items() if not k.startswith(("pos_embed_", "patch_embed.proj"))}
        pos = sd["pos_embed_spatial"] + sd["pos_embed_temporal"].mean(1, keepdim=True)
        out["pos_embed"] = torch.cat([sd["pos_embed_class"], pos], 1)
        out["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"][:, :, 0]
        if "patch_embed.proj.bias" in sd:
            out["patch_embed.proj.bias"] = sd["patch_embed.proj.bias"]
        depth = 1 + max(int(m.group(1)) for m in (re.match(r"blocks\.(\d+)\.", k) for k in sd) if m)
        for i in range(depth):
            b = f"blocks.{i}.attn"
            for suffix in ("weight", "bias"):
                if f"{b}.q.{suffix}" in out:
                    out[f"{b}.qkv.{suffix}"] = torch.cat([out.pop(f"{b}.{n}.{suffix}") for n in "qkv"], 0)
        return out
    raise NotImplementedError(kind)


def convert_ssl_vit(kind: str, raw_sd: Mapping) -> Dict[str, torch.Tensor]:
    """A published self-supervised checkpoint -> the state_dict of the
    port's `VisionTransformer` for `VIT_PRESETS[kind]` (checkpoint.py:280):
    `make_vit(kind).load_state_dict(convert_ssl_vit(kind, raw_sd))`."""
    from scenedino_torch.models.vit import VIT_PRESETS

    cfg = VIT_PRESETS[kind]
    sd = {f"vit.{k}": v for k, v in adapt_ssl_state_dict(kind, raw_sd).items()}
    return convert_vit(sd, "vit", depth=cfg.depth, num_registers=cfg.num_registers, layerscale=cfg.layerscale,
                       class_token=cfg.class_token)


def convert_dpt(sd: Mapping, prefix: str, n_levels: int = 4) -> Dict[str, torch.Tensor]:
    """The reference's DPTHead -> the port's `DPTHead` state_dict (checkpoint.py:293)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_levels):
        _rename(sd, f"{prefix}.reassemble_blocks.projects.{i}", f"reassemble_project_{i}", out)
        _rename(sd, f"{prefix}.convs.{i}", f"conv_{i}", out)
    for i in (0, 1, 3):  # resize_layers.2 is an identity
        _rename(sd, f"{prefix}.reassemble_blocks.resize_layers.{i}", f"resize_{i}", out)
    for i in range(n_levels):
        fb = f"{prefix}.fusion_blocks.{i}"
        _rename(sd, f"{fb}.project", f"fusion_{i}.project", out)
        for unit in (("res_conv_unit1", "res_conv_unit2") if i > 0 else ("res_conv_unit2",)):
            for conv in ("conv1", "conv2"):
                _rename(sd, f"{fb}.{unit}.{conv}", f"fusion_{i}.{unit}.{conv}", out)
    _rename(sd, f"{prefix}.project", "project", out)
    for i, name in enumerate(("head_conv0", "head_deconv", "head_conv1")):
        _rename(sd, f"{prefix}.output_head.head_modules.{i}", name, out)
    return out


def convert_resnetfc(sd: Mapping, prefix: str, n_blocks: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's ResnetFC -> the port's (checkpoint.py:319), with each
    block's `shortcut` (a bias-free Linear) where it has one."""
    out: Dict[str, torch.Tensor] = {}
    _rename(sd, f"{prefix}.lin_in", "lin_in", out)
    _rename(sd, f"{prefix}.lin_out", "lin_out", out)
    for i in range(n_blocks):
        b = f"{prefix}.blocks.{i}"
        _rename(sd, f"{b}.fc_0", f"block_{i}.fc_0", out)
        _rename(sd, f"{b}.fc_1", f"block_{i}.fc_1", out)
        if f"{b}.shortcut.weight" in sd:
            out[f"block_{i}.shortcut.weight"] = _tensor(sd[f"{b}.shortcut.weight"])
    return out


def convert_downsampler(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """PatchSalienceDownsampler (checkpoint.py:331): its 1x1 `conv` is the port's `salience_conv`."""
    out = {"patch_weight": _tensor(sd[f"{prefix}.patch_weight"]), "patch_bias": _tensor(sd[f"{prefix}.patch_bias"])}
    _rename(sd, f"{prefix}.conv", "salience_conv", out)
    return out


def convert_dim_reduction(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """MlpDimReduction (checkpoint.py:339)."""
    out: Dict[str, torch.Tensor] = {}
    _rename(sd, f"{prefix}.linear_in", "linear_in", out)
    _rename(sd, f"{prefix}.linear_out", "linear_out", out)
    return out


def _conv1x1_as_linear(sd: Mapping, src: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    """A 1x1 Conv2d (out, in, 1, 1) as the port's Linear (out, in) (checkpoint.py:378)."""
    out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])[:, :, 0, 0]
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])


def convert_semantic_head(sd: Mapping, prefix: str = "downstream_head") -> Dict[str, torch.Tensor]:
    """The reference's SemanticHead -> the port's `SemanticHead` state_dict
    (checkpoint.py:346): parameters, and the pseudo assignments as int64."""
    out: Dict[str, torch.Tensor] = {}
    for src, dst in (("linear_path.0", "linear"), ("nonlinear_path.0", "nonlinear_1"),
                     ("nonlinear_path.2", "nonlinear_2")):
        _conv1x1_as_linear(sd, f"{prefix}.stego_head.{src}", f"stego_head.{dst}", out)
    for head in ("direct_cluster_head", "stego_cluster_head"):
        out[f"{head}.cluster_centers"] = _tensor(sd[f"{prefix}.{head}.cluster_centers"])
        out[f"{head}.pseudo_assignment"] = _tensor(sd[f"{prefix}.{head}.pseudo_assignment"]).long()
    for head in ("direct_linear_head", "stego_linear_head"):
        p = f"{prefix}.{head}"
        for name in (("linear",) if f"{p}.linear.weight" in sd else ("linear1", "linear2")):
            _rename(sd, f"{p}.{name}", f"{head}.{name}", out)
    return out


def infer_vit_meta(sd: Mapping, prefix: str) -> Tuple[int, int, bool]:
    """(depth, register count, layerscale) of the ViT under `prefix`, from
    its key names (checkpoint.py:391): published checkpoints record no
    architecture."""
    depth, num_registers, layerscale = 0, 0, False
    pat = re.compile(re.escape(prefix) + r"\.blocks\.(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            depth = max(depth, int(m.group(1)) + 1)
        if k in (f"{prefix}.blocks.0.ls1.gamma", f"{prefix}.blocks.0.ls1.weight"):
            layerscale = True
    for reg_key in (f"{prefix}.reg_token", f"{prefix}.register_tokens"):
        if reg_key in sd:
            num_registers = int(sd[reg_key].shape[1])
    return depth, num_registers, layerscale


class _TrackedDict(dict):
    """A dict that records which keys were read (strict conversion)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.accessed = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if super().__contains__(k):
            self.accessed.add(k)
        return super().get(k, default)


# keys of the reference's BTSWrapper that carry no weight to convert: the
# positional code's buffers, the PCA visualization (fit at run time), the
# LPIPS network, BatchNorm's counters, the k-means bookkeeping
_IGNORABLE = re.compile(
    r"(^|\.)(code_xyz|visualization|lpips)\.|num_batches_tracked$|"
    r"(^|\.)pseudo_assignment$|centroids_initialized$"
)


@dataclasses.dataclass
class ReferenceCheckpoint:
    """A converted reference checkpoint: the field's `state_dict`, the
    semantic head's (None without a downstream head) and the artifact field
    (None without one)."""

    field: Dict[str, torch.Tensor]
    head: Optional[Dict[str, torch.Tensor]]
    artifact_field: Optional[torch.Tensor]


def convert_scenedino_checkpoint(state_dict: Mapping) -> ReferenceCheckpoint:
    """The reference's `checkpoint["model"]` (BTSWrapper names:
    `renderer.net.encoder.encoder.vit.*` for the student ViT, or
    `...encoder.model.*`; `renderer.net.encoder.{gt_encoder.vit, decoder,
    downsampler, dim_reduction}.*`; `renderer.net.heads.<name>.*`;
    `renderer.net.empty_feature`; `renderer.net.downstream_head.*`;
    `artifact_field` on the wrapper) -> the port's tensors
    (checkpoint.py:441, always strict). The ViT's depth, registers and
    LayerScale and the heads' block counts are inferred from the key set.
    It raises, naming them, if any weight-bearing `renderer.net.*` key (or
    `artifact_field`) was left unread."""
    sd = _TrackedDict(state_dict)
    net = "renderer.net"
    enc = f"{net}.encoder"
    vit_prefix = f"{enc}.encoder.vit"
    if f"{enc}.encoder.model.cls_token" in sd:  # a ViT wrapped without the FX graph module
        vit_prefix = f"{enc}.encoder.model"
    field = _prefixed("encoder.vit_encoder.vit", convert_vit(sd, vit_prefix, *infer_vit_meta(sd, vit_prefix)))
    field.update(_prefixed("encoder.decoder", convert_dpt(sd, f"{enc}.decoder")))
    gt_prefix = vit_prefix.replace(f"{enc}.encoder.", f"{enc}.gt_encoder.")
    if f"{gt_prefix}.cls_token" in sd:
        field.update(_prefixed("encoder.gt_encoder.vit", convert_vit(sd, gt_prefix, *infer_vit_meta(sd, gt_prefix))))
    if f"{enc}.dim_reduction.linear_in.weight" in sd:
        field.update(_prefixed("encoder.dim_reduction", convert_dim_reduction(sd, f"{enc}.dim_reduction")))
    elif f"{enc}.dim_reduction.weights" in sd:  # OrthogonalLinearDimReduction
        field["encoder.dim_reduction.weights"] = _tensor(sd[f"{enc}.dim_reduction.weights"])
        field["encoder.dim_reduction.bias"] = _tensor(sd[f"{enc}.dim_reduction.bias"])
    head_names = sorted({m.group(1) for m in (re.match(rf"{re.escape(net)}\.heads\.([^.]+)\.", k) for k in sd) if m})
    for name in head_names:
        hp = f"{net}.heads.{name}"
        nb = 0
        while f"{hp}.blocks.{nb}.fc_0.weight" in sd:
            nb += 1
        field.update(_prefixed(f"heads.{name}", convert_resnetfc(sd, hp, nb)))
    if f"{enc}.downsampler.conv.weight" in sd:
        field.update(_prefixed("encoder.downsampler", convert_downsampler(sd, f"{enc}.downsampler")))
    if f"{net}.empty_feature" in sd:  # learn_empty variants
        field["empty_feature"] = _tensor(sd[f"{net}.empty_feature"])
    artifact = _tensor(sd["artifact_field"]) if "artifact_field" in sd else None
    head = None
    if f"{net}.downstream_head.stego_head.linear_path.0.weight" in sd:
        head = convert_semantic_head(sd, f"{net}.downstream_head")
    missed = [k for k in sd if k not in sd.accessed and not _IGNORABLE.search(k)
              and (k.startswith(net) or k == "artifact_field")]
    if missed:
        raise ValueError(f"unconsumed checkpoint keys ({len(missed)}): {missed[:20]}")
    return ReferenceCheckpoint(field=field, head=head, artifact_field=artifact)


def reference_checkpoint_of(ckpt) -> Optional[ReferenceCheckpoint]:
    """A loaded checkpoint in the reference's torch layout (its BTSWrapper
    state dict, bare or under "model" as its trainer saves it) converted
    by `convert_scenedino_checkpoint` (the counterpart of
    scenedino_tpu/utils/checkpoint.py:46-69); None for any other layout."""
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, Mapping) else None
    if not (isinstance(sd, Mapping) and any(str(k).startswith("renderer.net.") for k in sd)):
        return None
    return convert_scenedino_checkpoint(sd)


_DEC = "renderer.net.encoder.decoder."
_TO_REFERENCE = (  # (pattern, replacement) on the port's name, in order
    (r"^encoder\.vit_encoder\.vit\.", "renderer.net.encoder.encoder.vit."),
    (r"^encoder\.gt_encoder\.vit\.", "renderer.net.encoder.gt_encoder.vit."),
    (r"\.vit\.patch_embed\.", ".vit.patch_embed.proj."),
    (r"\.(ls[12])$", r".\1.gamma"),
    (r"^encoder\.decoder\.reassemble_project_(\d)", _DEC + r"reassemble_blocks.projects.\1"),
    (r"^encoder\.decoder\.conv_(\d)", _DEC + r"convs.\1"),
    (r"^encoder\.decoder\.resize_(\d)", _DEC + r"reassemble_blocks.resize_layers.\1"),
    (r"^encoder\.decoder\.fusion_(\d)", _DEC + r"fusion_blocks.\1"),
    (r"^encoder\.decoder\.head_conv0", _DEC + "output_head.head_modules.0"),
    (r"^encoder\.decoder\.head_deconv", _DEC + "output_head.head_modules.1"),
    (r"^encoder\.decoder\.head_conv1", _DEC + "output_head.head_modules.2"),
    (r"^encoder\.downsampler\.salience_conv\.", "renderer.net.encoder.downsampler.conv."),
    (r"^encoder\.", "renderer.net.encoder."),
    (r"^heads\.([^.]+)\.block_(\d+)\.", r"renderer.net.heads.\1.blocks.\2."),
    (r"^(heads\.|empty_feature$)", r"renderer.net.\1"),
)
_HEAD_TO_REFERENCE = {"stego_head.linear.": "stego_head.linear_path.0.",
                      "stego_head.nonlinear_1.": "stego_head.nonlinear_path.0.",
                      "stego_head.nonlinear_2.": "stego_head.nonlinear_path.2."}


def to_reference_layout(field: Mapping[str, torch.Tensor], head: Optional[Mapping[str, torch.Tensor]] = None,
                        artifact_field: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The port's field (and head, and artifact field) state_dicts under the
    reference's BTSWrapper names: the inverse of `convert_scenedino_checkpoint`,
    for writing a checkpoint that the reference's code reads. The tensors are
    the given ones (the STEGO head's Linear weights as 1x1 convolutions)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in field.items():
        for pattern, repl in _TO_REFERENCE:
            key = re.sub(pattern, repl, key)
        out[key] = value
    for key, value in (head or {}).items():
        for port, ref in _HEAD_TO_REFERENCE.items():
            if key.startswith(port):
                key = ref + key[len(port):]
                value = value[:, :, None, None] if key.endswith("weight") else value
        out["renderer.net.downstream_head." + key] = value
    if artifact_field is not None:
        out["artifact_field"] = artifact_field
    return out
