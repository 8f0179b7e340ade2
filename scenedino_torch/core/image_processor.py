"""Image processors: map input images to the reconstruction target's space
(counterpart of `scenedino_tpu/core/image_processor.py`; reference
`scenedino/common/image_processor.py`).

RGB ([-1, 1] -> [0, 1], the shipped configs' only one), Patch (each
pixel's p x p neighbourhood), Perceptual (LPIPS-VGG taps, unit-normalized
and resized to the image), the flow processors (normalized flow of frame
pairs, with occlusions) and the RAFT feature extractor. Images are
(B, V, C, H, W). The last three need weights that do not ship:
`make_image_processor` raises without them.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch.core.resize import jax_resize

PERCEPTUAL_CHANNELS = (64, 128, 256, 512, 512)  # lpips.chns


def rgb_processor(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] (image_processor.py:34-41)."""
    return images * 0.5 + 0.5


def patch_processor(images: torch.Tensor, patch_size: int = 3) -> torch.Tensor:
    """Each pixel's p x p neighbourhood (edge-padded) over the channels,
    row by row of the window: (B, V, C, H, W) -> (B, V, C*p*p, H, W) in [0, 1]."""
    B, V, C, H, W = images.shape
    p, pad = patch_size, patch_size // 2
    x = F.pad((images * 0.5 + 0.5).reshape(B * V, C, H, W), (pad, pad, pad, pad), mode="replicate")
    shifts = [x[:, :, dy:dy + H, dx:dx + W] for dy in range(p) for dx in range(p)]
    return torch.cat(shifts, 1).reshape(B, V, C * p * p, H, W)


def _vgg(vgg_params: Mapping[str, torch.Tensor]) -> nn.Module:
    """An `eval.lpips.LPIPS(net="vgg")` with the trunk's state dict
    (`conv<j>.weight` / `.bias`, JAX's "trunk" subtree through
    `utils.convert.from_jax_params`), on its tensors' device."""
    from scenedino_torch.eval.lpips import LPIPS

    model = LPIPS("vgg")
    model.trunk.load_state_dict(vgg_params)
    return model.to(next(iter(vgg_params.values())).device)


def perceptual_processor(images: torch.Tensor, vgg_params, layers: int = 1) -> torch.Tensor:
    """The LPIPS-VGG pyramid as the target (PerceptualProcessor,
    image_processor.py:44-79): the VGG16 trunk on the LPIPS-scaled images,
    its first `layers` taps (relu1_2, 2_2, 3_3, ...) unit-normalized over
    the channels, resized to the image as `jax.image.resize` (bilinear),
    concatenated: (B, V, sum(PERCEPTUAL_CHANNELS[:layers]), H, W).
    `vgg_params`: the trunk's state dict, or the LPIPS("vgg") built from it."""
    vgg = vgg_params if isinstance(vgg_params, nn.Module) else _vgg(vgg_params)
    B, V, C, H, W = images.shape
    x = (images.reshape(B * V, C, H, W).float() - vgg.shift) / vgg.scale
    feats = []
    for t in vgg.taps(x)[:layers]:
        t = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=1, keepdim=True), 1e-10)
        if tuple(t.shape[-2:]) != (H, W):
            t = jax_resize(t, (H, W), "bilinear")
        feats.append(t)
    return torch.cat(feats, 1).reshape(B, V, -1, H, W)


def automasking_wrapper(processor: Callable) -> Callable:
    """AutoMaskingWrapper (image_processor.py:264-282): the processed images
    with a per-pixel automasking threshold (B, H, W) as one more channel.
    The reference's forward stacks tensors of unequal channel counts, which
    cannot run; its declared channel count (inner + 1) is a concatenation."""

    def run(images: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
        B, V, C, H, W = images.shape
        proc = processor(images)
        thr = threshold.reshape(B, 1, 1, H, W).expand(B, V, 1, H, W).to(proc.dtype)
        return torch.cat([proc, thr], 2)

    return run


def _raft_features(raft_params: Mapping[str, torch.Tensor]) -> nn.Module:
    """RAFT's feature trunk from a `models.raft.RAFT` state dict
    (`convert_raft_state_dict`), on its tensors' device."""
    from scenedino_torch.models.raft import RAFTEncoder

    enc = RAFTEncoder("instance")
    prefix = "feature_encoder."
    enc.load_state_dict({k[len(prefix):]: v for k, v in raft_params.items() if k.startswith(prefix)})
    return enc.to(next(iter(raft_params.values())).device).eval()


def make_image_processor(config: Optional[dict], vgg_params=None, flow_fn=None,
                         raft_params: Optional[Mapping] = None) -> Callable:
    """The `image_processor` block's processor: rgb (default), patch
    (`patch_size`), perceptual (`layers`; `vgg_params`), flow and
    flow_occlusion (`flow_fn(img0, img1)` -> pixel flow (B, 2, H, W) of
    images in [0, 1]), raft (the RAFT feature trunk at 1/8, resized to
    the image; `raft_params`)."""
    kind = (config or {}).get("type", "RGB").lower()
    if kind == "rgb":
        return rgb_processor
    if kind == "patch":
        ps = config.get("patch_size", 3)
        return lambda images: patch_processor(images, ps)
    if kind == "perceptual":
        if vgg_params is None:
            raise NotImplementedError(
                "perceptual processor needs converted LPIPS-VGG weights "
                "(eval/lpips.py load_lpips / convert_lpips_state_dict); none "
                "are bundled — pass vgg_params (the 'trunk' subtree)."
            )
        layers = config.get("layers", 1)
        vgg = _vgg(vgg_params)
        return lambda images: perceptual_processor(images, vgg, layers)
    if kind in ("flow", "flow_occlusion"):
        if flow_fn is None:
            raise NotImplementedError(
                f"image processor '{kind}' needs a flow network: pass "
                "flow_fn(img0, img1) -> (B, 2, H, W) pixel flow (the "
                "reference uses pretrained torchvision RAFT)."
            )
        from scenedino_torch.core.flow import pack_flow_channels

        occlusions = kind == "flow_occlusion"

        def run(images: torch.Tensor) -> torch.Tensor:
            B, V, C, H, W = images.shape
            img01 = (images * 0.5 + 0.5).reshape(B * V // 2, 2, C, H, W)
            fwd = flow_fn(img01[:, 0], img01[:, 1])
            bwd = flow_fn(img01[:, 1], img01[:, 0])
            return pack_flow_channels(images, fwd, bwd, with_occlusions=occlusions)

        return run
    if kind == "raft":
        if raft_params is None:
            raise NotImplementedError(
                "RaftExtractor needs converted torchvision RAFT weights "
                "(models/raft.py convert_raft_state_dict); none are bundled "
                "— pass raft_params."
            )
        enc = _raft_features(raft_params)

        def run_raft(images: torch.Tensor) -> torch.Tensor:
            B, V, C, H, W = images.shape
            feats = enc(images.reshape(B * V, C, H, W))
            return jax_resize(feats, (H, W), "bilinear").reshape(B, V, -1, H, W)

        return run_raft
    raise ValueError(f"unknown image processor: {kind}")
