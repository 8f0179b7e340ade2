"""pixelNeRF's backbones (counterpart of `scenedino_tpu/models/pixelnerf.py`;
reference `scenedino/models/backbones/spatial_encoder.py:10-169` and
`image_encoder.py:6-67`): `SpatialEncoder`, a pixel-aligned ResNet
pyramid, and `ImageEncoder`, a global latent. `backbone_util.make_backbone`
builds them as "spatial" and "global"; the shipped configs select neither.

The trunk is torchvision's ResNet-18/34 with frozen batch norms
(`monodepth2.BasicBlock`), fed the [-1, 1] image as pixelNeRF feeds it (no
ImageNet normalization). The pyramid is upsampled to the stem's
resolution by bilinear interpolation with align_corners=True.
`convert_torchvision_resnet` maps a torchvision ResNet state dict onto
the trunk's.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch.models.monodepth2 import BasicBlock, FrozenBatchNorm

RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def _resize_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW x with torch's align_corners=True, as the
    reference resizes: output index i reads input coordinate
    i (in - 1) / (out - 1); an axis of one input pixel repeats it (JAX's
    scale-and-translate form zeros the second half of such an axis)."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


class _ResnetTrunk(nn.Module):
    """The ResNet-18/34 trunk: forward(x NCHW) -> [stem (stride 2),
    layer1 (4), layer2 (8), layer3 (16), layer4 (32)], the first
    `num_layers` of them (spatial_encoder.py:122-140); the max pool after
    the stem with `use_first_pool`."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3), widths: Tuple[int, ...] = (64, 128, 256, 512),
                 use_first_pool: bool = True, num_layers: int = 4):
        super().__init__()
        self.use_first_pool, self.num_layers = use_first_pool, num_layers
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.stages: List[List[str]] = []
        cin = 64
        for li, (n, w) in enumerate(zip(layers, widths)):
            if li + 2 > num_layers:
                break
            names = []
            for bi in range(n):
                name = f"layer{li + 1}_{bi}"
                setattr(self, name, BasicBlock(cin, w, 2 if (bi == 0 and li > 0) else 1))
                names.append(name)
                cin = w
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        feats = [h]
        for li, names in enumerate(self.stages):
            if li == 0 and self.use_first_pool:
                h = F.max_pool2d(h, 3, 2, 1)
            for name in names:
                h = getattr(self, name)(h)
            feats.append(h)
        return feats


class SpatialEncoder(nn.Module):
    """forward(x (B, 3, H, W) in [-1, 1]) -> [latent (B, L, H/2, W/2)]: the
    trunk's maps upsampled to the stem's resolution and concatenated,
    L = latent_size = (0, 64, 128, 256, 512, 1024)[num_layers]."""

    def __init__(self, backbone: str = "resnet34", num_layers: int = 4, use_first_pool: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.model = _ResnetTrunk(RESNET_LAYERS[backbone], use_first_pool=use_first_pool, num_layers=num_layers)

    @property
    def latent_size(self) -> int:
        return [0, 64, 128, 256, 512, 1024][self.num_layers]

    def forward(self, x: torch.Tensor, ground_truth: bool = False, fold_matrix: Optional[torch.Tensor] = None,
                crops=None) -> List[torch.Tensor]:
        """The field's encoder call; `ground_truth` and `crops` change nothing."""
        if fold_matrix is not None:
            raise ValueError("a pixelNeRF encoder has no final conv to fold a matrix into")
        feats = self.model(x)
        H0, W0 = feats[0].shape[-2:]
        return [torch.cat([_resize_align_corners(f, H0, W0) for f in feats], 1)]

    def expand_dim(self, features: torch.Tensor) -> torch.Tensor:
        return features


class ImageEncoder(nn.Module):
    """forward(x (B, 3, H, W)) -> (B, latent_size): the whole trunk, a global
    average pool and, unless latent_size is 512, a linear layer `fc`."""

    def __init__(self, backbone: str = "resnet34", latent_size: int = 128):
        super().__init__()
        self.latent_size = latent_size
        self.model = _ResnetTrunk(RESNET_LAYERS[backbone], num_layers=5)
        self.fc = nn.Linear(512, latent_size) if latent_size != 512 else None

    def forward(self, x: torch.Tensor, ground_truth: bool = False) -> torch.Tensor:
        h = self.model(x)[-1].mean((2, 3))
        return self.fc(h) if self.fc is not None else h


def convert_torchvision_resnet(state_dict: Mapping, prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """A torchvision ResNet-18/34 state dict (keys under `prefix`) -> the
    trunk's (`_ResnetTrunk`) state dict: convolutions as they are, batch
    norms' weight / bias / running_mean / running_var -> weight / bias /
    mean / var, a block's `downsample.0` / `.1` -> `downsample` /
    `downsample_bn`."""

    def t(key):
        v = state_dict[key]
        return (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).float().clone()

    out: Dict[str, torch.Tensor] = {"conv1.weight": t(prefix + "conv1.weight")}

    def bn(src, dst):
        for a, b in (("weight", "weight"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
            out[f"{dst}.{b}"] = t(f"{src}.{a}")

    bn(prefix + "bn1", "bn1")
    li = 1
    while f"{prefix}layer{li}.0.conv1.weight" in state_dict:
        bi = 0
        while f"{prefix}layer{li}.{bi}.conv1.weight" in state_dict:
            src, dst = f"{prefix}layer{li}.{bi}", f"layer{li}_{bi}"
            for j in (1, 2):
                out[f"{dst}.conv{j}.weight"] = t(f"{src}.conv{j}.weight")
                bn(f"{src}.bn{j}", f"{dst}.bn{j}")
            if f"{src}.downsample.0.weight" in state_dict:
                out[f"{dst}.downsample.weight"] = t(f"{src}.downsample.0.weight")
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
            bi += 1
        li += 1
    return out
