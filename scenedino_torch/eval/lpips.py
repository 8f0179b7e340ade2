"""LPIPS perceptual distance (counterpart of `scenedino_tpu/eval/lpips.py`;
the `lpips` package as the reference uses it: `evaluation/wrapper.py:30`,
`training/trainer.py:103` (alex), `common/image_processor.py:47` (vgg),
`common/metrics.py:185`).

LPIPS v0.1: the fixed scaling layer on images in [-1, 1], the frozen
AlexNet or VGG16 trunk tapped after its 5 ReLU stages, each tap
unit-normalized over its channels, the squared difference weighted by a
non-negative 1x1 head, averaged over space and summed over the taps. The
trunk's convolutions are plain `nn.Conv2d` (cuDNN on the card).

No weights ship: `load_lpips(path, net)` reads a local `.pt` (a published
`lpips` state dict with the torchvision trunk's keys merged in), converted
by `convert_lpips_state_dict`, and raises `FileNotFoundError` without one.
It downloads nothing.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch import resolve_device

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG_CHANNELS = (64, 128, 256, 512, 512)
# AlexNet's convs: (out channels, kernel, stride, padding); VGG16's stages: (channels, 3x3 convs)
_ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# torchvision's sequential indices of the trunks' convs, and the lpips slice holding each
_ALEX_INDEX = ((0, 1), (3, 2), (6, 3), (8, 4), (10, 5))
_VGG_INDEX = ((0, 1), (2, 1), (5, 2), (7, 2), (10, 3), (12, 3), (14, 3), (17, 4), (19, 4), (21, 4), (24, 5), (26, 5),
              (28, 5))


class LPIPS(nn.Module):
    """`lpips.LPIPS(net=...)`: forward(x, y) of NCHW images in [-1, 1]
    (normalize=False) -> (B,) distances. `trunk.conv<j>` are the trunk's
    convolutions in order, `lin<k>` the 5 heads' weights (C_k,)."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in ("alex", "vgg"):
            raise ValueError(f"net must be 'alex' or 'vgg', got {net!r}")
        self.net = net
        self.trunk = nn.Module()
        if net == "alex":
            convs = list(_ALEX_CONVS)
        else:
            convs = [(c, 3, 1, 1) for c, reps in _VGG_STAGES for _ in range(reps)]
        cin = 3
        for j, (cout, k, s, p) in enumerate(convs):
            self.trunk.add_module(f"conv{j}", nn.Conv2d(cin, cout, k, s, p))
            cin = cout
        for k, c in enumerate(ALEX_CHANNELS if net == "alex" else VGG_CHANNELS):
            self.register_parameter(f"lin{k}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None], persistent=False)

    def _conv(self, j: int, x: torch.Tensor) -> torch.Tensor:
        return F.relu(getattr(self.trunk, f"conv{j}")(x))

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The trunk's 5 ReLU taps of scaled images (B, 3, H, W)."""
        taps = []
        if self.net == "alex":
            for j in range(5):
                if j in (1, 2):  # torchvision's MaxPool2d(3, 2): no padding, floor
                    x = F.max_pool2d(x, 3, 2)
                x = self._conv(j, x)
                taps.append(x)
            return taps
        j = 0
        for stage, (_, reps) in enumerate(_VGG_STAGES):
            if stage:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(reps):
                x = self._conv(j, x)
                j += 1
            taps.append(x)
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.taps((x.float() - self.shift) / self.scale)
        fy = self.taps((y.float() - self.shift) / self.scale)
        total = 0.0
        for k, (ax, ay) in enumerate(zip(fx, fy)):
            ax = ax / torch.clamp_min(torch.linalg.vector_norm(ax, dim=1, keepdim=True), 1e-10)
            ay = ay / torch.clamp_min(torch.linalg.vector_norm(ay, dim=1, keepdim=True), 1e-10)
            w = getattr(self, f"lin{k}")[None, :, None, None]
            total = total + ((ax - ay) ** 2 * w).sum(1).mean((1, 2))
        return total


def convert_lpips_state_dict(sd: Mapping, net: str = "alex") -> Dict[str, torch.Tensor]:
    """A published `lpips` state dict with the torchvision trunk -> the
    `LPIPS` module's state_dict (eval/lpips.py:115-151). Takes the trunk
    under `net.<i>`, `net.slice<s>.<i>` or `features.<i>` and the heads as
    `lin<k>.model.1.weight` or `lins.<k>.model.1.weight`."""
    out: Dict[str, torch.Tensor] = {}
    for j, (i, sl) in enumerate(_ALEX_INDEX if net == "alex" else _VGG_INDEX):
        key = next((k for k in (f"net.{i}.weight", f"net.slice{sl}.{i}.weight", f"features.{i}.weight") if k in sd),
                   None)
        if key is None:
            raise KeyError(f"trunk conv {i} not found in state dict")
        out[f"trunk.conv{j}.weight"] = torch.as_tensor(sd[key]).float()
        out[f"trunk.conv{j}.bias"] = torch.as_tensor(sd[key.replace(".weight", ".bias")]).float()
    for k in range(5):
        key = next((n for n in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight") if n in sd), None)
        if key is None:
            raise KeyError(f"lin{k} head not found in state dict")
        out[f"lin{k}"] = torch.as_tensor(sd[key]).float().reshape(-1)
    return out


def load_lpips(path: Optional[str] = None, net: str = "alex", device=None) -> LPIPS:
    """The LPIPS module with the weights of a local `.pt` (read with
    `torch.load(weights_only=True)`), frozen, in eval mode, on `device`
    (CUDA unless "cpu" is asked for); raises `FileNotFoundError` without
    the file (nothing is downloaded)."""
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights not found. Export them once with torch:\n"
            f"  import lpips, torch; m = lpips.LPIPS(net='{net}')\n"
            f"  torch.save({{**m.net.state_dict(), **m.state_dict()}}, 'lpips_{net}.pt')\n"
            "then pass that file's path.")
    device = resolve_device(device)
    model = LPIPS(net)
    model.load_state_dict(convert_lpips_state_dict(torch.load(path, map_location="cpu", weights_only=True), net))
    return model.to(device).eval().requires_grad_(False)
