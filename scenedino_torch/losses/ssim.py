"""SSIM error and the L1+SSIM photometric error (counterpart of
`scenedino_tpu/losses/ssim.py:27-72`): 3x3 Gaussian window, zero pad,
comp_mode clamp."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from scenedino_torch.core import absolute, clip

# 3x3 Gaussian window (the reference's layers.py:96-102)
_WINDOW = ((0.0947, 0.1183, 0.0947), (0.1183, 0.1478, 0.1183), (0.0947, 0.1183, 0.0947))
_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _gaussian_avg(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 valid convolution with the Gaussian window. x (B, C, H, W)."""
    C = x.shape[1]
    kernel = x.new_tensor(_WINDOW)[None, None].expand(C, 1, 3, 3)
    return F.conv2d(x, kernel, groups=C)


def ssim_error(x: torch.Tensor, y: torch.Tensor, pad: bool = True, comp_mode: bool = True,
               eval_mode: bool = False) -> torch.Tensor:
    """SSIM error map, (B, C, H, W) -> (B, C, H, W) with the zero pad;
    `eval_mode` returns the SSIM index itself, unclamped."""
    if pad:
        x = F.pad(x, (1, 1, 1, 1))
        y = F.pad(y, (1, 1, 1, 1))
    mu_x = _gaussian_avg(x)
    mu_y = _gaussian_avg(y)
    sigma_x = _gaussian_avg(x * x) - mu_x ** 2
    sigma_y = _gaussian_avg(y * y) - mu_y ** 2
    sigma_xy = _gaussian_avg(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x ** 2 + mu_y ** 2 + _C1) * (sigma_x + sigma_y + _C2)
    if eval_mode:
        return n / d
    if comp_mode:
        return clip(1 - n / d, 0.0, 1.0) / 2.0
    return clip((1 - n / d) / 2.0, 0.0, 1.0)


def l1_ssim(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """0.85 mean_c(ssim) + 0.15 mean_c(|pred - gt|): (B, C, H, W) -> (B, H, W)."""
    s = ssim_error(pred, gt).mean(1)
    return 0.85 * s + 0.15 * absolute(pred - gt).mean(1)
