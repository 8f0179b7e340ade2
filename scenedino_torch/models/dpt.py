"""DPT dense-prediction decoder (counterpart of `scenedino_tpu/models/dpt.py`).

NCHW throughout. Four tapped ViT grids -> reassemble (1x1 projection, x4
and x2 transposed convs, identity, stride-2 conv) -> 3x3 convs to d_out ->
fusion from the deepest level up, each with a x2 bilinear upsample
(align_corners=True) -> project -> output head (3x3 conv, x2 transposed
conv, 3x3 conv) -> a full-resolution d_out map (2x the image for patch 8).
The convolutions are plain `F.conv2d` / `F.conv_transpose2d` calls: plain
products that the JAX package left to XLA.

The other decoders of `scenedino_tpu/models/dpt.py:168-219`:
`SimpleFeaturePyramidDecoder` (five maps from the last ViT grid, then the
monodepth2 decoder) and `NoDecoder` (the last grid resized to the image
and L2-normalized, as `jax.image.resize` resizes it).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch.core import safe_normalize
from scenedino_torch.core.resize import jax_resize
from scenedino_torch.models.layers import cast, conv2d, conv_transpose2d
from scenedino_torch.models.monodepth2 import Monodepth2Decoder


def _resize_bilinear(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    """`F.interpolate(mode="bilinear", antialias=False)` on NCHW."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners,
                         antialias=False)


class _FoldableConv3x3(nn.Module):
    """3x3 same-pad conv whose output channels can be folded with a
    (features, d) matrix at call time: conv(x, K) @ W == conv(x, K @ W),
    so `fold` gives the d-channel result directly. Parameters `weight`
    (features, C, 3, 3) and `bias` (features,)."""

    def __init__(self, in_channels: int, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_normal_(self.weight, mode="fan_in", nonlinearity="linear")

    def forward(self, x: torch.Tensor, fold: Optional[torch.Tensor] = None) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if fold is not None:
            weight = torch.einsum("fchw,fd->dchw", weight.float(), fold.float())
            bias = bias.float() @ fold.float()
        x = cast(x, self.dtype)
        return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), padding=1)


def _conv3x3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class PreActResidualConvUnit(nn.Module):
    """relu -> conv -> relu -> conv, plus the input."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv3x3(channels, channels)
        self.conv2 = _conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv2d(torch.relu(x), self.conv1, self.dtype)
        h = conv2d(torch.relu(h), self.conv2, self.dtype)
        return h + x


class FeatureFusionBlock(nn.Module):
    """Fuse a skip input, x2 upsample (align_corners=True), 1x1 project."""

    def __init__(self, channels: int, with_unit1: bool = True, dtype=None):
        super().__init__()
        self.dtype = dtype
        if with_unit1:
            self.res_conv_unit1 = PreActResidualConvUnit(channels, dtype)
        self.res_conv_unit2 = PreActResidualConvUnit(channels, dtype)
        self.project = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None) -> torch.Tensor:
        if res is not None:
            if not hasattr(self, "res_conv_unit1"):
                raise ValueError("a FeatureFusionBlock built without unit1 takes no skip input")
            if res.shape[-2:] != x.shape[-2:]:
                res = _resize_bilinear(res, x.shape[-2:], align_corners=False)
            x = x + self.res_conv_unit1(res)
        x = self.res_conv_unit2(x)
        x = _resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=True)
        return conv2d(x, self.project, self.dtype)


class DPTHead(nn.Module):
    """forward(4 ViT grids (B, C_vit, Gh, Gw), shallow to deep) -> [(B, d_out, H, W)]."""

    def __init__(self, in_channels: int, post_process_channels: Sequence[int] = (64, 64, 128, 256),
                 d_out: int = 256, dtype=None):
        super().__init__()
        self.dtype = dtype
        ch = [min(d_out, c) for c in post_process_channels]
        for i, c in enumerate(ch):
            setattr(self, f"reassemble_project_{i}", nn.Conv2d(in_channels, c, 1))
            setattr(self, f"conv_{i}", _conv3x3(c, d_out, bias=False))
        self.resize_0 = nn.ConvTranspose2d(ch[0], ch[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(ch[1], ch[1], 2, stride=2)
        self.resize_3 = nn.Conv2d(ch[3], ch[3], 3, stride=2, padding=1)
        self.fusion_0 = FeatureFusionBlock(d_out, with_unit1=False, dtype=dtype)
        for i in range(1, len(ch)):
            setattr(self, f"fusion_{i}", FeatureFusionBlock(d_out, dtype=dtype))
        self.project = _conv3x3(d_out, d_out)
        self.head_conv0 = _conv3x3(d_out, d_out)
        self.head_deconv = nn.ConvTranspose2d(d_out, d_out, 2, stride=2)
        self.head_conv1 = _FoldableConv3x3(d_out, d_out, dtype)
        self.n_levels = len(ch)

    def forward(self, inputs: List[torch.Tensor], fold_matrix: Optional[torch.Tensor] = None):
        dt = self.dtype
        feats = []
        for i, x in enumerate(inputs):
            x = conv2d(x, getattr(self, f"reassemble_project_{i}"), dt)
            if i == 0:
                x = conv_transpose2d(x, self.resize_0, dt)
            elif i == 1:
                x = conv_transpose2d(x, self.resize_1, dt)
            elif i == 3:
                x = conv2d(x, self.resize_3, dt)
            feats.append(conv2d(x, getattr(self, f"conv_{i}"), dt))

        out = self.fusion_0(feats[-1])
        for i in range(1, len(feats)):
            out = getattr(self, f"fusion_{i}")(out, feats[-(i + 1)])
        out = conv2d(out, self.project, dt)
        out = conv2d(out, self.head_conv0, dt)
        out = conv_transpose2d(out, self.head_deconv, dt)
        return [self.head_conv1(out, fold=fold_matrix)]


class _StridedConvTranspose(nn.Module):
    """flax's `nn.ConvTranspose` (transpose_kernel=False) with kernel size =
    stride: each input pixel paints one output block with the kernel
    mirrored. `weight` (out, in, k, k) holds the flax kernel in a conv's
    layout (`utils.convert`'s for any 4-D kernel)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_normal_(self.weight, mode="fan_in", nonlinearity="linear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.transpose(0, 1).flip(-2, -1), self.bias, stride=self.k)


class SimpleFeaturePyramidDecoder(nn.Module):
    """The last ViT grid -> five maps at x8, x4, x2, x1 and x1/2 (transposed
    convs, a conv, a stride-2 conv) -> the monodepth2 decoder
    (dpt.py:168-198): forward(grids) -> [(B, d_out, ...) for each scale],
    in fp32. `num_ch_enc` must name the five maps' widths."""

    def __init__(self, latent_size: int = 768, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 num_ch_dec: Sequence[int] = (128, 128, 256, 256, 512), d_out: int = 64,
                 scales: Sequence[int] = (0,), use_skips: bool = True):
        super().__init__()
        ch = tuple(num_ch_enc)
        if len(ch) != 5:
            # the JAX decoder reads num_ch_enc[4] and raises IndexError on the
            # four entries of the DPT default (dpt.py:188)
            raise ValueError(f"the simple-feature-pyramid decoder takes five num_ch_enc widths, got {ch}")
        self.scales = tuple(scales)
        self.resize_0 = _StridedConvTranspose(latent_size, ch[0], 8)
        self.resize_1 = _StridedConvTranspose(latent_size, ch[1], 4)
        self.resize_2 = _StridedConvTranspose(latent_size, ch[2], 2)
        self.resize_3 = nn.Conv2d(latent_size, ch[3], 3, padding=1)
        self.resize_4 = nn.Conv2d(latent_size, ch[4], 3, stride=2, padding=1)
        self.monodepth2 = Monodepth2Decoder(ch, tuple(max(d_out, c) for c in num_ch_dec), d_out, self.scales,
                                            use_skips)

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        x = inputs[-1].float()
        feats = [self.resize_0(x), self.resize_1(x), self.resize_2(x), self.resize_3(x), self.resize_4(x)]
        outs = self.monodepth2(feats)
        return [outs[s] for s in self.scales]


class NoDecoder(nn.Module):
    """The last grid resized to `image_size` by `jax.image.resize`'s
    `interpolation` ("nearest", "bilinear" or "bicubic"), then L2-normalized
    over channels (dpt.py:201-219). The reference resizes with
    `F.interpolate`, whose bicubic (a = -0.75, edge clamped) and nearest
    (no half-pixel shift) differ from JAX's; the port follows the JAX
    package."""

    def __init__(self, image_size, interpolation: str = "bilinear"):
        super().__init__()
        self.image_size = tuple(image_size)
        self.interpolation = interpolation

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        x = jax_resize(inputs[-1], self.image_size, self.interpolation)
        return [safe_normalize(x, dim=1, eps=1e-12)]
