"""Monodepth2: a ResNet-18 encoder and a multi-scale decoder (counterpart
of `scenedino_tpu/models/monodepth2.py`). NCHW throughout; fp32.

The decoder also serves the simple-feature-pyramid decoder
(`dpt.SimpleFeaturePyramidDecoder`): from the deepest map up, each level is
a 3x3 conv block (reflection pad, ELU), a nearest x2 upsample, the skip map
of the level above concatenated (cropped to it), a second conv block and,
at the output scales, a bare reflection-padded 3x3 conv to `d_out`. The
encoder normalizes its [0, 1] input uniformly, (x - 0.45) / 0.225, and
its batch norms are frozen: a per-channel affine of stored statistics
(`mean`, `var`), which are parameters as in the reference's tree. The
whole model is the stage-1 step's uncertainty predictor
(`SceneField(uncertainty_predictor=...)`) and the S4C baseline's
pixel-aligned encoder (`backbone_util.make_backbone`, the field's
`encoder`: its scale-0 map is the feature grid, `expand_dim` the identity).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflection padding by 1 on both spatial axes; an axis of length 1
    repeats its value, as `jnp.pad(mode="reflect")` does (a map of 1 row
    at the encoder's deepest level of a small image)."""
    if min(x.shape[-2:]) > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    for dim in (-1, -2):
        n = x.shape[dim]
        lo, hi = (x.narrow(dim, 1, 1), x.narrow(dim, n - 2, 1)) if n > 1 else (x, x)
        x = torch.cat([lo, x, hi], dim)
    return x


class ConvBlock(nn.Module):
    """Reflection-padded 3x3 conv + ELU (monodepth2.py:30-39)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(reflect_pad1(x)))


class Monodepth2Decoder(nn.Module):
    """forward(5 encoder maps, shallow to deep) -> {scale: (B, d_out, ...)}."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 num_ch_dec: Sequence[int] = (128, 128, 256, 256, 512), d_out: int = 128,
                 scales: Tuple[int, ...] = (0, 1, 2, 3), use_skips: bool = True):
        super().__init__()
        ch_dec = [max(d_out, c) for c in num_ch_dec]
        self.scales = tuple(scales)
        self.use_skips = use_skips
        for i in range(4, -1, -1):
            setattr(self, f"upconv_{i}_0", ConvBlock(num_ch_enc[-1] if i == 4 else ch_dec[i + 1], ch_dec[i]))
            skip = num_ch_enc[i - 1] if use_skips and i > 0 else 0
            setattr(self, f"upconv_{i}_1", ConvBlock(ch_dec[i] + skip, ch_dec[i]))
            if i in self.scales:
                setattr(self, f"dispconv_{i}", nn.Conv2d(ch_dec[i], d_out, 3))

    def forward(self, feats: List[torch.Tensor]) -> Dict[int, torch.Tensor]:
        outputs = {}
        x = feats[-1]
        for i in range(4, -1, -1):
            x = getattr(self, f"upconv_{i}_0")(x)
            x = x.repeat_interleave(2, -2).repeat_interleave(2, -1)  # nearest x2
            if self.use_skips and i > 0:
                skip = feats[i - 1]
                x = torch.cat([x[..., :skip.shape[-2], :skip.shape[-1]], skip], 1)
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                outputs[i] = getattr(self, f"dispconv_{i}")(reflect_pad1(x))
        return outputs


class FrozenBatchNorm(nn.Module):
    """Eval-mode batch norm: (x - mean) / sqrt(var + eps) * weight + bias per
    channel (monodepth2.py:42); the statistics are not updated."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(p):
            return p[:, None, None]

        return (x - c(self.mean)) * torch.rsqrt(c(self.var) + self.eps) * c(self.weight) + c(self.bias)


class BasicBlock(nn.Module):
    """torchvision's ResNet basic block: two 3x3 convs and the skip,
    through a strided 1x1 conv where the shape changes (monodepth2.py:62)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(cout)
        if cin != cout or stride != 1:
            self.downsample = nn.Conv2d(cin, cout, 1, stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(cout)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.downsample is not None:
            x = self.downsample_bn(self.downsample(x))
        return F.relu(h + x)


class ResnetEncoder(nn.Module):
    """ResNet-18: five maps at strides 2 to 32, widths (64, 64, 128, 256, 512)
    (monodepth2.py:83). Input (B, 3, H, W) in [0, 1]."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.blocks: List[str] = []
        cin = 64
        for li, (n, w) in enumerate(zip(layers, widths)):
            names = []
            for bi in range(n):
                name = f"layer{li + 1}_{bi}"
                setattr(self, name, BasicBlock(cin, w, 2 if (bi == 0 and li > 0) else 1))
                names.append(name)
                cin = w
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - 0.45) / 0.225
        h = F.relu(self.bn1(self.conv1(x)))
        feats = [h]
        h = F.max_pool2d(h, 3, 2, 1)
        for names in self.blocks:
            for name in names:
                h = getattr(self, name)(h)
            feats.append(h)
        return feats


class Monodepth2(nn.Module):
    """forward(x (B, 3, H, W) in [-1, 1]) -> [(B, d_out, H / 2^s, W / 2^s) for
    s in scales], shallowest first (monodepth2.py:140)."""

    def __init__(self, d_out: int = 128, scales: Tuple[int, ...] = (0, 1, 2, 3),
                 num_ch_dec: Optional[Sequence[int]] = None):
        super().__init__()
        self.d_out = d_out
        self.scales = tuple(scales)
        self.encoder = ResnetEncoder()
        self.decoder = Monodepth2Decoder(num_ch_dec=tuple(num_ch_dec) if num_ch_dec else (128, 128, 256, 256, 512),
                                         d_out=d_out, scales=self.scales)

    @property
    def latent_size(self) -> int:
        return self.d_out

    def forward(self, x: torch.Tensor, fold_matrix: Optional[torch.Tensor] = None, ground_truth: bool = False,
                crops=None) -> List[torch.Tensor]:
        """The field's encoder call: `ground_truth` and `crops` (a DINO
        encoder's) change nothing here; there is no conv to fold a
        `fold_matrix` into, so one raises (`fast_field.encode_prefolded`
        folds this encoder's grid in two steps)."""
        if fold_matrix is not None:
            raise ValueError("a Monodepth2 encoder has no final conv to fold a matrix into")
        outs = self.decoder(self.encoder(x * 0.5 + 0.5))
        return [outs[s] for s in self.scales]

    def expand_dim(self, features: torch.Tensor) -> torch.Tensor:
        """The identity: a legacy backbone's field features are its own."""
        return features
