"""The monodepth2 decoder (counterpart of `scenedino_tpu/models/monodepth2.py:110`
`Monodepth2Decoder`), which the simple-feature-pyramid decoder
(`dpt.SimpleFeaturePyramidDecoder`) runs. NCHW throughout; fp32.

From the deepest map up, each level is a 3x3 conv block (reflection pad,
ELU), a nearest x2 upsample, the skip map of the level above concatenated
(cropped to it), a second conv block and, at the output scales, a bare
reflection-padded 3x3 conv to `d_out`. The ResNet encoder of monodepth2 is
not ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


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
