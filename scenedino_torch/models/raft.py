"""RAFT-large optical flow (counterpart of `scenedino_tpu/models/raft.py`;
`torchvision.models.optical_flow.raft_large` as the reference's
RaftExtractor and Flow(Occlusion)Processor use it,
`scenedino/common/image_processor.py:161-263`). NCHW throughout.

- `RAFTEncoder`: the feature trunk (instance norm, eps 1e-5, biased
  variance) or the context trunk (frozen batch norm: stored statistics as
  parameters): a 7x7/2 conv, three residual stages (64, 96, 128 channels;
  strides 1, 2, 2), a 1x1 conv to 256 channels at 1/8 resolution.
- `correlation_pyramid`: all-pairs correlation over sqrt(C), then three
  2x2 average pools; `lookup_pyramid`: a bilinear window of radius 4 at
  each level (zeros outside), 4 x 81 = 324 channels, the window's x offset
  varying slowest (torchvision's CorrBlock meshgrid, "ij"), the channel
  order converted weights expect. The correlation is a plain matmul.
- The update: motion encoder, separable ConvGRU (1x5 then 5x1, hidden
  128), flow head, `iters` times in a Python loop with shared weights;
  then the mask predictor and `convex_upsample` (x8).

`convert_raft_state_dict` maps a torchvision `raft_large` state dict onto
`RAFT`'s (the JAX names, convolutions OIHW as torch keeps them;
BatchNorm's running_mean / running_var become `mean` / `var`).
`make_raft_flow_fn` gives the processors' `flow_fn`. No weights ship.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch.models.monodepth2 import FrozenBatchNorm


def _norm(kind: str, features: int) -> nn.Module:
    if kind == "instance":  # no parameters, no running statistics
        return nn.InstanceNorm2d(features)
    if kind == "batch":
        return FrozenBatchNorm(features)
    raise ValueError(kind)


def _conv(cin: int, cout: int, k, stride: int = 1, pad=0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, pad)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int, norm: str):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.norm1, self.norm2 = _norm(norm, features), _norm(norm, features)
        self.downsample_conv = self.downsample_norm = None
        if stride != 1 or cin != features:
            self.downsample_conv = _conv(cin, features, 1, stride)
            self.downsample_norm = _norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        return F.relu(x + y)


class RAFTEncoder(nn.Module):
    """The feature ("instance") or context ("batch") trunk: (B, 3, H, W) in
    [-1, 1] -> (B, out_channels, H/8, W/8)."""

    def __init__(self, norm: str = "instance", out_channels: int = 256,
                 stage_channels: Tuple[int, ...] = (64, 96, 128)):
        super().__init__()
        self.conv_in = _conv(3, 64, 7, 2, 3)
        self.norm_in = _norm(norm, 64)
        cin = 64
        self.stages: List[str] = []
        for i, (ch, stride) in enumerate(zip(stage_channels, (1, 2, 2))):
            for j, s in ((0, stride), (1, 1)):
                setattr(self, f"layer{i + 1}_{j}", ResidualBlock(cin, ch, s, norm))
                self.stages.append(f"layer{i + 1}_{j}")
                cin = ch
        self.conv_out = _conv(cin, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm_in(self.conv_in(x)))
        for name in self.stages:
            x = getattr(self, name)(x)
        return self.conv_out(x)


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor, num_levels: int = 4) -> List[torch.Tensor]:
    """f1, f2 (B, C, H, W) at 1/8 -> [(B*H*W, 1, h_l, w_l)]: level 0 the
    correlation of each pixel of f1 with every pixel of f2 over sqrt(C),
    each further level a 2x2 average pool (floor) of the one before."""
    B, C, H, W = f1.shape
    corr = torch.matmul(f1.float().reshape(B, C, H * W).transpose(1, 2), f2.float().reshape(B, C, H * W))
    corr = (corr / torch.sqrt(torch.tensor(float(C)))).reshape(B * H * W, 1, H, W)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return pyramid


def lookup_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """coords (B, H, W, 2) pixel (x, y) in level-0 units -> (B, H, W,
    levels * (2r + 1)^2): each level's correlation at coords / 2^level plus
    the window's offsets, bilinear from its four neighbours, a neighbour
    outside the level 0; tap t = i (2r + 1) + j is the offset (dx_i, dy_j)."""
    B, H, W, _ = coords.shape
    n = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).reshape(-1, 2)  # (n*n, 2): x slowest
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        flat = corr.reshape(B * H * W, hl * wl)
        c = coords.reshape(B * H * W, 1, 2) / (2.0 ** lvl) + delta[None]
        x, y = c[..., 0], c[..., 1]
        x0, y0 = torch.floor(x), torch.floor(y)
        wx, wy = x - x0, y - y0

        def tap(yy, xx):
            idx = yy.long().clamp(0, hl - 1) * wl + xx.long().clamp(0, wl - 1)
            v = torch.gather(flat, 1, idx)
            inside = (yy >= 0) & (yy <= hl - 1) & (xx >= 0) & (xx <= wl - 1)
            return torch.where(inside, v, torch.zeros_like(v))

        val = (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x0 + 1) * wx * (1 - wy)
               + tap(y0 + 1, x0) * (1 - wx) * wy + tap(y0 + 1, x0 + 1) * wx * wy)
        out.append(val.reshape(B, H, W, n * n))
    return torch.cat(out, -1)


class MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 4 * 81):
        super().__init__()
        self.convcorr1 = _conv(corr_channels, 256, 1)
        self.convcorr2 = _conv(256, 192, 3, 1, 1)
        self.convflow1 = _conv(2, 128, 7, 1, 3)
        self.convflow2 = _conv(128, 64, 3, 1, 1)
        self.conv = _conv(192 + 64, 126, 3, 1, 1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convcorr2(F.relu(self.convcorr1(corr))))
        f = F.relu(self.convflow2(F.relu(self.convflow1(flow))))
        cf = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([cf, flow], 1)  # 128


class SepConvGRU(nn.Module):
    """A ConvGRU pass with 1x5 kernels, then one with 5x1 (hidden 128)."""

    def __init__(self, hidden: int = 128, input_dim: int = 128 + 128):
        super().__init__()
        for name, k, pad in (("horizontal", (1, 5), (0, 2)), ("vertical", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}_{name}", _conv(hidden + input_dim, hidden, k, 1, pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for name in ("horizontal", "vertical"):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz_{name}")(hx))
            r = torch.sigmoid(getattr(self, f"convr_{name}")(hx))
            q = torch.tanh(getattr(self, f"convq_{name}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(128, 256, 3, 1, 1)
        self.conv2 = _conv(256, 2, 3, 1, 1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(h)))


class MaskPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(128, 256, 3, 1, 1)
        self.conv2 = _conv(256, 8 * 8 * 9, 1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(h))) * 0.25


class UpdateStep(nn.Module):
    """One recurrent update; `RAFT` runs it `iters` times with its weights."""

    def __init__(self, corr_radius: int = 4, corr_levels: int = 4):
        super().__init__()
        self.corr_radius = corr_radius
        self.motion_encoder = MotionEncoder(corr_levels * (2 * corr_radius + 1) ** 2)
        self.recurrent_block = SepConvGRU()
        self.flow_head = FlowHead()

    def forward(self, h, coords1, inp, coords0, pyramid):
        corr = lookup_pyramid(pyramid, coords1.permute(0, 2, 3, 1), self.corr_radius).permute(0, 3, 1, 2)
        m = self.motion_encoder(coords1 - coords0, corr)
        h = self.recurrent_block(h, torch.cat([inp, m], 1))
        return h, coords1 + self.flow_head(h)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow (B, 2, H, W) at 1/8, mask (B, 576, H, W) -> (B, 2, 8H, 8W): each
    fine pixel (8h + u, 8w + v) a softmax-weighted (mask channel k*64 + u*8
    + v over k) mix of the 3x3 zero-padded coarse neighbourhood of 8 x flow
    (RAFT, eq. 6)."""
    B, _, H, W = flow.shape
    m = torch.softmax(mask.reshape(B, 9, 8, 8, H, W), dim=1)
    fp = F.pad(flow * 8.0, (1, 1, 1, 1))
    taps = torch.stack([fp[:, :, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], 1)  # (B, 9, 2, H, W)
    up = torch.einsum("bkuvhw,bkchw->bchuwv", m, taps)
    return up.reshape(B, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """raft_large: forward(img0, img1 (B, 3, H, W) in [-1, 1]) -> the last
    iteration's upsampled flow (B, 2, H, W) in pixels."""

    def __init__(self, iters: int = 12, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        self.iters, self.corr_levels = iters, corr_levels
        self.feature_encoder = RAFTEncoder("instance")
        self.context_encoder = RAFTEncoder("batch")
        self.update = UpdateStep(corr_radius, corr_levels)
        self.mask_predictor = MaskPredictor()

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        f1 = self.feature_encoder(img0).float()
        f2 = self.feature_encoder(img1).float()
        ctx = self.context_encoder(img0)
        h, inp = torch.tanh(ctx[:, :128]), F.relu(ctx[:, 128:])
        pyramid = correlation_pyramid(f1, f2, self.corr_levels)
        B, _, H8, W8 = f1.shape
        ys, xs = torch.meshgrid(torch.arange(H8, dtype=torch.float32, device=f1.device),
                                torch.arange(W8, dtype=torch.float32, device=f1.device), indexing="ij")
        coords0 = torch.stack([xs, ys])[None].expand(B, 2, H8, W8)
        coords1 = coords0
        for _ in range(self.iters):
            h, coords1 = self.update(h, coords1, inp, coords0, pyramid)
        return convex_upsample(coords1 - coords0, self.mask_predictor(h))


# ------------------------------------------------------------- converter
def convert_raft_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision raft_large state dict (0.18's module tree:
    {feature,context}_encoder.{convnormrelu.0, layer<s>.<b>.convnormrelu{1,2}.0,
    .downsample.0, conv}, update_block.motion_encoder.conv*.0,
    update_block.recurrent_block.convgru{1,2}.conv{z,r,q},
    update_block.flow_head.conv{1,2}, mask_predictor.{convrelu.0, conv};
    instance norms hold nothing, batch norms weight / bias / running
    statistics) -> `RAFT`'s state dict."""
    out: Dict[str, torch.Tensor] = {}

    def t(key):
        v = sd[key]
        return (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).float().clone()

    def conv(src, dst):
        out[f"{dst}.weight"] = t(f"{src}.weight")
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = t(f"{src}.bias")

    def bn(src, dst):
        for a, b in (("weight", "weight"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
            out[f"{dst}.{b}"] = t(f"{src}.{a}")

    for prefix, batch in (("feature_encoder", False), ("context_encoder", True)):
        conv(f"{prefix}.convnormrelu.0", f"{prefix}.conv_in")
        conv(f"{prefix}.conv", f"{prefix}.conv_out")
        if batch:
            bn(f"{prefix}.convnormrelu.1", f"{prefix}.norm_in")
        for stage in (1, 2, 3):
            for blk in (0, 1):
                src, dst = f"{prefix}.layer{stage}.{blk}", f"{prefix}.layer{stage}_{blk}"
                conv(f"{src}.convnormrelu1.0", f"{dst}.conv1")
                conv(f"{src}.convnormrelu2.0", f"{dst}.conv2")
                if batch:
                    bn(f"{src}.convnormrelu1.1", f"{dst}.norm1")
                    bn(f"{src}.convnormrelu2.1", f"{dst}.norm2")
                if f"{src}.downsample.0.weight" in sd:
                    conv(f"{src}.downsample.0", f"{dst}.downsample_conv")
                    if batch:
                        bn(f"{src}.downsample.1", f"{dst}.downsample_norm")
    me, rb = "update_block.motion_encoder", "update_block.recurrent_block"
    for name in ("convcorr1", "convcorr2", "convflow1", "convflow2", "conv"):
        conv(f"{me}.{name}.0", f"update.motion_encoder.{name}")
    for gru, direction in (("convgru1", "horizontal"), ("convgru2", "vertical")):
        for gate in ("z", "r", "q"):
            conv(f"{rb}.{gru}.conv{gate}", f"update.recurrent_block.conv{gate}_{direction}")
    conv("update_block.flow_head.conv1", "update.flow_head.conv1")
    conv("update_block.flow_head.conv2", "update.flow_head.conv2")
    conv("mask_predictor.convrelu.0", "mask_predictor.conv1")
    conv("mask_predictor.conv", "mask_predictor.conv2")
    return out


def make_raft_flow_fn(params: Mapping[str, torch.Tensor], iters: int = 12, device=None):
    """`flow_fn(img0, img1)` of the flow processors from converted weights
    (`convert_raft_state_dict`), on `device` (the weights' by default):
    inputs in [0, 1] (processor space), mapped to [-1, 1] as the
    torchvision transform maps them."""
    model = RAFT(iters=iters)
    model.load_state_dict(params)
    model = model.to(device if device is not None else next(iter(params.values())).device).eval()

    def flow_fn(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        return model(img0 * 2 - 1, img1 * 2 - 1)

    return flow_fn
