"""Field heads (counterpart of `scenedino_tpu/models/heads.py`; reference
`scenedino/models/prediction_heads/resnetfc.py`, `mlp.py`).

The shipped SceneDINO head is ResnetFC with n_blocks=0: lin_out(relu(lin_in(x))),
d_in = feature + positional code, d_out = 1 + dino_dims; the serving path
folds it (ops/fast_field.py). The general ResnetFC (residual blocks, a
softplus activation for beta > 0, latent conditioning through `lin_z_<i>`,
the views combined at `combine_layer`) and the "mlp" `ImplicitNet` (skip
connections) are the reference's other heads. Inputs are (..., V, d_in);
a head's call may carry the field's `invalid_features` (..., V), which
only the multi-view heads (`models.multi_view_head`) read.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

MULTI_VIEW_HEADS = ("MultiViewHead", "SimpleMultiViewHead", "MultiViewHead2", "MultiViewHead3")


def _kaiming(lin: nn.Linear, zero: bool = False) -> nn.Linear:
    if zero:
        nn.init.zeros_(lin.weight)
    else:
        nn.init.kaiming_normal_(lin.weight, mode="fan_in")
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)
    return lin


def _activation(beta: float):
    if beta > 0:
        return lambda v: F.softplus(beta * v) / beta
    return torch.relu


def combine_views(x: torch.Tensor, combine_type: str = "average") -> torch.Tensor:
    """Reduce the view axis (-2) (combine_interleaved, util.py:470-480)."""
    if combine_type == "average":
        return x.mean(-2)
    if combine_type == "max":
        return x.amax(-2)
    raise NotImplementedError(combine_type)


class ResnetBlockFC(nn.Module):
    """Fully connected residual block (resnetfc.py:11-64): fc_1(act(fc_0(act(x))))
    plus x, or plus a bias-free `shortcut` of x where the width changes;
    fc_1 starts at zero."""

    def __init__(self, size_in: int, size_out: Optional[int] = None, size_h: Optional[int] = None,
                 beta: float = 0.0):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.act = _activation(beta)
        self.fc_0 = _kaiming(nn.Linear(size_in, size_h))
        self.fc_1 = _kaiming(nn.Linear(size_h, size_out), zero=True)
        self.shortcut = _kaiming(nn.Linear(size_in, size_out, bias=False)) if size_in != size_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.fc_1(self.act(self.fc_0(self.act(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + dx


class ResnetFC(nn.Module):
    """pixelNeRF's conditioned MLP (resnetfc.py:67-203): lin_in on the
    input's last d_in - d_latent channels, n_blocks residual blocks (each
    below `combine_layer` adds lin_z_<i> of the first d_latent channels;
    the view axis is averaged or maxed at `combine_layer`, keeping a view
    of 1), lin_out of the activation. With n_blocks=0 it is
    lin_out(act(lin_in(x)))."""

    def __init__(self, d_in: int, d_out: int, d_hidden: int = 128, n_blocks: int = 0, d_latent: int = 0,
                 beta: float = 0.0, combine_layer: int = 1000, combine_type: str = "average"):
        super().__init__()
        self.n_blocks, self.d_latent = n_blocks, d_latent
        self.combine_layer, self.combine_type = combine_layer, combine_type
        self.act = _activation(beta)
        self.lin_in = nn.Linear(d_in - d_latent, d_hidden)
        for i in range(n_blocks):
            if d_latent > 0 and i < combine_layer:
                setattr(self, f"lin_z_{i}", nn.Linear(d_latent, d_hidden))
            setattr(self, f"block_{i}", ResnetBlockFC(d_hidden, beta=beta))
        self.lin_out = nn.Linear(d_hidden, d_out)
        for lin in (self.lin_in, self.lin_out):  # first: a seed draws the n_blocks=0 head as it always has
            _kaiming(lin)
        for i in range(n_blocks):
            if hasattr(self, f"lin_z_{i}"):
                _kaiming(getattr(self, f"lin_z_{i}"))

    def forward(self, zx: torch.Tensor, **kwargs) -> torch.Tensor:
        z, x = (zx[..., :self.d_latent], zx[..., self.d_latent:]) if self.d_latent > 0 else (None, zx)
        x = self.lin_in(x)
        for i in range(self.n_blocks):
            if i == self.combine_layer:
                x = combine_views(x, self.combine_type)[..., None, :]
            if z is not None and i < self.combine_layer:
                x = x + getattr(self, f"lin_z_{i}")(z)
            x = getattr(self, f"block_{i}")(x)
        return self.lin_out(self.act(x))


class ImplicitNet(nn.Module):
    """A plain MLP with skip connections (mlp.py:11-100): layer i is
    relu(lin_<i>(x)), the input concatenated (over sqrt 2) before the
    layers in `skip_in`, the views combined before `combine_layer`; then
    lin_out."""

    def __init__(self, d_in: int, d_out: int, dims: Sequence[int] = (128, 128, 128, 128),
                 skip_in: Sequence[int] = (), combine_layer: int = 1000, combine_type: str = "average"):
        super().__init__()
        self.dims, self.skip_in = tuple(dims), tuple(skip_in)
        self.combine_layer, self.combine_type = combine_layer, combine_type
        width = inp = d_in
        for i, d in enumerate(self.dims):
            if i == combine_layer:  # the combined views become the skips' input
                inp = width
            setattr(self, f"lin_{i}", nn.Linear(width + (inp if i in self.skip_in else 0), d))
            width = d
        self.lin_out = nn.Linear(width, d_out)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        inp = x
        for i in range(len(self.dims)):
            if i == self.combine_layer:
                x = combine_views(x, self.combine_type)[..., None, :]
                inp = x
            if i in self.skip_in:
                x = torch.cat([x, inp], -1) / math.sqrt(2.0)
            x = torch.relu(getattr(self, f"lin_{i}")(x))
        return self.lin_out(x)


def make_head(conf: dict, d_in: int, d_out: int) -> nn.Module:
    """The head of a `decoder_heads` entry (prediction_heads/__init__.py:14-47)."""
    kind = conf.get("type", "resnet")
    args = dict(conf.get("args", {}) or {})
    if kind == "resnet":
        return ResnetFC(d_in, d_out, d_hidden=args.get("d_hidden", 128), n_blocks=args.get("n_blocks", 0),
                        d_latent=args.get("d_latent", 0), beta=args.get("beta", 0.0),
                        combine_layer=args.get("combine_layer", 1000),
                        combine_type=args.get("combine_type", "average"))
    if kind == "mlp":
        return ImplicitNet(d_in, d_out, dims=tuple(args.get("dims", (128, 128, 128, 128))),
                           skip_in=tuple(args.get("skip_in", ())), combine_layer=args.get("combine_layer", 1000),
                           combine_type=args.get("combine_type", "average"))
    if kind in MULTI_VIEW_HEADS:  # the legacy BTS attention-aggregation heads
        from scenedino_torch.models.multi_view_head import make_multi_view_head

        return make_multi_view_head(kind, args or dict(conf), conf.get("d_in", d_in), d_out)
    raise ValueError(f"unknown head type: {kind}")
