"""Core math of the port (counterpart of `scenedino_tpu.core`)."""
from __future__ import annotations

import torch


def maximum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """`jnp.maximum(x, bound)` with its gradient: at a tie each side gets
    half. `torch.clamp` would pass the whole gradient to x."""
    return torch.maximum(x, x.new_tensor(bound))


def minimum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """`jnp.minimum(x, bound)`, ties split like `maximum`."""
    return torch.minimum(x, x.new_tensor(bound))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`, ties split like `maximum`."""
    return minimum(maximum(x, lo), hi)


def absolute(x: torch.Tensor) -> torch.Tensor:
    """`jnp.abs(x)` with its gradient: +1 at x = 0, where `torch.abs`
    gives 0 (an L1 term of a pixel rendered exactly at its target)."""
    return torch.where(x >= 0, x, -x)


def safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-10) -> torch.Tensor:
    """L2-normalize with a gradient that is finite at x = 0.

    `x * rsqrt(max(|x|^2, eps^2))`: at an all-zero row the max passes no
    gradient to the norm, so the gradient is I / eps instead of 0/0.
    """
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(maximum(sq, eps * eps))
