"""Hand-written CUDA kernels of the port and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain PyTorch version for CPU tensors. Each keeps `launches`, the
number of kernel launches it made, so a run can show that its path went
through the kernel; K1's wrappers keep the counts of the D = 80 kernels, of
the kernels of every other head dim to 256 and of those past 256 apart.
"""
from scenedino_torch.kernels.attention import (
    ANY_COUNTS,
    D80_COUNTS,
    WIDE_COUNTS,
    attention,
    attention_bwd_dkv,
    attention_bwd_dq,
)
from scenedino_torch.kernels.encode_view import encode_view
from scenedino_torch.kernels.point_render import point_query, point_render, probe_weights
from scenedino_torch.kernels.row_gather import row_gather

WRAPPERS = {
    "attention": attention,
    "attention_bwd_dq": attention_bwd_dq,
    "attention_bwd_dkv": attention_bwd_dkv,
    **D80_COUNTS,
    **ANY_COUNTS,
    **WIDE_COUNTS,
    "point_render": point_render,
    "probe_weights": probe_weights,
    "point_query": point_query,
    "row_gather": row_gather,
    "encode_view": encode_view,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
