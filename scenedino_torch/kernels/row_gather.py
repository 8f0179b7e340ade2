"""Row gather: out[i] = table[idx[i]] for a 2-D table (the P1/P2 kernel).

The counterpart of the repository's two Pallas row-gather probes,
`tools/probe_pallas_gather.py:17` `run` (256 rows of a 512x128 fp32 table)
and `tools/bench_pallas_gather.py:38` `pallas_gather` (2^20 rows of a
32768x128 bf16 table). Mosaic could not lower either; on Hopper a row
gather is one plain kernel, `csrc/row_gather.cu`. On the serving path it
carries the probe render's nearest upsample of the probe histograms
(`ops/fast_field.render_novel_view_probe`).

On CUDA tensors `row_gather` launches the kernel or raises; on CPU tensors
it takes `row_gather_plain`, `table[idx]`. At P1's size a call is host
time: the wrapper makes every check on every call, but looks its C
function up and types it once and switches device only when it must
(`build.function`, `build.call_on_stream`).
"""
from __future__ import annotations

import ctypes

import torch

from scenedino_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]`; an index outside [0, rows) raises."""
    return table[idx.long()]


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of `table` (rows, C) at int32 indices `idx` (n,): (n, C).

    On CUDA the kernel takes a contiguous fp32 or bf16 table whose
    row is a multiple of 16 bytes, 16-byte aligned, and contiguous int32
    indices, and raises on anything else. It reads nothing outside the
    table: an index outside [0, rows) gives a row of zero bytes (the plain
    version raises on one; nothing in the port passes one).
    """
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"row_gather takes a 2-D table and 1-D indices, got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"row_gather takes int32 indices, got {idx.dtype}")
    device = table.device
    if device != idx.device:
        raise ValueError("row_gather's table and indices must share one device")
    if device.type == "cpu":
        return row_gather_plain(table, idx)
    if device.type != "cuda":
        raise ValueError(f"row_gather runs on cuda or cpu tensors, got {device}")
    rows, C = table.shape
    row_bytes = C * table.element_size()
    if table.dtype not in DTYPES:
        raise ValueError(f"the CUDA row_gather kernel takes an fp32 or bf16 table, got {table.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the CUDA row_gather kernel takes a contiguous table and indices")
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"the CUDA row_gather kernel takes 16-byte aligned rows of a multiple of 16 bytes; "
                         f"got {row_bytes} bytes a row")
    if rows >= 2 ** 31:
        raise ValueError(f"the CUDA row_gather kernel takes fewer than 2^31 rows, got {rows}")
    n = idx.shape[0]
    out = torch.empty((n, C), dtype=table.dtype, device=device)
    err = build.call_on_stream(build.function("row_gather", "row_gather", ARGTYPES), device, table.data_ptr(),
                               idx.data_ptr(), out.data_ptr(), n, rows, row_bytes)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: cudaError {err}")
    build.count_launch(row_gather)
    return out


row_gather.launches = 0
