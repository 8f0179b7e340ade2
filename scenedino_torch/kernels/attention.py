"""K1: multi-head softmax attention over (B, N, H, D) tensors, with its
backward.

The ViT calls `attention` for every block. It is a
`torch.autograd.Function`: on CUDA tensors the forward launches the
hand-written kernel of `csrc/attention.cu` (bf16, D = 64), which also
writes the rows' log-sum-exp when a gradient is needed, and the backward
launches the two kernels of `csrc/attention_bwd.cu` (wgmma products on
tiles that TMA loads; the primitives are in `csrc/hopper.cuh`):
`attention_bwd_dq` (dQ, and di = rowsum(dO o)) then `attention_bwd_dkv`
(dK, dV). At D = 80 (the I-JEPA-H/14 backbone) the same three functions
launch the forward of `csrc/attention_d80.cu` (mma.sync products on
cp.async tiles) and the backward pair of `csrc/attention_d80_bwd.cu`
(wgmma on TMA tiles, a row of 80 split into a 64-column tile and a
16-column side tile), each with a launch count of its own (`D80_COUNTS`). On
CPU tensors the same Function takes `attention_plain` and
`attention_bwd_plain` (any D). Anything else raises. It replaces the
Pallas TPU flash attention reached from `scenedino_tpu/models/vit.py:126`
and its custom VJP (`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from scenedino_torch.kernels import build

# the head dims the CUDA kernels take: 64 (attention.cu, attention_bwd.cu)
# and 80 (attention_d80.cu, attention_d80_bwd.cu)
HEAD_DIMS = (64, 80)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q k^T / sqrt(D) in fp32, (B, H, N, N)."""
    qf, kf = (t.float().transpose(1, 2) for t in (q, k))
    return (qf @ kf.transpose(-1, -2)) * q.shape[-1] ** -0.5


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per head in fp32 math; the result takes
    q's dtype."""
    s = _scores(q, k)
    return (torch.softmax(s, -1) @ v.float().transpose(1, 2)).transpose(1, 2).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled logits, (B, H, N) fp32."""
    return torch.logsumexp(_scores(q, k), -1)


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO o), (B, H, N) fp32."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_from_di(q, k, v, do, lse, di):
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # (B, H, N, D)
    p = torch.exp(_scores(q, k) - lse.float()[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - di.float()[..., None]) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ dof
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def attention_bwd_plain(q, k, v, o, do, lse) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit fp32 backward: with P = exp(q k^T / sqrt(D) - lse),
    di = rowsum(dO o), dS = P (dO v^T - di) / sqrt(D):
    dq = dS k, dk = dS^T q, dv = P^T dO. Results take q's dtype."""
    return _bwd_from_di(q, k, v, do, lse, _row_dot(o, do))


def _check(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.ndim != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(
            f"attention tensors must share one (B, N, H, D) shape, got "
            f"{[tuple(t.shape) for t in ts]}"
        )
    if any(t.device != q.device or t.dtype != q.dtype for t in ts):
        raise ValueError("attention tensors must share one device and dtype")


def _check_cuda(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu tensors, got {q.device}")
    D = q.shape[-1]
    if q.dtype != torch.bfloat16 or D not in HEAD_DIMS:
        raise ValueError(
            f"the CUDA attention kernels take bf16 with head dim in {HEAD_DIMS}, "
            f"got {q.dtype} with head dim {D} (no other head dim has a kernel: ROADMAP.md, queue 1, item 3)"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the CUDA attention kernels take contiguous tensors")
    _check_aligned(*ts)


def _check_aligned(*ts: torch.Tensor) -> None:
    """The kernels read 16 bytes at a time and the backward's tensor maps
    need a 16-byte aligned base: a view that starts inside an allocation
    may not be."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"the CUDA attention kernels take 16-byte aligned tensors, got one at "
                             f"{t.data_ptr():#x} (storage offset {t.storage_offset()})")


def _launch(step: str, ptrs, q: torch.Tensor) -> None:
    """Launch K1's `step` ("fwd", "bwd_dq" or "bwd_dkv") at q's head dim and
    add one to its launch count."""
    B, N, H, D = q.shape
    lib_name, fn_name, counter = _KERNELS[D][step]
    fn = build.function(lib_name, fn_name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 4
                        + [ctypes.c_float, ctypes.c_void_p])
    err = build.call_on_stream(fn, q.device, *ptrs, B, N, H, D, D ** -0.5)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")
    counter.launches += 1


def attention_fwd(q, k, v, with_lse: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 forward: (out, lse or None). CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v), attention_lse_plain(q, k) if with_lse else None
    _check_cuda(q, k, v)
    B, N, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32) if with_lse else None
    _launch("fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None), q)
    return out, lse


def attention_bwd_dq(q, k, v, o, do, lse) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ and di = rowsum(dO o) (B, H, N) fp32. CPU tensors take the plain version."""
    _check(q, k, v, o, do)
    if q.device.type == "cpu":
        di = _row_dot(o, do)
        return _bwd_from_di(q, k, v, do, lse, di)[0], di
    _check_cuda(q, k, v, o, do)
    _check_stats(lse, q)
    B, N, H, D = q.shape
    dq = torch.empty_like(q)
    di = torch.empty(B, H, N, device=q.device, dtype=torch.float32)
    _launch("bwd_dq", tuple(t.data_ptr() for t in (q, k, v, o, do, lse, dq, di)), q)
    return dq, di


def attention_bwd_dkv(q, k, v, do, lse, di) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV from di of `attention_bwd_dq`. CPU tensors take the plain version."""
    _check(q, k, v, do)
    if q.device.type == "cpu":
        return _bwd_from_di(q, k, v, do, lse, di)[1:]
    _check_cuda(q, k, v, do)
    _check_stats(lse, q)
    _check_stats(di, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("bwd_dkv", tuple(t.data_ptr() for t in (q, k, v, do, lse, di, dk, dv)), q)
    return dk, dv


def _check_stats(t: torch.Tensor, q: torch.Tensor) -> None:
    B, N, H, _ = q.shape
    if t.shape != (B, H, N) or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
        raise ValueError(f"row statistics must be contiguous fp32 {(B, H, N)} on {q.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = attention_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            return attention_bwd_plain(q, k, v, o, do, lse)
        dq, di = attention_bwd_dq(q, k, v, o, do, lse)
        dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
        return dq, dk, dv


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v; q, k, v and the result are (B, N, H, D).
    Differentiable; the forward saves the log-sum-exp only when autograd
    records the call."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v)
    return attention_fwd(q, k, v)[0]


attention.launches = 0
attention_bwd_dq.launches = 0
attention_bwd_dkv.launches = 0
# the launch counts of the D = 80 kernels, which the same three wrappers launch
D80_COUNTS = {name: SimpleNamespace(launches=0)
              for name in ("attention_d80", "attention_d80_bwd_dq", "attention_d80_bwd_dkv")}
# (library, C function, launch count) of each step of K1 at each head dim
_KERNELS = {
    64: {"fwd": ("attention", "attention_fwd", attention),
         "bwd_dq": ("attention_bwd", "attention_bwd_dq", attention_bwd_dq),
         "bwd_dkv": ("attention_bwd", "attention_bwd_dkv", attention_bwd_dkv)},
    80: {"fwd": ("attention_d80", "attention_d80_fwd", D80_COUNTS["attention_d80"]),
         "bwd_dq": ("attention_d80_bwd", "attention_d80_bwd_dq", D80_COUNTS["attention_d80_bwd_dq"]),
         "bwd_dkv": ("attention_d80_bwd", "attention_d80_bwd_dkv", D80_COUNTS["attention_d80_bwd_dkv"])},
}
