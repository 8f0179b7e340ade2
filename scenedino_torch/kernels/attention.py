"""K1: multi-head softmax attention over (B, N, H, D) tensors, with its
backward.

The ViT calls `attention` for every block. It is a
`torch.autograd.Function`: on CUDA tensors the forward launches the
hand-written kernel of `csrc/attention.cu` (bf16, D = 64), which also
writes the rows' log-sum-exp when a gradient is needed, and the backward
launches the two kernels of `csrc/attention_bwd.cu` (wgmma products on
tiles that TMA loads; the primitives are in `csrc/hopper.cuh`):
`attention_bwd_dq` (dQ, and di = rowsum(dO o)) then `attention_bwd_dkv`
(dK, dV). On CPU
tensors the same Function takes `attention_plain` and
`attention_bwd_plain`. Anything else raises. It replaces the Pallas TPU
flash attention reached from `scenedino_tpu/models/vit.py:126` and its
custom VJP (`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from scenedino_torch.kernels import build

HEAD_DIM = 64


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
    if q.dtype != torch.bfloat16 or D != HEAD_DIM:
        raise ValueError(
            f"the CUDA attention kernels take bf16 with head dim {HEAD_DIM}, "
            f"got {q.dtype} with head dim {D}"
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


_functions: Dict[Tuple[str, str], Callable] = {}


def _function(lib_name: str, fn_name: str, n_ptrs: int) -> Callable:
    """The C function `fn_name` of `csrc/<lib_name>.cu`; its ctypes
    signature is set once, when it is first looked up."""
    fn = _functions.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(build.load(lib_name), fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _functions[lib_name, fn_name] = fn
    return fn


def _launch(lib_name: str, fn_name: str, n_ptrs: int, ptrs, dims, device) -> None:
    fn = _function(lib_name, fn_name, n_ptrs)
    B, N, H, D = dims
    with torch.cuda.device(device):
        err = fn(*ptrs, B, N, H, D, D ** -0.5, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")


def attention_fwd(q, k, v, with_lse: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 forward: (out, lse or None). CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v), attention_lse_plain(q, k) if with_lse else None
    _check_cuda(q, k, v)
    B, N, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32) if with_lse else None
    _launch("attention", "attention_fwd", 5,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None),
            q.shape, q.device)
    attention.launches += 1
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
    _launch("attention_bwd", "attention_bwd_dq", 8,
            tuple(t.data_ptr() for t in (q, k, v, o, do, lse, dq, di)), q.shape, q.device)
    attention_bwd_dq.launches += 1
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
    _launch("attention_bwd", "attention_bwd_dkv", 8,
            tuple(t.data_ptr() for t in (q, k, v, do, lse, di, dk, dv)), q.shape, q.device)
    attention_bwd_dkv.launches += 1
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
