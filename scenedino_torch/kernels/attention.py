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
launch the forward of `csrc/attention_d80.cu` and the backward pair of
`csrc/attention_d80_bwd.cu`, all three wgmma on TMA tiles with a row of 80
split into a 64-column tile and a 16-column side tile (`csrc/hopper.cuh`'s
rows of 80), each with a launch count of its own (`D80_COUNTS`). At every
other head dim up to 256 (D = 32 in the ViTs of the configs'
`vit_overrides`, 8 and 16 in the JAX package's tests) they launch the three
kernels of `csrc/attention_any.cu` (`ANY_COUNTS`): the same design on a row
of ceil(D / 64) whole 64-column tiles, whose columns past D TMA fills with
zeros, at the padded widths 64, 128, 192 and 256. Past 256 (a ViT of
`vit_overrides` with wide heads: ViT-B/8 with 2 heads has D = 384) they
launch the three kernels of `csrc/attention_wide.cu` (`WIDE_COUNTS`): the
output columns in groups of 256 (dK and dV: 128) a block, each group
recomputing the products over the whole head dim, every operand streamed
through one ring in 64-column chunks. Where D % 8 != 0 the
wrappers zero-pad q, k, v (and o, dO) to the next multiple of 8 with one
copy each, launch those kernels at the true D's softmax scale and cut the
results back to D (`route` names each head dim's kernels and widths).
On CPU tensors the same Function takes `attention_plain` and
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

# the head dims with kernels of their own: 64 (attention.cu, attention_bwd.cu)
# and 80 (attention_d80.cu, attention_d80_bwd.cu); every other head dim up to
# ANY_MAX_HEAD_DIM, attention_any.cu's widest, takes attention_any.cu, and
# every one past it attention_wide.cu
HEAD_DIMS = (64, 80)
ANY_MAX_HEAD_DIM = 256


def route(D: int) -> Tuple[object, int, int]:
    """The kernels that K1 launches at head dim D: (their key in `_KERNELS`,
    the width the wrappers hand them, the width they compute at). D = 64
    and 80 take their own; every other D up to ANY_MAX_HEAD_DIM takes
    attention_any.cu and every D past it attention_wide.cu, each handed D
    rounded up to a multiple of 8 (zero columns added by the wrappers) and
    computing at the next multiple of 64 (zero columns added by TMA)."""
    if D <= 0:
        raise ValueError(f"a head dim is positive, got {D}")
    if D in HEAD_DIMS:
        return D, D, D
    aligned = -(-D // 8) * 8
    return "any" if D <= ANY_MAX_HEAD_DIM else "wide", aligned, -(-aligned // 64) * 64


def _scores(q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q k^T times `scale` (default 1 / sqrt(D)) in fp32, (B, H, N, N)."""
    qf, kf = (t.float().transpose(1, 2) for t in (q, k))
    return (qf @ kf.transpose(-1, -2)) * (q.shape[-1] ** -0.5 if scale is None else scale)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per head in fp32 math (`scale` in place of
    1 / sqrt(D) where given); the result takes q's dtype."""
    s = _scores(q, k, scale)
    return (torch.softmax(s, -1) @ v.float().transpose(1, 2)).transpose(1, 2).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled logits, (B, H, N) fp32."""
    return torch.logsumexp(_scores(q, k, scale), -1)


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO o), (B, H, N) fp32."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_from_di(q, k, v, do, lse, di, scale=None):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # (B, H, N, D)
    p = torch.exp(_scores(q, k, scale) - lse.float()[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - di.float()[..., None]) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dv = p.transpose(-1, -2) @ dof
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def attention_bwd_plain(q, k, v, o, do, lse, scale=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit fp32 backward: with P = exp(q k^T / sqrt(D) - lse),
    di = rowsum(dO o), dS = P (dO v^T - di) / sqrt(D) (`scale` in place of
    1 / sqrt(D) where given): dq = dS k, dk = dS^T q, dv = P^T dO. Results
    take q's dtype."""
    return _bwd_from_di(q, k, v, do, lse, _row_dot(o, do), scale)


def with_head_dim(width: int, fn, *ts: torch.Tensor):
    """`fn` on the (B, N, H, D) tensors `ts` zero-padded along the head dim
    to `width` (one copy each; none where D is `width`), with every 4-D
    tensor of its results cut back to D. Zero columns leave q k^T, the
    log-sum-exp, di and the other columns unchanged, so the cut results are
    those at D when `fn` uses D's softmax scale."""
    D = ts[0].shape[-1]
    if width == D:
        return fn(*ts)
    out = fn(*(torch.nn.functional.pad(t, (0, width - D)) for t in ts))
    return tuple(t[..., :D].contiguous() if t is not None and t.ndim == 4 else t for t in out)


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
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA attention kernels take bf16, got {q.dtype}")
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


def _launch(step: str, ptrs, q: torch.Tensor, key, scale: float) -> None:
    """Launch K1's `step` ("fwd", "bwd_dq" or "bwd_dkv") of the kernels
    `_KERNELS[key]` at q's (padded) head dim with softmax scale `scale` and
    add one to its launch count."""
    B, N, H, D = q.shape
    lib_name, fn_name, counter = _KERNELS[key][step]
    fn = build.function(lib_name, fn_name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 4
                        + [ctypes.c_float, ctypes.c_void_p])
    err = build.call_on_stream(fn, q.device, *ptrs, B, N, H, D, scale)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")
    build.count_launch(counter)


def _on_kernels(fn, *ts: torch.Tensor):
    """`fn(*ts, key, scale)` with the kernels' key and the width that `route`
    gives D (the tensors padded and the results cut back where D % 8 != 0),
    at D's softmax scale."""
    D = ts[0].shape[-1]
    key, width, _ = route(D)
    return with_head_dim(width, lambda *padded: fn(*padded, key, D ** -0.5), *ts)


def _fwd_kernel(q, k, v, with_lse, key, scale):
    B, N, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32) if with_lse else None
    _launch("fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None), q, key, scale)
    return out, lse


def attention_fwd(q, k, v, with_lse: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1 forward: (out, lse or None). CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v), attention_lse_plain(q, k) if with_lse else None
    _check_cuda(q, k, v)
    return _on_kernels(lambda q, k, v, key, scale: _fwd_kernel(q, k, v, with_lse, key, scale), q, k, v)


def attention_bwd_dq(q, k, v, o, do, lse) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ and di = rowsum(dO o) (B, H, N) fp32. CPU tensors take the plain version."""
    _check(q, k, v, o, do)
    if q.device.type == "cpu":
        di = _row_dot(o, do)
        return _bwd_from_di(q, k, v, do, lse, di)[0], di
    _check_cuda(q, k, v, o, do)
    _check_stats(lse, q)

    def launch(q, k, v, o, do, key, scale):
        B, N, H, _ = q.shape
        dq = torch.empty_like(q)
        di = torch.empty(B, H, N, device=q.device, dtype=torch.float32)
        _launch("bwd_dq", tuple(t.data_ptr() for t in (q, k, v, o, do, lse, dq, di)), q, key, scale)
        return dq, di

    return _on_kernels(launch, q, k, v, o, do)


def attention_bwd_dkv(q, k, v, do, lse, di) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV from di of `attention_bwd_dq`. CPU tensors take the plain version."""
    _check(q, k, v, do)
    if q.device.type == "cpu":
        return _bwd_from_di(q, k, v, do, lse, di)[1:]
    _check_cuda(q, k, v, do)
    _check_stats(lse, q)
    _check_stats(di, q)

    def launch(q, k, v, do, key, scale):
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        _launch("bwd_dkv", tuple(t.data_ptr() for t in (q, k, v, do, lse, di, dk, dv)), q, key, scale)
        return dk, dv

    return _on_kernels(launch, q, k, v, do)


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
# the launch counts of the D = 80 kernels, of the kernels of every other head
# dim to 256 and of those past it, which the same three wrappers launch
D80_COUNTS = {name: SimpleNamespace(launches=0)
              for name in ("attention_d80", "attention_d80_bwd_dq", "attention_d80_bwd_dkv")}
ANY_COUNTS = {name: SimpleNamespace(launches=0)
              for name in ("attention_any", "attention_any_bwd_dq", "attention_any_bwd_dkv")}
WIDE_COUNTS = {name: SimpleNamespace(launches=0)
               for name in ("attention_wide", "attention_wide_bwd_dq", "attention_wide_bwd_dkv")}
# (library, C function, launch count) of each step of K1 at each head dim
_KERNELS = {
    64: {"fwd": ("attention", "attention_fwd", attention),
         "bwd_dq": ("attention_bwd", "attention_bwd_dq", attention_bwd_dq),
         "bwd_dkv": ("attention_bwd", "attention_bwd_dkv", attention_bwd_dkv)},
    80: {"fwd": ("attention_d80", "attention_d80_fwd", D80_COUNTS["attention_d80"]),
         "bwd_dq": ("attention_d80_bwd", "attention_d80_bwd_dq", D80_COUNTS["attention_d80_bwd_dq"]),
         "bwd_dkv": ("attention_d80_bwd", "attention_d80_bwd_dkv", D80_COUNTS["attention_d80_bwd_dkv"])},
    "any": {"fwd": ("attention_any", "attention_any_fwd", ANY_COUNTS["attention_any"]),
            "bwd_dq": ("attention_any", "attention_any_bwd_dq", ANY_COUNTS["attention_any_bwd_dq"]),
            "bwd_dkv": ("attention_any", "attention_any_bwd_dkv", ANY_COUNTS["attention_any_bwd_dkv"])},
    "wide": {"fwd": ("attention_wide", "attention_wide_fwd", WIDE_COUNTS["attention_wide"]),
             "bwd_dq": ("attention_wide", "attention_wide_bwd_dq", WIDE_COUNTS["attention_wide_bwd_dq"]),
             "bwd_dkv": ("attention_wide", "attention_wide_bwd_dkv", WIDE_COUNTS["attention_wide_bwd_dkv"])},
}
