"""K1 at every head dim but 64 and 80 on the CPU: the port's attention
against JAX at D = 32, 48, 96 and 128, and the walks of
`csrc/attention_any.cu` (forward, dq, dkv) emulated against the plain
versions at padded widths from 32 to 256.

`scenedino_tpu/models/vit.py:_flash_mhsa` hands any D to the Pallas flash
attention; the configs' `vit_overrides` (width 64, 2 heads) give D = 32.
On the CPU `attention` takes the plain forward and backward; here they
meet `jax.nn.dot_product_attention` and its VJP, each D's reference one
`jax.jit`.

The emulation walks as the kernel does: D padded with zero columns to the
next of 32, 48, 64, 96, 128, 192 and 256 (the kernel's instantiations), the
scale the true D's; a block owns 64 query rows (zero-filled past N); the
forward and dq walk key tiles of 64 rows (32 above a padded width of 128),
zero-filled past N; the forward's online softmax in base 2 with the exact
rescale (the running max moves whenever it grows), key columns past N at
-inf, P rounded to bf16 before P V, the output rounded to bf16 and LSE =
(m + log2 l) ln 2; dq with di = rowsum(dO o), P from the log-sum-exp and
key columns past N at P = 0, dS rounded to bf16 before dS K; dkv per 64 key
rows over 32-row query tiles, a query row past N having lse = +inf and
di = 0, P^T and dS^T rounded to bf16; results rounded to bf16.

Tolerances: the port against JAX atol/rtol 1e-5 (fp32, sums in another
order); the emulation's output within K1_TOL = 2e-2 and its gradients
within K1_BWD_REL = 2e-2 of the largest plain magnitude plus 1e-3, the
bounds the kernels are held to on the card (bf16 results, P and dS rounded
to bf16); its log-sum-exp and di within 1e-5 (fp32 sums in another order;
on the card 1e-3, where exp2 is approximate).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import (
    HEAD_DIMS,
    MAX_HEAD_DIM,
    _KERNELS,
    attention,
    attention_bwd_plain,
    attention_lse_plain,
    attention_plain,
)

K1_TOL = 2e-2
K1_BWD_REL = 2e-2
TOL = dict(atol=1e-5, rtol=1e-5)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
PADS = (32, 48, 64, 96, 128, 192, 256)  # the kernel's instantiations
BQ, BQ_DKV = 64, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(n, D, seed, B=2, H=2, count=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, D)).astype(np.float32) for _ in range(count)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("D", [32, 48, 96, 128])
def test_attention_at_other_head_dims_matches_jax(D):
    q, k, v, do = _inputs(70, D, seed=D)

    @jax.jit
    def ref(q, k, v, do):
        out, vjp = jax.vjp(jax.nn.dot_product_attention, q, k, v)
        return out, vjp(do)

    ref_out, ref_grads = ref(*(jnp.asarray(a) for a in (q, k, v, do)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = attention(*leaves)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    for name, leaf, r in zip("qkv", leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), err_msg=f"d{name}", **TOL)


def test_every_other_head_dim_takes_the_padded_kernel():
    """D = 64 and 80 keep their kernels; every other D up to 256 names
    attention_any.cu's three C functions, which pad to the widths here."""
    assert HEAD_DIMS == (64, 80) and MAX_HEAD_DIM == PADS[-1]
    assert {step: _KERNELS["any"][step][:2] for step in _KERNELS["any"]} == {
        "fwd": ("attention_any", "attention_any_fwd"), "bwd_dq": ("attention_any", "attention_any_bwd_dq"),
        "bwd_dkv": ("attention_any", "attention_any_bwd_dkv")}
    assert "attention_any" in build.all_names()
    assert [p.name for p in build.sources("attention_any")] == ["attention_any.cu", "hopper.cuh"]
    src = (build.CSRC / "attention_any.cu").read_text()
    for name in ("attention_any_fwd", "attention_any_bwd_dq", "attention_any_bwd_dkv"):
        assert f'extern "C" int {name}(' in src, name
    assert re.search(r"const int widths\[\] = \{([^}]*)\};", src).group(1) == ", ".join(map(str, PADS))
    for pd in PADS:
        assert f"std::integral_constant<int, {pd}>" in src, pd
    code = re.sub(r"//[^\n]*", "", src)
    assert "mma.sync.aligned.m16n8k16" in code and "cp.async.cg.shared.global" in code
    assert not re.search(r"\batomic\w*\(|\batom\.|\bred\.", code)


def _padded(D):
    return next(w for w in PADS if D <= w)


def _key_tile(pd):
    return 32 if pd > 128 else 64


def _rows(x, start, count, pd):
    """Rows [start, start + count) of (N, D) as a tile of `pd` columns, zero
    past N and past D, as the copies fill it."""
    out = torch.zeros(count, pd)
    part = x[start:start + count]
    out[:part.shape[0], :x.shape[1]] = part
    return out


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_forward(q, k, v):
    """One head, (N, D) bf16 values in fp32: the output (N, D) and LSE (N,)."""
    N, D = q.shape
    pd = _padded(D)
    bk, scale_log2 = _key_tile(pd), D ** -0.5 * LOG2E
    out, lse = torch.zeros(N, D), torch.zeros(N)
    for r0 in range(0, N, BQ):
        qi = _rows(q, r0, BQ, pd)
        m, l, o = torch.full((BQ,), -float("inf")), torch.zeros(BQ), torch.zeros(BQ, pd)
        for t0 in range(0, N, bk):
            s = qi @ _rows(k, t0, bk, pd).T
            s[:, max(N - t0, 0):] = -float("inf")
            m_new = torch.maximum(m, s.max(-1).values * scale_log2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[:, None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[:, None] + _bf16(p) @ _rows(v, t0, bk, pd)
            m = m_new
        n = min(BQ, N - r0)
        out[r0:r0 + n] = _bf16(o * (1 / l)[:, None])[:n, :D]
        lse[r0:r0 + n] = ((m + torch.log2(l)) * LN2)[:n]
    return out, lse


def emulate_dq(q, k, v, o, do, lse):
    N, D = q.shape
    pd = _padded(D)
    bk, scale = _key_tile(pd), D ** -0.5
    di = (do * o).sum(-1)
    dq = torch.zeros(N, D)
    for r0 in range(0, N, BQ):
        n = min(BQ, N - r0)
        qi, doi = _rows(q, r0, BQ, pd), _rows(do, r0, BQ, pd)
        lr, dr = torch.zeros(BQ), torch.zeros(BQ)  # 0 past N
        lr[:n], dr[:n] = lse[r0:r0 + n] * LOG2E, di[r0:r0 + n]
        acc = torch.zeros(BQ, pd)
        for t0 in range(0, N, bk):
            kt, vt = _rows(k, t0, bk, pd), _rows(v, t0, bk, pd)
            live = t0 + torch.arange(bk) < N
            p = torch.where(live, torch.exp2((qi @ kt.T) * scale * LOG2E - lr[:, None]), torch.tensor(0.0))
            ds = p * ((doi @ vt.T) - dr[:, None]) * scale
            acc = acc + _bf16(ds) @ kt
        dq[r0:r0 + n] = _bf16(acc)[:n, :D]
    return dq, di


def emulate_dkv(q, k, v, do, lse, di):
    N, D = q.shape
    pd = _padded(D)
    scale = D ** -0.5
    dk, dv = torch.zeros(N, D), torch.zeros(N, D)
    for k0 in range(0, N, BQ):
        kt, vt = _rows(k, k0, BQ, pd), _rows(v, k0, BQ, pd)
        ak, av = torch.zeros(BQ, pd), torch.zeros(BQ, pd)
        for t0 in range(0, N, BQ_DKV):
            qt, dot = _rows(q, t0, BQ_DKV, pd), _rows(do, t0, BQ_DKV, pd)
            n = min(BQ_DKV, N - t0)
            lt, dt = torch.full((BQ_DKV,), float("inf")), torch.zeros(BQ_DKV)
            lt[:n], dt[:n] = lse[t0:t0 + n] * LOG2E, di[t0:t0 + n]
            pt = torch.exp2((kt @ qt.T) * scale * LOG2E - lt[None, :])
            av = av + _bf16(pt) @ dot
            dst = pt * ((vt @ dot.T) - dt[None, :]) * scale
            ak = ak + _bf16(dst) @ qt
        n = min(BQ, N - k0)
        dk[k0:k0 + n], dv[k0:k0 + n] = _bf16(ak)[:n, :D], _bf16(av)[:n, :D]
    return dk, dv


@pytest.mark.parametrize("D,N", [(32, 1), (32, 130), (8, 65), (20, 70), (48, 65), (56, 40), (96, 129), (72, 64),
                                 (128, 100), (160, 33), (200, 97), (256, 70)])
def test_padded_walk_emulation_matches_the_plain_versions(D, N):
    """Every instantiated width, head dims on it and below it (20: rows not
    16-byte aligned, filled by plain loads), ragged token counts around the
    64-row blocks and the 32-row tiles."""
    q, k, v, do = (_t(a).to(torch.bfloat16) for a in _inputs(N, D, seed=D + N, B=1, H=2))
    out_ref = attention_plain(q, k, v)
    lse_ref = attention_lse_plain(q, k)
    grads_ref = attention_bwd_plain(q, k, v, out_ref, do, lse_ref)
    for h in range(2):
        qh, kh, vh, doh, oh = (x[0, :, h].float() for x in (q, k, v, do, out_ref))
        out, lse = emulate_forward(qh, kh, vh)
        assert (out - oh).abs().max().item() <= K1_TOL
        np.testing.assert_allclose(lse.numpy(), lse_ref[0, h].numpy(), atol=1e-5, rtol=0)
        dq, di = emulate_dq(qh, kh, vh, oh, doh, lse_ref[0, h])
        np.testing.assert_allclose(di.numpy(), (doh * oh).sum(-1).numpy(), atol=1e-5, rtol=0)
        dk, dv = emulate_dkv(qh, kh, vh, doh, lse_ref[0, h], di)
        for name, got, ref in zip("qkv", (dq, dk, dv), grads_ref):
            want = ref[0, :, h].float()
            err = (got - want).abs().max().item()
            assert err <= K1_BWD_REL * want.abs().max().item() + 1e-3, (name, err)
