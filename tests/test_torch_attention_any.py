"""K1 at every head dim but 64 and 80 on the CPU: the port's attention
against JAX at D = 32, 48, 96 and 128, the route that the wrappers take at
every head dim, the wrappers' zero padding of D % 8 != 0 around the plain
versions, and the walks of `csrc/attention_any.cu` (forward, dq, dkv)
emulated against the plain versions at padded widths from 64 to 256.

`scenedino_tpu/models/vit.py:_flash_mhsa` hands any D to the Pallas flash
attention; the configs' `vit_overrides` (width 64, 2 heads) give D = 32.
On the CPU `attention` takes the plain forward and backward; here they
meet `jax.nn.dot_product_attention` and its VJP, each D's reference one
`jax.jit`.

The emulation walks as the kernels do: D rounded up to a multiple of 8 by
the wrapper's zero columns, then to M = ceil(D / 64) tiles of 64 columns by
TMA's zero fill (the kernels' widths 64, 128, 192, 256), the scale the true
D's; the products over the head dim summed over ceil(D / 16) k-steps of 16
columns in order; a warpgroup owns 64 rows (zero past N) and walks 64-row
tiles (zero past N). The forward's online softmax in base 2 with the exact
rescale (the running max moves whenever it grows), key columns past N at
-inf, P rounded to bf16 before P V, the output rounded to bf16 and LSE =
(m + log2 l) ln 2; dq with di = rowsum(dO o), P from the log-sum-exp and key
columns past N at P = 0, dS rounded to bf16 before dS K; dkv per 64 key rows
over 64-row query tiles, a query row past N having lse = +inf and di = 0,
P^T rounded to bf16 for dV += P^T dO and for dS^T = P^T (dP^T - di) / sqrt(D)
(the kernel keeps only the packed P^T), dS^T rounded to bf16, dK and dV in
the shipped column groups (two groups of two tiles above 128 columns, the
second starting at tile M - 2); results rounded to bf16.

Tolerances: the port against JAX atol/rtol 1e-5 (fp32, sums in another
order); the padded plain versions against the unpadded ones 1e-6 (zero
columns add exact zeros; fp32 sums in another blocking); the emulation's
output within K1_TOL = 2e-2 and its gradients within K1_BWD_REL = 2e-2 of
the largest plain magnitude plus 1e-3, the bounds the kernels are held to
on the card (bf16 results, P and dS rounded to bf16); its log-sum-exp and di
within 1e-5 (fp32 sums in another order; on the card 1e-3, where exp2 is
approximate).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import (
    ANY_MAX_HEAD_DIM,
    HEAD_DIMS,
    _KERNELS,
    attention,
    attention_bwd_plain,
    attention_lse_plain,
    attention_plain,
    route,
    with_head_dim,
)

K1_TOL = 2e-2
K1_BWD_REL = 2e-2
TOL = dict(atol=1e-5, rtol=1e-5)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
PADS = (64, 128, 192, 256)  # the kernels' widths
BT = 64  # rows of an own and of a walked tile


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
    attention_any.cu's three C functions: wgmma on TMA tiles at four
    widths, at 64 columns one instantiation for each count of k-steps (a
    template parameter: no wgmma under a predicate), a producer and
    consumers split by setmaxnreg, no mma.sync, cp.async or atomics."""
    assert HEAD_DIMS == (64, 80) and ANY_MAX_HEAD_DIM == PADS[-1]
    assert {step: _KERNELS["any"][step][:2] for step in _KERNELS["any"]} == {
        "fwd": ("attention_any", "attention_any_fwd"), "bwd_dq": ("attention_any", "attention_any_bwd_dq"),
        "bwd_dkv": ("attention_any", "attention_any_bwd_dkv")}
    assert "attention_any" in build.all_names()
    assert [p.name for p in build.sources("attention_any")] == ["attention_any.cu", "hopper.cuh"]
    src = (build.CSRC / "attention_any.cu").read_text()
    for name in ("attention_any_fwd", "attention_any_bwd_dq", "attention_any_bwd_dkv"):
        assert f'extern "C" int {name}(' in src, name
    instantiated = re.findall(r"return f\(Int<(\d+)>\{\}, Int<(\d+)>\{\}\);", src)
    assert [(int(m), int(ks)) for m, ks in instantiated] == [(1, 1), (1, 2), (1, 3), (1, 4), (2, 8), (3, 12),
                                                                (4, 16)]
    assert len(PADS) == 4
    code = re.sub(r"//[^\n]*", "", src)
    assert "@r wgmma" not in code and "_if(" not in code
    for used in ("wgmma_m64n64k16_rs", "wgmma_m64n64k16_ss", "tma_load_4d", "tma_store_4d", "registers_take",
                 "registers_release", "softmax_tile", "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert used in code, used
    for gone in ("mma.sync", "cp.async", "ldmatrix"):
        assert gone not in code, gone
    assert not re.search(r"\batomic\w*\(|\batom\.|\bred\.", code)


def test_route_of_every_head_dim():
    """Each D from 1 to 256: the kernels' key, the width the wrappers hand
    them (D, or the next multiple of 8) and the width they compute at; past
    256 attention_wide.cu's (tests/test_torch_attention_wide.py)."""
    for D in range(1, 257):
        if D in (64, 80):
            want = (D, D, D)
        else:
            width = D if D % 8 == 0 else D + 8 - D % 8
            pd = 64 if D <= 64 else 128 if D <= 128 else 192 if D <= 192 else 256
            want = ("any", width, pd)
        assert route(D) == want, D
    assert route(20) == ("any", 24, 64) and route(60) == ("any", 64, 64) and route(76) == ("any", 80, 128)
    assert route(250) == ("any", 256, 256) and route(136) == ("any", 136, 192)
    assert route(257) == ("wide", 264, 320) and route(264) == ("wide", 264, 320)
    with pytest.raises(ValueError, match="positive"):
        route(0)


@pytest.mark.parametrize("D", [20, 36, 100])
def test_zero_padding_the_head_dim_changes_nothing(D):
    """The wrappers' padding of a head dim that is not a multiple of 8,
    run around the plain versions at D's scale: the forward, its
    log-sum-exp and the three gradients equal the unpadded ones."""
    q, k, v, do = (_t(a) for a in _inputs(70, D, seed=500 + D))
    width, scale = route(D)[1], D ** -0.5
    assert width % 8 == 0 and width > D
    out, lse = with_head_dim(width, lambda q, k, v: (attention_plain(q, k, v, scale),
                                                     attention_lse_plain(q, k, scale)), q, k, v)
    ref_out, ref_lse = attention_plain(q, k, v), attention_lse_plain(q, k)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-6, rtol=0)
    grads = with_head_dim(width, lambda q, k, v, o, do: attention_bwd_plain(q, k, v, o, do, ref_lse, scale),
                          q, k, v, ref_out, do)
    for name, got, want in zip("qkv", grads, attention_bwd_plain(q, k, v, ref_out, do, ref_lse)):
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0, err_msg=f"d{name}")


def _padded(D):
    return route(D)[2]


def _rows(x, start, count, pd):
    """Rows [start, start + count) of (N, D) as a tile of `pd` columns, zero
    past N and past D, as the copies fill it."""
    out = torch.zeros(count, pd)
    part = x[start:start + count]
    out[:part.shape[0], :x.shape[1]] = part
    return out


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _nt(a, b, D):
    """a b^T over the k-steps of 16 columns that hold a column below D,
    summed in order (the columns past them are zero and cost no product)."""
    out = torch.zeros(a.shape[0], b.shape[0])
    for kk in range(-(-D // 16)):
        out = out + a[:, 16 * kk:16 * kk + 16] @ b[:, 16 * kk:16 * kk + 16].T
    return out


def emulate_forward(q, k, v):
    """One head, (N, D) bf16 values in fp32: the output (N, D) and LSE (N,)."""
    N, D = q.shape
    pd = _padded(D)
    scale_log2 = D ** -0.5 * LOG2E
    out, lse = torch.zeros(N, D), torch.zeros(N)
    for r0 in range(0, N, BT):
        qi = _rows(q, r0, BT, pd)
        m, l, o = torch.full((BT,), -float("inf")), torch.zeros(BT), torch.zeros(BT, pd)
        for t0 in range(0, N, BT):
            s = _nt(qi, _rows(k, t0, BT, pd), D)
            s[:, max(N - t0, 0):] = -float("inf")
            m_new = torch.maximum(m, s.max(-1).values * scale_log2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[:, None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[:, None] + _bf16(p) @ _rows(v, t0, BT, pd)
            m = m_new
        n = min(BT, N - r0)
        out[r0:r0 + n] = _bf16(o * (1 / l)[:, None])[:n, :D]
        lse[r0:r0 + n] = ((m + torch.log2(l)) * LN2)[:n]
    return out, lse


def emulate_dq(q, k, v, o, do, lse):
    N, D = q.shape
    pd = _padded(D)
    scale = D ** -0.5
    di = (do * o).sum(-1)
    dq = torch.zeros(N, D)
    for r0 in range(0, N, BT):
        n = min(BT, N - r0)
        qi, doi = _rows(q, r0, BT, pd), _rows(do, r0, BT, pd)
        lr, dr = torch.zeros(BT), torch.zeros(BT)  # 0 past N
        lr[:n], dr[:n] = lse[r0:r0 + n] * LOG2E, di[r0:r0 + n]
        acc = torch.zeros(BT, pd)
        for t0 in range(0, N, BT):
            kt, vt = _rows(k, t0, BT, pd), _rows(v, t0, BT, pd)
            live = t0 + torch.arange(BT) < N
            p = torch.where(live, torch.exp2(_nt(qi, kt, D) * scale * LOG2E - lr[:, None]), torch.tensor(0.0))
            ds = p * (_nt(doi, vt, D) - dr[:, None]) * scale
            acc = acc + _bf16(ds) @ kt
        dq[r0:r0 + n] = _bf16(acc)[:n, :D]
    return dq, di


def _column_groups(pd):
    """dkv's column groups: (first tile, tiles, first tile it stores)."""
    M = pd // 64
    if M <= 2:
        return [(0, M, 0)]
    return [(0, 2, 0), (M - 2, 2, 2)]


def emulate_dkv(q, k, v, do, lse, di):
    N, D = q.shape
    pd = _padded(D)
    scale = D ** -0.5
    dk, dv = torch.zeros(N, D), torch.zeros(N, D)
    for k0 in range(0, N, BT):
        kt, vt = _rows(k, k0, BT, pd), _rows(v, k0, BT, pd)
        ak, av = torch.zeros(BT, pd), torch.zeros(BT, pd)
        for c0, mc, store in _column_groups(pd):
            cols = slice(64 * c0, 64 * (c0 + mc))
            gk, gv = torch.zeros(BT, 64 * mc), torch.zeros(BT, 64 * mc)
            for t0 in range(0, N, BT):
                qt, dot = _rows(q, t0, BT, pd), _rows(do, t0, BT, pd)
                n = min(BT, N - t0)
                lt, dt = torch.full((BT,), float("inf")), torch.zeros(BT)
                lt[:n], dt[:n] = lse[t0:t0 + n] * LOG2E, di[t0:t0 + n]
                pt = _bf16(torch.exp2(_nt(kt, qt, D) * scale * LOG2E - lt[None, :]))
                gv = gv + pt @ dot[:, cols]
                dst = pt * (_nt(vt, dot, D) - dt[None, :]) * scale
                gk = gk + _bf16(dst) @ qt[:, cols]
            keep = slice(64 * store, 64 * (c0 + mc))
            ak[:, keep], av[:, keep] = gk[:, 64 * (store - c0):], gv[:, 64 * (store - c0):]
        n = min(BT, N - k0)
        dk[k0:k0 + n], dv[k0:k0 + n] = _bf16(ak)[:n, :D], _bf16(av)[:n, :D]
    return dk, dv


@pytest.mark.parametrize("D,N", [(32, 1), (32, 130), (8, 65), (20, 70), (48, 65), (56, 40), (96, 129), (72, 64),
                                 (128, 100), (160, 33), (200, 97), (256, 70), (16, 64), (192, 129), (32, 63),
                                 (136, 65), (104, 127)])
def test_padded_walk_emulation_matches_the_plain_versions(D, N):
    """Every width, head dims on it and below it (8, 16: one k-step; 20: rows
    not 16-byte aligned, padded to 24 by the wrapper; 136, 160, 192: the
    second column group of dkv overlapping the first), ragged token counts
    around the 64-row tiles."""
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
