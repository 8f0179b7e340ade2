"""K1 at head dim 80 on the CPU: the plain versions against JAX, the
walks of `csrc/attention_d80.cu` (the forward) and
`csrc/attention_d80_bwd.cu` (dq, dkv) emulated against the plain
versions, and the I-JEPA-H/14 ViT (16 heads of 80) cut to size against
JAX's.

The plain forward, log-sum-exp and backward are generic in D; here they
meet `jax.nn.dot_product_attention` and its VJP, and the Pallas module's
`mha_reference` at (2, 585, 2, 80), the token count of `make_vit
("i_jepa_huge")` at 192x640, padded to 1024 with segment ids as
`scenedino_tpu/models/vit.py:_flash_mhsa` pads for the TPU kernel.

The forward's emulation walks as its kernel does: a warpgroup owns 64
query rows (zero-filled past N) and walks 64-row key tiles zero-filled
past N; only the last tile, peeled off the walk, sets its key columns at
or past N to -inf; the online softmax in base 2 (scale * log2(e) folded
in) with the lazy rescale (the running max of a warp's 16 rows moves only
when one of them grows by more than 8, so P < 2^8; `lazy=False` moves it
on every tile), P rounded to bf16 before P V, the row sum of the
unrounded P, the output rounded to bf16 and
LSE = (m scale log2(e) + log2 l) ln 2, m the logits' running max. The
backward's walks as its two
kernels do: a warpgroup owns 64 rows, zero-filled past N; dq walks 64-row
key tiles and sets dS to 0 in the last tile's columns past N (only that
tile is masked), a query row past N having lse = +inf; dkv walks query
tiles of 32 or 64 rows (BWD80_DKV_QT), a query row past N having
lse = +inf and di = 0, so its P and dS are 0 without a mask; P and dS are
rounded to bf16 before their products, the sums over walked tiles kept
in fp32 and the results rounded to bf16.

Tolerances: the plain versions against JAX atol/rtol 1e-5 (fp32, sums in
another order); the emulation's output within K1_TOL = 2e-2 and its
gradients within K1_BWD_REL = 2e-2 of the largest plain magnitude plus
1e-3, the bounds the kernels are held to on the card (bf16 results, P and
dS rounded to bf16); its log-sum-exp within 1e-5 (on the card 1e-3,
where exp2 is approximate); the tiny ViT atol/rtol 1e-4.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference, mha_reference_no_custom_vjp

from scenedino_tpu.models.vit import VIT_PRESETS as JVIT_PRESETS
from scenedino_tpu.models.vit import VisionTransformer as JVisionTransformer
from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import (
    HEAD_DIMS,
    attention,
    attention_bwd_plain,
    attention_fwd,
    attention_lse_plain,
    attention_plain,
)
from scenedino_torch.models.vit import VIT_PRESETS, make_vit

D = 80
K1_TOL = 2e-2
K1_BWD_REL = 2e-2
TOL = dict(atol=1e-5, rtol=1e-5)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
KT = 64  # the forward's walked key tile
BT = 64  # the backward's own rows a warpgroup and dq's walked key tile
QTS = (32, 64)  # the rows of dkv's walked query tile (BWD80_DKV_QT)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(n, seed, B=2, H=2, count=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, D)).astype(np.float32) for _ in range(count)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _library_code(name):
    """The code of `csrc/<name>.cu` and of every file it includes, comments dropped."""
    return re.sub(r"//[^\n]*", "", "".join(p.read_text() for p in build.sources(name)))


def test_the_kernels_take_head_dims_64_and_80_from_their_own_sources():
    assert HEAD_DIMS == (64, 80)
    assert {"attention_d80", "attention_d80_bwd"} <= set(build.all_names())
    assert [p.name for p in build.sources("attention_d80")] == ["attention_d80.cu", "hopper.cuh"]
    assert [p.name for p in build.sources("attention_d80_bwd")] == ["attention_d80_bwd.cu", "hopper.cuh"]
    fwd = (build.CSRC / "attention_d80.cu").read_text()
    assert 'extern "C" int attention_d80_fwd(' in fwd
    assert "attention_d80_bwd_dq" not in fwd and "attention_d80_bwd_dkv" not in fwd
    bwd = (build.CSRC / "attention_d80_bwd.cu").read_text()
    for name in ("attention_d80_bwd_dq", "attention_d80_bwd_dkv"):
        assert f'extern "C" int {name}(' in bwd
    # both on wgmma on TMA tiles (the 64-column tile and the 16-column side
    # tile, from hopper.cuh's rows of 80), a producer and setmaxnreg; no
    # warp-level product, no cp.async and no atomics
    for name, source in (("attention_d80", fwd), ("attention_d80_bwd", bwd)):
        code = _library_code(name)
        for used in ("wgmma_m64n64k16_rs", "wgmma_m64n16k16_rs", "wgmma_desc_b32", "tma_load_4d", "tma_store_4d",
                     "CU_TENSOR_MAP_SWIZZLE_32B", "registers_take", "registers_release"):
            assert used in code, (name, used)
        for shared in ("Rows80", "load_rows", "store_rows", "load_own", "product_rows80", "store_acc80",
                       "encode_pair", "registers_take"):
            assert shared in source, (name, shared)
        source_code = re.sub(r"//[^\n]*", "", source)
        assert "mma.sync" not in code and "cp.async.cg" not in source_code, name
        assert not re.search(r"\batomic\w*\(|\batom\.|\bred\.", source_code), name
    for used in ("product_nt80", "softmax_tile", "pack_p", "rescale", "FWD80_SMALL_WGS"):
        assert used in fwd, used
    from scenedino_torch.kernels.attention import _KERNELS
    assert {step: _KERNELS[80][step][:2] for step in _KERNELS[80]} == {
        "fwd": ("attention_d80", "attention_d80_fwd"), "bwd_dq": ("attention_d80_bwd", "attention_d80_bwd_dq"),
        "bwd_dkv": ("attention_d80_bwd", "attention_d80_bwd_dkv")}


def test_hopper_header_offers_the_side_tile_primitives():
    """The 16-column side tile's wgmma forms, descriptor and swizzle,
    beside hopper.cuh's 64-column convention (which the D = 64 kernels,
    K2-K4 and K6 use unchanged); the rows of 80 that both D = 80 files
    build on, in one copy; the K1 forwards' online softmax, in one copy."""
    src = (build.CSRC / "hopper.cuh").read_text()
    for name in ("wgmma_m64n16k16_rs", "wgmma_m64n32k16_rs", "wgmma_desc_b32_at", "WGMMA_B32_MN_STEP",
                 "side_offset", "load_a_side", "store_side", "encode_head_box_map",
                 "struct Rows80", "struct MapPair", "void load_rows(", "void store_rows(", "struct OwnRows",
                 "void load_own(", "void product_nt80(", "struct Acc80", "void product_rows80(", "void store_acc80(",
                 "int encode_pair(", "bool bad_shape80(", "bool softmax_scores(", "bool softmax_tile(",
                 "void pack_p(", "void rescale("):
        assert name in src, name
    assert "uint64_t(3) << 62" in src and "uint64_t(256 >> 4) << 32" in src  # B32, 8-row groups 256 bytes apart
    assert "constexpr uint64_t WGMMA_B32_MN_STEP = 512 >> 4;" in src  # 16 rows of 32 bytes a k-step
    for name in ("attention.cu", "attention_d80.cu", "attention_d80_bwd.cu"):
        text = (build.CSRC / name).read_text()
        for one_copy in ("struct Rows80", "struct Acc80", "int encode_pair(", "bool softmax_scores(",
                         "void pack_p("):
            assert one_copy not in text, (name, one_copy)


@pytest.mark.parametrize("n", [1, 65, 130])
def test_plain_forward_and_backward_match_jax_dot_product_attention(n):
    q, k, v, do = _inputs(n, seed=n)
    ref_out, vjp = jax.vjp(jax.nn.dot_product_attention, *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o = attention_plain(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_out), **TOL)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    lse_ref = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    np.testing.assert_allclose(attention_lse_plain(tq, tk).numpy(), lse_ref, **TOL)
    got = attention_bwd_plain(tq, tk, tv, o, tdo, attention_lse_plain(tq, tk))
    for name, g, r in zip("qkv", got, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"d{name}", **TOL)


def _mha_reference_pad(N, B=2, block=512):
    NP = -(-N // block) * block
    ids = jnp.broadcast_to((jnp.arange(NP) < N).astype(jnp.int32)[None], (B, NP))

    def prep(x):
        return jnp.pad(x.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, NP - N), (0, 0)))

    return NP, SegmentIds(q=ids, kv=ids), prep


def test_plain_versions_match_mha_reference_at_the_i_jepa_token_count():
    """(2, 585, 2, 80), padded to 1024 and masked by segment ids: the
    output, the log-sum-exp from its residuals and the VJP."""
    N = 585
    q, k, v, do = _inputs(N, seed=7)
    NP, ids, prep = _mha_reference_pad(N)
    assert NP == 1024
    out, l, m = mha_reference_no_custom_vjp(*(prep(jnp.asarray(a)) for a in (q, k, v)), None, ids,
                                            sm_scale=D ** -0.5, save_residuals=True)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o = attention_plain(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), np.asarray(out[:, :, :N].transpose(0, 2, 1, 3)), **TOL)
    lse = attention_lse_plain(tq, tk)
    np.testing.assert_allclose(lse.numpy(), np.asarray((m + jnp.log(l))[:, :, :N]), **TOL)

    def f(q, k, v):  # its backward takes sm_scale = 1 only: q is scaled before the call
        return mha_reference(prep(q * D ** -0.5), prep(k), prep(v), None, segment_ids=ids)[:, :, :N].transpose(
            0, 2, 1, 3)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    for name, g, r in zip("qkv", attention_bwd_plain(tq, tk, tv, o, tdo, lse), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"d{name}", **TOL)


def _rows(x, start, count):
    """Rows [start, start + count) of (N, D), zero-filled past N as cp.async and TMA fill them."""
    out = torch.zeros(count, x.shape[1])
    part = x[start:start + count]
    out[:part.shape[0]] = part
    return out


def _emulate_forward(q, k, v, mask=True, lazy=True, trace=None):
    """One head, (N, D) bf16 values in fp32, as attention_d80.cu walks:
    (out (N, D), lse (N,)). `mask`: the peeled last tile's key columns at or
    past N are -inf; `lazy`: the running max of a warp's 16 rows moves only
    when one of them grows by more than 8 (base 2), else on every tile;
    `trace`, a list: gets (query tile, walked tile, warps whose max moved,
    the largest P) for each step."""
    N = q.shape[0]
    sl2 = D ** -0.5 * LOG2E
    tiles = -(-N // KT)
    out, lse = torch.zeros(tiles * KT, D), torch.zeros(tiles * KT)
    for i in range(tiles):  # a warpgroup's 64 query rows
        qi = _rows(q, i * KT, KT)
        m = torch.full((KT,), -float("inf"))  # the logits' running max, scaled to base 2
        l = torch.zeros(KT)
        o = torch.zeros(KT, D)
        for t in range(tiles):  # the walked key and value tiles, the last one peeled off
            s = qi @ _rows(k, t * KT, KT).T
            if mask and t == tiles - 1:
                s[:, N - t * KT:] = -float("inf")
            mx = s.max(-1).values * sl2
            move = torch.ones(KT, dtype=torch.bool)
            if lazy:  # per warp: 4 warps of 16 rows
                move = (mx > m + 8).reshape(4, 16).any(-1).repeat_interleave(16)
            m_new = torch.where(move, torch.maximum(m, mx), m)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * sl2 - m_new[:, None])
            if trace is not None:
                trace.append((i, t, int(move[::16].sum()), p.max().item()))
            l = l * alpha + p.sum(-1)
            o = o * alpha[:, None] + _bf16(p) @ _rows(v, t * KT, KT)
            m = m_new
        rows = slice(i * KT, (i + 1) * KT)
        out[rows] = _bf16(o / l[:, None])
        lse[rows] = (m + torch.log2(l)) * LN2
    return out[:N], lse[:N]


def _padded(x, rows, fill):
    out = torch.full((rows,), fill)
    out[:x.shape[0]] = x
    return out


def _emulate_backward(q, k, v, o, do, lse, qt=64, mask=True):
    """One head, as attention_d80_bwd.cu walks: the dq kernel, then dkv
    with query tiles of `qt` rows; (dq, dk, dv) bf16 values, di."""
    N = q.shape[0]
    scale = D ** -0.5
    sl2 = scale * LOG2E
    inf = float("inf")
    di = (do * o).sum(-1)
    rows = -(-N // BT) * BT  # the warpgroups' own rows, zero-filled past N
    q_own, do_own, k_own, v_own = (_rows(x, 0, rows) for x in (q, do, k, v))
    lse2_own, dis_own = _padded(lse * LOG2E, rows, inf), _padded(di * scale, rows, 0.0)
    dq = torch.zeros(rows, D)
    for t in range(-(-N // BT)):  # dq: each 64-row key tile
        kt, vt = _rows(k, t * BT, BT), _rows(v, t * BT, BT)
        p = torch.exp2(q_own @ kt.T * sl2 - lse2_own[:, None])
        ds = p * (do_own @ vt.T * scale - dis_own[:, None])
        if mask and N - t * BT < BT:  # the last tile: key columns past N
            ds[:, N - t * BT:] = 0.0
        dq += _bf16(ds) @ kt
    dk, dv = torch.zeros(rows, D), torch.zeros(rows, D)
    for t in range(-(-N // qt)):  # dkv: each query tile, lse +inf and di 0 past N
        q_t, do_t = _rows(q, t * qt, qt), _rows(do, t * qt, qt)
        lse2_t = _padded(lse[t * qt:(t + 1) * qt] * LOG2E, qt, inf)
        dis_t = _padded(di[t * qt:(t + 1) * qt] * scale, qt, 0.0)
        pt = torch.exp2(k_own @ q_t.T * sl2 - lse2_t[None])
        dst = pt * (v_own @ do_t.T * scale - dis_t[None])
        dv += _bf16(pt) @ do_t
        dk += _bf16(dst) @ q_t
    return [_bf16(x[:N]) for x in (dq, dk, dv)], di


def _head(x, h):
    return x[0, :, h].float()


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 130, 585])
def test_tile_walk_emulation_matches_the_plain_versions(n, lazy):
    """The forward's walk, with the lazy rescale (the kernel's) and with O
    rescaled on every tile: output and log-sum-exp against the plain
    versions and the Pallas module's mha_reference, padded to a multiple of
    512 tokens (1024 at I-JEPA-H/14's 585) and masked by segment ids."""
    q, k, v = (_t(a).to(torch.bfloat16) for a in _inputs(n, seed=30 + n, B=1, count=3))
    out, lse = attention_fwd(q, k, v, with_lse=True)  # CPU: the plain versions
    NP, ids, prep = _mha_reference_pad(n, B=1)
    ref, ref_l, ref_m = mha_reference_no_custom_vjp(*(prep(jnp.asarray(x.float().numpy())) for x in (q, k, v)),
                                                    None, ids, sm_scale=D ** -0.5, save_residuals=True)
    ref_lse = np.asarray((ref_m + jnp.log(ref_l))[0, :, :n])
    for h in range(q.shape[2]):
        o, l2 = _emulate_forward(_head(q, h), _head(k, h), _head(v, h), lazy=lazy)
        assert (o - _head(out, h)).abs().max().item() <= K1_TOL
        assert np.abs(o.numpy() - np.asarray(ref[0, h, :n])).max() <= K1_TOL
        np.testing.assert_allclose(l2.numpy(), lse[0, h].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(l2.numpy(), ref_lse[h], atol=1e-5, rtol=0)


def test_lazy_rescale_at_d80_keeps_p_below_two_to_the_eight_and_moves_on_a_jump():
    """Keys that grow along the walk: with the lazy rescale the running max
    stays put while the logits grow by less than 8 (so P < 2^8 before its
    bf16 rounding) and moves on a larger jump; the result is the plain
    version's either way."""
    n = 256
    rng = np.random.default_rng(3)
    q, base = (_bf16(torch.from_numpy(np.abs(rng.normal(size=(n, D))).astype(np.float32))) for _ in range(2))
    # a row's logits in the four walked tiles: about 8 (base 2, a tile's max
    # about 11) times 1, 1.05, 1.1, 2; q and k are drawn apart, so no row
    # meets a key of its own
    grow = np.repeat(np.array([0.0, 0.05, 0.1, 1.0], np.float32), 64)[:, None]
    k = _bf16(base * torch.from_numpy(1 + grow))
    v = _bf16(_t(_inputs(n, seed=4, B=1, H=1, count=1)[0][0, :, 0]))
    trace = []
    out, lse = _emulate_forward(q, k, v, lazy=True, trace=trace)
    qb, kb, vb = (x[None, :, None].to(torch.bfloat16) for x in (q, k, v))
    assert (out - attention_plain(qb, kb, vb)[0, :, 0].float()).abs().max().item() <= K1_TOL
    assert (lse - attention_lse_plain(qb, kb)[0, 0]).abs().max().item() <= 1e-5
    moves = {(i, t): moved for i, t, moved, _ in trace}
    assert all(moves[i, 0] == 4 for i in range(4))  # the first tile sets the max of every warp
    assert all(moves[i, 1] == 0 and moves[i, 2] == 0 for i in range(4))  # growth below 8: no move
    assert all(moves[i, 3] > 0 for i in range(4))  # the jump
    assert max(p for *_, p in trace) < 2 ** 8


def test_drifting_keys_move_the_running_max_along_the_walk():
    """The card's case of keys that drift along the walk (12 n / N added
    to every value of key row n, tools/bench_attention_bwd.drifting_keys;
    tests/test_torch_kernels.py): at 1921 tokens the running max of some
    warps moves after the first tile, so the lazy rescale's jump runs, and
    the walk still meets the plain versions."""
    n = 1921
    q, k, v = (_t(a).to(torch.bfloat16) for a in _inputs(n, seed=11, B=1, H=1, count=3))
    k = (k.float() + 12 * torch.arange(n, dtype=torch.float32)[None, :, None, None] / n).to(torch.bfloat16)
    trace = []
    out, lse = _emulate_forward(_head(q, 0), _head(k, 0), _head(v, 0), trace=trace)
    assert sum(moved for _, t, moved, _ in trace if t > 0) > 0
    assert max(p for *_, p in trace) < 2 ** 8
    assert (out - attention_plain(q, k, v)[0, :, 0].float()).abs().max().item() <= K1_TOL
    assert (lse - attention_lse_plain(q, k)[0, 0]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("qt", QTS)
@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 585, 1921])
def test_backward_tile_walk_emulation_matches_the_plain_backward(n, qt):
    """The backward's walk, around the 16-row k-steps, the 32- and 64-row
    tiles and the 128-row block, and at the I-JEPA-H/14 and D = 80 step
    token counts: dq, dk, dv and di."""
    q, k, v, do = (_t(a).to(torch.bfloat16) for a in _inputs(n, seed=30 + n, B=1))
    out, lse = attention_fwd(q, k, v, with_lse=True)
    ref = attention_bwd_plain(q, k, v, out, do, lse)
    for h in range(q.shape[2]):
        got, di = _emulate_backward(*(_head(x, h) for x in (q, k, v, out, do)), lse[0, h], qt=qt)
        np.testing.assert_allclose(di.numpy(), (_head(do, h) * _head(out, h)).sum(-1).numpy(), atol=1e-6, rtol=0)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            r = _head(r, h)
            assert torch.isfinite(g).all(), name
            assert (g - r).abs().max().item() <= K1_BWD_REL * r.abs().max().item() + 1e-3, name


def test_tile_walk_emulation_needs_its_mask():
    """Zero-filled key rows give S = 0, not P = 0: without the -inf columns
    the last tile's padding takes weight in every row."""
    n = 65
    q, k, v = (_t(a).to(torch.bfloat16) for a in _inputs(n, seed=3, B=1, H=1, count=3))
    plain = attention_plain(q, k, v)[0, :, 0].float()
    unmasked, _ = _emulate_forward(*(x[0, :, 0].float() for x in (q, k, v)), mask=False)
    assert (unmasked - plain).abs().max().item() > 10 * K1_TOL


def test_backward_walk_needs_the_dq_mask():
    """In dq a zero-filled key row's S = 0 gives P = exp(-lse), and dS
    meets a zero row of K, so the mask changes nothing while P is finite.
    Where every logit is far below 0, lse is too, exp(-lse) overflows and
    inf times the zero row is NaN: the mask keeps dq finite."""
    n = 65
    rng = np.random.default_rng(4)
    q = torch.full((1, n, 1, D), 12.0)
    k = torch.full((1, n, 1, D), -12.0) + torch.from_numpy(rng.normal(size=(1, n, 1, D)).astype(np.float32))
    v, do = (torch.from_numpy(rng.normal(size=(1, n, 1, D)).astype(np.float32)) for _ in range(2))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    out, lse = attention_fwd(q, k, v, with_lse=True)
    assert lse.max().item() < -1000
    args = [_head(x, 0) for x in (q, k, v, out, do)] + [lse[0, 0]]
    masked, _ = _emulate_backward(*args)
    unmasked, _ = _emulate_backward(*args, mask=False)
    ref = attention_bwd_plain(q, k, v, out, do, lse)[0][0, :, 0].float()
    assert torch.isfinite(masked[0]).all()
    assert (masked[0] - ref).abs().max().item() <= K1_BWD_REL * ref.abs().max().item() + 1e-3
    assert torch.isnan(unmasked[0]).all()


def test_autograd_function_at_d80_is_the_plain_backward_on_the_cpu():
    q, k, v, do = map(_t, _inputs(40, seed=5))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    attention(*leaves).backward(do)
    o = attention_plain(q, k, v)
    for leaf, r in zip(leaves, attention_bwd_plain(q, k, v, o, do, attention_lse_plain(q, k))):
        np.testing.assert_allclose(leaf.grad.numpy(), r.numpy(), atol=1e-6, rtol=1e-6)


def test_i_jepa_vit_cut_to_size_matches_reference():
    """make_vit("i_jepa_huge") with its 14-pixel patch, no class token and
    heads of 80 (width 160, 2 heads, depth 2) against JAX's on the same
    weights; 3 x 4 patches of a 42 x 62 image (a VALID patch embed drops
    the last 6 columns, as at 192 x 640: 13 x 45 = 585 tokens)."""
    overrides = {"width": 160, "num_heads": 2, "depth": 2, "pos_embed_size": (42, 56)}
    cfg = dataclasses.replace(VIT_PRESETS["i_jepa_huge"], **overrides)
    assert cfg.width // cfg.num_heads == D and not cfg.class_token and cfg.patch_size == 14
    assert 192 // 14 * (640 // 14) == 585
    jcfg = dataclasses.replace(JVIT_PRESETS["i_jepa_huge"], **overrides, intermediate_layers=(0, 1))
    x = np.random.default_rng(8).uniform(size=(2, 3, 42, 62)).astype(np.float32)
    jmodel = JVisionTransformer(cfg=jcfg, want_key_features=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(9)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        w = rng.normal(size=leaf.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(w / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray(1.0 + 0.1 * w if "scale" in name else 0.1 * w)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    ref = jmodel.apply(params, jnp.asarray(x))
    from scenedino_torch.utils.convert import from_jax_params

    model = make_vit("i_jepa_huge", intermediate_layers=(0, 1), want_key_features=True, overrides=overrides)
    model.load_state_dict(from_jax_params(params["params"])[0])
    out = model(_t(x))
    assert out["features_normalized"].shape == (2, 12, 160)
    assert sorted(out) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(ref[name]), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_the_ptxas_gate_reads_each_kernels_setmaxnreg_split():
    """chip_smoke.py's phase 1 gate and the bench tool read the backward
    kernels' registers, spills and template arguments from nvcc's output;
    the producer / consumer split mirrors hopper.cuh's Registers."""
    from scenedino_torch.tools.bench_attention_bwd import backward_report, register_split

    src = (build.CSRC / "hopper.cuh").read_text()
    assert "static constexpr int PRODUCER = 24;" in src and "SHARE > 240 ? 240 : SHARE" in src
    assert register_split(2, 1) == (24, 240) and register_split(1, 2) == (24, 232)
    entry = "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{}' for 'sm_90a'"
    log = "\n".join([
        entry.format("27attention_d80_bwd_dq_kernelILi2ELi3ELi1EEEvNS_6DqMapsENS_6DqArgsE"),
        "ptxas info    : Used 168 registers, used 16 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        entry.format("28attention_d80_bwd_dkv_kernelILi1ELi2ELi2ELi32EEEvNS_7DkvMapsENS_7DkvArgsE"),
        "ptxas info    : Used 128 registers, used 16 barriers",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
    ])
    assert backward_report(log) == {
        "dq": {"registers": 168, "stack": 0, "spill_stores": 0, "spill_loads": 0, "wgs": 2, "stages": 3, "blocks": 1,
               "producer": 24, "consumer": 240},
        "dkv": {"registers": 128, "stack": 0, "spill_stores": 8, "spill_loads": 8, "wgs": 1, "stages": 2, "blocks": 2,
                "qt": 32, "producer": 24, "consumer": 232}}


def test_the_ptxas_gate_reads_the_forwards_two_instantiations():
    """The D = 80 forward is built in two instantiations (the block shape
    of most grids and of grids short of one wave); the gate and the bench
    tool key each by its warpgroups, ring slots and blocks per SM, with its
    setmaxnreg split, and a spill shows."""
    from scenedino_torch.tools.bench_attention_bwd import FWD80_MACROS, forward_report, parse_fwd_variant

    src = (build.CSRC / "attention_d80.cu").read_text()
    for macro, value in zip(FWD80_MACROS, (3, 3, 1, 2, 3, 1)):
        assert f"#define {macro} {value}\n" in src, macro
    assert parse_fwd_variant("3,3,1", FWD80_MACROS) == {"FWD80_WGS": 3, "FWD80_STAGES": 3, "FWD80_BLOCKS": 1}
    assert parse_fwd_variant("3,3,1/1,3,2", FWD80_MACROS)["FWD80_SMALL_BLOCKS"] == 2
    entry = "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{}' for 'sm_90a'"
    log = "\n".join([
        entry.format("24attention_d80_fwd_kernelILi3ELi3ELi1EEEvNS_9Fwd80MapsENS_9Fwd80ArgsE"),
        "ptxas info    : Used 128 registers, used 16 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        entry.format("24attention_d80_fwd_kernelILi2ELi3ELi1EEEvNS_9Fwd80MapsENS_9Fwd80ArgsE"),
        "ptxas info    : Used 168 registers, used 16 barriers",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
    ])
    assert forward_report(log) == {
        "fwd 3,3,1": {"registers": 128, "stack": 0, "spill_stores": 0, "spill_loads": 0, "wgs": 3, "stages": 3,
                      "blocks": 1, "producer": 24, "consumer": 160},
        "fwd 2,3,1": {"registers": 168, "stack": 0, "spill_stores": 4, "spill_loads": 4, "wgs": 2, "stages": 3,
                      "blocks": 1, "producer": 24, "consumer": 240}}
