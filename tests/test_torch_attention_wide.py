"""K1 past head dim 256 on the CPU: the port's attention against JAX at
D = 264, 300, 384 and 512, the route of every head dim from 257 to 1280,
the wrappers' zero padding of D = 300 around the plain versions, the walks
of `csrc/attention_wide.cu` (forward, dq, dkv) emulated against the plain
versions, and a ViT of one 320-wide head through both packages.

`scenedino_tpu/models/vit.py:_flash_mhsa` hands any D to the Pallas flash
attention; a ViT of `vit_overrides` with wide heads (ViT-B/8 with 2 heads:
D = 384) takes the wide kernels on the card. On the CPU `attention` takes
the plain forward and backward; here they meet `jax.nn.dot_product_attention`
and its VJP, each D's reference one `jax.jit`.

The emulation walks as the kernels do: D rounded up to a multiple of 8 by
the wrapper's zero columns, then to whole 64-column chunks by TMA's zero
fill; the output columns in column groups of 4 chunks (the forward, dq) or
2 (dkv), the last group starting 4 (2) chunks before the end and keeping
only its own; every group forming S (and dP) over all the chunks, one
64-column product a chunk in order, so every group holds the same softmax
state; the forward's online softmax in base 2 with the exact rescale, key
columns past N at -inf, P rounded to bf16 before P V, the output rounded to
bf16 and LSE = (m + log2 l) ln 2 from group 0; dq with P from the
log-sum-exp, key columns past N at P = 0, dS rounded to bf16 before dS K;
dkv per 64 key rows over 64-row query tiles, a query row past N having lse
+inf and di 0, P^T rounded to bf16 for dV += P^T dO and for dS^T, dS^T
rounded to bf16 before dS^T Q; results rounded to bf16.

Tolerances: the port against JAX atol/rtol 1e-5 (fp32, sums in another
order); the padded plain versions against the unpadded ones 1e-6 (zero
columns add exact zeros); the emulation's output within K1_TOL = 2e-2 and
its gradients within K1_BWD_REL = 2e-2 of the largest plain magnitude plus
1e-3, the bounds the kernels are held to on the card; its log-sum-exp and
di within 1e-5 (fp32 sums in another order). The ViT: its features within
1e-4 (tests/test_torch_attention_d80.py's I-JEPA ViT), its input gradient
within 1e-4 of the largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.models.vit import VIT_PRESETS as JVIT_PRESETS
from scenedino_tpu.models.vit import VisionTransformer as JVisionTransformer
from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import (
    ANY_MAX_HEAD_DIM,
    _KERNELS,
    attention,
    attention_bwd_plain,
    attention_lse_plain,
    attention_plain,
    route,
    with_head_dim,
)
from scenedino_torch.models.vit import Attention, make_vit

K1_TOL = 2e-2
K1_BWD_REL = 2e-2
TOL = dict(atol=1e-5, rtol=1e-5)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
BT = 64  # rows of an own and of a walked tile
GROUPS = {"fwd": 4, "dq": 4, "dkv": 2}  # 64-column chunks a column group (csrc/attention_wide.cu)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(n, D, seed, B=1, H=1, count=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, D)).astype(np.float32) for _ in range(count)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("D", [264, 300, 384, 512])
def test_attention_past_head_dim_256_matches_jax(D):
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


def test_route_of_every_head_dim_past_256():
    """Each D from 257 to 1280 names attention_wide.cu's three C functions,
    handed D rounded up to a multiple of 8 and computing at the next
    multiple of 64; none is refused."""
    assert ANY_MAX_HEAD_DIM == 256
    for D in range(ANY_MAX_HEAD_DIM + 1, 1281):
        width = -(-D // 8) * 8
        assert route(D) == ("wide", width, -(-width // 64) * 64), D
    assert route(264) == ("wide", 264, 320) and route(300) == ("wide", 304, 320) and route(1280) == ("wide", 1280, 1280)
    assert {step: _KERNELS["wide"][step][:2] for step in _KERNELS["wide"]} == {
        "fwd": ("attention_wide", "attention_wide_fwd"), "bwd_dq": ("attention_wide", "attention_wide_bwd_dq"),
        "bwd_dkv": ("attention_wide", "attention_wide_bwd_dkv")}
    assert [p.name for p in build.sources("attention_wide")] == ["attention_wide.cu", "hopper.cuh"]
    src = (build.CSRC / "attention_wide.cu").read_text()
    for name in ("attention_wide_fwd", "attention_wide_bwd_dq", "attention_wide_bwd_dkv"):
        assert f'extern "C" int {name}(' in src, name
    assert "FWD_G = 4, DQ_G = 4, DKV_G = 2;" in src  # GROUPS


def test_zero_padding_a_wide_head_dim_changes_nothing():
    """D = 300, padded to 304 by the wrappers, around the plain versions at
    D's scale: the forward, its log-sum-exp and the three gradients equal
    the unpadded ones."""
    D = 300
    q, k, v, do = (_t(a) for a in _inputs(70, D, seed=600, B=2, H=2))
    width, scale = route(D)[1], D ** -0.5
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


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _rows(x, start, count, pd):
    """Rows [start, start + count) of (N, D) as `pd` columns, zero past N
    and past D, as TMA fills them."""
    out = torch.zeros(count, pd)
    part = x[start:start + count]
    out[:part.shape[0], :x.shape[1]] = part
    return out


def _groups(chunks, G):
    """The column groups: (first chunk c0, first chunk stored)."""
    return [(min(g * G, chunks - G), g * G) for g in range(-(-chunks // G))]


def _over_chunks(a, b, chunks):
    """a b^T summed one 64-column chunk at a time, in order."""
    out = torch.zeros(a.shape[0], b.shape[0])
    for c in range(chunks):
        out = out + a[:, 64 * c:64 * c + 64] @ b[:, 64 * c:64 * c + 64].T
    return out


def _store(dst, r0, acc, c0, first, G, n, D):
    """The group's chunks from `first` on, rounded to bf16, into rows r0..r0 + n of dst, cut at D."""
    lo, hi = 64 * first, min(64 * (c0 + G), D)
    if lo < hi:
        dst[r0:r0 + n, lo:hi] = _bf16(acc)[:n, lo - 64 * c0:hi - 64 * c0]


def emulate_forward(q, k, v):
    """One head, (N, D) bf16 values in fp32: the output (N, D) and LSE (N,)."""
    N, D = q.shape
    pd = route(D)[2]
    chunks, G = pd // 64, GROUPS["fwd"]
    scale_log2 = D ** -0.5 * LOG2E
    out, lse = torch.zeros(N, D), torch.zeros(N)
    for r0 in range(0, N, BT):
        n = min(BT, N - r0)
        qi = _rows(q, r0, BT, pd)
        states = []
        for c0, first in _groups(chunks, G):
            m, l, o = torch.full((BT,), -float("inf")), torch.zeros(BT), torch.zeros(BT, 64 * G)
            for t0 in range(0, N, BT):
                s = _over_chunks(qi, _rows(k, t0, BT, pd), chunks)
                s[:, max(N - t0, 0):] = -float("inf")
                m_new = torch.maximum(m, s.max(-1).values * scale_log2)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * scale_log2 - m_new[:, None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[:, None] + _bf16(p) @ _rows(v, t0, BT, pd)[:, 64 * c0:64 * (c0 + G)]
                m = m_new
            states.append((m, l))
            _store(out, r0, o * (1 / l)[:, None], c0, first, G, n, D)
        assert all(torch.equal(m, states[0][0]) and torch.equal(l, states[0][1]) for m, l in states)
        m, l = states[0]
        lse[r0:r0 + n] = ((m + torch.log2(l)) * LN2)[:n]
    return out, lse


def emulate_dq(q, k, v, o, do, lse):
    N, D = q.shape
    pd = route(D)[2]
    chunks, G = pd // 64, GROUPS["dq"]
    scale = D ** -0.5
    di = (do * o).sum(-1)
    dq = torch.zeros(N, D)
    for r0 in range(0, N, BT):
        n = min(BT, N - r0)
        qi, doi = _rows(q, r0, BT, pd), _rows(do, r0, BT, pd)
        lr, dr = torch.zeros(BT), torch.zeros(BT)  # 0 past N
        lr[:n], dr[:n] = lse[r0:r0 + n] * LOG2E, di[r0:r0 + n]
        for c0, first in _groups(chunks, G):
            acc = torch.zeros(BT, 64 * G)
            for t0 in range(0, N, BT):
                kt, vt = _rows(k, t0, BT, pd), _rows(v, t0, BT, pd)
                live = t0 + torch.arange(BT) < N
                p = torch.where(live, torch.exp2(_over_chunks(qi, kt, chunks) * scale * LOG2E - lr[:, None]),
                                torch.tensor(0.0))
                ds = p * (_over_chunks(doi, vt, chunks) - dr[:, None]) * scale
                acc = acc + _bf16(ds) @ kt[:, 64 * c0:64 * (c0 + G)]
            _store(dq, r0, acc, c0, first, G, n, D)
    return dq, di


def emulate_dkv(q, k, v, do, lse, di):
    N, D = q.shape
    pd = route(D)[2]
    chunks, G = pd // 64, GROUPS["dkv"]
    scale = D ** -0.5
    dk, dv = torch.zeros(N, D), torch.zeros(N, D)
    for k0 in range(0, N, BT):
        n = min(BT, N - k0)
        kt, vt = _rows(k, k0, BT, pd), _rows(v, k0, BT, pd)
        for c0, first in _groups(chunks, G):
            cols = slice(64 * c0, 64 * (c0 + G))
            gk, gv = torch.zeros(BT, 64 * G), torch.zeros(BT, 64 * G)
            for t0 in range(0, N, BT):
                qt, dot = _rows(q, t0, BT, pd), _rows(do, t0, BT, pd)
                m = min(BT, N - t0)
                lt, dt = torch.full((BT,), float("inf")), torch.zeros(BT)
                lt[:m], dt[:m] = lse[t0:t0 + m] * LOG2E, di[t0:t0 + m] * scale
                pt = _bf16(torch.exp2(_over_chunks(kt, qt, chunks) * scale * LOG2E - lt[None, :]))
                gv = gv + pt @ dot[:, cols]
                dst = pt * (_over_chunks(vt, dot, chunks) * scale - dt[None, :])
                gk = gk + _bf16(dst) @ qt[:, cols]
            _store(dk, k0, gk, c0, first, G, n, D)
            _store(dv, k0, gv, c0, first, G, n, D)
    return dk, dv


@pytest.mark.parametrize("D,N", [(264, 63), (320, 129), (384, 63), (768, 129)])
def test_wide_walk_emulation_matches_the_plain_versions(D, N):
    """Five chunks (264, the last 8 columns wide; 320), six (384) and
    twelve (768): the forward's and dq's last group overlapping the one
    before at 264 and 320, dkv's at 264 and 320; ragged token counts around
    the 64-row tiles."""
    q, k, v, do = (_t(a).to(torch.bfloat16) for a in _inputs(N, D, seed=D + N))
    out_ref = attention_plain(q, k, v)
    lse_ref = attention_lse_plain(q, k)
    grads_ref = attention_bwd_plain(q, k, v, out_ref, do, lse_ref)
    qh, kh, vh, doh, oh = (x[0, :, 0].float() for x in (q, k, v, do, out_ref))
    out, lse = emulate_forward(qh, kh, vh)
    assert (out - oh).abs().max().item() <= K1_TOL
    np.testing.assert_allclose(lse.numpy(), lse_ref[0, 0].numpy(), atol=1e-5, rtol=0)
    dq, di = emulate_dq(qh, kh, vh, oh, doh, lse_ref[0, 0])
    np.testing.assert_allclose(di.numpy(), (doh * oh).sum(-1).numpy(), atol=1e-5, rtol=0)
    dk, dv = emulate_dkv(qh, kh, vh, doh, lse_ref[0, 0], di)
    for name, got, ref in zip("qkv", (dq, dk, dv), grads_ref):
        want = ref[0, :, 0].float()
        err = (got - want).abs().max().item()
        assert err <= K1_BWD_REL * want.abs().max().item() + 1e-3, (name, err)


def test_vit_of_one_wide_head_matches_reference():
    """make_vit("dino_base8") with vit_overrides width 320, depth 2, 1 head
    (D = 320) on a 32 x 64 image (33 tokens) against JAX's on the same
    weights, carried by utils/convert.py; the port's attention forced
    through K1's autograd Function (`attention`, the wide route: its plain
    versions on the CPU), JAX's through jax.nn.dot_product_attention. The
    features and the input's gradient of their sum."""
    overrides = {"width": 320, "num_heads": 1, "depth": 2, "pos_embed_size": (32, 64)}
    jcfg = dataclasses.replace(JVIT_PRESETS["dino_base8"], **overrides, intermediate_layers=(0, 1))
    assert route(jcfg.width // jcfg.num_heads)[0] == "wide"
    x = np.random.default_rng(10).uniform(size=(1, 3, 32, 64)).astype(np.float32)
    jmodel = JVisionTransformer(cfg=jcfg, want_key_features=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        w = rng.normal(size=leaf.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(w / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray(1.0 + 0.1 * w if "scale" in name else 0.1 * w)

    params = jax.tree_util.tree_map_with_path(draw, shapes)

    @jax.jit
    def ref(params, x):
        out, vjp = jax.vjp(lambda x: jmodel.apply(params, x), x)
        return out, vjp(jax.tree_util.tree_map(jnp.ones_like, out))[0]

    ref_out, ref_dx = ref(params, jnp.asarray(x))
    from scenedino_torch.utils.convert import from_jax_params

    model = make_vit("dino_base8", intermediate_layers=(0, 1), want_key_features=True, overrides=overrides)
    model.load_state_dict(from_jax_params(params["params"])[0])
    blocks = [m for m in model.modules() if isinstance(m, Attention)]
    assert len(blocks) == 2
    for m in blocks:
        m.use_flash = True
    xt = _t(x).requires_grad_(True)
    out = model(xt)
    assert sorted(out) == sorted(ref_out)
    sum(o.sum() for o in out.values()).backward()
    for name in ref_out:
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(ref_out[name]), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    dx = np.asarray(ref_dx)
    np.testing.assert_allclose(xt.grad.numpy(), dx, atol=1e-4 * float(np.abs(dx).max()), rtol=0)
