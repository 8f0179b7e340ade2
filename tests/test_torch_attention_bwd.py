"""The K1 backward on the CPU against JAX: `attention_bwd_plain` and the
autograd Function `attention` (which takes the plain versions for CPU
tensors) against `jax.vjp` of `jax.nn.dot_product_attention` and of the
Pallas module's own reference `mha_reference`
(jax/experimental/pallas/ops/tpu/flash_attention.py:1530), the latter
padded to a multiple of 128 tokens and masked by segment ids as
`scenedino_tpu/models/vit.py:_flash_mhsa` pads for the kernel.

fp32 throughout; tolerance atol 1e-5 / rtol 1e-4: fp32 round-off of
products over up to 130 tokens, summed in other orders.

Then what Python can reach of the CUDA kernels (`csrc/attention_bwd.cu`):
an emulation of their tile walk (64-row tiles, the tail zero-filled, P and
dS masked past N and rounded to bf16 before the second products, di handed
from dq to dkv) against `attention_bwd_plain` within the bound the kernels
are held to on the card (2e-2 of the largest |plain| value plus 1e-3); the
sources the library's name hashes; the alignment the tensor maps need.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference

from scenedino_torch.kernels import attention, attention_bwd_dkv, attention_bwd_dq, build, launches
from scenedino_torch.kernels.attention import (
    _check_aligned,
    attention_bwd_plain,
    attention_fwd,
    attention_lse_plain,
    attention_plain,
)

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(n, seed, B=2, H=3, D=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, D)).astype(np.float32) for _ in range(4)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_dot_product_grads(q, k, v, do):
    _, vjp = jax.vjp(jax.nn.dot_product_attention, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _jax_mha_reference_grads(q, k, v, do, block=128):
    """vjp of mha_reference on (B, H, NP, D), NP the next multiple of `block`,
    pad rows masked by segment ids (0 pad, 1 real); the pad sliced off.
    Its backward takes sm_scale = 1 only, so q is scaled before the call."""
    B, N, H, D = q.shape
    NP = -(-N // block) * block
    ids = jnp.broadcast_to((jnp.arange(NP) < N).astype(jnp.float32)[None], (B, NP))

    def f(q, k, v):
        def prep(x):
            return jnp.pad(x.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, NP - N), (0, 0)))

        out = mha_reference(prep(q * float(D) ** -0.5), prep(k), prep(v), None,
                            segment_ids=SegmentIds(q=ids, kv=ids))
        return out[:, :, :N].transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("n", [1, 65, 130])
def test_plain_backward_matches_jax_dot_product_attention(n):
    q, k, v, do = _inputs(n, seed=n)
    ref = _jax_dot_product_grads(q, k, v, do)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o = attention_plain(tq, tk, tv)
    got = attention_bwd_plain(tq, tk, tv, o, tdo, attention_lse_plain(tq, tk))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), r, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("n", [65, 130])
def test_autograd_function_matches_mha_reference_vjp(n):
    q, k, v, do = _inputs(n, seed=10 + n)
    ref = _jax_mha_reference_grads(q, k, v, do)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    before = launches()
    out = attention(*leaves)
    out.backward(_t(do))
    assert launches() == before  # CPU tensors take the plain versions
    for name, leaf, r in zip("qkv", leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, err_msg=f"d{name}", **TOL)


def test_split_wrappers_equal_the_plain_backward():
    """dq then dkv (the kernels' split, with di handed from one to the
    other) give the plain backward's numbers on CPU tensors."""
    q, k, v, do = map(_t, _inputs(33, seed=3))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    np.testing.assert_allclose(lse.numpy(), attention_lse_plain(q, k).numpy())
    dq, di = attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    assert di.shape == (2, 3, 33)
    for got, ref in zip((dq, dk, dv), attention_bwd_plain(q, k, v, o, do, lse)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)


def test_no_graph_no_lse():
    q = torch.randn(1, 9, 2, 64)
    assert attention_fwd(q, q, q)[1] is None
    with torch.no_grad():
        out = attention(q.requires_grad_(True), q, q)
    assert out.grad_fn is None


TILE = 64
K1_BWD_REL = 2e-2  # the card's bound: this share of the largest |plain| value plus 1e-3


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tile(x, t):
    """Rows [64 t, 64 t + 64) of (N, D), rows past N zero-filled as a TMA load fills them."""
    out = torch.zeros(TILE, x.shape[1])
    rows = x[t * TILE:(t + 1) * TILE]
    out[:rows.shape[0]] = rows
    return out


def _emulate_kernels(q, k, v, o, do, lse, mask=True):
    """One head, (N, D) bf16 values held in fp32; lse (N,). The walk of
    attention_bwd_dq then attention_bwd_dkv: fp32 accumulation of bf16
    products, base-2 exponent, P and dS rounded to bf16 for the second
    products, columns at or past N masked to 0, results cut at N."""
    N, D = q.shape
    scale, log2e = D ** -0.5, 1.4426950408889634
    tiles = -(-N // TILE)
    pad = tiles * TILE - N
    lse2 = torch.cat([lse * log2e, torch.zeros(pad)])
    # dq: a warpgroup owns a query tile, walks the key tiles; di = rowsum(dO o) goes to dkv
    di = torch.cat([(do * o).sum(-1), torch.zeros(pad)])
    dq = torch.zeros(tiles * TILE, D)
    for i in range(tiles):
        rows = slice(i * TILE, (i + 1) * TILE)
        qi, doi = _tile(q, i), _tile(do, i)
        for t in range(tiles):
            kt, vt = _tile(k, t), _tile(v, t)
            p = torch.exp2(qi @ kt.T * (scale * log2e) - lse2[rows, None])
            ds = p * ((doi @ vt.T) * scale - (di[rows] * scale)[:, None])
            if mask:
                ds[:, max(N - t * TILE, 0):] = 0
            dq[rows] += _bf16(ds) @ kt
    # dkv: a warpgroup owns a key tile, walks the query tiles with their lse and di
    dk, dv = torch.zeros(tiles * TILE, D), torch.zeros(tiles * TILE, D)
    for i in range(tiles):
        rows = slice(i * TILE, (i + 1) * TILE)
        ki, vi = _tile(k, i), _tile(v, i)
        for t in range(tiles):
            cols = slice(t * TILE, (t + 1) * TILE)
            qt, dot = _tile(q, t), _tile(do, t)
            pt = torch.exp2(ki @ qt.T * (scale * log2e) - lse2[None, cols])
            if mask:
                pt[:, max(N - t * TILE, 0):] = 0
            dst = pt * ((vi @ dot.T) * scale - (di[cols] * scale)[None])
            dv[rows] += _bf16(pt) @ dot
            dk[rows] += _bf16(dst) @ qt
    return [_bf16(x[:N]) for x in (dq, dk, dv)], di[:N]


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130])
def test_tile_walk_emulation_matches_the_plain_backward(n):
    """Pins the kernels' masking rule where it can run: zero-filled key rows
    give S = 0 and P = exp2(-lse) != 0, so without the mask on columns past N
    the gradients of the last tile would be wrong."""
    q, k, v, do = (_t(a).to(torch.bfloat16) for a in _inputs(n, seed=20 + n, B=1, H=2))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    ref = attention_bwd_plain(q, k, v, o, do, lse)
    di_ref = (do.float() * o.float()).sum(-1)
    for h in range(q.shape[2]):
        got, di = _emulate_kernels(*(x[0, :, h].float() for x in (q, k, v, o, do)), lse[0, h])
        np.testing.assert_allclose(di.numpy(), di_ref[0, :, h].numpy(), atol=1e-5, rtol=1e-5)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            r = r[0, :, h].float()
            err = (g - r).abs().max().item()
            assert err <= K1_BWD_REL * r.abs().max().item() + 1e-3, (name, err)


def test_tile_walk_emulation_needs_its_mask():
    """Where every logit of a row is very negative, lse is too, and a
    zero-filled key column gives P = exp2(0 - lse * log2(e)) = inf: unmasked,
    inf times the zero rows of K is NaN. The mask keeps the walk finite
    (uniform P makes the true gradients cancel to round-off, so no bound is
    held here; the test above holds it)."""
    n = 65
    ones = torch.ones(1, n, 1, 64)
    q, k = (5 * ones).to(torch.bfloat16), (-5 * ones).to(torch.bfloat16)  # every logit -200
    v, do = (_t(a).to(torch.bfloat16) for a in _inputs(n, seed=5, B=1, H=1)[:2])
    o, lse = attention_fwd(q, k, v, with_lse=True)
    assert lse.max().item() < -190
    args = [x[0, :, 0].float() for x in (q, k, v, o, do)] + [lse[0, 0]]
    masked, _ = _emulate_kernels(*args)
    assert all(torch.isfinite(g).all() for g in masked)
    unmasked, _ = _emulate_kernels(*args, mask=False)
    assert not torch.isfinite(unmasked[0]).all()


def test_backward_library_hashes_the_hopper_header():
    names = [p.name for p in build.sources("attention_bwd")]
    assert names == ["attention_bwd.cu", "hopper.cuh"]
    assert (build.CSRC / "hopper.cuh").exists()
    text = (build.CSRC / "attention_bwd.cu").read_text()
    for needle in ("wgmma_m64n64k16_rs", "tma_load_4d", "mbar_wait", "registers_take"):
        assert needle in text, needle


def test_wrapper_refuses_a_misaligned_base_pointer():
    """The tensor maps need 16-byte aligned bases: a contiguous view that
    starts 2 bytes into its storage is refused before any launch."""
    store = torch.zeros(2 * 5 * 3 * 64 + 1, dtype=torch.bfloat16)
    aligned = store[:-1].view(2, 5, 3, 64)
    shifted = store[1:].view(2, 5, 3, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    _check_aligned(aligned, aligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned(aligned, shifted)


def test_ptxas_report_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3foo23attention_bwd_dq_kernelILi2ELi3ELi1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN3foo23attention_bwd_dq_kernelILi2ELi3ELi1EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN3foo24attention_bwd_dkv_kernelILi2ELi3ELi1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN3foo24attention_bwd_dkv_kernelILi2ELi3ELi1EEEv
    32 bytes stack frame, 28 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
"""
    report = build.ptxas_report(log)
    assert list(report) == ["_ZN3foo23attention_bwd_dq_kernelILi2ELi3ELi1EEEv",
                            "_ZN3foo24attention_bwd_dkv_kernelILi2ELi3ELi1EEEv"]
    dq, dkv = report.values()
    assert dq == {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 168}
    assert dkv == {"stack": 32, "spill_stores": 28, "spill_loads": 24, "registers": 168}
    assert build.ptxas_report("") == {}
