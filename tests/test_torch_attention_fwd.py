"""What Python can reach of the K1 forward kernel (`csrc/attention.cu`) on
the CPU: an emulation of its tile walk against `attention_plain` and
`attention_lse_plain`, and against the Pallas module's own reference
(jax/experimental/pallas/ops/tpu/flash_attention.py `mha_reference`, its
residuals for the log-sum-exp) padded to a multiple of 128 tokens and
masked by segment ids as `scenedino_tpu/models/vit.py:_flash_mhsa` pads
for the kernel; then that the library's name hashes `csrc/hopper.cuh` and
that the source is built on its primitives.

The emulation walks as the kernel does: 64-row query tiles (one a
warpgroup), 64-row key and value tiles zero-filled past N, S = Q K^T in
fp32 from bf16 values, the online softmax in base 2 with scale * log2(e)
folded in, the last tile's columns at or past N set to -inf, O rescaled
by alpha (exactly, as the kernel is built: the running max moves whenever
it grows; `lazy=True` walks as the kernel did before, with the lazy
rescale: the running max of a warp's 16 rows moves only when one of them
grows by more than 8), P rounded to bf16 before P V, the output rounded to
bf16 and LSE = (m + log2 l) ln 2. On keys scaled along the walk, where the
softmax lands on one key, the lazy walk reads a whole bf16 step more than
the exact one (ROADMAP queue 3, item C).

Tolerances: the output within K1_TOL = 2e-2, the bound the kernel is held
to on the card (bf16 output, ulp 2^-8 at |x| ~ 1, plus P rounded to bf16
for P V); the log-sum-exp within 1e-5 absolute (fp32 statistics of the
same values, summed in another order; on the card 1e-3, where exp2 is
approximate).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference_no_custom_vjp

from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import attention_fwd, attention_lse_plain, attention_plain

TILE = 64
K1_TOL = 2e-2
LSE_TOL = 1e-5
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(n, seed, B=1, H=2, D=64):
    """q, k, v (B, n, H, D) drawn with numpy, rounded to bf16 as the kernel takes them."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, n, H, D)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _tile(x, t):
    """Rows [64 t, 64 t + 64) of (N, D), rows past N zero-filled as a TMA load fills them."""
    out = torch.zeros(TILE, x.shape[1])
    rows = x[t * TILE:(t + 1) * TILE]
    out[:rows.shape[0]] = rows
    return out


def _emulate_kernel(q, k, v, mask=True, lazy=True, trace=None, query_tiles=None):
    """One head, (N, D) bf16 values held in fp32: the forward kernel's walk.
    `lazy`: the lazy rescale (K1_RESCALE_SLACK 8): the running max of the 16
    rows of a warp moves only when one of them grows by more than 8.
    `trace`, a list: gets (query tile, walked tile, warps whose max moved,
    the largest P) for each step. `query_tiles`: the warpgroups' query tiles
    to walk (each walks on its own), all by default; the rows of the others
    are 0. Returns the output (N, D), bf16 values in fp32, and the LSE (N,)."""
    N, D = q.shape
    scale_log2 = D ** -0.5 * LOG2E
    tiles = -(-N // TILE)
    out, lse = torch.zeros(tiles * TILE, D), torch.zeros(tiles * TILE)
    for i in range(tiles) if query_tiles is None else query_tiles:  # a warpgroup's query tile
        qi = _tile(q, i)
        m = torch.full((TILE,), -float("inf"))
        l = torch.zeros(TILE)
        o = torch.zeros(TILE, D)
        for t in range(tiles):  # the walked key and value tiles
            s = qi @ _tile(k, t).T
            if mask:
                s[:, max(N - t * TILE, 0):] = -float("inf")
            mx = s.max(-1).values * scale_log2
            move = torch.ones(TILE, dtype=torch.bool)
            if lazy:  # per warp: 4 warps of 16 rows
                move = (mx > m + 8).reshape(4, 16).any(-1).repeat_interleave(16)
            m_new = torch.where(move, torch.maximum(m, mx), m)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[:, None])
            if trace is not None:
                trace.append((i, t, int(move[::16].sum()), p.max().item()))
            l = l * alpha + p.sum(-1)
            o = o * alpha[:, None] + p.to(torch.bfloat16).float() @ _tile(v, t)
            m = m_new
        rows = slice(i * TILE, (i + 1) * TILE)
        out[rows] = (o / l[:, None]).to(torch.bfloat16).float()
        lse[rows] = (m + torch.log2(l)) * LN2
    return out[:N], lse[:N]


def _emulate_all(q, k, v, mask=True, lazy=True):
    """The emulation over every (batch, head): (B, N, H, D) and (B, H, N)."""
    B, N, H, _ = q.shape
    out, lse = torch.zeros(q.shape), torch.zeros(B, H, N)
    for b in range(B):
        for h in range(H):
            out[b, :, h], lse[b, h] = _emulate_kernel(*(x[b, :, h].float() for x in (q, k, v)), mask=mask,
                                                      lazy=lazy)
    return out, lse


def _mha_reference(q, k, v, block=128):
    """mha_reference's forward on (B, H, NP, D), NP the next multiple of
    `block`, pad rows masked by segment ids (0 pad, 1 real); the output
    (B, N, H, D) and the log-sum-exp m + log(l) of its residuals (B, H, N)."""
    B, N, H, D = q.shape
    NP = -(-N // block) * block
    ids = jnp.broadcast_to((jnp.arange(NP) < N).astype(jnp.int32)[None], (B, NP))

    def prep(x):
        x = jnp.asarray(x.float().numpy())
        return jnp.pad(x.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, NP - N), (0, 0)))

    out, l, m = mha_reference_no_custom_vjp(prep(q), prep(k), prep(v), None, SegmentIds(q=ids, kv=ids),
                                            sm_scale=float(D) ** -0.5, save_residuals=True)
    lse = m + jnp.log(l)
    return (torch.from_numpy(np.array(out[:, :, :N].transpose(0, 2, 1, 3))),
            torch.from_numpy(np.array(lse[:, :, :N])))


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 191, 192, 193])
def test_tile_walk_emulation_matches_the_plain_forward_and_mha_reference(n, lazy):
    """Around the 64-row tile and the 192-row block of three warpgroups;
    with the exact rescale (the kernel's) and with the lazy one."""
    q, k, v = _inputs(n, seed=40 + n)
    out, lse = _emulate_all(q, k, v, lazy=lazy)
    plain = attention_plain(q, k, v).float()
    plain_lse = attention_lse_plain(q, k)
    ref, ref_lse = _mha_reference(q, k, v)
    for name, r in (("plain", plain), ("mha_reference", ref)):
        err = (out - r).abs().max().item()
        assert err <= K1_TOL, (name, err)
    for name, r in (("plain", plain_lse), ("mha_reference", ref_lse)):
        err = (lse - r).abs().max().item()
        assert err <= LSE_TOL, (name, err)
    # the wrapper's CPU path is the plain version
    got, got_lse = attention_fwd(q, k, v, with_lse=True)
    assert torch.equal(got, attention_plain(q, k, v)) and torch.equal(got_lse, plain_lse)


@pytest.mark.parametrize("n", [65, 193])
def test_tile_walk_emulation_needs_its_mask(n):
    """Zero-filled key rows past N give S = 0 and P = exp2(-m) > 0: unmasked,
    the last tile adds weight to rows that do not exist, so the row sum l,
    the output (divided by l) and the log-sum-exp are wrong."""
    q, k, v = _inputs(n, seed=70 + n)
    plain = attention_plain(q, k, v).float()
    plain_lse = attention_lse_plain(q, k)
    masked, masked_lse = _emulate_all(q, k, v)
    assert (masked - plain).abs().max().item() <= K1_TOL
    assert (masked_lse - plain_lse).abs().max().item() <= LSE_TOL
    unmasked, unmasked_lse = _emulate_all(q, k, v, mask=False)
    assert (unmasked - plain).abs().max().item() > K1_TOL
    assert (unmasked_lse - plain_lse).abs().max().item() > 1e-2


def test_exact_rescale_stays_within_one_step_where_the_lazy_one_reads_two():
    """Item C of ROADMAP queue 3: keys scaled along the walk (key row n by
    1 + 4 n / N), the construction of tools/softmax_sweep.py and chip_smoke.py
    phase 11a at their (2, 1921, 12, 64) shape and seeds (200 + N, 1, 2, 3),
    drawn with numpy. Where the fp32 output reaches 4 a bf16 step is
    3.125e-2; there the lazy walk (P of the dominant key up to 2^8, rounded
    to bf16 for P V while l sums it unrounded) reads a whole step against the
    fp32 plain version rounded to bf16, the exact walk (that P is 1) stays
    within 1.5625e-2. Only the query tiles that hold such a row are walked:
    each walks on its own."""
    B, N, Hh, D = 2, 1921, 12, 64
    ramp = torch.arange(N, dtype=torch.float32)[:, None, None] / N
    cases = []
    for seed in (200 + N, 1, 2, 3):
        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.normal(size=(B, N, Hh, D)).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(3))
        for b in range(B):
            qb, vb = q[b:b + 1], v[b:b + 1]
            kb = (k[b:b + 1].float() * (1 + 4 * ramp)).to(torch.bfloat16)
            ref = attention_plain(qb, kb, vb).float()[0]  # (N, H, D)
            for h in range(Hh):
                rows = (ref[:, h].abs() >= 4).any(-1).nonzero()[:, 0]
                if rows.numel() == 0:
                    continue
                tiles = sorted({int(r) // TILE for r in rows})
                args = (qb[0, :, h].float(), kb[0, :, h].float(), vb[0, :, h].float())
                at = torch.cat([torch.arange(t * TILE, min((t + 1) * TILE, N)) for t in tiles])
                errs = [(_emulate_kernel(*args, lazy=lazy, query_tiles=tiles)[0][at] - ref[at, h]).abs().max().item()
                        for lazy in (True, False)]
                cases.append((seed, b, h, *errs))
    lazy_two = [c for c in cases if c[3] >= 3.125e-2]
    assert lazy_two, cases  # the fault shows on the CPU too
    assert all(c[4] <= 1.5625e-2 for c in lazy_two), lazy_two
    assert all(c[4] <= 1.5625e-2 for c in cases), cases


def test_lazy_rescale_keeps_p_below_two_to_the_eight_and_moves_on_a_jump():
    """Keys that grow along the walk: with the lazy rescale the running max
    stays put while the logits grow by less than 8 (so P < 2^8 before its
    bf16 rounding) and moves on a larger jump; the result is the plain
    version's either way."""
    n = 256
    rng = np.random.default_rng(3)
    base = np.abs(rng.normal(size=(n, 64))).astype(np.float32)
    q = torch.from_numpy(base).to(torch.bfloat16).float()
    # the logits of the four walked tiles: about 11.5 (base 2) times 1, 1.05, 1.1, 2
    grow = np.repeat(np.array([0.0, 0.05, 0.1, 1.0], np.float32), 64)[:, None]
    k = torch.from_numpy(base * (1 + grow)).to(torch.bfloat16).float()
    v = _inputs(n, seed=4, H=1)[2][0, :, 0].float()
    trace = []
    out, lse = _emulate_kernel(q, k, v, lazy=True, trace=trace)
    qb, kb, vb = (x[None, :, None].to(torch.bfloat16) for x in (q, k, v))
    assert (out - attention_plain(qb, kb, vb)[0, :, 0].float()).abs().max().item() <= K1_TOL
    assert (lse - attention_lse_plain(qb, kb)[0, 0]).abs().max().item() <= LSE_TOL
    moves = {(i, t): moved for i, t, moved, _ in trace}
    assert all(moves[i, 0] == 4 for i in range(4))  # the first tile sets the max of every warp
    assert all(moves[i, 1] == 0 and moves[i, 2] == 0 for i in range(4))  # growth below 8: no move
    assert all(moves[i, 3] > 0 for i in range(4))  # the jump
    assert max(p for *_, p in trace) < 2 ** 8


def test_tile_walk_emulation_needs_no_mask_on_whole_tiles():
    """At N a multiple of 64 no key row is zero-filled: the walk with and
    without the mask is the same, so only a ragged last tile pays for it."""
    q, k, v = _inputs(128, seed=5)
    masked, masked_lse = _emulate_all(q, k, v)
    unmasked, unmasked_lse = _emulate_all(q, k, v, mask=False)
    assert torch.equal(masked, unmasked) and torch.equal(masked_lse, unmasked_lse)


def test_forward_library_hashes_the_hopper_header():
    names = [p.name for p in build.sources("attention")]
    assert names == ["attention.cu", "hopper.cuh"]
    text = (build.CSRC / "attention.cu").read_text()
    for needle in ("wgmma_m64n64k16_rs", "tma_load_4d", "tma_store_4d", "mbar_wait",
                   "mbar_arrive", "registers_take", "softmax_tile", "allow_smem"):
        assert needle in text, needle
    # the online softmax (ex2.approx) is hopper.cuh's, shared with the D = 80 forward
    assert "fast_exp2(fmaf(" in (build.CSRC / "hopper.cuh").read_text()
    for gone in ("wmma::", "cudaFuncSetAttribute"):  # the WMMA kernel it replaced; the attribute is set once per device
        assert gone not in text, gone
