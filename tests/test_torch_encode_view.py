"""K6, the encode-view render: its plain version (what the CPU runs) against
the JAX reference's `render_encode_view` and `render_encode_view_batched`
on the same folded state and strata, in the state's two dtypes (the fp32
fold of stage 2, the bf16 state of serving), both depth statistics and 8
and 48 samples a ray; a CPU emulation of the kernel's walk (64-row tiles of
rays padded with dead rows to 8, 16, 32 or 64 samples; the z code and both
products as the kernel's wgmma steps, bf16-rounded code and h for the bf16
state, three TF32 passes for the fp32 one; one warp a ray, two samples a
lane: the product scan, butterfly sums and ballot median) against the
plain version; the wide walk (csrc/wide_walk.cuh, every shape the
shipped instantiations do not take) emulated as it streams the weights:
the z code padded to whole code tiles (64 bf16 or 32 TF32 columns), h
formed 64 hidden units at a time and rounded (bf16) or split (TF32 hi and
lo, three passes) where its products load it, the output columns in
chunks of 64 with the density column's chunk first, the rays composited
one tile or 64-sample segment at a time (tests/test_torch_point_render.py's
`composite_tiles`, the warps the wide walk shares with the shipped one) and
each chunk's features summed with those weights, against the plain version
at D 136 and 512, E 129 and 769, 33 z-code columns and 320 samples a ray;
one TF32 pass against three at the seeded state's widths and scales; and
the wrapper's refusals. The kernel against its plain version
on a card is in tests/test_torch_kernels.py (which imports no JAX).

The strata are the JAX function's own, rebuilt from its key (`uniform`
of `split(key, 5)[0]`, fast_field.py:294). Tolerances: fp32 (JAX under
"highest" precision) rtol 1e-4 and an atol of 1e-4, or 1e-5 x the largest
magnitude where that is larger, as tests/test_torch_query.py; bf16: h is
rounded to bf16 before W2 on both sides, but the two sum its fp32 terms
in other orders, so a rounding can flip (ulp 2^-8 |h|, on a few of the
~1e5 hidden values): depth 5e-2 m, feature and colour 5e-3 (chip_smoke.py's
K2 bounds, the same reason), the median ray's error below 1e-5; the
median depth the reference's sample or its neighbour on at most 1 % of
rays. The emulation: its sums (three TF32 passes of ~2^-22 a product for
the fp32 state) against the plain version's fp32 ones, 1e-5 relative
(1e-4 m in depth); the median's sample exactly. The TF32 case: three
passes within a tenth of the fp32 state's bounds of the card (1e-3 m,
1e-4, 1e-4), one pass outside them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.core import encoding
from scenedino_torch.kernels import launches, reset_launches
from scenedino_torch.kernels.encode_view import EncodeViewConfig, encode_view, encode_view_plain
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops import fast_field as ff

K_NDC = np.array([[1.1, 0.0, 0.02], [0.0, 2.2, -0.01], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _state(rng, B, H, W, D, E, dtype):
    """A folded (B, 1)-view state: a grid at twice the render size, the
    weights, colour images; grid, W_code, W2 and the images stored in
    `dtype` as build_fast_state stores them."""
    w2c = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 1, 4, 4)).copy()
    w2c[:, 0, 0, 3] = -0.2 * np.arange(B)
    ks = np.broadcast_to(K_NDC, (B, 1, 3, 3)).copy()
    b2 = rng.normal(size=E) * 0.2
    b2[0] += 0.5
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    cast = lambda x: f32(x).astype(dtype)  # noqa: E731
    return jff.FastFieldState(
        folded_grid=cast(rng.normal(size=(B, 1, 2 * H, 2 * W, D))), w_code=cast(rng.normal(size=(39, D)) * 0.3),
        b1=f32(rng.normal(size=D) * 0.1), w2=cast(rng.normal(size=(D, E)) / np.sqrt(D)), b2=f32(b2),
        feat_ks=f32(ks), feat_w2c=f32(w2c), color_imgs=cast(rng.uniform(size=(B, 1, H, W, 3))), color_ks=f32(ks),
        color_w2c=f32(w2c))


def _to_port(jfs) -> ff.FastFieldState:
    def conv(a):
        t = torch.from_numpy(np.asarray(a, np.float32))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    return ff.FastFieldState(*(None if getattr(jfs, f) is None else conv(getattr(jfs, f))
                               for f in ff.FastFieldState._fields))


def _strata(key, R, K):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.split(key, 5)[0], (R, K))))


def _check(out, ref, dtype, z=None, median=False):
    names = ("depth", "feature", "rgb")
    for name, o, r in zip(names, out, ref):
        r = np.asarray(r, np.float32)
        o = o.numpy()
        assert o.shape == r.shape, name
        if dtype == jnp.float32:
            np.testing.assert_allclose(o, r, atol=max(1e-4, 1e-5 * float(np.abs(r).max())), rtol=1e-4, err_msg=name)
        elif name == "depth" and median:
            zz = z.numpy().reshape(*o.shape, -1)
            k_o = np.abs(zz - o[..., None]).argmin(-1)
            k_r = np.abs(zz - r[..., None]).argmin(-1)
            assert np.abs(k_o - k_r).max() <= 1 and (k_o != k_r).mean() <= 1e-2
        else:
            bound = 5e-2 if name == "depth" else 5e-3
            err = np.abs(o - r)
            assert err.max() <= bound and np.median(err) <= 1e-5, (name, err.max(), np.median(err))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32-fold", "bf16-state"])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
@pytest.mark.parametrize("D,E", [(16, 7), (64, 17)])
@pytest.mark.parametrize("K", [8, 48])
def test_plain_matches_reference(dtype, depth_statistic, D, E, K):
    H, W = 12, 24
    jfs = _state(np.random.default_rng(D + E), 1, H, W, D, E, dtype)
    cfg = (JFieldConfig(dino_dims=E - 1), FieldConfig(dino_dims=E - 1))
    key = jax.random.PRNGKey(7)
    ref = jff.render_encode_view(jfs, cfg[0], H, W, key, n_coarse=K, depth_statistic=depth_statistic)
    u = _strata(key, H * W, K)
    out = ff.render_encode_view(_to_port(jfs), cfg[1], H, W, u=u, n_coarse=K, depth_statistic=depth_statistic)
    z = ff.encode_view_inputs(_to_port(jfs), cfg[1], H, W, u=u[None], n_coarse=K)[0][1]
    _check(out, ref, dtype, z, depth_statistic == "median")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32-fold", "bf16-state"])
@pytest.mark.parametrize("code_mode", ["z", "distance"])
@pytest.mark.parametrize("K", [8, 48])
def test_batched_plain_matches_reference(dtype, code_mode, K):
    H, W, B = 8, 16, 3
    jfs = _state(np.random.default_rng(5), B, H, W, 16, 9, dtype)
    cfg = (JFieldConfig(dino_dims=8, code_mode=code_mode), FieldConfig(dino_dims=8, code_mode=code_mode))
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    ref = jff.render_encode_view_batched(jfs, cfg[0], H, W, keys, n_coarse=K)
    u = torch.stack([_strata(k, H * W, K) for k in keys])
    reset_launches()
    out = ff.render_encode_view_batched(_to_port(jfs), cfg[1], H, W, u=u, n_coarse=K)
    assert launches()["encode_view"] == 0  # the CPU takes the plain version
    _check(out, ref, dtype)


# ------------------------------------------------------------ the kernel's walk
def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _tf32(x):
    """cvt.rna.tf32.f32: fp32 to 10 mantissa bits, to nearest, ties away from
    zero (on the magnitude's bits, so for either sign)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """x = hi + lo, each TF32: the kernel's 3xTF32 operands."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _wgmma(a, b, k_step, passes=None):
    """a (rows, k) @ b (k, n) as the kernel issues it: k in steps of `k_step`
    (bf16 k16, TF32 k8), each step's products exact and summed into the fp32
    accumulator. passes None: the operands as they are (bf16 values); 1: one
    TF32 pass; 3: the three passes lo hi, hi lo, hi hi of each step. (W2's
    rows are permuted within a TF32 step in the kernel; a step's sum is
    exact here, so the order inside it does not show.)"""
    if passes is None:
        terms = [(a, b)]
    elif passes == 1:
        terms = [(_tf32(a), _tf32(b))]
    else:
        (ah, al), (bh, bl) = _split(a), _split(b)
        terms = [(al, bh), (ah, bl), (ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], k_step):
        for x, y in terms:
            step = x[:, k0:k0 + k_step].astype(np.float64) @ y[k0:k0 + k_step].astype(np.float64)
            acc = (acc + step).astype(np.float32)
    return acc


def _butterfly(v):
    """The warp's xor-shuffle sum: every lane ends with the same total."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def _scan(v, op):
    """The warp's Hillis-Steele inclusive scan over the 32 lanes."""
    for o in (1, 2, 4, 8, 16):
        nxt = v.copy()
        nxt[:, o:] = op(v[:, o:], v[:, :-o])
        v = nxt
    return v


def _normalized_depth(dl, cfg):
    """The kernel's normalized depth of depths `dl` (fp32): x = 1 / max(dl,
    1e-3) under inv_z, else dl; then fma(x - zn_sub, zn_scale, -1) rounded
    once, the constants of `encoding.zn_constants` (jitted XLA's)."""
    f = np.float32
    sub, scale = encoding.zn_constants(cfg.z_near, cfg.z_far, cfg.inv_z)
    x = f(1) / np.maximum(dl, f(1e-3)) if cfg.inv_z else dl
    return encoding.fma32(torch.from_numpy(np.ascontiguousarray(x - f(sub), f)), scale, -1.0).numpy()

def emulate_kernel(base, z, zscale, w_z, w2, b2, color, cfg: EncodeViewConfig, bf16: bool, passes: int = 3):
    """csrc/encode_view.cu's walk in numpy fp32. The rays' samples padded with
    dead rows to Kp (the next of 8, 16, 32, 64) in 64-row tiles of 64 / Kp
    rays, the last tile's rays past N and the dead rows at depth 0 and base 0
    (the kernel's zeroed buffers); per row the z code (16 columns), its
    product with W_z and out = h W2 + b2 by `_wgmma` (bf16: code and h
    rounded to bf16, k16 steps; fp32: `passes` TF32 passes, k8 steps, with
    W_z and W2 zero-padded to 16 x 64 DC and 64 DC x (64 + 8 or 24)); then
    one warp a ray, two samples a lane: the product scan, the butterfly sums,
    the ballot median; each feature column summed over the ray's samples in
    order by one thread (fused multiply-adds)."""
    f = np.float32
    N, D = base.shape
    K, E, Cz = z.shape[1], w2.shape[1], w_z.shape[0]
    Kp = next(p for p in (8, 16, 32, 64) if K <= p)
    rpt = 64 // Kp
    tiles = -(-N // rpt)
    DP = 64 * -(-D // 64)
    EP = 24 if E <= 24 else 72
    # the tiles' rows: ray tile * rpt + row // Kp, sample row % Kp
    ray = np.arange(tiles * 64) // Kp
    k = np.arange(tiles * 64) % Kp
    live = (ray < N) & (k < K)
    rr = np.minimum(ray, N - 1)
    zrow = np.where(live, z[rr, np.minimum(k, K - 1)], f(0))
    brow = np.zeros((tiles * 64, DP), f)
    brow[ray < N, :D] = base[rr[ray < N]]
    zs = np.where(ray < N, zscale[rr], f(0))

    zn = _normalized_depth(zrow * zs, cfg)
    code = np.zeros((tiles * 64, 16), f)
    for c in range(Cz):
        if cfg.include_input and c == 0:
            code[:, c] = zn
        else:
            i = c - int(cfg.include_input)
            arg = zn * f(cfg.freq_factor * 2 ** (i // 2)) + (f(np.pi / 2) if i % 2 else f(0))
            code[:, c] = np.sin(arg.astype(np.float64)).astype(f)
    wz = np.zeros((16, DP), f)
    wz[:Cz, :D] = w_z
    w2p = np.zeros((DP, EP), f)
    w2p[:D, :E] = w2
    if bf16:
        acc = _wgmma(_bf16(code), wz, 16)
        h = _bf16(np.maximum(brow + acc, f(0)))
        out = _wgmma(h, w2p, 16)
    else:
        acc = _wgmma(code, wz, 8, passes)
        h = np.maximum(brow + acc, f(0))
        out = _wgmma(h, w2p, 8, passes)
    out = (out[:, :E] + b2).reshape(tiles * rpt, Kp, E)[:N]
    zk = zrow.reshape(tiles * rpt, Kp)[:N]

    # one warp a ray: sample 2 lane + t
    samp = np.arange(64)
    live = samp < K
    pad = lambda a, v: np.concatenate([a, np.full((N, 64 - Kp), v, f)], 1)  # noqa: E731
    x, zz = pad(out[..., 0], 0), pad(zk, 0)
    sigma = np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))
    delta = np.where(samp + 1 < K, zz[:, np.minimum(samp + 1, 63)] - zz, f(1e10))
    alpha = np.where(live, f(1) - np.exp(-np.abs(delta) * np.maximum(sigma, 0)), f(0))
    if cfg.hard_alpha_cap:
        alpha[:, K - 1] = 1.0
    fl = np.where(live, np.maximum(f(1) - alpha, f(1e-10)), f(1))
    incl = _scan(fl[:, 0::2] * fl[:, 1::2], np.multiply)
    excl = np.concatenate([np.ones((N, 1), f), incl[:, :-1]], 1)
    w = np.zeros((N, 64), f)
    w[:, 0::2] = alpha[:, 0::2] * excl
    w[:, 1::2] = alpha[:, 1::2] * (excl * fl[:, 0::2])
    pair = w[:, 0::2] + w[:, 1::2]
    total = _butterfly(pair)
    if cfg.depth_statistic == "median":
        den = np.maximum(total, f(1e-10))[:, None]
        cum = _scan(pair, np.add)
        before = np.concatenate([np.zeros((N, 1), f), cum[:, :-1]], 1)
        below = ((live[0::2] & ((before + w[:, 0::2]) / den < 0.5)).sum(1)
                 + (live[1::2] & (cum / den < 0.5)).sum(1))
        depth = zz[np.arange(N), np.minimum(below, K - 1)]
    else:
        depth = _butterfly(w[:, 0::2] * zz[:, 0::2] + w[:, 1::2] * zz[:, 1::2])
    dino = np.zeros((N, E - 1), f)
    for s in range(K):  # fmaf(w, out, sum): the product exact, one rounding
        dino = (w[:, s, None].astype(np.float64) * out[:, s, 1:] + dino).astype(f)
    return depth, dino, color * total[:, None]


def _walk_inputs(rng, N, K, D, E, bf16, w_scale):
    base = rng.normal(size=(N, D)).astype(np.float32)
    z = np.sort(rng.uniform(3, 80, size=(N, K)), -1).astype(np.float32)
    zscale = rng.uniform(0.8, 1.0, size=N).astype(np.float32)
    w_z = (rng.normal(size=(13, D)) * w_scale[0]).astype(np.float32)
    w2 = (rng.normal(size=(D, E)) * w_scale[1]).astype(np.float32)
    if bf16:
        w_z, w2 = _bf16(w_z), _bf16(w2)
    b2 = (rng.normal(size=E) * 0.2).astype(np.float32)
    b2[0] += 0.5
    color = rng.uniform(size=(N, 3)).astype(np.float32)
    return base, z, zscale, w_z, w2, b2, color


def _plain(args, cfg, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    base, z, zscale, w_z, w2, b2, color = map(torch.from_numpy, args)
    return encode_view_plain(base, z, zscale, w_z.to(dt), w2.to(dt), b2, color, cfg)


@pytest.mark.parametrize("K", [5, 12, 32, 48, 64])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_kernel_walk_matches_plain(K, bf16, depth_statistic):
    cfg = EncodeViewConfig(depth_statistic=depth_statistic)
    args = _walk_inputs(np.random.default_rng(K), 37, K, 16, 7, bf16, (0.3, 0.3))
    plain = _plain(args, cfg, bf16)
    emu = emulate_kernel(*args, cfg, bf16)
    for name, p, e in zip(("depth", "feature", "rgb"), plain, emu):
        if name == "depth" and depth_statistic == "median":
            np.testing.assert_array_equal(p.numpy(), e)
        else:
            np.testing.assert_allclose(p.numpy(), e, rtol=1e-5, atol=1e-4 if name == "depth" else 1e-5, err_msg=name)


def emulate_wide(base, z, zscale, w_z, w2, b2, color, cfg: EncodeViewConfig, bf16: bool):
    """The wide walk in numpy fp32 (compositing in torch, as the kernels'
    warps): per sample the z code at any width, zero-padded to whole code
    tiles of KW columns (bf16 64, TF32 32); per 64-unit hidden chunk c the
    code product over the code tiles (`_wgmma` over the tiles' k-steps in
    order: a unit's steps continue the chunk's accumulator), h = relu(base +
    acc) rounded to bf16 or kept fp32 (split into TF32 hi and lo by each
    product that loads it); per 64-column output chunk j the product over
    the hidden k-tiles, + b2, the density column's chunk first. Rays of K <=
    64 samples pack 64 / Kp to a tile, longer ones take one 64-sample
    segment a tile; `composite_tiles` composites them, and each chunk's
    feature columns are summed over a ray's samples in order (fused
    multiply-adds)."""
    from test_torch_point_render import composite_tiles

    f = np.float32
    N, D = base.shape
    K, E, Cz = z.shape[1], w2.shape[1], w_z.shape[0]
    KW, k_step, passes = (64, 16, None) if bf16 else (32, 8, 3)
    dc, ct, ec = -(-D // 64), -(-Cz // KW), -(-E // 64)
    zn = _normalized_depth(z * zscale[:, None], cfg).reshape(-1)
    code = np.zeros((N * K, KW * ct), f)
    for c in range(Cz):
        if cfg.include_input and c == 0:
            code[:, c] = zn
        else:
            i = c - int(cfg.include_input)
            arg = zn * f(cfg.freq_factor * 2 ** (i // 2)) + (f(np.pi / 2) if i % 2 else f(0))
            code[:, c] = np.sin(arg.astype(np.float64)).astype(f)
    if bf16:
        code = _bf16(code)
    wz = np.zeros((KW * ct, 64 * dc), f)
    wz[:Cz, :D] = w_z
    brow = np.zeros((N * K, 64 * dc), f)
    brow[:, :D] = np.repeat(base, K, 0)
    h = np.zeros((N * K, 64 * dc), f)
    for c in range(dc):
        n = slice(64 * c, 64 * c + 64)
        hc = np.maximum(brow[:, n] + _wgmma(code, wz[:, n], k_step, passes), f(0))
        h[:, n] = _bf16(hc) if bf16 else hc
    w2p = np.zeros((64 * dc, 64 * ec), f)
    w2p[:D, :E] = w2
    b2p = np.zeros(64 * ec, f)
    b2p[:E] = b2
    chunks = [(_wgmma(h, w2p[:, 64 * j:64 * j + 64], k_step, passes) + b2p[64 * j:64 * j + 64]).reshape(N, K, 64)
              for j in range(ec)]
    w, depth = composite_tiles(torch.from_numpy(chunks[0][..., 0]), torch.from_numpy(z), cfg.hard_alpha_cap,
                               cfg.depth_statistic == "median")  # the density column, before its softplus
    w = w.numpy()
    dino = np.zeros((N, 64 * ec), f)
    for j, o in enumerate(chunks):
        for s in range(K):
            dino[:, 64 * j:64 * j + 64] = (w[:, s, None].astype(np.float64) * o[:, s]
                                           + dino[:, 64 * j:64 * j + 64]).astype(f)
    return depth.numpy(), dino[:, 1:E], color * w.sum(-1)[:, None]


@pytest.mark.parametrize("K,D,E,num_freqs,bf16", [(32, 136, 129, 6, False), (32, 136, 129, 6, True),
                                                  (12, 512, 769, 16, True), (320, 136, 769, 8, False),
                                                  (48, 512, 129, 6, False)])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_wide_walk_matches_plain(K, D, E, num_freqs, bf16, depth_statistic):
    """The fp32 state to 1e-5 relative (1e-4 m in depth), the median's sample
    exactly; the bf16 state to the card's bf16 bounds (depth 5e-2 m, feature
    5e-3 times its largest magnitude where that exceeds 1, colour 5e-3; the
    median the plain version's sample on all but 2 % of rays): at these
    widths an h the two sum in other orders can round to the other bf16
    neighbour."""
    cfg = EncodeViewConfig(num_freqs=num_freqs, depth_statistic=depth_statistic)
    rng = np.random.default_rng(K + D + E)
    N = 9 if K > 64 else 37
    args = list(_walk_inputs(rng, N, K, D, E, bf16, (0.3, D ** -0.5)))
    args[3] = (rng.normal(size=(cfg.code_dims, D)) * 0.3).astype(np.float32)
    if bf16:
        args[3] = _bf16(args[3])
    plain = _plain(args, cfg, bf16)
    emu = emulate_wide(*args, cfg, bf16)
    for name, p, e in zip(("depth", "feature", "rgb"), plain, emu):
        p = p.numpy()
        if name == "depth" and depth_statistic == "median":
            assert np.mean(p != e) <= (0.02 if bf16 else 0.0)
        elif bf16:
            bound = {"depth": 5e-2, "feature": 5e-3 * max(1.0, float(np.abs(p).max())), "rgb": 5e-3}[name]
            assert np.abs(p - e).max() <= bound, name
        else:
            np.testing.assert_allclose(p, e, rtol=1e-5, atol=1e-4 if name == "depth" else 1e-5, err_msg=name)


def test_three_tf32_passes_hold_the_fp32_bounds_where_one_does_not():
    """The fp32 state at d_hidden 128, d_out 65 with the seeded state's weight
    scales (W_code x 39^-0.5, W2 x 128^-0.5; tools/bench_encode_view.py):
    the kernel's three TF32 passes stay within the fp32 state's bounds of the
    plain version (depth 1e-3 m, feature and colour 1e-4:
    bench_encode_view.TOL, tests/test_torch_kernels.py), one pass does not."""
    from scenedino_torch.tools.bench_encode_view import TOL

    cfg = EncodeViewConfig()
    args = _walk_inputs(np.random.default_rng(3), 64, 32, 128, 65, False, (39 ** -0.5, 128 ** -0.5))
    plain = [t.numpy() for t in _plain(args, cfg, False)]
    tol = TOL[torch.float32]

    def errors(passes):
        emu = emulate_kernel(*args, cfg, False, passes)
        return {name: float(np.abs(p - e).max()) for name, p, e in zip(tol, plain, emu)}

    three, one = errors(3), errors(1)
    assert all(three[name] <= tol[name] / 10 for name in tol), three
    assert any(one[name] > tol[name] for name in tol), one


def test_wrapper_refuses_what_the_function_does_not_take():
    cfg = EncodeViewConfig()
    args = [torch.randn(3, 8), torch.rand(3, 4) * 10 + 3, torch.ones(3), torch.randn(13, 8), torch.randn(8, 5),
            torch.zeros(5), torch.rand(3, 3)]
    encode_view(*args, cfg)
    for i, bad in ((1, torch.rand(2, 4)), (2, torch.ones(4)), (3, torch.randn(39, 8)), (4, torch.randn(7, 5)),
                   (5, torch.zeros(4)), (6, torch.rand(3, 4))):
        with pytest.raises(ValueError, match="encode_view"):
            encode_view(*args[:i], bad, *args[i + 1:], cfg)
    with pytest.raises(ValueError, match="dtype"):
        encode_view(*args[:3], args[3].to(torch.bfloat16), *args[4:], cfg)
    with pytest.raises(ValueError, match="density"):
        encode_view(*args[:4], torch.randn(8, 1), torch.zeros(1), args[6], cfg)
    with pytest.raises(ValueError, match="depth_statistic"):
        encode_view(*args, EncodeViewConfig(depth_statistic="Median"))
    with pytest.raises(ValueError, match="u must be"):
        fs = _to_port(_state(np.random.default_rng(0), 1, 4, 8, 8, 5, jnp.float32))
        ff.render_encode_view(fs, FieldConfig(dino_dims=4), 4, 8, u=torch.rand(32, 3), n_coarse=4)
