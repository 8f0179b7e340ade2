"""A CPU emulation of the point kernels' tile walk (`csrc/point_render.cu`:
K2 `point_render`, K3 `probe_weights`, K4 `point_query`), held against
their plain versions and the JAX package's compositing.

What the emulation follows, as the kernel does it:
  * the hidden units in the kernel's order: a thread of lane q holds the
    accumulator columns n = 64c + 8j + 2q + t, filled by its corner loads of
    grid channels [q 16C + 16c + 8G, + 8) (C = 1 or 2 chunks of 64); the
    weights are copied in under pi = `hidden_channel`; the two derivations
    must agree, and h and the head output must equal the plain version's
    exactly on dyadic inputs (no rounding anywhere), for D in {8, 16, 64, 128};
  * h = bf16(relu((g + code W_code) + b1)), the reference's order of
    additions (scenedino_tpu/ops/fast_field.py:900-912), which differs from
    g + (code W_code + b1) in fp32;
  * 64-row tiles of 64 // K rays, the rows past them dead (K = 12 packs 5
    rays and 4 dead rows; their values are NaN here and must not leak); one
    warp a ray, two samples a lane: the transmittance as a Hillis-Steele
    product scan over the lanes' pairs, E[z] and the weight total as
    butterfly sums, the median's CDF as a scanned sum and its index as a
    count of ballots. Against `composite_rays` / `weight_median_depth` of
    both packages: weights and E[z] to rtol 1e-5 (fp32 products and sums in
    another order), the median exactly;
  * a ray of K > 64 samples (K = 100, 128, 256: two to four tiles) walked
    tile by tile: each tile one warp from the transmittance the ray's
    earlier tiles left (a tile's last delta reads the next tile's first
    depth), E[z] and the weight total added tile by tile, the rows past K
    dead; the median from the ray's stored weights, 64 at a time, the CDF
    carried from chunk to chunk. Held as the one-tile walk is;
  * the whole walk against `point_render_plain` / `probe_weights_plain` /
    `point_query_plain`, within chip_smoke.py's K2-K4 bounds (the
    emulation's code product is summed in another order than the plain
    one, so an h may round to the other bf16 neighbour);
  * the wide walk (csrc/wide_walk.cuh), which runs every shape the shipped
    instantiations do not take: the same permutation at any count DC of
    hidden chunks, the lanes' corner loads element by element past D (a D
    that is not a multiple of 8 loads every channel once), the code padded
    to whole tiles of 64 columns; h formed chunk by chunk, each chunk's code
    product summed unit by unit over the code tiles and rounded where the
    kernel rounds it (bf16(relu((g + acc) + b1))); then the output columns
    in streamed chunks of 64, the density column's chunk first (its weights
    composite the ray before any feature chunk is summed). Exactly the plain
    head on dyadic inputs at D 132, 136 and 512; the whole walk within the
    K2-K4 bounds at D 136 and 512, E 129 and 769, 99 code columns, 320
    samples a ray.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.core.compositing as jcomp
from scenedino_torch.core import cameras, compositing, encoding
from scenedino_torch.core import rays as rays_mod
from scenedino_torch.core.sampling import sample_coarse

pr = importlib.import_module("scenedino_torch.kernels.point_render")  # the package exports the wrapper by this name

TP = 64
K2_DEPTH_TOL, K2_FEAT_TOL, K2_RGB_TOL, K3_TOL, K4_TOL = 5e-2, 5e-3, 5e-3, 5e-3, 1e-2


def hidden_channel(n, dc):
    """pi: the grid channel that the kernel's hidden unit n stands for."""
    c, j, q, t = n // 64, (n % 64) // 8, (n % 8) // 2, n % 2
    return q * 16 * dc + 16 * c + 2 * j + t


def lane_columns(D):
    """The kernel's column of every grid channel, from its loads: lane q,
    chunk c, group G of 8 channels (loaded only where base + 8 <= D), channel
    base + i lands in register 4 j + 2 hi + t with j = 4 G + i // 2, t = i % 2,
    i.e. column 64 c + 8 j + 2 q + t."""
    dc = 1 if D <= 64 else 2
    cols = {}
    for q in range(4):
        for c in range(dc):
            for G in range(2):
                base = q * 16 * dc + 16 * c + 8 * G
                if base + 8 > D:
                    continue
                for i in range(8):
                    cols[base + i] = 64 * c + 8 * (4 * G + i // 2) + 2 * q + i % 2
    return dc, cols


def kernel_weights(w_code, b1, w2, D):
    """W_code (64 code columns x DP), b1 (DP) and W2 (DP x E) in the kernel's hidden order, zero-padded."""
    dc = 1 if D <= 64 else 2
    dp = 64 * dc
    ch = torch.tensor([hidden_channel(n, dc) for n in range(dp)])
    live = ch < D
    wc = torch.zeros(64, dp)
    wc[:w_code.shape[0], live] = w_code.float()[:, ch[live]]
    b1p = torch.zeros(dp)
    b1p[live] = b1.float()[ch[live]]
    w2p = torch.zeros(dp, w2.shape[1])
    w2p[live] = w2.float()[ch[live]]
    return dc, ch, live, wc, b1p, w2p


def kernel_head(code, g, w_code, b1, w2, b2, D):
    """The kernel's two products on rows of code (P, C) and blended rows g
    (P, D): g lands in the kernel's columns as the lanes load it."""
    dc, ch, live, wc, b1p, w2p = kernel_weights(w_code, b1, w2, D)
    _, cols = lane_columns(D)
    gk = torch.zeros(g.shape[0], 64 * dc)
    for channel, n in cols.items():
        gk[:, n] = g[:, channel]
    code64 = torch.zeros(code.shape[0], 64)
    code64[:, :code.shape[1]] = code.float()
    h = torch.relu((gk + code64 @ wc) + b1p).to(torch.bfloat16)
    return h, h.float() @ w2p + b2.float()


@pytest.mark.parametrize("D", [8, 16, 64, 128])
def test_hidden_permutation_gives_the_plain_head_exactly(D):
    dc, cols = lane_columns(D)
    assert sorted(cols) == list(range(D))  # every channel loaded once
    assert all(hidden_channel(n, dc) == channel for channel, n in cols.items())
    rng = np.random.default_rng(D)
    P, C, E = 70, 39, 65

    def dyadic(*shape, scale):  # small multiples of 2^-k: every product and sum below is exact in fp32
        return torch.from_numpy(rng.integers(-3, 4, size=shape).astype(np.float32) * scale)

    code = dyadic(P, C, scale=0.25).to(torch.bfloat16)
    g, w_code, b1 = dyadic(P, D, scale=1 / 16), dyadic(C, D, scale=1 / 8).to(torch.bfloat16), dyadic(D, scale=1 / 4)
    w2, b2 = dyadic(D, E, scale=1 / 8).to(torch.bfloat16), dyadic(E, scale=1 / 2)
    h_ref = torch.relu(g + code.float() @ w_code.float() + b1).to(torch.bfloat16)
    out_ref = h_ref.float() @ w2.float() + b2
    h, out = kernel_head(code, g, w_code, b1, w2, b2, D)
    _, ch, live, *_ = kernel_weights(w_code, b1, w2, D)
    assert torch.equal(h[:, live], h_ref[:, ch[live]]) and not h[:, ~live].float().any()
    assert torch.equal(out, out_ref)


def test_order_of_the_first_layers_additions():
    """(g + code W_code) + b1, as the reference sums it: on values where
    fp32 rounding tells the orders apart, the kernel's order gives the
    plain version's (and the reference's) h, the other order does not."""
    import jax

    g, acc, b1 = np.float32(1e8), np.float32(-1e8), np.float32(1.5)
    ref = jax.nn.relu((jnp.float32(g) + jnp.float32(acc)) + jnp.float32(b1))  # fast_field.py:900-912's order
    assert float(ref) == 1.5
    assert float(torch.relu((torch.tensor(g) + torch.tensor(acc)) + torch.tensor(b1))) == float(ref)
    assert float(torch.relu(torch.tensor(g) + (torch.tensor(acc) + torch.tensor(b1)))) != float(ref)
    # and the plain version's h is exactly the kernel emulation's on such a row
    code = torch.zeros(1, 39, dtype=torch.bfloat16)
    code[0, 0] = 1.0
    w_code = torch.zeros(39, 8, dtype=torch.bfloat16)
    w_code[0] = -2.0 ** 26  # code W_code = -2^26 in every column
    gv = torch.full((1, 8), 2.0 ** 26)
    b1v = torch.full((8,), 1.5)
    h, _ = kernel_head(code, gv, w_code, b1v, torch.eye(8, dtype=torch.bfloat16), torch.zeros(8), 8)
    _, ch, live, *_ = kernel_weights(w_code, b1v, torch.eye(8), 8)
    assert torch.equal(h[:, live].float(), torch.full((1, 8), 1.5))


# ---------------------------------------------------------------- the warp's compositing


def _scan(x, op):
    """Hillis-Steele inclusive scan over the 32 lanes (last axis), as the
    kernel's shuffle-up rounds: lane l combines with lane l - o for o = 1 .. 16."""
    for o in (1, 2, 4, 8, 16):
        shifted = torch.cat([torch.ones_like(x[..., :o]), x[..., :-o]], -1)
        x = torch.where(torch.arange(32) >= o, op(x, shifted), x)
    return x


def _butterfly(x):
    """The kernel's xor-shuffle sum: every lane ends with the same total."""
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., torch.arange(32) ^ o]
    return x


def warp_composite(sigma, z, hard_cap, median):
    """One warp a ray (rows (n, K) of pre-softplus sigma and z), two samples a
    lane. Returns the weights (n, K) and the depth (n,)."""
    n, K = z.shape
    k = torch.arange(64)
    pad = lambda t, v: torch.cat([t, torch.full((n, 64 - K), v)], -1)  # noqa: E731
    s = pr._softplus(pad(sigma, 0.0))
    zz = pad(z, 0.0)
    znext = torch.cat([zz[:, 1:], torch.zeros(n, 1)], -1)
    delta = torch.where(k + 1 < K, znext - zz, torch.tensor(1e10))
    alpha = 1.0 - torch.exp(-torch.abs(delta) * torch.clamp_min(s, 0.0))
    if hard_cap:
        alpha = torch.where(k == K - 1, torch.tensor(1.0), alpha)
    alpha = torch.where(k < K, alpha, torch.tensor(0.0))
    f = torch.where(k < K, torch.clamp_min(1.0 - alpha, 1e-10), torch.tensor(1.0))
    f2, a2, z2 = f.reshape(n, 32, 2), alpha.reshape(n, 32, 2), zz.reshape(n, 32, 2)
    incl = _scan(f2[..., 0] * f2[..., 1], torch.mul)
    excl = torch.cat([torch.ones(n, 1), incl[:, :-1]], -1)
    w = torch.stack([a2[..., 0] * excl, a2[..., 1] * (excl * f2[..., 0])], -1)  # (n, 32, 2)
    weights = w.reshape(n, 64)[:, :K]
    if not median:
        return weights, _butterfly(w[..., 0] * z2[..., 0] + w[..., 1] * z2[..., 1])[:, 0]
    den = torch.clamp_min(_butterfly(w[..., 0] + w[..., 1])[:, :1], 1e-10)
    cum = _scan(w[..., 0] + w[..., 1], torch.add)
    before = torch.cat([torch.zeros(n, 1), cum[:, :-1]], -1)
    k0 = 2 * torch.arange(32)
    below = ((k0 < K) & ((before + w[..., 0]) / den < 0.5)).sum(-1) + ((k0 + 1 < K) & (cum / den < 0.5)).sum(-1)
    at = torch.clamp_max(below, K - 1)
    return weights, z.gather(1, at[:, None])[:, 0]


def warp_composite_segments(sigma, z, hard_cap, median):
    """Rays (n, K) of K > 64 samples as the kernel walks them: 64-sample
    tiles, each one warp as in `warp_composite` from the carried
    transmittance. Returns the weights (n, K) and the depth (n,)."""
    n, K = z.shape
    trans, depth, total, weights = torch.ones(n), torch.zeros(n), torch.zeros(n), []
    for k0 in range(0, K, TP):
        k = k0 + torch.arange(TP)
        live = k < K
        at = k.clamp(max=K - 1)  # dead rows repeat the last sample
        s = pr._softplus(sigma[:, at])
        zz, znext = z[:, at], z[:, (k + 1).clamp(max=K - 1)]  # past the tile: the next tile's first depth
        delta = torch.where(k + 1 < K, znext - zz, torch.tensor(1e10))
        alpha = 1.0 - torch.exp(-torch.abs(delta) * torch.clamp_min(s, 0.0))
        if hard_cap:
            alpha = torch.where(k == K - 1, torch.tensor(1.0), alpha)
        alpha = torch.where(live, alpha, torch.tensor(0.0))
        f = torch.where(live, torch.clamp_min(1.0 - alpha, 1e-10), torch.tensor(1.0))
        f2, a2, z2 = f.reshape(n, 32, 2), alpha.reshape(n, 32, 2), zz.reshape(n, 32, 2)
        incl = _scan(f2[..., 0] * f2[..., 1], torch.mul)
        excl = torch.cat([torch.ones(n, 1), incl[:, :-1]], -1) * trans[:, None]
        w = torch.stack([a2[..., 0] * excl, a2[..., 1] * (excl * f2[..., 0])], -1)  # (n, 32, 2)
        depth = depth + _butterfly(w[..., 0] * z2[..., 0] + w[..., 1] * z2[..., 1])[:, 0]
        total = total + _butterfly(w[..., 0] + w[..., 1])[:, 0]
        trans = trans * incl[:, 31]
        weights.append(w.reshape(n, TP))
    padded = torch.cat(weights, -1)
    if not median:
        return padded[:, :K], depth
    den = torch.clamp_min(total, 1e-10)[:, None]
    count, base = torch.zeros(n, dtype=torch.long), torch.zeros(n)
    for c0 in range(0, K, TP):
        kc = c0 + 2 * torch.arange(32)
        v0, v1 = padded[:, kc], padded[:, kc + 1]
        cum = _scan(v0 + v1, torch.add) + base[:, None]
        before = torch.cat([base[:, None], cum[:, :-1]], -1)
        count += ((kc < K) & ((before + v0) / den < 0.5)).sum(-1) + ((kc + 1 < K) & (cum / den < 0.5)).sum(-1)
        base = cum[:, 31]
    return padded[:, :K], z.gather(1, torch.clamp_max(count, K - 1)[:, None])[:, 0]


def tiles_of(values, K, fill=float("nan")):
    """Rays (R, K) packed as the kernel packs them: 64-row tiles of 64 // K
    rays, rows past them (and past the last ray) `fill`. Returns (T, 64)."""
    R = values.shape[0]
    rpt = TP // K
    T = -(-R // rpt)
    out = torch.full((T, TP), fill)
    for t in range(T):
        rays = values[t * rpt:(t + 1) * rpt]
        out[t, :rays.numel()] = rays.reshape(-1)
    return out


def composite_tiles(sigma, z, hard_cap, median):
    """The walk over the packed tiles: each tile's rays read their own rows
    only; a ray of more than 64 samples over its own tiles."""
    R, K = z.shape
    if K > TP:
        return warp_composite_segments(sigma, z, hard_cap, median)
    rpt = TP // K
    st, zt = tiles_of(sigma, K), tiles_of(z, K)
    weights, depth = [], []
    for t in range(st.shape[0]):
        n = min(rpt, R - t * rpt)
        rows = torch.arange(n)[:, None] * K + torch.arange(K)
        wt, dt = warp_composite(st[t][rows], zt[t][rows], hard_cap, median)
        weights.append(wt)
        depth.append(dt)
    return torch.cat(weights), torch.cat(depth)


@pytest.mark.parametrize("K", [7, 12, 32, 48, 64, 100, 128, 256])
@pytest.mark.parametrize("hard_cap", [True, False])
def test_warp_compositing_matches_both_packages(K, hard_cap):
    rng = np.random.default_rng(K + 100 * hard_cap)
    R = 3 * max(TP // K, 1) + 2  # a ragged last tile
    z = np.sort(rng.uniform(3.0, 80.0, size=(R, K)), -1).astype(np.float32)
    sigma = (rng.normal(size=(R, K)) * 2.0 - 1.0).astype(np.float32)
    sigma[0] = 50.0  # saturated alphas: the 1e-10 floor
    sigma[1] = -30.0  # empty ray: the weights all but vanish
    zt, st = torch.from_numpy(z), torch.from_numpy(sigma)
    for median in (False, True):
        stat = "median" if median else "expectation"
        w, d = composite_tiles(st, zt, hard_cap, median)
        port = compositing.composite_rays(pr._softplus(st), zt, hard_cap, stat)
        ref = jcomp.composite_rays(np.asarray(pr._softplus(st)), jnp.asarray(z), hard_cap, stat)
        assert torch.isfinite(w).all() and torch.isfinite(d).all()
        np.testing.assert_allclose(w.numpy(), np.asarray(ref.weights), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(w.numpy(), port.weights.numpy(), rtol=1e-5, atol=1e-7)
        if median:
            np.testing.assert_array_equal(d.numpy(), np.asarray(ref.depth))
            np.testing.assert_array_equal(
                d.numpy(), np.asarray(jcomp.weight_median_depth(jnp.asarray(w.numpy()), jnp.asarray(z))))
        else:
            np.testing.assert_allclose(d.numpy(), np.asarray(ref.depth), rtol=1e-5)
        np.testing.assert_allclose(d.numpy(), port.depth.numpy(), rtol=1e-5)


def test_dead_rows_of_a_tile_are_not_read():
    """K = 12: 5 rays and 4 dead rows a tile; NaN in the dead rows leaves
    every ray finite, and a value moved into a dead row changes nothing."""
    st, zt = torch.randn(11, 12), torch.sort(torch.rand(11, 12) * 77 + 3, -1).values
    assert tiles_of(st, 12).isnan()[:, 60:].all()
    w, d = composite_tiles(st, zt, True, False)
    assert torch.isfinite(w).all() and torch.isfinite(d).all() and w.shape == (11, 12)


# ---------------------------------------------------------------- the whole walk


def _inputs(K, D, E, cfg, seed, H=12, W=20):
    g = torch.Generator().manual_seed(seed)
    kmat = torch.tensor([[0.7, 0.0, 0.02], [0.0, 2.3, -0.05], [0.0, 0.0, 1.0]])
    wide = torch.tensor([[0.4, 0.0, 0.0], [0.0, 1.2, 0.0], [0.0, 0.0, 1.0]])  # leaves the encode view
    c, s = np.cos(0.1), np.sin(0.1)
    pose = torch.tensor([[c, 0, s, 0.5], [0, 1, 0, -0.2], [-s, 0, c, 0.3], [0, 0, 0, 1]], dtype=torch.float32)
    r, _ = rays_mod.rays_from_k(pose[None], wide[None], W, H, cfg.z_near, cfg.z_far)
    flat = r.reshape(-1, 8).contiguous()
    z = sample_coarse(flat, K, generator=g).contiguous()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    C = cfg.code_dims
    return (flat, z, randn(2 * H, 2 * W, D).to(torch.bfloat16), randn(C, D, scale=C ** -0.5).to(torch.bfloat16),
            randn(D, scale=0.1), randn(D, E, scale=D ** -0.5).to(torch.bfloat16), randn(E, scale=0.3),
            torch.eye(4), kmat, torch.rand(H, W, 3, generator=g).to(torch.bfloat16), torch.eye(4), kmat)


def walk_points(pts, grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg):
    """Each point's head output (P, E) as the kernel forms it: the set-up
    (projection, bf16 code, corners and weights), the lanes' blended rows in
    the kernel's columns, both products under pi."""
    Hg, Wg, D = grid.shape
    xy, zc, cam = cameras.project(pts, feat_w2c, feat_k)
    depth_like = zc if cfg.code_mode == "z" else torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    zn = encoding.normalize_z(depth_like, cfg.z_near, cfg.z_far, inv_z=cfg.inv_z)
    code = encoding.positional_encoding(torch.cat([xy, zn], -1), cfg.num_freqs, cfg.freq_factor,
                                        cfg.include_input).to(torch.bfloat16)
    g = pr._sample_grid(grid, pr._to_pixel(xy[:, 0], Wg), pr._to_pixel(xy[:, 1], Hg))
    return kernel_head(code, g, w_code, b1, w2, b2, D)[1]


@pytest.mark.parametrize("K,D,E", [(7, 8, 2), (12, 128, 65), (32, 64, 17), (48, 16, 9), (64, 128, 65),
                                   (100, 16, 9), (128, 64, 17), (256, 128, 65)])
def test_walk_matches_the_plain_kernels(K, D, E):
    cfg = pr.PointRenderConfig(num_freqs=4, include_input=False, code_mode="distance") if D == 8 \
        else pr.PointRenderConfig()
    args = _inputs(K, D, E, cfg, seed=K + D)
    rays, z = args[0], args[1]
    R = z.shape[0]
    out = walk_points(pr._ray_points(rays, z), *args[2:9], cfg)  # (R K, E)
    for median in (False, True):
        mcfg = pr.PointRenderConfig(**{**cfg.__dict__, "depth_statistic": "median" if median else "expectation"})
        w, depth = composite_tiles(out[:, 0].reshape(R, K), z, cfg.hard_alpha_cap, median)
        feat = torch.stack([(w[:, k, None] * out.reshape(R, K, E)[:, k, 1:]) for k in range(K)]).sum(0)
        ref = pr.point_render_plain(*args, mcfg)
        if median:
            assert (depth != ref[0]).float().mean().item() <= 0.02  # a flip of h may move a near tie
        else:
            assert (depth - ref[0]).abs().max().item() <= K2_DEPTH_TOL
        assert (feat - ref[1]).abs().max().item() <= K2_FEAT_TOL
    probe = pr.probe_weights_plain(*args[:5], args[5][:, :1].contiguous(), args[6][:1].contiguous(), *args[7:9], cfg)
    assert (w - probe).abs().max().item() <= K3_TOL
    pts = pr._ray_points(rays, z)[:1000]
    sigma, qfeat = pr.point_query_plain(pts, *args[2:9], cfg)
    q_out = walk_points(pts, *args[2:9], cfg)
    assert (pr._softplus(q_out[:, 0]) - sigma).abs().max().item() <= K4_TOL
    assert (q_out[:, 1:] - qfeat).abs().max().item() <= K4_TOL


# ---------------------------------------------------------------- the wide walk


def wide_lane_columns(D):
    """The wide walk's column of every grid channel, from its loads: lane q,
    chunk c of DC, group G of 8 channels, channel base + i loaded where it is
    below D (element by element past D), in column 64 c + 8 (4 G + i // 2) +
    2 q + i % 2."""
    dc = -(-D // 64)
    cols = {}
    for q in range(4):
        for c in range(dc):
            for G in range(2):
                base = q * 16 * dc + 16 * c + 8 * G
                for i in range(8):
                    if base + i < D:
                        cols[base + i] = 64 * c + 8 * (4 * G + i // 2) + 2 * q + i % 2
    return dc, cols


def wide_kernel_head(code, g, w_code, b1, w2, b2, D):
    """The wide walk's two products on rows of code (P, C) and blended rows g
    (P, D): the weights packed under pi into units of 64 x 64, h formed one
    64-unit chunk at a time from the code product summed unit by unit over
    the code tiles, rounded to bf16; the output in chunks of 64 columns over
    the hidden k-tiles, the density column's chunk first. Returns h (P, 64
    DC) in the kernel's hidden order and the output chunks, in order."""
    dc, cols = wide_lane_columns(D)
    dp = 64 * dc
    ch = torch.tensor([hidden_channel(n, dc) for n in range(dp)])
    live = ch < D
    P, C = code.shape
    ct, ec = -(-C // 64), -(-w2.shape[1] // 64)
    gk = torch.zeros(P, dp)
    gk[:, torch.tensor(list(cols.values()))] = g[:, torch.tensor(list(cols))]
    code_p = torch.zeros(P, 64 * ct)
    code_p[:, :C] = code.float()
    wc = torch.zeros(64 * ct, dp)
    wc[:C, live] = w_code.float()[:, ch[live]]
    b1p = torch.zeros(dp)
    b1p[live] = b1.float()[ch[live]]
    w2p = torch.zeros(dp, 64 * ec)
    w2p[live, :w2.shape[1]] = w2.float()[ch[live]]
    b2p = torch.zeros(64 * ec)
    b2p[:b2.shape[0]] = b2.float()
    h = []
    for c in range(dc):
        n = slice(64 * c, 64 * c + 64)
        acc = torch.zeros(P, 64)
        for s in range(ct):  # one unit of the ring: code tile s of hidden chunk c
            acc = acc + code_p[:, 64 * s:64 * s + 64] @ wc[64 * s:64 * s + 64, n]
        h.append(torch.relu((gk[:, n] + acc) + b1p[n]).to(torch.bfloat16))
    h = torch.cat(h, 1)
    chunks = []
    for j in range(ec):
        e = slice(64 * j, 64 * j + 64)
        o = torch.zeros(P, 64)
        for kt in range(dc):  # one unit: output chunk j over hidden k-tile kt
            o = o + h[:, 64 * kt:64 * kt + 64].float() @ w2p[64 * kt:64 * kt + 64, e]
        chunks.append(o + b2p[e])
    return h, chunks


@pytest.mark.parametrize("D,E,C", [(132, 129, 69), (136, 769, 99), (512, 129, 39), (512, 769, 99)])
def test_wide_walk_gives_the_plain_head_exactly(D, E, C):
    """At any DC the lanes load every channel once and pi names it; on
    dyadic inputs (no rounding anywhere) the wide walk's h and output equal
    the plain version's exactly."""
    dc, cols = wide_lane_columns(D)
    assert sorted(cols) == list(range(D))
    assert all(hidden_channel(n, dc) == channel for channel, n in cols.items())
    rng = np.random.default_rng(D + E)
    P = 70

    def dyadic(*shape, scale):
        return torch.from_numpy(rng.integers(-3, 4, size=shape).astype(np.float32) * scale)

    code = dyadic(P, C, scale=0.25).to(torch.bfloat16)
    g, w_code, b1 = dyadic(P, D, scale=1 / 16), dyadic(C, D, scale=1 / 8).to(torch.bfloat16), dyadic(D, scale=1 / 4)
    w2, b2 = dyadic(D, E, scale=1 / 8).to(torch.bfloat16), dyadic(E, scale=1 / 2)
    h_ref = torch.relu(g + code.float() @ w_code.float() + b1).to(torch.bfloat16)
    out_ref = h_ref.float() @ w2.float() + b2
    h, chunks = wide_kernel_head(code, g, w_code, b1, w2, b2, D)
    ch = torch.tensor([hidden_channel(n, dc) for n in range(64 * dc)])
    live = ch < D
    assert torch.equal(h[:, live], h_ref[:, ch[live]]) and not h[:, ~live].float().any()
    out = torch.cat(chunks, 1)
    assert torch.equal(out[:, :E], out_ref) and not out[:, E:].any()


def wide_walk_points(pts, grid, w_code, b1, w2, b2, feat_w2c, feat_k, cfg):
    """Each point's output chunks as the wide walk forms them (`walk_points`'s set-up)."""
    Hg, Wg, D = grid.shape
    xy, zc, cam = cameras.project(pts, feat_w2c, feat_k)
    depth_like = zc if cfg.code_mode == "z" else torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    zn = encoding.normalize_z(depth_like, cfg.z_near, cfg.z_far, inv_z=cfg.inv_z)
    code = encoding.positional_encoding(torch.cat([xy, zn], -1), cfg.num_freqs, cfg.freq_factor,
                                        cfg.include_input).to(torch.bfloat16)
    g = pr._sample_grid(grid, pr._to_pixel(xy[:, 0], Wg), pr._to_pixel(xy[:, 1], Hg))
    return wide_kernel_head(code, g, w_code, b1, w2, b2, D)[1]


@pytest.mark.parametrize("K,D,E,num_freqs", [(12, 136, 129, 6), (32, 512, 769, 16), (100, 136, 769, 11),
                                             (320, 512, 129, 6)])
def test_wide_walk_matches_the_plain_kernels(K, D, E, num_freqs):
    """K2: the density column's chunk composites the rays (the one-tile or
    the multi-tile walk's warps), then each chunk's feature columns are
    summed with those weights; K3 the weights alone; K4 each point's chunks;
    against the plain versions with chip_smoke.py's bounds (K4's over each
    point's largest output, at least 1, as phase 3c holds it)."""
    cfg = pr.PointRenderConfig(num_freqs=num_freqs)
    hw = (4, 8) if K > 256 else (12, 20)
    args = _inputs(K, D, E, cfg, seed=K + D + E, H=hw[0], W=hw[1])
    rays, z = args[0], args[1]
    R = z.shape[0]
    chunks = wide_walk_points(pr._ray_points(rays, z), *args[2:9], cfg)
    for median in (False, True):
        mcfg = pr.PointRenderConfig(**{**cfg.__dict__, "depth_statistic": "median" if median else "expectation"})
        w, depth = composite_tiles(chunks[0][:, 0].reshape(R, K), z, cfg.hard_alpha_cap, median)
        feat = torch.cat([torch.stack([w[:, k, None] * o.reshape(R, K, 64)[:, k] for k in range(K)]).sum(0)
                          for o in chunks], 1)[:, 1:E]
        ref = pr.point_render_plain(*args, mcfg)
        if median:
            assert (depth != ref[0]).float().mean().item() <= 0.02
        else:
            assert (depth - ref[0]).abs().max().item() <= K2_DEPTH_TOL
        assert (feat - ref[1]).abs().max().item() <= K2_FEAT_TOL
    probe = pr.probe_weights_plain(*args[:5], args[5][:, :1].contiguous(), args[6][:1].contiguous(), *args[7:9], cfg)
    assert (w - probe).abs().max().item() <= K3_TOL
    pts = pr._ray_points(rays, z)[:1000]
    sigma, qfeat = pr.point_query_plain(pts, *args[2:9], cfg)
    q_out = torch.cat(wide_walk_points(pts, *args[2:9], cfg), 1)
    d = torch.maximum((pr._softplus(q_out[:, 0]) - sigma).abs(), (q_out[:, 1:E] - qfeat).abs().amax(-1))
    assert (d / torch.clamp_min(torch.maximum(sigma, qfeat.abs().amax(-1)), 1.0)).max().item() <= K4_TOL
