"""K6, the encode-view render: its plain version (what the CPU runs) against
the JAX reference's `render_encode_view` and `render_encode_view_batched`
on the same folded state and strata, in the state's two dtypes (the fp32
fold of stage 2, the bf16 state of serving) and both depth statistics; a
CPU emulation of the kernel's walk (one lane a sample: the z code, the
hidden units one at a time, the warp's product scan, butterfly sums and
ballot median) against the plain version; and the wrapper's refusals.
The kernel against its plain version on a card is in
tests/test_torch_kernels.py (which imports no JAX).

The strata are the JAX function's own, rebuilt from its key (`uniform`
of `split(key, 5)[0]`, fast_field.py:294). Tolerances: fp32 (JAX under
"highest" precision) rtol 1e-4 and an atol of 1e-4, or 1e-5 x the largest
magnitude where that is larger, as tests/test_torch_query.py; bf16: h is
rounded to bf16 before W2 on both sides, but the two sum its fp32 terms
in other orders, so a rounding can flip (ulp 2^-8 |h|, on a few of the
~1e5 hidden values): depth 5e-2 m, feature and colour 5e-3 (chip_smoke.py's
K2 bounds, the same reason), the median ray's error below 1e-5; the
median depth the reference's sample or its neighbour on at most 1 % of
rays. The emulation: fp32 sums in the kernel's order against the plain
version's, 1e-5 relative (1e-4 m in depth); the median's sample exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.ops import fast_field as jff
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

    return ff.FastFieldState(*(conv(getattr(jfs, f)) for f in ff.FastFieldState._fields))


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
def test_plain_matches_reference(dtype, depth_statistic, D, E):
    H, W, K = 12, 24, 8
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
def test_batched_plain_matches_reference(dtype, code_mode):
    H, W, K, B = 8, 16, 8, 3
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


def emulate_kernel(base, z, zscale, w_z, w2, b2, color, cfg: EncodeViewConfig, bf16: bool):
    """csrc/encode_view.cu's arithmetic in numpy fp32, one ray a row and one
    sample a lane: the code, the hidden units one at a time, then the
    warp-parallel compositing."""
    f = np.float32
    N, D = base.shape
    K, E, Cz = z.shape[1], w2.shape[1], w_z.shape[0]
    lane = np.arange(32)
    live = lane < K
    zk = np.zeros((N, 32), f)
    zk[:, :K] = z
    dl = zk * zscale[:, None]
    if cfg.inv_z:
        zn01 = (f(1) / np.maximum(dl, f(1e-3)) - f(1 / cfg.z_far)) / f(1 / cfg.z_near - 1 / cfg.z_far)
    else:
        zn01 = (dl - f(cfg.z_near)) / f(cfg.z_far - cfg.z_near)
    zn = f(2) * zn01 - f(1)
    code = np.zeros((N, 32, 16), f)
    for c in range(Cz):
        if cfg.include_input and c == 0:
            code[..., c] = zn
        else:
            i = c - int(cfg.include_input)
            arg = zn * f(cfg.freq_factor * 2 ** (i // 2)) + (f(np.pi / 2) if i % 2 else f(0))
            code[..., c] = np.sin(arg.astype(np.float64)).astype(f)
    if bf16:
        code = _bf16(code)
    wz = np.zeros((D, 16), f)
    wz[:, :Cz] = w_z.T
    acc = np.zeros((N, 32, E), f)
    for j in range(D):
        t = np.zeros((N, 32), f)
        for c in range(16):
            t = t + code[..., c] * wz[j, c]
        h = base[:, j:j + 1] + t
        h = np.where(h < 0, f(0), h)
        if bf16:
            h = _bf16(h)
        acc = acc + h[..., None] * w2[j]
    out = acc + b2
    x = out[..., 0]
    sigma = np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))
    z_next = zk[:, np.minimum(lane + 1, 31)]
    delta = np.where(lane + 1 < K, z_next - zk, f(1e10))
    alpha = np.where(live, f(1) - np.exp(-np.abs(delta) * np.maximum(sigma, 0)), f(0))
    if cfg.hard_alpha_cap:
        alpha[:, K - 1] = 1.0
    fl = np.where(live, np.maximum(f(1) - alpha, f(1e-10)), f(1))
    incl = _scan(fl, np.multiply)
    excl = np.concatenate([np.ones((N, 1), f), incl[:, :-1]], 1)
    w = alpha * excl
    total = _butterfly(w)
    if cfg.depth_statistic == "median":
        below = live & (_scan(w, np.add) / np.maximum(total, f(1e-10))[:, None] < 0.5)
        depth = zk[np.arange(N), np.minimum(below.sum(1), K - 1)]
    else:
        depth = _butterfly(w * zk)
    dino = np.stack([_butterfly(w * out[..., e]) for e in range(1, E)], -1)
    return depth, dino, color * total[:, None]


@pytest.mark.parametrize("K", [5, 12, 32])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_kernel_walk_matches_plain(K, bf16, depth_statistic):
    rng = np.random.default_rng(K)
    N, D, E = 64, 16, 7
    cfg = EncodeViewConfig(depth_statistic=depth_statistic)
    base = rng.normal(size=(N, D)).astype(np.float32)
    z = np.sort(rng.uniform(3, 80, size=(N, K)), -1).astype(np.float32)
    zscale = rng.uniform(0.8, 1.0, size=N).astype(np.float32)
    w_z, w2 = rng.normal(size=(13, D)).astype(np.float32) * 0.3, rng.normal(size=(D, E)).astype(np.float32) * 0.3
    if bf16:
        w_z, w2 = _bf16(w_z), _bf16(w2)
    b2 = rng.normal(size=E).astype(np.float32) * 0.2
    color = rng.uniform(size=(N, 3)).astype(np.float32)
    dt = torch.bfloat16 if bf16 else torch.float32
    plain = encode_view_plain(torch.from_numpy(base), torch.from_numpy(z), torch.from_numpy(zscale),
                              torch.from_numpy(w_z).to(dt), torch.from_numpy(w2).to(dt), torch.from_numpy(b2),
                              torch.from_numpy(color), cfg)
    emu = emulate_kernel(base, z, zscale, w_z, w2, b2, color, cfg, bf16)
    for name, p, e in zip(("depth", "feature", "rgb"), plain, emu):
        if name == "depth" and depth_statistic == "median":
            np.testing.assert_array_equal(p.numpy(), e)
        else:
            np.testing.assert_allclose(p.numpy(), e, rtol=1e-5, atol=1e-4 if name == "depth" else 1e-5, err_msg=name)


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
