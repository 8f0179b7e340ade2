"""Parity of the port's field queries without a novel-view render with the
JAX reference on the CPU: the voxel query `fast_query_fused` (the K4
kernel runs its plain version here) and the unfused `fast_query`, the
SSCBench voxel grid, the channels-last `grid_sample_views_hwc`, and the
encode-view render `render_encode_view` (+ `_batched`) in its three
grid-ratio branches and both depth statistics.

Both sides get the same numbers: a random fp32 folded state, the same
points, the same seg head, and for the encode view the strata the JAX
function draws from its key (`uniform` of `split(key, 5)[0]`,
fast_field.py:294), rebuilt here from that key. Tolerances: fp32 with JAX
under "highest" matmul precision; sigma, feature, colour and depth to
rtol 1e-4 and an atol of 1e-4, or of 1e-5 x the largest magnitude where
that is larger (fp32 round-off of the lookup, the two products and the
compositing summed in other orders); seg labels, the voxel grid and its
mask exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.core import grid_sample as jgrid_sample
from scenedino_tpu.eval import sscbench as jssc
from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.core import grid_sample
from scenedino_torch.eval import sscbench
from scenedino_torch.kernels import launches, reset_launches
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops import fast_field as ff

K_NDC = np.array([[1.1, 0.0, 0.02], [0.0, 2.2, -0.01], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    atol = max(1e-4, 1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(out), ref, atol=atol, rtol=1e-4)


def _random_state(rng, grid_hw, img_hw, V=1, B=1, D=16, E=7):
    """A folded fp32 state: random grid and weights, view v's camera 0.3 v m
    to the right of the origin."""
    w2c = np.broadcast_to(np.eye(4, dtype=np.float32), (B, V, 4, 4)).copy()
    w2c[..., 0, 3] = -0.3 * np.arange(V)
    ks = np.broadcast_to(K_NDC, (B, V, 3, 3)).copy()
    b2 = rng.normal(size=E) * 0.2
    b2[0] += 0.5
    arr = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    return jff.FastFieldState(
        folded_grid=arr(rng.normal(size=(B, V, *grid_hw, D))),
        w_code=arr(rng.normal(size=(39, D)) * 0.3), b1=arr(rng.normal(size=D) * 0.1),
        w2=arr(rng.normal(size=(D, E)) * 0.3), b2=arr(b2),
        feat_ks=arr(ks), feat_w2c=arr(w2c),
        color_imgs=arr(rng.uniform(size=(B, V, *img_hw, 3))), color_ks=arr(ks), color_w2c=arr(w2c),
    )


def _to_port(jfs) -> ff.FastFieldState:
    return ff.FastFieldState(*(None if getattr(jfs, f) is None else _t(np.asarray(getattr(jfs, f), np.float32))
                               for f in ff.FastFieldState._fields))


def _points(rng, P):
    """World points in front of the cameras, some outside their views."""
    return np.concatenate([rng.uniform(-2, 2, size=(P, 2)), rng.uniform(4, 44, size=(P, 1))], -1).astype(np.float32)


# ------------------------------------------------------------ voxel queries


def test_fast_query_fused_matches_reference_with_and_without_seg_fn():
    """Mirror of tests/test_fast_field.py:226: sigma and feature of the
    fused query, and a seg head applied to the feature."""
    rng = np.random.default_rng(0)
    jfs = _random_state(rng, (32, 64), (16, 32))
    cfg, jcfg = FieldConfig(dino_dims=6), JFieldConfig(dino_dims=6)
    xyz = _points(rng, 128)
    js, jf = jff.fast_query_fused(jfs, jcfg, jnp.asarray(xyz), segments=8, band=8)
    reset_launches()
    s, f = ff.fast_query_fused(_to_port(jfs), cfg, _t(xyz), segments=8, band=8)
    assert set(launches().values()) == {0}  # CPU tensors take the plain version
    assert s.shape == (128,) and f.shape == (128, 6)
    _close(s, js)
    _close(f, jf)
    wm = rng.normal(size=(6, 5)).astype(np.float32)
    _, jseg = jff.fast_query_fused(jfs, jcfg, jnp.asarray(xyz), segments=8, band=8,
                                   seg_fn=lambda d: jnp.argmax(d @ jnp.asarray(wm), axis=-1))
    _, seg = ff.fast_query_fused(_to_port(jfs), cfg, _t(xyz), seg_fn=lambda d: torch.argmax(d @ _t(wm), -1))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))


@pytest.mark.parametrize("views,only_density", [(1, False), (1, True), (2, False)])
def test_fast_query_matches_reference(views, only_density):
    """The unfused drop-in for SceneField.forward: rgb of every render
    view, invalid flags, sigma and feature averaged over the encode views."""
    rng = np.random.default_rng(1)
    jfs = _random_state(rng, (32, 64), (16, 32), V=views)
    xyz = _points(rng, 96)[None]
    ref = jff.fast_query(jfs, JFieldConfig(dino_dims=6), jnp.asarray(xyz), only_density=only_density)
    out = ff.fast_query(_to_port(jfs), FieldConfig(dino_dims=6), _t(xyz), only_density=only_density)
    assert (out[0] is None) == (ref[0] is None) == only_density
    for o, r in zip(out, ref):
        if r is not None:
            assert tuple(o.shape) == r.shape
            _close(o, r)
    if not only_density:
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))  # invalid flags exactly


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_views_hwc_matches_reference(mode):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 3, 5, 7, 4)).astype(np.float32)
    xy = rng.uniform(-1.3, 1.3, size=(2, 3, 11, 2)).astype(np.float32)
    ref = jgrid_sample.grid_sample_views_hwc(jnp.asarray(feats), jnp.asarray(xy), mode)
    out = grid_sample.grid_sample_views_hwc(_t(feats), _t(xy), mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_generate_point_grid_is_the_references():
    pts, mask = sscbench.generate_point_grid()
    jpts, jmask = jssc.generate_point_grid()
    assert pts.shape == (256 * 256 * 32, 3) and pts.dtype == np.float32
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(mask, jmask)
    for name in ("SIGMA_CUTOFF", "VOXEL_SIZE", "SIZES", "SCENE_SIZE", "IMG_W", "IMG_H"):
        assert getattr(sscbench, name) == getattr(jssc, name), name
    for name in ("VOX_ORIGIN", "CAM_K", "CAM2VELO", "VELO2CAM"):
        np.testing.assert_array_equal(getattr(sscbench, name), getattr(jssc, name), err_msg=name)


# ------------------------------------------------------------ the encode-view render


def _strata(key, R, K):
    return _t(jax.random.uniform(jax.random.split(key, 5)[0], (R, K)))


@pytest.mark.parametrize("grid_hw", [(24, 48), (12, 24), (18, 36)], ids=["2x-mean", "equal", "general-ratio"])
@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_encode_view_render_matches_reference(grid_hw, depth_statistic):
    """Mirror of tests/test_encode_view_render.py, in all three branches."""
    H, W, K = 12, 24, 8
    jfs = _random_state(np.random.default_rng(3), grid_hw, (H, W))
    key = jax.random.PRNGKey(7)
    ref = jff.render_encode_view(jfs, JFieldConfig(dino_dims=6), H, W, key, n_coarse=K,
                                 depth_statistic=depth_statistic)
    out = ff.render_encode_view(_to_port(jfs), FieldConfig(dino_dims=6), H, W, u=_strata(key, H * W, K),
                                n_coarse=K, depth_statistic=depth_statistic)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        _close(o, r)


@pytest.mark.parametrize("code_mode", ["z", "distance"])
def test_encode_view_render_batched_matches_reference(code_mode):
    H, W, K, B = 8, 16, 8, 2
    jfs = _random_state(np.random.default_rng(4), (16, 32), (H, W), B=B)
    keys = jax.random.split(jax.random.PRNGKey(9), B)
    ref = jff.render_encode_view_batched(jfs, JFieldConfig(dino_dims=6, code_mode=code_mode), H, W, keys,
                                         n_coarse=K)
    u = torch.stack([_strata(k, H * W, K) for k in keys])
    out = ff.render_encode_view_batched(_to_port(jfs), FieldConfig(dino_dims=6, code_mode=code_mode), H, W, u=u,
                                        n_coarse=K)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        _close(o, r)


def test_encode_view_render_refuses_what_the_reference_refuses():
    fs = _to_port(_random_state(np.random.default_rng(5), (16, 32), (8, 16)))
    cfg = FieldConfig(dino_dims=6)
    with pytest.raises(ValueError, match="color image"):
        ff.render_encode_view(fs, cfg, 4, 8, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="depth_statistic"):
        ff.render_encode_view(fs, cfg, 8, 16, generator=torch.Generator().manual_seed(0), depth_statistic="Median")
