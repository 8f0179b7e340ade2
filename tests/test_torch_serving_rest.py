"""The rest of single-card serving against the JAX package on the CPU: the
int8 folded grid (`build_fast_state(quantize_grid=True)`), `fast_query`
and the unfused `render_novel_view` on it and on the exact grid,
`render_encode_view` on it (K6's plain version), the fused paths' refusal
of it, the pipelined stream step, `ops/pca.py` and `eval/voxel_io.py`.

The state: a random (C, 2H, 2W) feature grid and a random n_blocks=0 head,
folded by both packages (JAX at "highest" matmul precision). The strata
are JAX's own, `uniform(split(key, 5)[0], (R, K))` (fast_field.py:446,
:294), handed to the port as `u`.

Tolerances. The quantizer on JAX's own fp32 folded array: the int8 grid
bit for bit and the scale within 1 ulp. The port's own fold differs from
JAX's by fp32 reassociation, so its int8 grid may differ only where JAX's
folded / scale lies within 1e-4 of a half-integer. fp32 states (the exact
grid, and the int8 grid with fp32 weights): depth, feature, colour,
sigma and the encode view to 1e-4 absolute (fp32 round-off of the same
sums in other orders; depths reach 80 m, so 1e-4 is about 1e-6 of them).
The int8 grid with the serving bf16 weights rounds the code, h and the
colour image to bf16 on both sides, but sums their fp32 terms in other
orders, so a rounding can flip: depth to 1e-3 relative, the feature to
cosine >= 0.999 per ray and colours to 1e-2 (tests/test_torch_fast_field.py's
bf16 bounds). PCA's mean and components to 1e-4 after both packages' sign
flip, its projections to 1e-4 of their largest magnitude (the components'
fp32 SVD round-off times features of up to ~10); the k-means colours and
the voxel files exactly.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.voxel_io as jvoxel
import scenedino_tpu.ops.pca as jpca
from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.models.field import SceneState as JSceneState
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.eval import voxel_io
from scenedino_torch.kernels import launches, reset_launches
from scenedino_torch.kernels.point_render import _sample_quads
from scenedino_torch.models.factory import make_model
from scenedino_torch.models.field import FieldConfig, SceneState
from scenedino_torch.models.heads import make_head
from scenedino_torch.ops import fast_field as ff
from scenedino_torch.ops import pca
from tests.test_torch_downstream import _kmeans_pp_draws
from tests.test_torch_stage2 import MODEL

H, W, K = 8, 16, 16
C, D, E = 12, 16, 9
K_NDC = np.array([[0.9, 0.0, 0.03], [0.0, 1.9, -0.02], [0.0, 0.0, 1.0]], np.float32)
HEAD_CONF = {"type": "resnet", "args": {"n_blocks": 0, "d_hidden": D}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _novel_pose():
    c, s = np.cos(0.06), np.sin(0.06)
    return np.array([[c, 0, s, 0.35], [0, 1, 0, -0.1], [-s, 0, c, 0.4], [0, 0, 0, 1]], np.float32)


def _strata(key, R, n):
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.split(key, 5)[0], (R, n))))


@pytest.fixture(scope="module")
def folded():
    """Both packages' scene state and head on the same numbers: JAX's
    params and SceneState, the port's stand-in field (config, head) and
    SceneState. Channel 3 of the head's feature block is zero, so one
    folded channel is all zeros (its scale is the 1e-12 floor)."""
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(1, 1, C, 2 * H, 2 * W)).astype(np.float32)
    k1 = (rng.normal(size=(C + 39, D)) * 0.4).astype(np.float32)
    k1[:C, 3] = 0.0
    b1 = (rng.normal(size=D) * 0.1).astype(np.float32)
    k2 = (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32)
    b2 = (rng.normal(size=E) * 0.2).astype(np.float32)
    b2[0] += 0.5
    ks = K_NDC[None, None]
    w2c = np.eye(4, dtype=np.float32)[None, None]
    color = rng.uniform(size=(1, 1, 3, H, W)).astype(np.float32)
    jparams = {"params": {"heads_normal_head": {"lin_in": {"kernel": jnp.asarray(k1), "bias": jnp.asarray(b1)},
                                                "lin_out": {"kernel": jnp.asarray(k2), "bias": jnp.asarray(b2)}}}}
    jstate = JSceneState(*(jnp.asarray(a) for a in (feat, ks, w2c, color, ks, w2c)))
    cfg = FieldConfig(dino_dims=E - 1)
    head = make_head(HEAD_CONF, C + cfg.code_dims, cfg.d_out)
    with torch.no_grad():
        for lin, (k, b) in ((head.lin_in, (k1, b1)), (head.lin_out, (k2, b2))):
            lin.weight.copy_(torch.from_numpy(k.T))
            lin.bias.copy_(torch.from_numpy(b))
    field = types.SimpleNamespace(cfg=cfg, head_confs=(("normal_head", HEAD_CONF),),
                                  heads=torch.nn.ModuleDict({"normal_head": head}))
    state = SceneState(*(torch.from_numpy(a) for a in (feat, ks, w2c, color, ks, w2c)))
    return dict(jparams=jparams, jstate=jstate, jcfg=JFieldConfig(dino_dims=E - 1), field=field, state=state, cfg=cfg)


def _jax_state(f, dtype, quantize):
    return jff.build_fast_state(f["jparams"], f["jstate"], f["jcfg"], compute_dtype=dtype, quantize_grid=quantize)


def _to_port(jfs) -> ff.FastFieldState:
    def conv(a):
        if a.dtype == jnp.int8:
            return torch.from_numpy(np.array(a))
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    return ff.FastFieldState(*(None if getattr(jfs, n) is None else conv(getattr(jfs, n))
                               for n in ff.FastFieldState._fields))


def _close(out, ref, atol=1e-4):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32), atol=atol, rtol=0)


def _cosine(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


# ------------------------------------------------------------------ the int8 grid


def test_quantizer_on_the_references_folded_array_is_bit_for_bit(folded):
    exact = _jax_state(folded, jnp.float32, False)
    jq = _jax_state(folded, jnp.float32, True)
    grid, scale = ff.quantize_folded(torch.from_numpy(np.array(exact.folded_grid)))
    assert grid.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jq.folded_grid))
    ulp = np.spacing(np.asarray(jq.grid_scale))
    assert np.all(np.abs(scale.numpy() - np.asarray(jq.grid_scale)) <= ulp)
    assert scale[3].item() == np.float32(1e-12) / np.float32(127.0)  # the all-zero channel's floor
    assert grid.abs().max().item() == 127 and np.unique(grid.numpy()).size > 100


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_build_fast_state_int8_matches_reference(folded, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jq = _jax_state(folded, jdt, True)
    fs = ff.build_fast_state(folded["field"], folded["state"], compute_dtype=tdt, quantize_grid=True)
    assert fs.folded_grid.dtype == torch.int8 and fs.w2.dtype == tdt and fs.color_imgs.dtype == tdt
    np.testing.assert_allclose(fs.grid_scale.numpy(), np.asarray(jq.grid_scale), rtol=1e-6)
    q = np.asarray(_jax_state(folded, jnp.float32, False).folded_grid) / np.asarray(jq.grid_scale)
    near_half = np.abs(np.abs(q - np.floor(q)) - 0.5) < 1e-4
    differ = fs.folded_grid.numpy() != np.asarray(jq.folded_grid)
    assert not np.any(differ & ~near_half), int((differ & ~near_half).sum())
    for name in ("w_code", "w2", "color_imgs"):
        np.testing.assert_array_equal(getattr(fs, name).float().numpy(), np.asarray(getattr(jq, name), np.float32))
    assert ff.build_fast_state(folded["field"], folded["state"]).grid_scale is None  # the exact state


STATES = [("exact", "fp32"), ("int8", "fp32"), ("int8", "bf16")]


def _states(folded, grid, dtype):
    jfs = _jax_state(folded, jnp.float32 if dtype == "fp32" else jnp.bfloat16, grid == "int8")
    return jfs, _to_port(jfs)


def _assert_render_close(dtype, ours, ref):
    (d, f, c), (jd, jf, jc) = ours, [np.asarray(x, np.float32) for x in ref]
    if dtype == "fp32":
        for out, r in ((d, jd), (f, jf), (c, jc)):
            _close(out, r)
    else:
        np.testing.assert_allclose(d.numpy(), jd, rtol=1e-3)
        assert _cosine(f.numpy(), jf).min() >= 0.999
        _close(c, jc, atol=1e-2)


@pytest.mark.parametrize("grid,dtype", STATES)
def test_render_novel_view_matches_reference(folded, grid, dtype):
    jfs, fs = _states(folded, grid, dtype)
    pose, key, cfg = _novel_pose(), jax.random.PRNGKey(5), folded["cfg"]
    ref = jax.jit(lambda fs: jff.render_novel_view(fs, folded["jcfg"], jnp.asarray(pose), jnp.asarray(K_NDC), H, W,
                                                   key, n_coarse=K, band=8))(jfs)
    reset_launches()
    out = ff.render_novel_view(fs, cfg, torch.from_numpy(pose), torch.from_numpy(K_NDC), H, W,
                               u=_strata(key, H * W, K), n_coarse=K)
    assert not any(launches().values())  # plain torch, no kernel
    assert out[0].shape == (H, W) and out[1].shape == (H, W, E - 1) and out[2].shape == (H, W, 3)
    _assert_render_close(dtype, out, ref)
    if grid == "exact":  # the fused path on the same state and strata
        fused = ff.render_novel_view_fused(fs, cfg, torch.from_numpy(pose), torch.from_numpy(K_NDC), H, W,
                                           u=_strata(key, H * W, K), n_coarse=K)
        for a, b in zip(fused, out):
            _close(a, b)
    d, f, c = ff.render_novel_view(fs, cfg, torch.from_numpy(pose), torch.from_numpy(K_NDC), H, W,
                                   generator=torch.Generator().manual_seed(0), n_coarse=K, want_rgb=False,
                                   depth_statistic="median")
    assert c is None and torch.isfinite(d).all() and ((d >= 3.0) & (d <= 80.0)).all()


def test_colour_lookup_at_the_border_matches_the_references_quads():
    """Points outside the image on every side and exactly on its last
    row and column: the packed-quad blend of both packages, fp32 and bf16."""
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(5, 7, 3)).astype(np.float32)
    x = np.array([-3.2, -0.6, -0.5, 0.0, 2.25, 5.99, 6.0, 6.4, 9.0, 3.5, 3.5, 3.5], np.float32)
    y = np.array([2.0, 2.5, -1.5, 4.0, 4.0, 0.3, 1.7, 3.9, 4.5, -0.2, 4.2, 7.0], np.float32)
    from scenedino_tpu.ops.tile_gather import bilinear_gather_packed_plain, pack_quads

    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ji = jnp.asarray(img).astype(jdt)
        ref = np.asarray(bilinear_gather_packed_plain(pack_quads(ji), 5, 7, jnp.asarray(x), jnp.asarray(y)),
                         np.float32)
        out = _sample_quads(torch.from_numpy(img).to(tdt), torch.from_numpy(x), torch.from_numpy(y)).float()
        _close(out, ref, atol=1e-6 if jdt == jnp.float32 else 8e-3)


@pytest.mark.parametrize("grid,dtype", STATES)
def test_fast_query_matches_reference(folded, grid, dtype):
    jfs, fs = _states(folded, grid, dtype)
    xyz = np.random.default_rng(11).uniform([-4, -2, 2], [4, 2, 40], size=(1, 200, 3)).astype(np.float32)
    ref = jax.jit(lambda fs, p: jff.fast_query(fs, folded["jcfg"], p))(jfs, jnp.asarray(xyz))
    out = ff.fast_query(fs, folded["cfg"], torch.from_numpy(xyz))
    for name, a, b in zip(("rgb", "invalid", "sigma", "dino"), out, ref):
        if dtype == "fp32" or name == "invalid":
            _close(a, b)
        else:  # bf16 code and h: a rounding flip moves an output by ~1e-2 of its size
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=2e-2, atol=2e-2)


def test_render_encode_view_int8_matches_reference(folded):
    """K6's plain version on the int8 grid: dequantized before the 2x2 mean,
    which stays fp32; both depth statistics."""
    jfs, fs = _states(folded, "int8", "fp32")
    key = jax.random.PRNGKey(2)
    for stat in ("expectation", "median"):
        ref = jax.jit(lambda fs: jff.render_encode_view(fs, folded["jcfg"], H, W, key, n_coarse=K,
                                                        depth_statistic=stat))(jfs)
        out = ff.render_encode_view(fs, folded["cfg"], H, W, u=_strata(key, H * W, K), n_coarse=K,
                                    depth_statistic=stat)
        for a, b in zip(out, ref):
            _close(a, b)
    args, _ = ff.encode_view_inputs(fs, folded["cfg"], H, W, generator=torch.Generator().manual_seed(0))
    assert args[0].dtype == torch.float32 and args[3].dtype == fs.w_code.dtype  # base fp32, w_z the state's


def test_fused_paths_refuse_the_int8_grid(folded):
    jfs, fs = _states(folded, "int8", "bf16")
    pose, k = torch.from_numpy(_novel_pose()), torch.from_numpy(K_NDC)
    match = "exact-only"
    with pytest.raises(NotImplementedError, match=match):
        jff.render_novel_view_fused(jfs, folded["jcfg"], jnp.asarray(_novel_pose()), jnp.asarray(K_NDC), H, W,
                                    jax.random.PRNGKey(0))
    calls = [lambda: ff.render_novel_view_fused(fs, folded["cfg"], pose, k, H, W, n_coarse=K),
             lambda: ff.render_novel_view_probe(fs, folded["cfg"], pose, k, H, W),
             lambda: ff.fast_query_fused(fs, folded["cfg"], torch.zeros(8, 3))]
    for call in calls:
        with pytest.raises(NotImplementedError, match=match) as e:
            call()
        assert str(e.value) == ff.INT8_REFUSAL == "fused path is exact-only (no int8 grid)"


# ------------------------------------------------------------------ the pipelined stream step


def test_pipelined_stream_step_equals_the_two_calls():
    torch.manual_seed(0)
    model = make_model(MODEL, device="cpu", seed=4)
    model.eval().requires_grad_(False)
    h, w = MODEL["encoder"]["image_size"]
    g = torch.Generator().manual_seed(1)
    frames = [torch.rand(1, 1, 3, h, w, generator=g) * 2 - 1 for _ in range(3)]
    ks, poses = torch.from_numpy(K_NDC)[None, None], torch.eye(4)[None, None]
    pose, k = torch.from_numpy(_novel_pose()), torch.from_numpy(K_NDC)
    step = ff.make_pipelined_stream_step(model, 8, 16, n_coarse=8)

    def encode(img):
        with torch.no_grad():
            return ff.build_fast_state(model, model.encode(img, ks, poses, ids_encoder=(0,)))

    fs = encode(frames[0])
    for i, img in enumerate(frames[1:]):
        u = torch.rand(8 * 16, 8, generator=g)
        fs_next, out = step(fs, img, ks, poses, pose, k, u=u)
        ref_out = ff.render_novel_view_fused(fs, model.cfg, pose, k, 8, 16, u=u, n_coarse=8)
        ref_next = encode(img)
        for a, b in zip(out, ref_out):
            assert torch.equal(a, b), i
        for name in ff.FastFieldState._fields:
            a, b = getattr(fs_next, name), getattr(ref_next, name)
            assert (a is None and b is None) or torch.equal(a, b), name
        fs = fs_next


# ------------------------------------------------------------------ PCA and the k-means colours


def _features(seed=0, n=300, c=24):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, c)) * np.geomspace(4.0, 0.2, c) + rng.normal(size=c)
    return f.astype(np.float32)


@pytest.mark.parametrize("with_nan", [False, True])
def test_pca_matches_reference(with_nan):
    f = _features()
    if with_nan:
        f[[4, 90]] = np.nan  # rows with a non-finite value leave the statistics
    jstate = jpca.fit_pca(jnp.asarray(f))
    state = pca.fit_pca(torch.from_numpy(f))
    _close(state.mean, jstate.mean)
    _close(state.components, jstate.components)
    g = _features(1, 50)
    for norm in (False, True):
        for from_dim in (0, 3, 6):
            ref = np.asarray(jpca.transform_pca(jstate, jnp.asarray(g), norm, from_dim))
            _close(pca.transform_pca(state, torch.from_numpy(g), norm, from_dim), ref,
                   atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_svd_flip_matches_reference():
    u = np.array([[0.2, -0.9, 0.5], [-0.7, 0.1, -0.5], [0.1, 0.3, 0.0]], np.float32)
    v = np.arange(9, dtype=np.float32).reshape(3, 3) - 4
    for a, b in zip(pca._svd_flip(torch.from_numpy(u), torch.from_numpy(v)), jpca._svd_flip(u, v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_clusters", [8, 3])
def test_fit_transform_kmeans_matches_reference(n_clusters):
    f = _features(2, 120, 16).reshape(10, 12, 16)
    key = jax.random.PRNGKey(9)
    jrgb, jcenters = jpca.fit_transform_kmeans(key, jnp.asarray(f), n_clusters, n_iters=20)
    rgb, centers = pca.fit_transform_kmeans(torch.from_numpy(f), n_clusters, 20,
                                            draws=_kmeans_pp_draws(key, 120, n_clusters))
    assert rgb.shape == (10, 12, 3)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    _close(centers, jcenters, atol=1e-5)
    np.testing.assert_array_equal(pca.TAB10.numpy(), np.asarray(jpca.TAB10))


# ------------------------------------------------------------------ the voxel files


def test_voxel_files_are_the_references_bytes(tmp_path):
    rng = np.random.default_rng(4)
    occ = rng.random((9, 7, 5)) < 0.3
    colors = rng.uniform(-0.1, 1.1, size=(9, 7, 5, 3)).astype(np.float32)
    cases = [(occ, (0.0, -25.6, -2.0), 0.2, colors), (occ, (1.5, 2.0, -0.5), 0.1, None),
             (np.zeros((3, 3, 3), bool), (0.0, 0.0, 0.0), 0.2, None)]
    for i, (o, origin, vs, c) in enumerate(cases):
        ours, ref = tmp_path / f"ours{i}.ply", tmp_path / f"ref{i}.ply"
        assert voxel_io.save_as_voxel_ply(str(ours), o, origin, vs, c) == jvoxel.save_as_voxel_ply(
            str(ref), o, origin, vs, c)
        assert ours.read_bytes() == ref.read_bytes()
    grid = rng.random((16, 8, 4)) < 0.4
    packed = voxel_io.pack_voxel_bits(grid.reshape(-1))
    np.testing.assert_array_equal(packed, jvoxel.pack_voxel_bits(grid.reshape(-1)))
    np.testing.assert_array_equal(voxel_io.unpack_voxel_bits(packed.astype(np.uint8)),
                                  jvoxel.unpack_voxel_bits(packed.astype(np.uint8)))
    np.testing.assert_array_equal(voxel_io.unpack_voxel_bits(packed.astype(np.uint8)), grid.reshape(-1))
    voxel_io.save_voxel_grid(grid, str(tmp_path / "ours.bin"))
    jvoxel.save_voxel_grid(grid, str(tmp_path / "ref.bin"))
    assert (tmp_path / "ours.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    with pytest.raises(NotImplementedError, match="not implemented"):
        voxel_io.save_voxel_grid(grid, str(tmp_path / "x.bin"), format="npy")
