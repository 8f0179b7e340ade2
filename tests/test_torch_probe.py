"""Parity of the port's probe-guided serving path with the JAX reference on
the CPU: `sample_coarse_from_dist`, `encode_prefolded`,
`render_novel_view_probe` (the K3 probe and the row-gather upsample run
their plain versions here), the weight-median depth of the K2 path and
the probe, the fold's refusal of head configurations it cannot fold, and
the probe's quality bound on the analytic wall scene.

Draws: `jax.random` cannot be matched from torch, so every draw the JAX
function takes from its key is rebuilt here from that key and handed to
the port: the render's split into (kp, kf, ku) (fast_field.py:748), kf's
split into the bin picks and their places (sampling.py:81), and
`uniform` of each key at the reference's shapes.

Tolerances: fp32 throughout, JAX under "highest" matmul precision (its
one-hot bin lookup is an einsum that rounds at default precision).
Resampled depths and the depth, feature and colour of a render are held
to rtol 1e-4 and an atol of 1e-4, or of 1e-5 x the largest magnitude
where that is larger: fp32 round-off of the probe weights, the CDF and
the interpolation in another summation order. The resampling picks a bin
by comparing a draw with the CDF, so the bins themselves are equal (the
draws lie nowhere near a CDF step closer than that round-off; the tie
test puts one exactly on a step). On the trained fixture the two sides'
folded grids differ by fp32 round-off of the encoder, which can put a draw
on the other side of a step: there at most 0.5% of the pixels may fall
outside the tolerance above (each such pixel took another bin for one of
its samples). The fold is exact up to reassociation: folded grids to 2e-4
of their largest magnitude.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import scenedino_tpu.core.sampling as jsampling
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.core import sampling
from scenedino_torch.kernels import launches, point_render, reset_launches
from scenedino_torch.kernels.point_render import PointRenderConfig, point_render_plain
from scenedino_torch.models.factory import make_model
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops import fast_field as ff
from scenedino_torch.utils.convert import load_jax_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "goldens" / "s1b_field_params.npz"
CONFIG = ROOT / "configs" / "train_synthetic_convergence.yaml"
K_NDC = np.array([[0.7, 0.0, 0.0], [0.0, 2.3, 0.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _novel_pose(shift=(0.3, -0.1, 0.0), angle=0.05):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s, shift[0]], [0, 1, 0, shift[1]], [-s, 0, c, shift[2]], [0, 0, 0, 1]], np.float32)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    atol = max(1e-4, 1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(out), ref, atol=atol, rtol=1e-4)


def _close_but_rare_bin_flips(out, ref, share=5e-3):
    """`_close` on all but `share` of the pixels (leading two axes)."""
    out, ref = np.asarray(out), np.asarray(ref, np.float32)
    atol = max(1e-4, 1e-5 * float(np.abs(ref).max()))
    bad = ~np.isclose(out, ref, atol=atol, rtol=1e-4).reshape(*ref.shape[:2], -1).all(-1)
    assert bad.mean() <= share, (bad.sum(), np.abs(out - ref).max())


def _coarse_draws(key, R, K):
    """`render_novel_view_fused`'s strata: uniform of split(key, 5)[0]."""
    return _t(jax.random.uniform(jax.random.split(key, 5)[0], (R, K)))


def _probe_draws(key, H, W, s=4, n_probe=16, n_fine=10, n_uniform=2) -> ff.ProbeDraws:
    kp, kf, ku = jax.random.split(key, 3)
    k_u, k_t = jax.random.split(kf)
    R, Rp = H * W, (H // s) * (W // s)
    return ff.ProbeDraws(
        _t(jax.random.uniform(kp, (Rp, n_probe))),
        _t(jax.random.uniform(k_u, (R, n_fine))),
        _t(jax.random.uniform(k_t, (R, n_fine))),
        _t(jax.random.uniform(ku, (R, n_uniform))) if n_uniform else None,
    )


def _random_state(rng, H, W, D=16, E=9):
    """A folded fp32 state with random grid and weights, encode camera at
    the origin."""
    eye = np.eye(4, dtype=np.float32)[None, None]
    b2 = rng.normal(size=E) * 0.2
    b2[0] += 0.5
    arr = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    return jff.FastFieldState(
        folded_grid=arr(rng.normal(size=(1, 1, 2 * H, 2 * W, D))),
        w_code=arr(rng.normal(size=(39, D)) * 0.3), b1=arr(rng.normal(size=D) * 0.1),
        w2=arr(rng.normal(size=(D, E)) * 0.3), b2=arr(b2),
        feat_ks=jnp.asarray(K_NDC)[None, None], feat_w2c=jnp.asarray(eye),
        color_imgs=arr(rng.uniform(size=(1, 1, H, W, 3))),
        color_ks=jnp.asarray(K_NDC)[None, None], color_w2c=jnp.asarray(eye),
    )


def _to_port(jfs) -> ff.FastFieldState:
    return ff.FastFieldState(*(None if getattr(jfs, f) is None else _t(np.asarray(getattr(jfs, f), np.float32))
                               for f in ff.FastFieldState._fields))


# ------------------------------------------------------------ sampling


def _rays(R, near=3.0, far=80.0):
    rays = np.zeros((R, 8), np.float32)
    rays[:, 5], rays[:, 6], rays[:, 7] = 1.0, near, far
    return rays


@pytest.mark.parametrize("lindisp", [True, False])
def test_sample_coarse_from_dist_matches_reference(lindisp):
    rng = np.random.default_rng(0)
    R, Kb, N = 64, 16, 10
    rays = _rays(R)
    weights = (rng.uniform(size=(R, Kb)) ** 4).astype(np.float32)
    z_samp = np.sort(rng.uniform(3.0, 80.0, size=(R, Kb)), -1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jsampling.sample_coarse_from_dist(key, jnp.asarray(rays), jnp.asarray(weights), jnp.asarray(z_samp),
                                            N, lindisp)
    k_u, k_t = jax.random.split(key)
    out = sampling.sample_coarse_from_dist(_t(rays), _t(weights), _t(z_samp), N, lindisp,
                                           u=_t(jax.random.uniform(k_u, (R, N))),
                                           t=_t(jax.random.uniform(k_t, (R, N))))
    _close(out, ref)


def test_sample_coarse_from_dist_tie_rule(monkeypatch):
    """A draw exactly on a CDF value picks the bin that starts there, as the
    reference's compare-and-sum `_searchsorted_right` does. The weights are
    chosen so that weights + 1e-5 are the dyadic [0.25, 0.5, 0.125, 0.125]:
    the CDF [0, .25, .75, .875, 1] is then exact in any summation order."""
    target = np.array([0.25, 0.5, 0.125, 0.125], np.float32)
    eps = np.float32(1e-5)
    weights = target - eps
    for i in range(4):  # nudge each weight until weight + eps rounds to the target exactly
        while np.float32(weights[i] + eps) != target[i]:
            weights[i] = np.nextafter(weights[i], target[i] if weights[i] + eps < target[i] else 0)
    u = np.array([[0.0, 0.25, 0.75, 0.875], [0.25, 0.2499, 0.7501, 0.999]], np.float32)
    t = np.full_like(u, 0.5)
    R = u.shape[0]
    w = np.broadcast_to(weights, (R, 4)).copy()
    z_samp = np.broadcast_to(np.array([4.0, 8.0, 16.0, 32.0], np.float32), (R, 4)).copy()
    draws = iter([jnp.asarray(u), jnp.asarray(t)])
    monkeypatch.setattr(jsampling.jax.random, "uniform", lambda *a, **k: next(draws))
    ref = np.asarray(jsampling.sample_coarse_from_dist(jax.random.PRNGKey(0), jnp.asarray(_rays(R)),
                                                       jnp.asarray(w), jnp.asarray(z_samp), 4, False))
    out = sampling.sample_coarse_from_dist(_t(_rays(R)), _t(w), _t(z_samp), 4, False, u=_t(u), t=_t(t)).numpy()
    np.testing.assert_array_equal(out, ref)
    # bins: u = 0 -> 0, .25 -> 1, .75 -> 2, .875 -> 3; just below/above a step stays/moves
    borders = np.array([4.0, 6.0, 12.0, 24.0, 32.0])
    mids = 0.5 * (borders[:-1] + borders[1:])
    np.testing.assert_array_equal(out[0], mids[[0, 1, 2, 3]].astype(np.float32))
    np.testing.assert_array_equal(out[1], mids[[1, 0, 2, 3]].astype(np.float32))


# ------------------------------------------------------------ median depth (K2 path)


@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
def test_novel_view_depth_statistic_matches_reference(depth_statistic):
    H, W, K = 8, 16, 32
    jfs = _random_state(np.random.default_rng(1), H, W)
    cfg = JFieldConfig(dino_dims=8)
    pose, key = _novel_pose(), jax.random.PRNGKey(2)
    jd, jf, jc = jff.render_novel_view_fused(jfs, cfg, jnp.asarray(pose), jnp.asarray(K_NDC), H, W, key,
                                             n_coarse=K, depth_statistic=depth_statistic)
    d, f, c = ff.render_novel_view_fused(_to_port(jfs), FieldConfig(dino_dims=8), _t(pose), _t(K_NDC), H, W,
                                         u=_coarse_draws(key, H * W, K), n_coarse=K,
                                         depth_statistic=depth_statistic)
    for out, ref in ((d, jd), (f, jf), (c, jc)):
        _close(out, ref)


def test_point_render_plain_median_is_a_sample_depth():
    """The median is the first sample whose normalized weight CDF reaches 0.5."""
    H, W, K = 4, 8, 16
    fs = _to_port(_random_state(np.random.default_rng(3), H, W))
    g = torch.Generator().manual_seed(0)
    flat = ff._target_rays(FieldConfig(dino_dims=8), _t(_novel_pose()), _t(K_NDC), H, W).reshape(-1, 8)
    z = sampling.sample_coarse(flat, K, generator=g)
    args = (flat, z, *ff._single_view(fs, "test"), *ff._colour_view(fs))
    d_med = point_render_plain(*args, PointRenderConfig(depth_statistic="median"))[0]
    d_exp, f_exp, c_exp = point_render_plain(*args, PointRenderConfig())
    assert torch.equal(d_med[:, None].eq(z).any(-1), torch.ones(H * W, dtype=torch.bool))
    assert not torch.equal(d_med, d_exp)
    with pytest.raises(ValueError, match="depth_statistic"):
        point_render(*args, PointRenderConfig(depth_statistic="Median"))


# ------------------------------------------------------------ the probe render


@pytest.mark.parametrize("depth_statistic,want_rgb", [("expectation", True), ("median", False)])
def test_probe_render_matches_reference(depth_statistic, want_rgb):
    H, W = 16, 32
    jfs = _random_state(np.random.default_rng(4), H, W)
    cfg = JFieldConfig(dino_dims=8)
    pose, key = _novel_pose((0.2, -0.1, 0.1)), jax.random.PRNGKey(7)
    jd, jf, jc = jff.render_novel_view_probe(jfs, cfg, jnp.asarray(pose), jnp.asarray(K_NDC), H, W, key,
                                             want_rgb=want_rgb, depth_statistic=depth_statistic)
    reset_launches()
    d, f, c = ff.render_novel_view_probe(_to_port(jfs), FieldConfig(dino_dims=8), _t(pose), _t(K_NDC), H, W,
                                         draws=_probe_draws(key, H, W), want_rgb=want_rgb,
                                         depth_statistic=depth_statistic)
    assert set(launches().values()) == {0}  # CPU tensors take the plain versions
    assert d.shape == (H, W) and f.shape == (H, W, 8)
    _close(d, jd)
    _close(f, jf)
    if want_rgb:
        _close(c, jc)
    else:
        assert c is None and jc is None
    assert np.all((d.numpy() >= 3.0 - 1e-3) & (d.numpy() <= 80.0 + 1e-3))


def test_probe_render_refuses_a_frame_the_stride_does_not_divide():
    fs = _to_port(_random_state(np.random.default_rng(5), 6, 8))
    with pytest.raises(ValueError, match="stride"):
        ff.render_novel_view_probe(fs, FieldConfig(dino_dims=8), _t(np.eye(4)), _t(K_NDC), 6, 8,
                                   generator=torch.Generator().manual_seed(0))


def _wall_state(cfg, H, W, HG, WG, D=8, beta=250.0):
    """tests/test_probe_quality.py's analytic wall: a softplus density wall
    at a smoothly varying depth, carried by the grid's channel 0 against
    the code's normalized-depth channel."""
    uu, vv = np.meshgrid(np.linspace(-1, 1, WG), np.linspace(-1, 1, HG))
    dstar = 10.0 + 6.0 * np.sin(2.2 * uu) * np.cos(1.7 * vv) + 3.0 * uu
    zn = 2.0 * ((1.0 / np.maximum(dstar, 1e-6) - 1.0 / 80.0) / (1.0 / 3.0 - 1.0 / 80.0)) - 1.0
    folded = np.zeros((1, 1, HG, WG, D), np.float32)
    folded[0, 0, :, :, 0] = beta * zn
    folded[0, 0, :, :, 1] = 1.0 + 0.5 * np.sin(3 * uu) * np.cos(2 * vv)
    folded[0, 0, :, :, 2] = 1.0 + 0.5 * uu
    folded[0, 0, :, :, 3] = 1.0 - 0.5 * vv
    w_code = np.zeros((cfg.code_dims, D), np.float32)
    w_code[2, 0] = -beta
    w2 = np.zeros((D, 1 + cfg.dino_dims), np.float32)
    w2[0, 0] = w2[1, 1] = w2[2, 2] = w2[3, 3] = 1.0
    w2[1, 4] = 0.5
    b2 = np.zeros(1 + cfg.dino_dims, np.float32)
    b2[0] = -8.0
    img = np.zeros((1, 1, H, W, 3), np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    img[0, 0, :, :, 0], img[0, 0, :, :, 1], img[0, 0, :, :, 2] = xx, yy, 0.5
    k = np.array([[0.9, 0, 0], [0, 1.8, 0], [0, 0, 1]], np.float32)
    eye = _t(np.eye(4))[None, None]
    fs = ff.FastFieldState(_t(folded), _t(w_code), torch.zeros(D), _t(w2), _t(b2), _t(k)[None, None], eye,
                           _t(img), _t(k)[None, None], eye)
    return fs, _t(k)


def test_probe_quality_bound_on_the_analytic_wall():
    """tests/test_probe_quality.py:84 on the port: at the serving defaults
    the probe's depth error against a 256-sample gold is no worse than the
    exact 32-sample path's at the median and the 95th percentile (10%
    slack, as there), features stay aligned, colours match."""
    H, W = 64, 96
    cfg = FieldConfig(dino_dims=4)
    fs, k = _wall_state(cfg, H, W, 128, 192)
    pose, key = _t(_novel_pose((0.25, -0.08, 0.0), 0.04)), jax.random.PRNGKey(0)
    dg, fg, rg = ff.render_novel_view_fused(fs, cfg, pose, k, H, W, u=_coarse_draws(key, H * W, 256), n_coarse=256)
    de, _, _ = ff.render_novel_view_fused(fs, cfg, pose, k, H, W, u=_coarse_draws(key, H * W, 32), n_coarse=32)
    dp, fp, rp = ff.render_novel_view_probe(fs, cfg, pose, k, H, W, draws=_probe_draws(key, H, W))
    dg, fg, rg, de, dp, fp, rp = (t.numpy() for t in (dg, fg, rg, de, dp, fp, rp))
    err_exact, err_probe = np.abs(de - dg), np.abs(dp - dg)
    assert np.median(err_probe) <= np.median(err_exact) * 1.1, (np.median(err_probe), np.median(err_exact))
    assert np.percentile(err_probe, 95) <= np.percentile(err_exact, 95) * 1.1
    assert np.median(err_probe) < 0.5 and np.percentile(err_probe, 95) < 6.0
    cos = (fp * fg).sum(-1) / np.maximum(np.linalg.norm(fp, axis=-1) * np.linalg.norm(fg, axis=-1), 1e-9)
    assert np.median(cos) > 0.9999 and cos.min() > 0.995, cos.min()
    assert np.percentile(np.abs(rp - rg), 95) < 0.005 and np.abs(rp - rg).max() < 0.08


# ------------------------------------------------------------ encode_prefolded and can_fold

TINY = {
    "predict_dino": True,
    "dino_dims": 8,
    "z_near": 3.0,
    "z_far": 80.0,
    "encoder": {
        "encoder_arch": "vit-s",
        "num_ch_enc": [8, 8, 16, 16],
        "intermediate_features": [0, 1, 2],
        "decoder_out_dim": 16,
        "dino_pca_dim": 8,
        "image_size": [32, 64],
        "vit_overrides": {"width": 64, "depth": 3, "num_heads": 2},
    },
    "decoder_heads": [{"type": "resnet", "name": "normal_head", "args": {"n_blocks": 0, "d_hidden": 16}}],
}


def _j_encode_prefolded(jfield, params, imgs, projs, poses):
    fn = jax.jit(lambda p, i, k, c: jff.encode_prefolded(jfield, p, i, k, c, compute_dtype=jnp.float32))
    return fn(params, *(jnp.asarray(a) for a in (imgs, projs, poses)))


@pytest.fixture(scope="module")
def tiny():
    """(JAX field, its seeded params, the port's serving model on them, inputs)."""
    rng = np.random.default_rng(6)
    imgs = rng.uniform(-1, 1, size=(1, 1, 3, 32, 64)).astype(np.float32)
    projs = np.broadcast_to(K_NDC, (1, 1, 3, 3)).copy()
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 1, 4, 4)).copy()
    jfield = j_make_model(TINY)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jfield.init({"params": k, "augment": k}, jnp.asarray(imgs), jnp.asarray(projs),
                                                jnp.asarray(poses), method=JSceneField.warmup))

    def draw(path, leaf):
        x = rng.normal(size=leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            return jnp.asarray(x / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray(1.0 + 0.1 * x if "scale" in name else 0.1 * x)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = make_model(TINY, device="cpu")
    load_jax_params(model, params["params"])
    return jfield, params, model, (imgs, projs, poses)


def test_encode_prefolded_matches_two_step_fold_and_reference(tiny):
    jfield, params, model, (imgs, projs, poses) = tiny
    jfs = _j_encode_prefolded(jfield, params, imgs, projs, poses)
    fs = ff.encode_prefolded(model, _t(imgs), _t(projs), _t(poses), compute_dtype=torch.float32)
    with torch.inference_mode():
        state = model.encode(_t(imgs), _t(projs), _t(poses), ids_encoder=(0,))
    two_step = ff.build_fast_state(model, state, compute_dtype=torch.float32)
    scale = max(float(np.abs(np.asarray(jfs.folded_grid)).max()), 1.0)
    for ref in (jfs.folded_grid, two_step.folded_grid):
        np.testing.assert_allclose(fs.folded_grid.numpy(), np.asarray(ref), atol=2e-4 * scale, rtol=2e-4)
    for name in ("w_code", "b1", "w2", "b2", "color_imgs", "feat_ks", "feat_w2c", "color_ks", "color_w2c"):
        assert torch.equal(getattr(fs, name), getattr(two_step, name)), name
        np.testing.assert_allclose(getattr(fs, name).numpy(), np.asarray(getattr(jfs, name)), atol=1e-6, err_msg=name)


def test_can_fold_refuses_what_the_reference_refuses(tiny, monkeypatch):
    """beta > 0 or d_latent > 0 leave no trace in the parameter tree; both
    packages refuse the fold when the head configuration says so."""
    jfield, params, model, (imgs, projs, poses) = tiny
    jcfg = jfield.cfg
    assert jff.can_fold(params, jcfg, head_confs=jfield.head_confs) and ff.can_fold(model)
    for args in ({"n_blocks": 0, "d_hidden": 16, "beta": 1.0}, {"n_blocks": 0, "d_hidden": 16, "d_latent": 4}):
        confs = (("normal_head", {"type": "resnet", "args": args}),)
        assert not jff.can_fold(params, jcfg, head_confs=confs)
        assert not ff.can_fold(model, head_confs=confs)
    monkeypatch.setattr(model, "head_confs", (("normal_head", {"type": "resnet", "args": {"beta": 1.0}}),))
    with pytest.raises(ValueError, match="not foldable"):
        ff.encode_prefolded(model, _t(imgs), _t(projs), _t(poses))


# ------------------------------------------------------------ the whole probe path, trained field


@pytest.fixture(scope="module")
def s1b():
    from scenedino_tpu.datasets import make_datasets

    config = yaml.safe_load(open(CONFIG))
    npz = np.load(GOLDEN)
    flat = {k: npz[k] for k in npz.files}
    train_ds, _ = make_datasets(config["dataset"])
    return config, flat, train_ds[len(train_ds) - 1]


def test_whole_probe_path_on_the_trained_s1b_fixture(s1b):
    """encode_prefolded -> render_novel_view_probe at the serving defaults,
    fp32, on the committed trained field, the same draws on both sides."""
    config, flat, item = s1b
    H, W = 48, 96
    imgs, projs, poses = (np.asarray(item[k])[None, :1] for k in ("imgs", "projs", "poses"))
    pose = item["poses"][0] @ _novel_pose((0.27, -0.06, 0.6))
    key = jax.random.PRNGKey(1)
    jfield = j_make_model(config["model"])
    params = {}
    for name, value in flat.items():
        node = params
        for part in name.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[name.split("/")[-1]] = jnp.asarray(value)
    jfs = _j_encode_prefolded(jfield, params, imgs, projs, poses)
    jd, jf, jc = jax.jit(lambda fs: jff.render_novel_view_probe(
        fs, jfield.cfg, jnp.asarray(pose), jnp.asarray(item["projs"][0]), H, W, key))(jfs)

    model = make_model(config["model"], device="cpu")
    load_jax_params(model, flat)
    fs = ff.encode_prefolded(model, _t(imgs), _t(projs), _t(poses), compute_dtype=torch.float32)
    _close(fs.folded_grid, jfs.folded_grid)
    d, f, c = ff.render_novel_view_probe(fs, model.cfg, _t(pose), _t(item["projs"][0]), H, W,
                                         draws=_probe_draws(key, H, W))
    for out, ref in ((d, jd), (f, jf), (c, jc)):
        _close_but_rare_bin_flips(out, ref)
