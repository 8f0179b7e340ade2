"""Parity of the port's serving path (scenedino_torch.ops.fast_field over the
K2 op) with the JAX reference on the CPU.

Both sides get the same numbers: the folded state (random, or from the
trained s1b fixture through both encoders) and the same stratum draws,
`jax.random.uniform(jax.random.split(key, 5)[0], (R, K))`, which is what
`render_novel_view_fused` draws inside (fast_field.py:581,
sampling.py:25). On the CPU the K2 op runs its plain version.

Tolerances: fp32 runs hold depth, feature and colour to rtol 1e-4 and an
atol of 1e-4, or of 1e-5 x the largest magnitude where that is larger
(the trained field's features reach ~100, and a feature that nearly
cancels to 0 keeps the round-off of its large terms). That is fp32
round-off after a ViT, a DPT stack, the fold, the MLP and compositing,
summed in other orders. bf16 runs round the grid, code, hidden layer and
colour image to bf16 on both sides; they agree except where a value sits
on a bf16 rounding boundary and where the reference blends colours in
bf16 while the port blends in fp32, so they hold depth to 1e-3 relative,
the feature to cosine >= 0.999 per ray and colours to 1e-2 absolute (a
few bf16 ulps of a value in [0, 1]).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.kernels import point_render
from scenedino_torch.models.factory import make_model
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops.fast_field import FastFieldState, build_fast_state, render_novel_view_fused
from scenedino_torch.utils.convert import TRAINING_ONLY, load_jax_params

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "s1b_field_params.npz"
CONFIG = pathlib.Path(__file__).parent.parent / "configs" / "train_synthetic_convergence.yaml"
K_NDC = np.array([[0.7, 0.0, 0.0], [0.0, 2.3, 0.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _novel_pose(shift=(0.3, -0.1, 0.0)):
    c, s = np.cos(0.05), np.sin(0.05)
    return np.array([[c, 0, s, shift[0]], [0, 1, 0, shift[1]], [-s, 0, c, shift[2]], [0, 0, 0, 1]], np.float32)


def _draws(key, R, K):
    return np.asarray(jax.random.uniform(jax.random.split(key, 5)[0], (R, K)))


def _assert_fp32_close(out, ref):
    ref = np.asarray(ref, np.float32)
    atol = max(1e-4, 1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(out), ref, atol=atol, rtol=1e-4)


def _cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)


def _random_state(rng, H, W, D=16, E=9, dtype="fp32"):
    """A folded state with random grid and weights, encode camera at the
    origin, values rounded to `dtype` so both sides see the same numbers."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def arr(x, dt=jdt):
        return jnp.asarray(x.astype(np.float32)).astype(dt)

    eye = np.eye(4, dtype=np.float32)[None, None]
    b2 = rng.normal(size=E) * 0.2
    b2[0] += 0.5
    return jff.FastFieldState(
        folded_grid=arr(rng.normal(size=(1, 1, 2 * H, 2 * W, D))),
        w_code=arr(rng.normal(size=(39, D)) * 0.3),
        b1=arr(rng.normal(size=D) * 0.1, jnp.float32),
        w2=arr(rng.normal(size=(D, E)) * 0.3),
        b2=arr(b2, jnp.float32),
        feat_ks=jnp.asarray(K_NDC)[None, None],
        feat_w2c=jnp.asarray(eye),
        color_imgs=arr(rng.uniform(size=(1, 1, H, W, 3))),
        color_ks=jnp.asarray(K_NDC)[None, None],
        color_w2c=jnp.asarray(eye),
    )


def _to_port(jfs) -> FastFieldState:
    def conv(x):
        dt = torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
        return _t(np.asarray(x.astype(jnp.float32)), dt)

    return FastFieldState(*(None if getattr(jfs, f) is None else conv(getattr(jfs, f))
                            for f in FastFieldState._fields))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_point_render_plain_matches_reference(dtype):
    H, W, K = 8, 16, 32
    jfs = _random_state(np.random.default_rng(0), H, W, dtype=dtype)
    cfg = JFieldConfig(dino_dims=8)
    pose, key = _novel_pose(), jax.random.PRNGKey(3)
    jd, jf, jc = jax.jit(
        lambda fs: jff.render_novel_view_fused(fs, cfg, jnp.asarray(pose), jnp.asarray(K_NDC), H, W, key, n_coarse=K)
    )(jfs)
    before = point_render.launches
    d, f, c = render_novel_view_fused(_to_port(jfs), FieldConfig(dino_dims=8), _t(pose), _t(K_NDC), H, W,
                                      u=_t(_draws(key, H * W, K)), n_coarse=K)
    assert point_render.launches == before  # CPU tensors take the plain version
    jd, jf, jc = (np.asarray(a, np.float32) for a in (jd, jf, jc))
    assert d.shape == (H, W) and f.shape == (H, W, 8) and c.shape == (H, W, 3)
    if dtype == "fp32":
        for out, ref in ((d, jd), (f, jf), (c, jc)):
            _assert_fp32_close(out, ref)
    else:
        np.testing.assert_allclose(d.numpy(), jd, rtol=1e-3)
        assert _cosine(f.numpy(), jf).min() >= 0.999
        np.testing.assert_allclose(c.numpy(), jc, atol=1e-2)
    assert np.all((jd >= 3.0) & (jd <= 80.0))


def test_point_render_rejects_bad_shapes():
    jfs = _random_state(np.random.default_rng(1), 4, 8)
    fs = _to_port(jfs)
    with pytest.raises(ValueError):
        render_novel_view_fused(fs._replace(w_code=fs.w_code[:-1]), FieldConfig(dino_dims=8), _t(_novel_pose()),
                                _t(K_NDC), 4, 8, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        render_novel_view_fused(fs, FieldConfig(dino_dims=8), _t(_novel_pose()), _t(K_NDC), 4, 8,
                                u=torch.zeros(4 * 8, 16), n_coarse=32)


@pytest.fixture(scope="module")
def s1b():
    from scenedino_tpu.datasets import make_datasets

    config = yaml.safe_load(open(CONFIG))
    npz = np.load(GOLDEN)
    flat = {k: npz[k] for k in npz.files}
    train_ds, _ = make_datasets(config["dataset"])
    return config, flat, train_ds[len(train_ds) - 1]


def test_whole_slice_on_the_trained_s1b_fixture(s1b):
    """encode -> build_fast_state -> render_novel_view_fused, fp32, on the
    committed trained field, same draws on both sides."""
    config, flat, item = s1b
    H, W, K = 48, 96, 32
    imgs, projs, poses = (np.asarray(item[k])[None, :1] for k in ("imgs", "projs", "poses"))
    pose = item["poses"][0] @ _novel_pose((0.27, -0.06, 0.6))
    key = jax.random.PRNGKey(0)

    jfield = j_make_model(config["model"])
    params = {}
    for name, value in flat.items():
        node = params
        for part in name.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[name.split("/")[-1]] = jnp.asarray(value)
    jstate = jax.jit(lambda p, i, k, c: jfield.apply(p, i, k, c, ids_encoder=(0,), method=JSceneField.encode))(
        params, jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(poses))
    jfs = jff.build_fast_state(params, jstate, jfield.cfg, compute_dtype=jnp.float32)
    jd, jf, jc = jax.jit(lambda fs: jff.render_novel_view_fused(
        fs, jfield.cfg, jnp.asarray(pose), jnp.asarray(item["projs"][0]), H, W, key, n_coarse=K))(jfs)

    model = make_model(config["model"], device="cpu")
    skipped = load_jax_params(model, flat)
    assert skipped and all(any(s.startswith(p + "/") for p in TRAINING_ONLY) for s in skipped)
    with torch.inference_mode():  # a serving request builds no graph
        state = model.encode(_t(imgs), _t(projs), _t(poses), ids_encoder=(0,))
    _assert_fp32_close(state.feat_grid, jstate.feat_grid)
    fs = build_fast_state(model, state, compute_dtype=torch.float32)
    _assert_fp32_close(fs.folded_grid, jfs.folded_grid)
    d, f, c = render_novel_view_fused(fs, model.cfg, _t(pose), _t(item["projs"][0]), H, W,
                                      u=_t(_draws(key, H * W, K)), n_coarse=K)
    for out, ref in ((d, jd), (f, jf), (c, jc)):
        _assert_fp32_close(out, ref)
