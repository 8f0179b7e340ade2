"""The S4C baseline on SSCBench and the field heads behind it, the port
against the JAX package on the CPU, on the same numpy-drawn weights carried
across by `utils.convert.from_jax_params`.

- The heads: ResnetFC with residual blocks (relu and beta > 0, a latent
  split, views combined at a layer, by mean and by max) and the "mlp"
  ImplicitNet with skip connections, on (4, 5, 3, d_in) inputs: atol 1e-5.
- A field without colour sampling (relu sigma, sigmoid rgb from the head):
  atol 1e-5.
- `make_model(s4c_baseline_config())` holds exactly the JAX tree's leaves.
- The S4C encode and query at 32x64 (the Monodepth2 encoder, d_hidden 64,
  20 outputs) on one block of 4,096 points, fp32 state on both sides:
  JAX's `make_query_fn(field, "s4c", True)` against the port's, sigma to
  rel 1e-4 (+ atol 1e-5 near zero) and the softmax probabilities to atol
  1e-4; the slow path the same against JAX's slow one.
- `cli.evaluate_sscbench --mode s4c --device cpu --max-frames 1` on a
  seeded tree with a port field snapshot: a finite table in [0, 1].

JAX at "highest" matmul precision, TF32 off, one torch thread.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.cli.evaluate_sscbench import make_query_fn as jmake_query_fn
from scenedino_tpu.models import heads as jheads
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.factory import s4c_baseline_config as j_s4c_config
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_tpu.ops.fast_field import encode_prefolded as jencode_prefolded
from scenedino_torch.cli import evaluate_sscbench
from scenedino_torch.models import heads
from scenedino_torch.models.factory import make_model, s4c_baseline_config
from scenedino_torch.ops.fast_field import encode_prefolded
from scenedino_torch.utils.checkpoint import save_field_snapshot
from scenedino_torch.utils.convert import flatten_params, from_jax_params
from tests.test_torch_sscbench import ssc_tree  # noqa: F401  (the seeded tree fixture)
from tests.test_torch_stage1_branches import _draw_tree

H, W = 32, 64
P = 4096


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


HEADS = {
    "resnet-blocks": {"type": "resnet", "args": {"n_blocks": 2, "d_hidden": 32}},
    "resnet-softplus-latent": {"type": "resnet", "args": {"n_blocks": 3, "d_hidden": 32, "beta": 2.0, "d_latent": 6,
                                                         "combine_layer": 1}},
    "resnet-max": {"type": "resnet", "args": {"n_blocks": 2, "d_hidden": 16, "combine_layer": 1,
                                              "combine_type": "max"}},
    "mlp-skip": {"type": "mlp", "args": {"dims": [24, 24, 24], "skip_in": [1, 2], "combine_layer": 2}},
}


@pytest.mark.parametrize("name", list(HEADS))
def test_head_types_match_jax(name):
    conf = HEADS[name]
    d_in, d_out = 20, 7
    x = np.random.default_rng(1).normal(size=(4, 5, 3, d_in)).astype(np.float32)
    jhead = jheads.make_head(conf, 0, d_out)
    params = _draw_tree(jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))), 3)
    ref = np.asarray(jax.jit(jhead.apply)(params, jnp.asarray(x)))
    head = heads.make_head(conf, d_in, d_out)
    state, skipped = from_jax_params(params["params"])
    assert skipped == []
    head.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = head(_t(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_multi_view_heads_name_their_slice():
    """The multi-view heads are built by type (models.multi_view_head; their
    parity is tests/test_torch_multi_view_head.py's)."""
    from scenedino_torch.models import multi_view_head

    for kind in heads.MULTI_VIEW_HEADS:
        assert isinstance(heads.make_head({"type": kind}, 20, 4), getattr(multi_view_head, kind))


def _imgs(seed, n=1):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, size=(1, n, 3, H, W)).astype(np.float32)
    projs = np.broadcast_to(np.array([[1.2, 0, 0], [0, 1.2 * W / H, 0], [0, 0, 1.0]], np.float32), (1, n, 3, 3))
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (1, n, 4, 4)).copy()
    poses[0, :, 0, 3] = 0.3 * np.arange(n)
    return imgs, np.ascontiguousarray(projs), poses


def _points(seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-8, 8, P), rng.uniform(-2, 2, P), rng.uniform(4, 40, P)], -1).astype(np.float32)


def _carried(conf, seed):
    """(JAX field, its params drawn with numpy, the port's field on them)."""
    jfield = j_make_model(conf)
    imgs, projs, poses = (jnp.asarray(a) for a in _imgs(0))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jfield.init({"params": k, "augment": k}, imgs, projs, poses,
                                                method=JSceneField.warmup))
    params = _draw_tree(shapes, seed)
    field = make_model(conf, device="cpu")
    state, skipped = from_jax_params(params["params"])
    assert skipped == []
    field.load_state_dict(state, strict=True)
    return jfield, params, field.eval()


@pytest.fixture(scope="module")
def s4c():
    return _carried(s4c_baseline_config(), 5)


def test_s4c_config_and_model_are_the_references(s4c):
    assert s4c_baseline_config() == j_s4c_config()
    jfield, params, field = s4c
    assert type(field.encoder).__name__ == "Monodepth2"
    assert sorted(field.state_dict()) == sorted(from_jax_params(params["params"])[0])
    assert len(flatten_params(params["params"])) == len(field.state_dict())
    x = torch.zeros(2, 3, 19)
    assert field.expand_dim(x) is x  # a legacy backbone's features are its own


def test_field_without_colour_sampling_matches_jax():
    conf = {**s4c_baseline_config(), "sample_color": False}
    jfield, params, field = _carried(conf, 6)
    assert field.cfg.d_out == 4
    imgs, projs, poses = _imgs(1, n=2)
    xyz = _points(2)[None, :512]
    ref = jax.jit(lambda p, i, k, c, x: jfield.apply(p, jfield.apply(p, i, k, c, method=JSceneField.encode), x))(
        params, *(jnp.asarray(a) for a in (imgs, projs, poses, xyz)))
    with torch.no_grad():
        out = field(field.encode(_t(imgs), _t(projs), _t(poses)), _t(xyz))
    assert out[3] is None and ref[3] is None
    for name, o, r in zip(("rgb", "invalid", "sigma"), out[:3], ref[:3]):
        assert tuple(o.shape) == r.shape, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow"])
def test_s4c_encode_and_query_match_jax(s4c, fast):
    """One block through `make_query_fn(..., "s4c", fast)` in both packages:
    the fast path is encode_prefolded's two-step fold of the Monodepth2 map
    and the point query (K4's plain version here), the slow path the field."""
    jfield, params, field = s4c
    imgs, projs, poses = _imgs(3)
    pts = _points(4)

    def jquery(p, i, k, c, x):
        if fast:
            state = jencode_prefolded(jfield, p, i, k, c, ids_encoder=(0,), ids_render=(0,),
                                      compute_dtype=jnp.float32)
        else:
            state = jfield.apply(p, i, k, c, ids_encoder=(0,), ids_render=(0,), method=JSceneField.encode)
        return jmake_query_fn(jfield, "s4c", fast)(x[None], {"vars": p, "state": state})

    jsigma, jprobs = jax.jit(jquery)(params, *(jnp.asarray(a) for a in (imgs, projs, poses, pts)))
    with torch.no_grad():
        args = (_t(imgs), _t(projs), _t(poses))
        state = (encode_prefolded(field, *args, ids_encoder=(0,), ids_render=(0,), compute_dtype=torch.float32)
                 if fast else field.encode(*args, ids_encoder=(0,), ids_render=(0,)))
        if fast:
            assert state.folded_grid.shape == (1, 1, H, W, 64) and state.w2.shape == (64, 20)
        sigma, probs = evaluate_sscbench.make_query_fn(field, None, "s4c", fast)(_t(pts)[None], state)
    assert sigma.shape == (1, P) and probs.shape == (1, P, 19)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(sigma.std()) > 0 and float(probs.std()) > 0  # the comparison sees varied values


def test_cli_evaluates_the_s4c_baseline_on_the_cpu(ssc_tree, tmp_path, capsys):  # noqa: F811
    field = make_model(s4c_baseline_config(), device="cpu", seed=7)
    ckpt = tmp_path / "s4c.pt"
    save_field_snapshot(str(ckpt), field)
    table, acc = evaluate_sscbench.main(["--data", str(ssc_tree), "--voxel-gt", str(ssc_tree / "voxel_gt"),
                                         "--ckpt", str(ckpt), "--mode", "s4c", "--resolution", str(H), str(W),
                                         "--device", "cpu", "--max-frames", "1"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(table))
    assert sorted(table) == ["12.8", "25.6", "51.2", "sec_per_frame"]
    for size in ("12.8", "25.6", "51.2"):
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in table[size].values())
    r = acc.results[51.2]
    assert r["tp"] + r["fp"] + r["tn"] + r["fn"] > 0
