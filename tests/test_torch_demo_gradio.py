"""The interactive demo's runner (`scenedino_torch/cli/demo_gradio.py`) and
the dummy encoders (`models/dummy.py`, `models/field.EncoderDummy`)
against the JAX package's on the CPU.

The field is tests/test_demo_gradio.py's: a `DinoDummyEncoder` at 16x32
(8-d map, 12-d teacher, patch 4, 6-d field feature) with the default head
and a semantic head of 5 clusters over 4 classes, its weights drawn with
numpy in JAX's layout (the pseudo assignment as seeded class ids) and
carried across by `utils.convert` (strict). `demo_run` in each of the five
modes on a 9x9x9 grid (0.5 m), the 2D strata from JAX's key: the panel
and the PLY as JAX's. JAX's field runs jitted, and its 2D render and grid
query run once and are reused by every mode (they do not depend on it), as
is its PCA of one set of features. Panels: the PCA panels within one level of 255 (the features agree to
fp32 round-off), the class panels equal; the PLY: the same header, vertices,
faces and colours (PCA colours within one level). The voxel guard and the
gradio gate raise as JAX's. The dummy encoders: every output against
JAX's, atol 1e-6. fp32, JAX at "highest" matmul precision.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.cli.demo as jdemo
import scenedino_tpu.cli.demo_gradio as J
import scenedino_tpu.eval.vis2d as jvis2d
import scenedino_tpu.renderer.nerf as jnerf
from scenedino_tpu.models.downstream import SemanticHead as JSemanticHead
from scenedino_tpu.models.downstream import SemanticHeadConfig as JSemanticHeadConfig
from scenedino_tpu.models.dummy import DinoDummyEncoder as JDinoDummyEncoder
from scenedino_tpu.models.field import EncoderDummy as JEncoderDummy
from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_torch.cli import demo_gradio as G
from scenedino_torch.datasets.image_io import write_png
from scenedino_torch.models import EncoderDummy
from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
from scenedino_torch.models.dummy import DinoDummyEncoder
from scenedino_torch.models.field import FieldConfig, SceneField
from scenedino_torch.utils.convert import from_jax_params, load_jax_head, load_jax_params
from tests.test_torch_stage1_branches import _draw_tree

H, W = 16, 32
ENC = dict(feat_dim=8, dino_dim=12, patch_size=4, dino_pca_dim=6)
HEAD = dict(n_classes=5, gt_classes=4, input_dim=12, code_dim=8)
GRID = dict(sigma_threshold=0.05, resolution=0.5, x_range=2.0, y_range=2.0, z_range=4.0, image_size=(H, W))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Jitted:
    """A flax module whose `apply` runs under jax.jit (the demo's JAX
    functions call it eagerly); the demo's head call, a lambda `method` with
    the mode as its last positional argument, is jitted with the mode fixed."""

    def __init__(self, module):
        self.downstream, self.module = module.downstream, module
        self._apply = jax.jit(module.apply, static_argnames=("only_density", "method", "mode", "ids_encoder"))

    def apply(self, *args, method=None, **kwargs):
        if method is not None and method.__name__ == "<lambda>":
            *arrays, mode = args
            return jax.jit(lambda *a: self.module.apply(*a, mode, method=method))(*arrays)
        return self._apply(*args, method=method, **kwargs)


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    jfield = JSceneField(encoder=JDinoDummyEncoder(size=(H, W), **ENC), cfg=JFieldConfig(dino_dims=6),
                         downstream=JSemanticHead(cfg=JSemanticHeadConfig(**HEAD)))
    z = (jnp.zeros((1, 1, 3, H, W)), jnp.zeros((1, 1, 3, 3)), jnp.zeros((1, 1, 4, 4)))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jfield.init({"params": k, "augment": k}, *z, method=JSceneField.warmup))
    params = _draw_tree({"params": shapes["params"]}, 4)["params"]
    rng = np.random.default_rng(5)
    state = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.integers(0, HEAD["gt_classes"], s.shape), s.dtype),
                                   shapes["state"])
    variables = {"params": params, "state": state}

    field = SceneField(DinoDummyEncoder((H, W), **ENC), FieldConfig(dino_dims=6)).eval()
    load_jax_params(field, {k_: v for k_, v in params.items() if k_ != "downstream"})
    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, {"params": params["downstream"], "state": state["downstream"]})
    head.eval()
    png = str(tmp_path_factory.mktemp("demo") / "demo.png")
    write_png(png, (np.random.default_rng(0).random((H, W, 3)) * 255).astype(np.uint8))
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.split(jax.random.PRNGKey(0), 5)[0], (H * W, 32))))
    return dict(jfield=jfield, variables=variables, field=field, head=head, png=png, u=u)


@pytest.fixture(scope="module")
def jax_runs(fields, tmp_path_factory):
    """JAX's demo_run in every mode: (panel, PLY bytes)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnerf, "render_rays_chunked", jax.jit(jnerf.render_rays_chunked,
                                                     static_argnames=("field_fn", "cfg", "chunk")))
    cache = {}
    for name in ("inference_rendered_2d", "inference_3d"):
        fn = getattr(jdemo, name)

        def once(*a, _fn=fn, _name=name, **kw):
            key = (_name, kw.get("mode"))
            if key not in cache:
                cache[key] = _fn(*a, **kw)
            return cache[key]

        mp.setattr(jdemo, name, once)
    mp.setattr(tempfile, "tempdir", str(tmp_path_factory.mktemp("jax_ply")))
    pca = jvis2d.get_dino_pca  # the PCA modes colour the PLY alike: one PCA of the same features

    def pca_once(features, fit_on=None, from_dim=0, _seen={}):
        key = (np.asarray(features).tobytes(), from_dim)
        if key not in _seen:
            _seen[key] = pca(features, fit_on, from_dim)
        return _seen[key]

    mp.setattr(jvis2d, "get_dino_pca", pca_once)
    runs = {}
    try:
        jfield = _Jitted(fields["jfield"])
        for mode in J.MODES:
            vis, ply = J.demo_run(jfield, fields["variables"], fields["png"], mode=mode, **GRID)
            with open(ply, "rb") as f:
                runs[mode] = (vis, f.read())
    finally:
        mp.undo()
    return runs


def _ply(data):
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    nv = int(next(line for line in lines if line.startswith("element vertex")).split()[-1])
    nf = int(next(line for line in lines if line.startswith("element face")).split()[-1])
    v = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=nv)
    f = np.frombuffer(body, dtype=[("n", "u1"), ("idx", "<i4", 3)], count=nf, offset=v.nbytes)
    return head, v, f


@pytest.mark.parametrize("mode", G.MODES)
def test_demo_run_matches_jax(fields, jax_runs, mode, tmp_path, monkeypatch):
    assert G.MODES == J.MODES and G.MAX_VOXEL_COUNT == J.MAX_VOXEL_COUNT
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    vis, ply = G.demo_run(fields["field"], fields["head"], fields["png"], mode=mode, u=fields["u"], **GRID)
    assert os.path.dirname(ply) == str(tmp_path)
    ref_vis, ref_ply = jax_runs[mode]
    assert vis.shape == ref_vis.shape == (H, W, 3) and vis.dtype == np.uint8
    diff = np.abs(vis.astype(int) - ref_vis.astype(int))
    if mode.startswith("SSC"):
        assert diff.max() == 0 and len(np.unique(vis.reshape(-1, 3), axis=0)) > 1
    else:
        assert diff.max() <= 1
    with open(ply, "rb") as f:
        head, v, faces = _ply(f.read())
    ref_head, ref_v, ref_faces = _ply(ref_ply)
    assert head == ref_head and len(v) > 0
    np.testing.assert_array_equal(v["xyz"], ref_v["xyz"])
    np.testing.assert_array_equal(faces, ref_faces)
    cdiff = np.abs(v["rgb"].astype(int) - ref_v["rgb"].astype(int)).max()
    assert cdiff == 0 if mode.startswith("SSC") else cdiff <= 1
    if mode.startswith("SSC"):
        assert v["rgb"].max() > 16  # the palette is [0, 1]: not divided again


def test_voxel_guard_and_gradio_gate(fields):
    for run, field, head in ((G.demo_run, fields["field"], fields["head"]),
                             (J.demo_run, fields["jfield"], fields["variables"])):
        with pytest.raises(ValueError, match="Too many voxels"):
            run(field, head, fields["png"], resolution=0.05, x_range=50.0, y_range=50.0, z_range=100.0,
                image_size=(H, W))
    try:
        import gradio  # noqa: F401

        pytest.skip("gradio installed")
    except ImportError:
        with pytest.raises(ImportError, match="gradio"):
            G._require_gradio()


def test_dummy_encoders_match_jax():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 3, H, W)).astype(np.float32))
    feats = rng.normal(size=(2, 5, 6)).astype(np.float32)
    pix = rng.normal(size=(2, 3, H, W, 1, 12)).astype(np.float32)
    jenc = JDinoDummyEncoder(size=(H, W), **ENC)

    def touch(m, x, f, p):
        return m(x), m(x, ground_truth=True), m.expand_dim(f), m.downsample(p, "image")

    k = jax.random.PRNGKey(0)
    params = _draw_tree(jax.eval_shape(lambda: jenc.init(k, x, feats, pix, method=touch)), 2)
    ref = jax.jit(lambda p: jenc.apply(p, x, feats, pix, method=touch))(params)
    enc = DinoDummyEncoder((H, W), **ENC)
    enc.load_state_dict(from_jax_params(params["params"])[0], strict=True)
    with torch.no_grad():
        out = (enc(_t(x))[0], enc(_t(x), ground_truth=True)[0], enc.expand_dim(_t(feats)),
               enc.downsample(_t(pix), "image"))
    for o, r in zip(out, (ref[0][0], ref[1][0], ref[2], ref[3])):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)
    assert enc.latent_size == 8 and enc.gt_patch_size == 4 and enc.teacher.latent_size == 12
    assert not enc(_t(x), ground_truth=True)[0].requires_grad

    jplain = JEncoderDummy(size=(H, W), feat_dim=5)
    pparams = _draw_tree(jax.eval_shape(lambda: jplain.init(k, x)), 3)
    plain = EncoderDummy((H, W), feat_dim=5)
    plain.load_state_dict(from_jax_params(pparams["params"])[0], strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(plain(_t(x)).detach().numpy(), np.asarray(jplain.apply(pparams, x)))
    assert plain.expand_dim(_t(feats)) is not None and plain.latent_size == 0
