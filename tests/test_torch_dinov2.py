"""The DINOv2 encoder family in the port against the JAX package on the
CPU, on the same numpy-drawn weights and inputs:

  * `core.resize.jax_resize` against `jax.image.resize(...,
    "bilinear")` at 192x640 -> 168x560 (the DINOv2 pre-resize) and at an
    odd size, on ImageNet-normalized images (|x| < 2.7): values within
    1e-6 (float32 weights built as JAX builds them, summed in another
    order), and its gradient within 1e-6;
  * `DinoViTEncoder` for v2, reg and fit3d (a ViT-S/14 cut to width 64,
    depth 3, 2 heads, the 37x37 position embedding resized to 2x4,
    LayerScale, 4 registers for reg and fit3d) at 32x64 -> 28x56: every
    grid within the encoder tests' atol 1e-4 / rtol 1e-4;
  * the external patch sizes (`DinoViTEncoder.patch_size`,
    `DinoModule.gt_patch_size`) equal to JAX's for v1, v1_16, v2, reg and
    fit3d;
  * `OrthogonalLinearDimReduction` within 1e-5, and a tiny field with the
    learned empty feature (points outside the views take it) on encode
    and on a query within 1e-4;
  * a tiny v2 field (student and teacher) on encode with the teacher's
    loss features within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.models.encoder as jenc
import scenedino_tpu.models.factory as jfactory
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_torch.core.resize import jax_resize
from scenedino_torch.models import encoder, factory
from scenedino_torch.models.factory import make_model
from scenedino_torch.utils.convert import load_jax_params
from tests.test_torch_models import TOL, _random_params
from tests.test_torch_training import MODEL, _batch, _jbatch, _tbatch
from tests.test_torch_training import _random_params as _field_params

VERSIONS = ("v2", "reg", "fit3d")
TINY_VIT = (("depth", 3), ("num_heads", 2), ("width", 64))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _normalized_images(seed, shape):
    x = np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)
    return encoder.normalize_input(_t(x)).numpy()


@pytest.mark.parametrize("shape,size", [((1, 3, 192, 640), (168, 560)), ((2, 3, 37, 61), (23, 53))],
                         ids=["192x640", "odd"])
def test_antialias_resize_matches_jax_image_resize(shape, size):
    x = _normalized_images(0, shape)
    ref = jax.image.resize(jnp.asarray(x), (*shape[:2], *size), "bilinear")
    xt = _t(x).requires_grad_(True)
    out = jax_resize(xt, size, "bilinear")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # the gradient: the transposed matrices on the upstream gradient
    g = np.random.default_rng(1).normal(size=(*shape[:2], *size)).astype(np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(jax.image.resize(a, (*shape[:2], *size), "bilinear") * g))(jnp.asarray(x))
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=0)
    # the antialias is not optional: a plain bilinear resize lands far away
    plain = torch.nn.functional.interpolate(_t(x), size, mode="bilinear", align_corners=False)
    assert (plain - out.detach()).abs().max() > 1e-2


@pytest.mark.parametrize("version", VERSIONS)
def test_dino_vit_encoder_matches_reference(version):
    kw = dict(backbone="vit-s", version=version, intermediate_features=(0, 1, 2), vit_overrides=TINY_VIT)
    jmodel = jenc.DinoViTEncoder(**kw, image_size=(32, 64))
    x = np.random.default_rng(2).uniform(-1, 1, size=(2, 3, 32, 64)).astype(np.float32)
    params = _random_params(jmodel, 4, jnp.asarray(x))
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x))

    model = encoder.DinoViTEncoder(**kw)
    load_jax_params(model, params["params"])
    out = model(_t(x))
    assert len(out) == len(ref) == 4
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape == (2, 64, 2, 4)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), err_msg=f"grid {i}", **TOL)
    assert model.patch_size == jmodel.patch_size == 16
    assert model.vit.cfg.num_registers == (0 if version == "v2" else 4) and model.vit.cfg.layerscale


@pytest.mark.parametrize("version", ("v1", "v1_16") + VERSIONS)
def test_patch_sizes_match_reference(version):
    assert encoder.DinoViTEncoder(version=version, vit_overrides=TINY_VIT).patch_size == \
        jenc.DinoViTEncoder(version=version).patch_size
    for student in ("v1", version):
        cfg = dict(version=student, separate_gt_version=version)
        assert encoder.DinoModule(encoder.DinoModuleConfig(**cfg, vit_overrides=TINY_VIT)).gt_patch_size == \
            jenc.DinoModule(cfg=jenc.DinoModuleConfig(**cfg)).gt_patch_size
    no_teacher = dict(version=version, separate_gt_version=None)
    assert encoder.DinoModule(encoder.DinoModuleConfig(**no_teacher, vit_overrides=TINY_VIT)).gt_patch_size == \
        jenc.DinoModule(cfg=jenc.DinoModuleConfig(**no_teacher)).gt_patch_size


def test_orthogonal_dim_reduction_matches_reference():
    jmodel = jenc.OrthogonalLinearDimReduction(full_channels=48, reduced_channels=8)
    feats = np.random.default_rng(3).normal(size=(2, 5, 8)).astype(np.float32)
    params = _random_params(jmodel, 5, jnp.asarray(feats))
    model = encoder.OrthogonalLinearDimReduction(8, 48)
    load_jax_params(model, params["params"])
    ref = jmodel.apply(params, jnp.asarray(feats))
    np.testing.assert_allclose(model(_t(feats)).detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # initialized as the reference's: the identity's first columns, no bias
    init = encoder.OrthogonalLinearDimReduction(8, 48)
    assert torch.equal(init.weights, torch.eye(48, 8)) and not init.bias.any()


def _field_pair(conf):
    jfield = j_make_model(conf)
    params = _field_params(jfield, _batch())
    model = make_model(conf, device="cpu", training=True)
    assert load_jax_params(model, params["params"]) == []
    return jfield, params, model


def test_learned_empty_feature_and_orthogonal_expansion_match_reference():
    conf = {**MODEL, "learn_empty": True,
            "encoder": {**MODEL["encoder"], "dim_reduction_arch": "orthogonal-linear"}}
    jfield, params, model = _field_pair(conf)
    assert model.empty_feature.shape == (16,) and "empty_feature" in params["params"]
    batch = _batch(4)
    jb, tb = _jbatch(batch), _tbatch(batch)
    kw = dict(ids_encoder=(0, 1), ids_render=(2,))
    with torch.no_grad():
        state = model.encode(tb["imgs"], tb["projs"], tb["poses"], **kw)
        # points in front of the cameras and behind them: the latter are outside every view
        xyz = np.random.default_rng(5).uniform([-4, -2, -20], [4, 2, 30], size=(2, 64, 3)).astype(np.float32)
        rgb, invalid, sigma, dino = model(state, _t(xyz))
        full = model.expand_dim(dino)
    def jquery(p, imgs, projs, poses, pts):  # compiled once: op by op the encode takes most of the test
        out = jfield.apply(p, jfield.apply(p, imgs, projs, poses, method=JSceneField.encode, **kw), pts)
        return out + (jfield.apply(p, out[3], method=JSceneField.expand_dim),)

    jrgb, jinvalid, jsigma, jdino, jfull = jax.jit(jquery)(params, jb["imgs"], jb["projs"], jb["poses"],
                                                           jnp.asarray(xyz))
    assert 0 < invalid.mean() < 1  # both kinds of points are present
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(jinvalid))
    for name, a, b in (("rgb", rgb, jrgb), ("sigma", sigma, jsigma), ("dino", dino, jdino), ("768", full, jfull)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


def test_dinov2_field_encode_matches_reference():
    conf = {**MODEL, "encoder": {**MODEL["encoder"], "version": "v2", "separate_gt_version": "v2"}}
    jfield, params, model = _field_pair(conf)
    assert model.encoder.gt_patch_size == jfield.encoder.gt_patch_size == 16
    assert model.encoder.downsampler.patch_size == 16
    batch = _batch(6)
    jb, tb = _jbatch(batch), _tbatch(batch)
    kw = dict(ids_encoder=(0,), ids_render=(1,), ids_loss=(0, 3))
    ref = jax.jit(lambda p, i, k, c: jfield.apply(p, i, k, c, with_loss_feats=True, method=JSceneField.encode,
                                                  **kw))(params, jb["imgs"], jb["projs"], jb["poses"])
    with torch.no_grad():
        state = model.encode(tb["imgs"], tb["projs"], tb["poses"], with_loss_feats=True, **kw)
    assert state.loss_feats.shape == (2, 2, 64, 2, 4)
    for name in ("feat_grid", "loss_feats"):
        np.testing.assert_allclose(getattr(state, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_dinov2_preset_is_the_references():
    assert factory.scenedino_dinov2_config() == jfactory.scenedino_dinov2_config()
    for variant in ("dino", "dinov2"):
        conf = factory.variant_config(variant, (96, 320))
        ref = jfactory.SCENEDINO_KITTI_360 if variant == "dino" else jfactory.scenedino_dinov2_config()
        assert conf == {**ref, "encoder": {**ref["encoder"], "image_size": (96, 320)}}
    with pytest.raises(ValueError, match="variant"):
        factory.variant_config("dinov3")
