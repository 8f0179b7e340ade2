"""Parity of the port's encoder stack (scenedino_torch.models) with the JAX
reference on the CPU, at small widths, on the same weights.

The JAX modules are initialized from a seed, their parameter trees go
through `scenedino_torch.utils.convert.load_jax_params` (strict), and the
same numpy inputs go through both sides in fp32. The JAX side runs under
"highest" matmul precision; on the CPU its attention is
jax.nn.dot_product_attention, the plain reference of the Pallas kernel,
and the port's is its counterpart `vit.dot_product_attention`. Tolerance: atol 1e-4 / rtol 1e-4 on
activations of order 1 after 3 blocks or a DPT stack (fp32 round-off,
summed in another order by XLA and by torch's CPU kernels).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.models.dpt as jdpt
import scenedino_tpu.models.encoder as jenc
import scenedino_tpu.models.factory as jfactory
import scenedino_tpu.models.heads as jheads
import scenedino_tpu.models.vit as jvit
from scenedino_torch.kernels import attention
from scenedino_torch.kernels.attention import attention_plain
from scenedino_torch.models import dpt, encoder, factory, heads, vit
from scenedino_torch.utils.convert import load_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _random_params(module, seed, *args, **kwargs):
    """A seeded random parameter tree of the JAX module's shape (from
    eval_shape: no init is run). Kernels ~ N(0, 1/fan_in), LayerNorm scales
    ~ 1, LayerScale ~ 0.3, everything else (biases, tokens) ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(x / np.sqrt(np.prod(leaf.shape[:-1])))
        if "scale" in name:
            return jnp.asarray(1.0 + 0.1 * x)
        if "ls" in name:
            return jnp.asarray(0.3 + 0.1 * x)
        return jnp.asarray(0.1 * x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("n", [7, 65])
def test_attention_plain_matches_dot_product_attention(n):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, n, 3, 64)).astype(np.float32) for _ in range(3))
    ref = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = attention.launches
    out = attention(_t(q), _t(k), _t(v))  # CPU tensors take the plain version
    assert attention.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(attention_plain(_t(q), _t(k), _t(v)).numpy(), out.numpy())
    with pytest.raises(ValueError):
        attention(_t(q), _t(k)[:, :-1], _t(v))


@pytest.mark.parametrize("preset,image", [("dino_small8", (32, 64)), ("dinov2_reg_small", (28, 56))])
def test_tiny_vit_matches_reference(preset, image):
    """width 64, depth 3, 2 heads; the DINOv2-reg case adds registers,
    LayerScale and the bicubic pos-embed resize from a 37x37 grid."""
    jcfg = dataclasses.replace(jvit.VIT_PRESETS[preset], width=64, depth=3, num_heads=2,
                               intermediate_layers=(0, 1, 2))
    jmodel = jvit.VisionTransformer(cfg=jcfg, want_key_features=True)
    x = np.random.default_rng(1).normal(size=(2, 3, *image)).astype(np.float32)
    params = _random_params(jmodel, 0, jnp.asarray(x))
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x))

    model = vit.make_vit(preset, intermediate_layers=(0, 1, 2), want_key_features=True,
                         overrides={"width": 64, "depth": 3, "num_heads": 2})
    load_jax_params(model, params["params"])
    out = model(_t(x))
    assert sorted(out) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(out[name].detach().numpy(), np.asarray(ref[name]), err_msg=name, **TOL)


def _dpt_inputs(rng, c=64, grid=(4, 8)):
    return [rng.normal(size=(1, c, *grid)).astype(np.float32) for _ in range(4)]


def test_dpt_head_matches_reference():
    rng = np.random.default_rng(2)
    xs = _dpt_inputs(rng)
    jmodel = jdpt.DPTHead(post_process_channels=(8, 8, 16, 16), d_out=16)
    params = _random_params(jmodel, 1, [jnp.asarray(a) for a in xs])
    ref = jax.jit(jmodel.apply)(params, [jnp.asarray(a) for a in xs])[0]

    model = dpt.DPTHead(64, (8, 8, 16, 16), 16)
    load_jax_params(model, params["params"])
    out = model([_t(a) for a in xs])[0]
    assert out.shape == (1, 16, 64, 128)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_fold", [False, True])
def test_foldable_conv_matches_reference(with_fold):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 6, 7, 16)).astype(np.float32)  # NHWC for the JAX side
    fold = rng.normal(size=(16, 5)).astype(np.float32) if with_fold else None
    jmodel = jdpt._FoldableConv3x3(16)
    params = _random_params(jmodel, 2, jnp.asarray(x))
    ref = jmodel.apply(params, jnp.asarray(x), fold=None if fold is None else jnp.asarray(fold))

    model = dpt._FoldableConv3x3(16, 16)
    load_jax_params(model, params["params"])
    out = model(_t(x).permute(0, 3, 1, 2), fold=None if fold is None else _t(fold))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    if with_fold:  # the fold equals the unfolded conv followed by the matrix
        plain = model(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1) @ _t(fold)
        np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), plain.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_dino_module_student_matches_reference():
    common = dict(
        encoder_arch="vit-s", version="v1", num_ch_enc=(8, 8, 16, 16), decoder_out_dim=16,
        intermediate_features=(0, 1, 2),
        vit_overrides=(("depth", 3), ("num_heads", 2), ("width", 64)),
    )
    jmodel = jenc.DinoModule(cfg=jenc.DinoModuleConfig(**common, image_size=(32, 64)))
    x = np.random.default_rng(4).uniform(-1, 1, size=(2, 3, 32, 64)).astype(np.float32)
    params = _random_params(jmodel, 3, jnp.asarray(x))  # student path only
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x))[0]

    model = encoder.DinoModule(encoder.DinoModuleConfig(**common))
    load_jax_params(model, params["params"])
    out = model(_t(x))[0]
    assert out.shape == ref.shape == (2, 16, 64, 128)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_resnetfc_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 10, 1, 20)).astype(np.float32)
    jmodel = jheads.ResnetFC(d_out=9, n_blocks=0, d_hidden=32)
    params = _random_params(jmodel, 4, jnp.asarray(x))
    model = heads.ResnetFC(20, 9, 32)
    load_jax_params(model, params["params"])
    np.testing.assert_allclose(model(_t(x)).detach().numpy(), np.asarray(jmodel.apply(params, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    assert heads.make_head({"type": "resnet", "args": {"n_blocks": 2}}, 20, 9).n_blocks == 2  # tests/test_torch_s4c.py
    from scenedino_torch.models.multi_view_head import MultiViewHead

    assert isinstance(heads.make_head({"type": "MultiViewHead"}, 20, 9), MultiViewHead)
    with pytest.raises(ValueError):
        heads.make_head({"type": "no_such_head"}, 20, 9)


def test_flagship_config_is_the_references():
    assert factory.SCENEDINO_KITTI_360 == jfactory.SCENEDINO_KITTI_360
    assert vit.VIT_PRESETS.keys() == jvit.VIT_PRESETS.keys()
    for name, cfg in vit.VIT_PRESETS.items():
        jcfg = jvit.VIT_PRESETS[name]
        for field in ("patch_size", "width", "depth", "num_heads", "mlp_ratio", "num_registers",
                      "layerscale", "class_token", "ln_eps", "pos_embed_size", "intermediate_layers"):
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)
