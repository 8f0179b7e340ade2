"""A SceneField with a `MultiViewHead` through one stage-1 training step,
the port against the JAX package on the CPU.

tests/test_torch_training.py's tiny flagship (ViT-S/8 cut to width 64,
depth 3, 2 heads; DPT to 16; 32x64 images, B = 2, V = 4; 256 rays in 8x8
patches, 8 coarse samples) with its head replaced by a MultiViewHead (an
"ff" embedding to 16, the fixed readout token, one attention layer of 2
heads, the additive float mask), the student encoding views 0 and 1 (the
port's `TrainConfig.ids_encoder`; JAX's step encodes view 0, so its
`SceneField.encode` is called with ids_encoder=(0, 1) for this test). The
weights are drawn with numpy in JAX's layout and carried across by
`utils.convert` (strict); the draws are the JAX step's, rebuilt from its
key. The loss dict to rtol 1e-5; every parameter's gradient and the
artifact field's to 1e-3 of its L2 norm (tests/test_torch_training.py's
bounds), the head's gradients live. JAX's forward and gradient run in
one jitted call. fp32, "highest" matmul precision.
"""
import jax
import numpy as np
import pytest
import torch

import scenedino_tpu.losses.reconstruction as jrec
import scenedino_tpu.renderer.nerf as jnerf
import scenedino_tpu.training.trainer as jtrain
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_torch.losses import reconstruction as rec
from scenedino_torch.models.factory import make_model
from scenedino_torch.models.multi_view_head import MultiViewHead
from scenedino_torch.renderer.nerf import RenderConfig
from scenedino_torch.training import trainer
from scenedino_torch.utils.convert import artifact_from_jax, from_jax_params, load_jax_params
from tests.test_torch_training import ART_SHAPE, MODEL, N_COARSE, TCFG, _batch, _grad_rel_err, _jax_draws, _jbatch, \
    _random_params, _t, _tbatch

IDS_ENCODER = (0, 1)
MVH_MODEL = {**MODEL, "decoder_heads": [{
    "type": "MultiViewHead", "name": "normal_head",
    "args": {"embedding_encoder": {"type": "ff", "d_out": 16}, "attn_layers": {"n_layers": 1, "n_heads": 2}}}]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


class _EncodeTwoViews:
    """Stands in for SceneField in the JAX trainer's `method=` references:
    its encode sees the views IDS_ENCODER."""

    expand_dim, downsample, predict_uncertainty = (JSceneField.expand_dim, JSceneField.downsample,
                                                   JSceneField.predict_uncertainty)

    @staticmethod
    def encode(module, *args, **kwargs):
        return JSceneField.encode(module, *args, **{**kwargs, "ids_encoder": IDS_ENCODER})


@pytest.fixture(scope="module")
def jax_step():
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrain, "SceneField", _EncodeTwoViews)
    try:
        jfield = j_make_model(MVH_MODEL)
        params = _random_params(jfield, _batch())
        jt = jtrain.TrainConfig(**TCFG)
        jr = jnerf.RenderConfig(n_coarse=N_COARSE)
        artifact = (1e-3 * np.random.default_rng(3).normal(size=ART_SHAPE)).astype(np.float32)  # as JAX's init draws it
        batch, key = _jbatch(_batch()), jax.random.PRNGKey(12)

        def loss_fn(p, art):
            return jtrain.stage1_forward(jfield, p, batch, key, jt, jr, jrec.ReconstructionLossConfig(), art,
                                         training=True)

        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(params, artifact)
    finally:
        mp.undo()
    return dict(params=params, artifact=artifact, losses=losses, grads=grads, key=key, jt=jt, jr=jr)


def test_multi_view_head_step_matches_jax(jax_step):
    model = make_model(MVH_MODEL, device="cpu", training=True)
    assert isinstance(model.heads["normal_head"], MultiViewHead)
    assert load_jax_params(model, jax_step["params"]["params"]) == []
    tt = trainer.TrainConfig(**TCFG, ids_encoder=IDS_ENCODER)
    state = trainer.init_train_state(model, tt, artifact_field=artifact_from_jax(jax_step["artifact"]))
    draws = _jax_draws(jax_step["key"], jax_step["jt"], jax_step["jr"])
    model.zero_grad(set_to_none=True)
    loss, losses = trainer.stage1_forward(model, _tbatch(_batch()), draws, tt, RenderConfig(n_coarse=N_COARSE),
                                          rec.ReconstructionLossConfig(), state.artifact_field)
    loss.backward()
    ref = jax_step["losses"]
    assert sorted(losses) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(losses[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)

    gparams, gart = jax_step["grads"]
    ref_grads = from_jax_params(gparams["params"])[0]
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(ref_grads)
    errs = {name: _grad_rel_err(params[name].grad, ref_grads[name]) for name in params
            if float(ref_grads[name].abs().max()) > 0}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    head = [n for n in params if n.startswith("heads.normal_head.")]
    assert all(n in errs for n in head) and any("independent_token" in n for n in head)
    assert _grad_rel_err(state.artifact_field.grad, _t(gart)) <= 1e-3


def test_multi_view_field_query_sees_both_views(jax_step):
    """The encode state holds both views and the head takes their invalid
    flags: a point seen by one view only differs from the same point with
    both views' features."""
    model = make_model(MVH_MODEL, device="cpu", training=True)
    load_jax_params(model, jax_step["params"]["params"])
    tb = _tbatch(_batch())
    with torch.no_grad():
        state = model.encode(tb["imgs"], tb["projs"], tb["poses"], ids_encoder=IDS_ENCODER)
        xyz = torch.tensor([[[0.0, 0.0, 10.0], [30.0, 0.0, 5.0]]]).expand(2, 2, 3).contiguous()
        feats, invalid = model.sample_features(state, xyz)
        assert feats.shape[2] == 2 and invalid.shape == (2, 2, 2)
        _, inv, sigma, dino = model(state, xyz)
    assert torch.isfinite(sigma).all() and dino.shape == (2, 2, MVH_MODEL["dino_dims"])
