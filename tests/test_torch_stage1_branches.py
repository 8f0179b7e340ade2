"""Parity of the stage-1 step's optional branches with the JAX reference on
the CPU: the monodepth2 uncertainty predictor (its ResNet encoder, carried
across by `utils.convert`), `predict_uncertainty`, the consistency branch
and `debug_stats`; and the NeRF sample-count schedule's milestones.

The field is tests/test_torch_training.py's tiny flagship (ViT-S/8 at
width 64, 32x64 images, B = 2, V = 4) with a `Monodepth2(d_out=1,
scales=(0, 1))` uncertainty predictor read at scale 1 (so its map is
resized to the image). The JAX tree is drawn from a seed with numpy (the
frozen batch norms' variances positive) and carried across strictly. The
draws are the JAX step's own, rebuilt from its key, the consistency
branch's included. Tolerances: the predictor's maps 1e-5; the loss dict
rtol 1e-5; the predictor's gradients |g - g_ref| <= 1e-3 |g_ref| per
tensor (tests/test_torch_training.py's stage-1 bounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.losses.reconstruction as jrec
import scenedino_tpu.renderer.nerf as jnerf
import scenedino_tpu.training.trainer as jtrain
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_tpu.models.monodepth2 import Monodepth2 as JMonodepth2
from scenedino_torch.losses import reconstruction as rec
from scenedino_torch.models.factory import make_model
from scenedino_torch.models.monodepth2 import Monodepth2
from scenedino_torch.renderer.nerf import RenderConfig, RenderDraws
from scenedino_torch.training import trainer
from scenedino_torch.utils.convert import artifact_from_jax, from_jax_params, load_jax_params
from tests.test_torch_training import (
    ART_SHAPE,
    MODEL,
    N_COARSE,
    TCFG,
    B,
    H,
    W,
    _batch,
    _grad_rel_err,
    _jax_draws,
    _jbatch,
    _t,
    _tbatch,
)

CONS_RAYS = 16
BRANCHES = dict(predict_uncertainty=True, uncertainty_predictor_res=1, predict_consistency=True,
                consistency_rays=CONS_RAYS, debug_stats=True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _draw_tree(shapes, seed):
    """A seeded tree of `shapes`: kernels ~ N(0, 1/fan_in), scales ~ 1, the
    batch norms' variances 1 + 0.1 |N|, the rest ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(x / np.sqrt(np.prod(leaf.shape[:-1])))
        if "var" in name:
            return jnp.asarray(1.0 + 0.1 * np.abs(x))
        if "scale" in name or "patch_weight" in name:
            return jnp.asarray(1.0 + 0.1 * x)
        return jnp.asarray(0.1 * x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def branch_models():
    """(JAX field with a Monodepth2 uncertainty predictor, its params, the port's on the same weights)."""
    from scenedino_tpu.models.factory import make_model as j_make_model

    jfield = j_make_model(MODEL).clone(uncertainty_predictor=JMonodepth2(d_out=1, scales=(0, 1)))
    jb = _jbatch(_batch())
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jfield.init({"params": k, "augment": k}, jb["imgs"], jb["projs"], jb["poses"],
                                                method=JSceneField.warmup))
    params = _draw_tree(shapes, 0)
    model = make_model(MODEL, device="cpu", training=True)
    model.uncertainty_predictor = Monodepth2(1, (0, 1))
    assert load_jax_params(model, params["params"]) == []
    return jfield, params, model


def test_monodepth2_matches_reference():
    """The whole model (ResNet-18 encoder with frozen batch norms, the
    decoder) from a JAX tree carried across by utils.convert, strictly."""
    jm = JMonodepth2(d_out=4, scales=(0, 1, 3))
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 3, 32, 64)).astype(np.float32)
    params = _draw_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 2)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    port = Monodepth2(4, (0, 1, 3))
    state, skipped = from_jax_params(params["params"])
    assert skipped == [] and "encoder.bn1.mean" in state and "encoder.layer2_0.downsample_bn.var" in state
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = port(_t(x))
    assert [o.shape for o in out] == [r.shape for r in ref] == [(2, 4, 32, 64), (2, 4, 16, 32), (2, 4, 4, 8)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


def test_predict_uncertainty_matches_reference(branch_models):
    jfield, params, model = branch_models
    imgs = _batch(3)["imgs"]
    predict = jax.jit(lambda p, x, res: jfield.apply(p, x, res, method=JSceneField.predict_uncertainty),
                      static_argnums=2)
    for res in (0, 1):
        ref = predict(params, jnp.asarray(imgs), res)
        with torch.no_grad():
            out = model.predict_uncertainty(_t(imgs), res)
        assert out.shape == (B, 4, 1, H, W) and bool((out > 0).all())
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5, err_msg=str(res))


def _consistency_draws(key, rcfg):
    """The consistency branch's draws from the step's key, as consistency_forward splits it."""
    k_cons = jax.random.split(key, 6)[5]
    k_rand, k_r0, k_r1 = jax.random.split(k_cons, 3)
    idx = torch.from_numpy(np.asarray(jax.random.randint(k_rand, (B, CONS_RAYS), 0, H * W)).astype(np.int64))

    def render(k):
        return RenderDraws(_t(jax.random.uniform(jax.random.split(k, 5)[0], (B * CONS_RAYS, rcfg.n_coarse))))

    return trainer.ConsistencyDraws(idx, render(k_r0), render(k_r1))


def test_stage1_branches_match_reference(branch_models):
    """uncertainty + consistency + debug_stats in one stage1_forward: every
    loss key against JAX's, and the predictor's gradient through the
    rendered uncertainty channel (the loss ignores it, so uncert_mean is
    added to drive it, as tests/test_trainer_stage1.py does)."""
    jfield, params, model = branch_models
    assert load_jax_params(model, params["params"]) == []
    kw = {**TCFG, **BRANCHES}
    jt, tt = jtrain.TrainConfig(**kw), trainer.TrainConfig(**kw)
    jr, rcfg = jnerf.RenderConfig(n_coarse=N_COARSE), RenderConfig(n_coarse=N_COARSE)
    art = 0.001 * jax.random.normal(jax.random.PRNGKey(3), ART_SHAPE)
    batch, key = _batch(), jax.random.PRNGKey(12)

    def loss_fn(p):
        loss, losses = jtrain.stage1_forward(jfield, p, _jbatch(batch), key, jt, jr, jrec.ReconstructionLossConfig(),
                                             art, training=True)
        return loss + losses["uncert_mean"], losses

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    draws = dataclasses.replace(_jax_draws(key, jt, jr), consistency=_consistency_draws(key, rcfg))
    model.zero_grad(set_to_none=True)
    loss, losses = trainer.stage1_forward(model, _tbatch(batch), draws, tt, rcfg, rec.ReconstructionLossConfig(),
                                          artifact_from_jax(art))
    (loss + losses["uncert_mean"]).backward()
    assert sorted(losses) == sorted(ref)
    assert {"uncert_mean", "consistency_depth_abs", "dbg_depth_min", "dbg_artifact_absmax"} <= set(losses)
    for name in ref:
        np.testing.assert_allclose(losses[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)
    ref_grads = from_jax_params(grads["params"])[0]
    up = {n: p for n, p in model.named_parameters() if n.startswith("uncertainty_predictor.")}
    assert up and any(float(p.grad.abs().max()) > 0 for p in up.values() if p.grad is not None)
    errs = {n: _grad_rel_err(p.grad, ref_grads[n]) for n, p in up.items() if float(ref_grads[n].abs().max()) > 0}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_consistency_forward_shapes(branch_models):
    _, _, model = branch_models
    tb = _tbatch(_batch(4))
    rcfg = RenderConfig(n_coarse=N_COARSE)
    g = torch.Generator().manual_seed(0)
    tt = trainer.TrainConfig(**{**TCFG, **BRANCHES})
    d = trainer.draw_stage1(g, tt, rcfg, B, 4, H, W)
    assert d.consistency.idx.shape == (B, CONS_RAYS) and d.consistency.r1.u.shape == (B * CONS_RAYS, N_COARSE)
    with torch.no_grad():
        cons = trainer.consistency_forward(model, tb["imgs"], tb["poses"], tb["projs"], None, d.consistency, tt, rcfg)
    assert cons["xyz"].shape == (B, CONS_RAYS, 3)
    assert cons["render_dict_1"]["coarse"]["depth"].shape == (B, CONS_RAYS)
    assert bool(torch.isfinite(cons["depth_abs"]))


# ------------------------------------------------------------- the schedule

SCHED = [[2, 3], [4, 12], [0, 2]]  # iterations 0-1: the base 8; 2: 4; 3 on: 12 + 2 fine (tests/test_torch_grad_accum.py)


def test_schedule_config_at_matches_reference():
    jst = jtrain.ScheduledTrainStep(lambda rc: None, jnerf.RenderConfig(n_coarse=8), SCHED)
    st = trainer.ScheduledTrainStep(lambda rc: rc, RenderConfig(n_coarse=8), SCHED)
    for it in range(12):
        assert st.config_at(it) == jst.config_at(it), it
    with pytest.raises(ValueError):
        trainer.ScheduledTrainStep(lambda rc: rc, RenderConfig(), [[3, 2], [4, 8], [0, 0]])


def test_a_teacher_grid_the_patches_miss_raises_in_both_packages():
    """configs/train_scenedino_kitti_360_dinov2.yaml pairs 8-pixel ray
    patches with the 16-pixel DINOv2 teacher: the patch picks then index
    past the teacher's grid. JAX's gather fills NaN there and its salience
    downsampler fails to broadcast (16x16 weights on 8x8 patches); the port
    refuses at the sampler, before any render (on the card the gather
    would assert on the device). At the teacher's patch size both run."""
    from scenedino_tpu.models.factory import make_model as j_make_model

    conf = {**MODEL, "encoder": {**MODEL["encoder"], "version": "v2", "separate_gt_version": "v2"}}
    jfield = j_make_model(conf)
    batch = _batch(5)
    jb, tb = _jbatch(batch), _tbatch(batch)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jfield.init({"params": k, "augment": k}, jb["imgs"], jb["projs"], jb["poses"],
                                                method=JSceneField.warmup))
    model = make_model(conf, device="cpu", training=True)
    rcfg, lcfg = RenderConfig(n_coarse=4), rec.ReconstructionLossConfig()
    for patch, raises in ((8, True), (16, False)):
        kw = {**TCFG, "patch_size": patch, "compensate_artifacts": False}
        jt, tt = jtrain.TrainConfig(**kw), trainer.TrainConfig(**kw)

        def jforward(p):
            return jtrain.stage1_forward(jfield, p, jb, jax.random.PRNGKey(1), jt, jnerf.RenderConfig(n_coarse=4),
                                         jrec.ReconstructionLossConfig(), None, training=True)[0]

        draws = trainer.draw_stage1(torch.Generator().manual_seed(0), tt, rcfg, B, 4, H, W, gt_patch=16)
        if raises:
            with pytest.raises((TypeError, ValueError)):
                jax.eval_shape(jforward, shapes)
            with pytest.raises(ValueError, match="teacher's patch size"):
                trainer.stage1_forward(model, tb, draws, tt, rcfg, lcfg)
        else:
            assert jax.eval_shape(jforward, shapes).shape == ()
            with torch.no_grad():
                loss, _ = trainer.stage1_forward(model, tb, draws, tt, rcfg, lcfg)
            assert bool(torch.isfinite(loss))
