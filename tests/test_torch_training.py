"""Parity of the port's stage-1 training step (scenedino_torch.training and
the modules it runs) with the JAX reference on the CPU, at small widths,
on the same weights and the same draws.

The model is the flagship's structure cut to size: a ViT-S/8 student and
teacher overridden to width 64, depth 3, 2 heads; DPT widths (8, 8, 16,
16) -> 16; an 8-d field feature expanded to 64; a 16-wide head; 32x64
images, B = 2, V = 4; 256 rays in 8x8 patches; 8 coarse samples. The
JAX parameter tree is drawn from a seed with numpy (every leaf nonzero,
so every gradient is live) and carried across with
`scenedino_torch.utils.convert.load_jax_params` (strict). fp32
throughout, JAX under "highest" matmul precision; on the CPU both sides
run their plain attention.

The draws are the JAX step's own: the test rebuilds them from its key as
the JAX code does (`jax.random.split(key, 6)` in `stage1_forward`, the
`randint` calls of `sample_frame_split` and `PatchRaySampler.sample`,
`uniform` in `sampling.sample_coarse`) and hands them to the port as a
`Stage1Draws`. Flax derives the flip coin inside `make_rng`, so the step
parity runs with `flip_augmentation=False` and the flip branch of
`encode` is held against both JAX outcomes on its own.

Tolerances: module values atol/rtol 1e-5 (1e-4 after the ViT and DPT);
the loss dict rtol 1e-5; gradients per tensor |g - g_ref| <= 1e-3 |g_ref|
(L2 norms: fp32 round-off summed in other orders through a ViT, a DPT
stack, the render and the loss, then back); after one Adam step the
parameters to 1e-3 x lr where |g_ref| > 1e-4 |g_ref|_max of its tensor
plus rtol 5e-7, four fp32 ulps of p, for the round-off of the sum
p + update (a wrong rate group, sign or bias correction is off by the
order of lr). Elsewhere the update is lr g / (|g| + eps) of a
round-off-sized g, whose sign is not defined, so there only
|update| <= lr is held.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.losses.reconstruction as jrec
import scenedino_tpu.losses.ssim as jssim
import scenedino_tpu.renderer.nerf as jnerf
import scenedino_tpu.training.scheduler as jsched
import scenedino_tpu.training.trainer as jtrain
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_torch.kernels import launches
from scenedino_torch.losses import reconstruction as rec
from scenedino_torch.losses import ssim
from scenedino_torch.models.factory import make_model
from scenedino_torch.renderer.nerf import RenderConfig, render_rays
from scenedino_torch.training import scheduler
from scenedino_torch.training import trainer
from scenedino_torch.utils.convert import artifact_from_jax, from_jax_params, load_jax_params

B, V, H, W = 2, 4, 32, 64
RAYS, PATCH, N_COARSE = 256, 8, 8
MODEL = {
    "predict_dino": True,
    "dino_dims": 8,
    "compensate_artifacts": True,
    "inv_z": True,
    "code_mode": "z",
    "z_near": 3.0,
    "z_far": 80.0,
    "encoder": {
        "mode": "downsample-prediction",
        "decoder_arch": "dpt",
        "downsampler_arch": "featup",
        "encoder_arch": "vit-s",
        "version": "v1",
        "separate_gt_version": "v1",
        "dim_reduction_arch": "mlp",
        "num_ch_enc": [8, 8, 16, 16],
        "intermediate_features": [0, 1, 2],
        "decoder_out_dim": 16,
        "dino_pca_dim": 8,
        "image_size": [H, W],
        "vit_overrides": {"width": 64, "depth": 3, "num_heads": 2},
    },
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "decoder_heads": [{"type": "resnet", "name": "normal_head", "args": {"n_blocks": 0, "d_hidden": 16}}],
    "final_prediction_head": "normal_head",
}
ART_SHAPE = (64, H // 8, W // 8)
TCFG = dict(lr=1e-3, ray_batch_size=RAYS, patch_size=PATCH, flip_augmentation=False)
LR_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, size=(B, V, 3, H, W)).astype(np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (B, V, 4, 4)).copy()
    poses[:, :, 0, 3] += np.arange(V) * 0.2 + rng.uniform(-0.05, 0.05, size=(B, V))
    poses[:, :, 2, 3] += rng.uniform(-0.3, 0.3, size=(B, V))
    projs = np.broadcast_to(np.array([[1.2, 0, 0], [0, 1.2 * W / H, 0], [0, 0, 1.0]], np.float32),
                            (B, V, 3, 3)).copy()
    return {"imgs": imgs, "poses": poses, "projs": projs}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _random_params(jfield, batch, seed=0):
    """A seeded tree of the JAX warmup init's shape (eval_shape: no init is
    run). Kernels ~ N(0, 1/fan_in), LayerNorm scales ~ 1, the rest ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    k = jax.random.PRNGKey(0)
    jb = _jbatch(batch)
    shapes = jax.eval_shape(lambda: jfield.init({"params": k, "augment": k}, jb["imgs"], jb["projs"],
                                                jb["poses"], method=JSceneField.warmup))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(x / np.sqrt(np.prod(leaf.shape[:-1])))
        if "scale" in name or "patch_weight" in name:
            return jnp.asarray(1.0 + 0.1 * x)
        return jnp.asarray(0.1 * x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    """(JAX field, its params, the port's training model on the same weights)."""
    jfield = j_make_model(MODEL)
    params = _random_params(jfield, _batch())
    model = make_model(MODEL, device="cpu", training=True)
    assert load_jax_params(model, params["params"]) == []
    return jfield, params, model


def _jax_draws(key, tcfg, rcfg, gt_patch=8):
    """The JAX step's draws from `key`, rebuilt as stage1_forward makes them."""
    k_split, k_shift, _, k_patch, k_render, _ = jax.random.split(key, 6)
    coin = tuple(int(c) for c in np.asarray(jax.random.randint(k_split, (V // 2,), 0, 3) == 0))
    shift = None
    if tcfg.grid_shift_augmentation:
        shift = tuple(int(s) for s in np.asarray(
            jax.random.randint(k_shift, (2,), -(gt_patch // 2), gt_patch // 2)))
    s = int(shift is not None)
    PC = tcfg.ray_batch_size // tcfg.patch_size ** 2
    k_v, k_y, k_x = jax.random.split(k_patch, 3)
    picks = [torch.from_numpy(np.asarray(jax.random.randint(kk, (B, PC), 0, hi)).astype(np.int64))
             for kk, hi in ((k_v, V // 2), (k_y, H // tcfg.patch_size - s), (k_x, W // tcfg.patch_size - s))]
    k_coarse = jax.random.split(k_render, 5)[0]
    u = _t(jax.random.uniform(k_coarse, (B * tcfg.ray_batch_size, rcfg.n_coarse)))
    return trainer.Stage1Draws(coin, shift, False, *picks, u)


def _configs(**overrides):
    kw = {**TCFG, **overrides}
    return (jtrain.TrainConfig(**kw), trainer.TrainConfig(**kw),
            jnerf.RenderConfig(n_coarse=N_COARSE), RenderConfig(n_coarse=N_COARSE))


def _grad_rel_err(got, ref):
    got = torch.zeros_like(ref) if got is None else got
    return float(torch.linalg.vector_norm(got - ref) / max(float(torch.linalg.vector_norm(ref)), 1e-30))


# ---------------------------------------------------------------- modules


def test_teacher_downsampler_and_dim_reduction_match_reference(models):
    jfield, params, model = models
    enc = jfield.encoder
    p_enc = {"params": params["params"]["encoder"]}
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(3, 3, H, W)).astype(np.float32)
    feats = rng.normal(size=(2, 5, 8)).astype(np.float32)
    patches = rng.normal(size=(2, 3, 8, 8, 1, 64)).astype(np.float32)
    image = rng.normal(size=(2, 2, 16, 24, 1, 64)).astype(np.float32)
    refs = jax.jit(lambda p: (enc.apply(p, jnp.asarray(x), ground_truth=True)[0],  # one compiled call
                              enc.apply(p, jnp.asarray(feats), method=type(enc).expand_dim),
                              enc.apply(p, jnp.asarray(patches), "patch", method=type(enc).downsample),
                              enc.apply(p, jnp.asarray(image), "image", method=type(enc).downsample)))(p_enc)
    ref = refs[0]
    with torch.no_grad():
        out = model.encoder(_t(x), ground_truth=True)[0]
    assert out.shape == (3, 64, H // 8, W // 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    # the teacher is frozen and builds no graph even with grad enabled
    assert not out.requires_grad and not any(p.requires_grad for p in model.encoder.gt_encoder.parameters())

    ref = refs[1]
    np.testing.assert_allclose(model.encoder.expand_dim(_t(feats)).detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    for arr, mode, ref in ((patches, "patch", refs[2]), (image, "image", refs[3])):
        out = model.encoder.downsample(_t(arr), mode)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5, err_msg=mode)


@pytest.mark.parametrize("shift", [None, (-3, 2)])
def test_encode_with_loss_features_and_shift_matches_reference(models, shift):
    jfield, params, model = models
    batch = _batch(2)
    jb, tb = _jbatch(batch), _tbatch(batch)
    kw = dict(ids_encoder=(0,), ids_render=(1, 2), ids_loss=(0, 3))
    ref = jax.jit(lambda p, b: jfield.apply(p, b["imgs"], b["projs"], b["poses"], with_loss_feats=True,
                                            loss_feature_grid_shift=None if shift is None else jnp.asarray(shift),
                                            method=JSceneField.encode, **kw))(params, jb)
    state = model.encode(tb["imgs"], tb["projs"], tb["poses"], with_loss_feats=True,
                         loss_feature_grid_shift=shift, **kw)
    assert state.feat_grid.requires_grad  # training builds the student's graph
    for name in ("feat_grid", "loss_feats", "color_imgs", "feat_w2c", "color_ks"):
        np.testing.assert_allclose(getattr(state, name).detach().numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_encode_flip_matches_both_reference_outcomes(models):
    """JAX draws the flip coin inside flax's `make_rng`; over several keys
    each JAX encode must equal the port's with coin True or with coin
    False, and both outcomes must occur."""
    jfield, params, model = models
    batch = _batch(3)
    jb, tb = _jbatch(batch), _tbatch(batch)
    enc = jax.jit(lambda k: jfield.apply(params, jb["imgs"], jb["projs"], jb["poses"], ids_encoder=(0,),
                                         augment_flip=True, method=JSceneField.encode,
                                         rngs={"augment": k}).feat_grid)
    with torch.no_grad():
        port = {c: model.encode(tb["imgs"], tb["projs"], tb["poses"], ids_encoder=(0,), flip=c).feat_grid.numpy()
                for c in (False, True)}
    assert np.abs(port[True] - port[False]).max() > 1e-2
    seen = set()
    for i in range(8):
        ref = np.asarray(enc(jax.random.PRNGKey(i)))
        match = [c for c in (False, True) if np.allclose(port[c], ref, atol=1e-4, rtol=1e-4)]
        assert len(match) == 1, i
        seen.add(match[0])
    assert seen == {False, True}


def test_render_rays_matches_reference(models):
    """The coarse render of the field's own query, same rays and strata."""
    jfield, params, model = models
    batch = _batch(4)
    jb, tb = _jbatch(batch), _tbatch(batch)
    state = model.encode(tb["imgs"], tb["projs"], tb["poses"], ids_encoder=(0,), ids_render=(1, 2))
    rng = np.random.default_rng(5)
    R = 48
    origins = rng.normal(size=(B, R, 3)) * 0.2
    dirs = rng.normal(size=(B, R, 3)) * [0.3, 0.2, 0.0] + [0, 0, 1]
    rays = np.concatenate([origins, dirs, np.full((B, R, 1), 3.0), np.full((B, R, 1), 80.0)], -1).astype(np.float32)
    key = jax.random.PRNGKey(6)

    @jax.jit
    def jrender(p, b):  # the encode, then the volumetric and the surface render, in one compiled call
        jstate = jfield.apply(p, b["imgs"], b["projs"], b["poses"], ids_encoder=(0,), ids_render=(1, 2),
                              method=JSceneField.encode)

        def field_fn(xyz, only_density=False):
            return jfield.apply(p, jstate, xyz, only_density=only_density)

        return (jnerf.render_rays(field_fn, jnp.asarray(rays), key, jnerf.RenderConfig(n_coarse=N_COARSE),
                                  want_weights=True, want_alphas=True, want_z_samps=True),
                jnerf.render_rays(field_fn, jnp.asarray(rays), key,
                                  jnerf.RenderConfig(n_coarse=N_COARSE, render_mode="surface")))

    ref, surface = jrender(params, jb)
    u = _t(jax.random.uniform(jax.random.split(key, 5)[0], (B * R, N_COARSE)))
    out = render_rays(lambda xyz, only_density=False: model(state, xyz, only_density=only_density),
                      _t(rays), u, RenderConfig(n_coarse=N_COARSE), want_weights=True, want_alphas=True,
                      want_z_samps=True)
    assert sorted(out["coarse"]) == sorted(ref["coarse"])
    for name, r in ref["coarse"].items():
        np.testing.assert_allclose(out["coarse"][name].detach().numpy(), np.asarray(r), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    # the surface mode: a density-only query, no colour
    ref = surface
    out = render_rays(lambda xyz, only_density=False: model(state, xyz, only_density=only_density),
                      _t(rays), u, RenderConfig(n_coarse=N_COARSE, render_mode="surface"))
    assert out["coarse"]["rgb"] is None and ref["coarse"]["rgb"] is None
    for name in ("depth", "dino_features", "invalid"):
        np.testing.assert_allclose(out["coarse"][name].detach().numpy(), np.asarray(ref["coarse"][name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_l1_ssim_values_and_grads_match_reference():
    """Includes pixels where pred equals gt: the SSIM error sits exactly on
    the clip's lower bound there, a tie that splits the gradient."""
    rng = np.random.default_rng(7)
    pred = rng.uniform(size=(3, 3, 8, 8)).astype(np.float32)
    gt = rng.uniform(size=(3, 3, 8, 8)).astype(np.float32)
    gt[0] = pred[0]
    w = rng.normal(size=(3, 8, 8)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jssim.l1_ssim(p, jnp.asarray(gt)) * w)

    ref_val, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    val = torch.sum(ssim.l1_ssim(tp, _t(gt)) * _t(w))
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_grad), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ssim.ssim_error(_t(pred), _t(gt)).numpy(),
                               np.asarray(jssim.ssim_error(jnp.asarray(pred), jnp.asarray(gt))), atol=1e-6)


def _loss_data(rng, PC=3, P=4, Vr=2, K=5, C=12):
    def u(*s):
        return rng.uniform(size=s).astype(np.float32)

    invalid = (rng.uniform(size=(B, PC, P, P, K, Vr)) < 0.4).astype(np.float32)
    invalid[0, 0] = 1.0  # every sample invalid in both views: masked rays
    return {
        "rgb_gt": u(B, PC, P, P, 3),
        "dino_gt": rng.normal(size=(B, PC, 1, 1, C)).astype(np.float32),
        "coarse": {
            "rgb": u(B, PC, P, P, Vr, 3),
            "depth": 3.0 + 70 * u(B, PC, P, P),
            "invalid": invalid,
            "weights": u(B, PC, P, P, K) / 2,
            "dino_features": rng.normal(size=(B, PC, P, P, C)).astype(np.float32),
            "dino_features_downsampled": rng.normal(size=(B, PC, 1, 1, C)).astype(np.float32),
        },
    }


def test_reconstruction_loss_values_and_grads_match_reference():
    data = _loss_data(np.random.default_rng(8))
    diff = ("rgb", "depth", "dino_features", "dino_features_downsampled")

    def jloss(c):
        d = {**data, "coarse": {**data["coarse"], **c}}
        d = jax.tree_util.tree_map(jnp.asarray, d)
        losses = jrec.reconstruction_loss(d)
        return losses["rec_loss"], losses

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(data["coarse"][k]) for k in diff})
    leaves = {k: _t(data["coarse"][k]).requires_grad_(True) for k in diff}
    d = {"rgb_gt": _t(data["rgb_gt"]), "dino_gt": _t(data["dino_gt"]),
         "coarse": {**{k: _t(v) for k, v in data["coarse"].items()}, **leaves}}
    out = rec.reconstruction_loss(d)
    assert sorted(out) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(out[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)
    out["rec_loss"].backward()
    for name in diff:
        np.testing.assert_allclose(leaves[name].grad.numpy(), np.asarray(ref_grads[name]), atol=1e-7, rtol=1e-4,
                                   err_msg=name)
    # another policy runs too, and matches the reference
    ref = jrec.reconstruction_loss(jax.tree_util.tree_map(jnp.asarray, data),
                                   jrec.ReconstructionLossConfig(invalid_policy="strict"))
    out = rec.reconstruction_loss(d, rec.ReconstructionLossConfig(invalid_policy="strict"))
    for name in ref:
        np.testing.assert_allclose(out[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["fix", "step"])
def test_schedules_match_reference(kind):
    conf = {"type": kind, "step_size": 3, "gamma": 0.1}
    ref = jsched.make_schedule(conf, 1e-4)
    port = scheduler.make_schedule(conf, 1e-4)
    for step in range(10):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6)


def test_frame_split_and_draws():
    key = jax.random.PRNGKey(11)
    coin = tuple(int(c) for c in np.asarray(jax.random.randint(key, (4,), 0, 3) == 0))
    ref = jtrain.sample_frame_split(key, 8)
    out = trainer.sample_frame_split(coin)
    for o, r in zip(out, ref):
        assert o == np.asarray(r).tolist()
    tcfg = trainer.TrainConfig(ray_batch_size=RAYS, patch_size=PATCH)
    d = trainer.draw_stage1(torch.Generator().manual_seed(0), tcfg, RenderConfig(n_coarse=N_COARSE), B, V, H, W)
    assert len(d.split_coin) == V // 2 and all(c in (0, 1) for c in d.split_coin)
    assert all(-4 <= s < 4 for s in d.shift) and isinstance(d.flip, bool)
    assert d.pv.shape == (B, RAYS // PATCH ** 2) and int(d.pv.max()) < V // 2
    assert int(d.py.max()) < H // PATCH - 1 and int(d.px.max()) < W // PATCH - 1
    assert d.u.shape == (B * RAYS, N_COARSE) and 0 <= float(d.u.min()) and float(d.u.max()) < 1


# ------------------------------------------------------------ whole step


@pytest.fixture(scope="module")
def jax_step(models):
    """The JAX step's loss dict and gradients at init, and the state after
    one step, on the shared weights and key. Its skip budget is 1 (a finite
    step does not read it), so that the skip tests below reuse its compile."""
    jfield, params, _ = models
    jt, _, jr, _ = _configs(skip_nonfinite_steps=1)
    lcfg = jrec.ReconstructionLossConfig()
    state, tx = jtrain.init_train_state(jfield, params, jt, artifact_shape=ART_SHAPE, key=jax.random.PRNGKey(3))
    batch, key = _jbatch(_batch()), jax.random.PRNGKey(12)

    def loss_fn(p, art):
        return jtrain.stage1_forward(jfield, p, batch, key, jt, jr, lcfg, art, training=True)

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        state.params, state.artifact_field)
    step = jax.jit(jtrain.make_train_step(jfield, jt, jr, lcfg, tx))
    new_state, step_losses = step(state, batch, key)
    return dict(state=state, losses=losses, grads=grads, new_state=new_state, step_losses=step_losses,
                step=step, key=key)


def _port_state(model, jstate, tcfg):
    model.load_state_dict(from_jax_params(jstate.params["params"])[0])
    return trainer.init_train_state(model, tcfg, artifact_field=artifact_from_jax(jstate.artifact_field))


def test_stage1_forward_loss_and_gradients_match_reference(models, jax_step):
    """Loss dict, the gradient of every parameter and of the artifact field."""
    jfield, _, model = models
    jt, tt, _, rcfg = _configs()
    state = _port_state(model, jax_step["state"], tt)
    draws = _jax_draws(jax_step["key"], jt, jnerf.RenderConfig(n_coarse=N_COARSE))
    assert draws.shift is not None
    model.zero_grad(set_to_none=True)
    before = launches()
    loss, losses = trainer.stage1_forward(model, _tbatch(_batch()), draws, tt, rcfg,
                                          rec.ReconstructionLossConfig(), state.artifact_field)
    loss.backward()
    assert launches() == before  # CPU tensors take the plain versions
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
    # live gradients reach the student ViT, the DPT, the head, the
    # downsampler and the expansion; the teacher gets none
    for prefix in ("encoder.vit_encoder.", "encoder.decoder.", "heads.", "encoder.downsampler.",
                   "encoder.dim_reduction."):
        assert any(n.startswith(prefix) for n in errs), prefix
    assert not any(n.startswith("encoder.gt_encoder.") for n in errs)
    assert _grad_rel_err(state.artifact_field.grad, _t(gart)) <= 1e-3


def test_train_step_parameters_match_reference(models, jax_step):
    """One make_train_step on the same weights and draws: Adam with the
    two learning-rate groups and the artifact field's own Adam."""
    jfield, _, model = models
    jt, tt, _, rcfg = _configs()
    state = _port_state(model, jax_step["state"], tt)
    step = trainer.make_train_step(model, tt, rcfg, rec.ReconstructionLossConfig())
    losses = step(state, _tbatch(_batch()), _jax_draws(jax_step["key"], jt, jnerf.RenderConfig(n_coarse=N_COARSE)))
    ref_losses = jax_step["step_losses"]
    for name in ("rec_loss", "nonfinite_consecutive", "nonfinite_total", "nonfinite_gave_up"):
        np.testing.assert_allclose(float(losses[name]), float(ref_losses[name]), rtol=1e-5, err_msg=name)
    assert state.applied == state.step == 1

    old = from_jax_params(jax_step["state"].params["params"])[0]
    new = from_jax_params(jax_step["new_state"].params["params"])[0]
    grads = from_jax_params(jax_step["grads"][0]["params"])[0]
    lrs = {n: tt.lr * (tt.encoder_lr_factor if n.startswith("encoder.vit_encoder.") else 1.0) for n in new}
    moved = 0
    for name, p in model.named_parameters():
        got, ref, g, lr = p.detach(), new[name], grads[name], lrs[name]
        assert float((got - old[name]).abs().max()) <= lr * (1 + 1e-3), name
        live = g.abs() > 1e-4 * float(g.abs().max())
        np.testing.assert_allclose(got[live].numpy(), ref[live].numpy(), atol=LR_TOL * lr, rtol=5e-7, err_msg=name)
        moved += int(live.sum())
    assert moved > 0.5 * sum(p.numel() for n, p in model.named_parameters() if not n.startswith("encoder.gt_"))
    new_art = np.asarray(jax_step["new_state"].artifact_field)
    np.testing.assert_allclose(state.artifact_field.detach().numpy(), new_art, atol=LR_TOL * tt.lr, rtol=0)


def test_nonfinite_step_is_skipped_like_optax(models, jax_step):
    """A NaN batch: params, the artifact field and every Adam moment stay
    as they were and the counters move as optax.apply_if_finite moves
    them (the JAX step's own counters on the same sequence); a good step
    then resets the consecutive count and trains."""
    jfield, _, model = models
    jt, tt, _, rcfg = _configs(skip_nonfinite_steps=1)
    lcfg = rec.ReconstructionLossConfig()
    jstate, jstep = jax_step["state"], jax_step["step"]  # the step's skip budget is 1
    state = _port_state(model, jax_step["state"], tt)
    step = trainer.make_train_step(model, tt, rcfg, lcfg)
    good = _batch()
    bad = {**good, "imgs": np.full_like(good["imgs"], np.nan)}
    draws = _jax_draws(jax_step["key"], jt, jnerf.RenderConfig(n_coarse=N_COARSE))

    def snapshot():
        opt = [t.clone() for s in state.optimizer.state.values() for t in s.values()]
        art_opt = [t.clone() for s in state.artifact_optimizer.state.values() for t in s.values()]
        return [p.detach().clone() for p in model.parameters()] + [state.artifact_field.detach().clone()] \
            + opt + art_opt

    counters = ("nonfinite_consecutive", "nonfinite_total", "nonfinite_gave_up")
    losses = step(state, _tbatch(good), draws)
    jstate, jl = jstep(jstate, _jbatch(good), jax_step["key"])
    before = snapshot()
    for batch, expect in ((bad, (1, 1, 0)), (good, (0, 1, 0))):
        losses = step(state, _tbatch(batch), draws)
        jstate, jl = jstep(jstate, _jbatch(batch), jax_step["key"])
        assert tuple(int(losses[c]) for c in counters) == tuple(int(jl[c]) for c in counters) == expect
        if expect[0]:
            assert not np.isfinite(float(losses["rec_loss"]))
            after = snapshot()
            assert len(after) == len(before) and all(torch.equal(a, b) for a, b in zip(after, before))
            assert state.applied == 1 and state.step == 2
    assert state.applied == 2
    assert not all(torch.equal(a, b) for a, b in zip(snapshot(), before))
    # past the budget (1 consecutive skip) the NaN update goes through, as optax lets it
    for i, expect in enumerate(((1, 2, 0), (2, 3, 1))):
        losses = step(state, _tbatch(bad), draws)
        jstate, jl = jstep(jstate, _jbatch(bad), jax_step["key"])
        assert tuple(int(losses[c]) for c in counters) == tuple(int(jl[c]) for c in counters) == expect
    assert not torch.isfinite(state.artifact_field).all()
    assert not np.isfinite(np.asarray(jstate.artifact_field)).all()


def _singular_pose_batch(seed):
    """View 0's pose is eye(4) with a zero on the diagonal: its inverse,
    and so the rebased poses of every view, are not finite."""
    batch = _batch(seed)
    batch["poses"][:, 0] = np.diag([1.0, 1.0, 0.0, 1.0]).astype(np.float32)
    return batch


def test_singular_pose_encodes_to_nonfinite_values_like_the_reference(models):
    """jnp.linalg.inv returns non-finite values for a singular pose; the
    port's inv_ex gives the same, where the same, and raises nothing."""
    jfield, params, model = models
    assert load_jax_params(model, params["params"]) == []  # earlier steps of this module moved the weights
    batch = _singular_pose_batch(10)
    jb, tb = _jbatch(batch), _tbatch(batch)
    ref = jax.jit(lambda p, b: jfield.apply(p, b["imgs"], b["projs"], b["poses"], ids_encoder=(0,),
                                            method=JSceneField.encode))(params, jb)
    with torch.no_grad():
        state = model.encode(tb["imgs"], tb["projs"], tb["poses"], ids_encoder=(0,))
    for name in ("feat_w2c", "color_w2c", "feat_grid"):
        r, o = np.asarray(getattr(ref, name)), getattr(state, name).numpy()
        finite = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(o), finite, err_msg=name)
        np.testing.assert_allclose(o[finite], r[finite], atol=1e-4, rtol=1e-4, err_msg=name)
    assert not np.isfinite(np.asarray(ref.feat_w2c)).all()


def test_singular_pose_step_is_skipped_like_the_reference(models, jax_step):
    """A singular pose through the whole step: no exception, a non-finite
    loss, the step skipped (nonfinite_consecutive 1) and the parameters and
    the artifact field unchanged, on both packages."""
    jfield, _, model = models
    jt, tt, _, rcfg = _configs(skip_nonfinite_steps=1)
    jstate, jstep = jax_step["state"], jax_step["step"]  # the step's skip budget is 1
    state = _port_state(model, jax_step["state"], tt)
    step = trainer.make_train_step(model, tt, rcfg, rec.ReconstructionLossConfig())
    batch = _singular_pose_batch(11)
    before = [p.detach().clone() for p in model.parameters()] + [state.artifact_field.detach().clone()]
    losses = step(state, _tbatch(batch), _jax_draws(jax_step["key"], jt, jnerf.RenderConfig(n_coarse=N_COARSE)))
    new_jstate, jl = jstep(jstate, _jbatch(batch), jax_step["key"])
    counters = ("nonfinite_consecutive", "nonfinite_total", "nonfinite_gave_up")
    assert tuple(int(losses[c]) for c in counters) == tuple(int(jl[c]) for c in counters) == (1, 1, 0)
    assert not np.isfinite(float(losses["rec_loss"])) and not np.isfinite(float(jl["rec_loss"]))
    after = [p.detach() for p in model.parameters()] + [state.artifact_field.detach()]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert state.applied == 0 and state.step == 1
    for a, b in zip(jax.tree_util.tree_leaves(new_jstate.params), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_training_entry_points_refuse_the_cpu_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_model() rightly runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(MODEL, training=True)


def test_unported_options_raise(models):
    """The research branches, accumulation, the schedule and the occupancy
    probe of the validation render now build or run."""
    _, _, model = models
    for kw in ({"predict_uncertainty": True}, {"predict_consistency": True}, {"gradient_accum_factor": 2},
               {"debug_stats": True}, {"loss_renderer_strategy": "stereo_view"}):
        assert callable(trainer.make_train_step(model, trainer.TrainConfig(**kw), RenderConfig(),
                                                rec.ReconstructionLossConfig()))
    batch = {k: v[:1] for k, v in _tbatch(_batch()).items()}
    batch["occ_pts"] = torch.zeros(1, 8, 3)  # the occupancy probe of the validation render
    out = trainer.stage1_eval_forward(model, batch, trainer.TrainConfig(), RenderConfig(n_coarse=2),
                                      generator=torch.Generator(), chunk=8192)
    assert out["occ_densities"].shape == (1, 8)
    # the reference's ScheduledTrainStep: the config maps, the schedule is the caller's
    assert trainer.configs_from_dict({"model": MODEL, "renderer": {"sched": [[10], [16], [0]]}})[2].n_coarse == 32


def test_serving_builds_no_graph(models):
    """encode records a graph (training needs it); a serving request under
    torch.inference_mode builds none, and the fold works on its state."""
    from scenedino_torch.ops.fast_field import build_fast_state

    _, _, model = models
    tb = _tbatch(_batch(9))
    with torch.inference_mode():
        state = model.encode(tb["imgs"][:1, :1], tb["projs"][:1, :1], tb["poses"][:1, :1])
        fs = build_fast_state(model, state, compute_dtype=torch.float32)
    assert state.feat_grid.grad_fn is None and not state.feat_grid.requires_grad
    assert fs.folded_grid.grad_fn is None
    assert model.encode(tb["imgs"][:1, :1], tb["projs"][:1, :1], tb["poses"][:1, :1]).feat_grid.grad_fn is not None


def test_config_blocks_map_like_the_reference_cli():
    from scenedino_torch.models.factory import SCENEDINO_KITTI_360_TRAIN

    model_conf, tcfg, rcfg, lcfg = trainer.configs_from_dict(SCENEDINO_KITTI_360_TRAIN)
    assert model_conf["encoder"]["dtype"] == "bfloat16" and model_conf["compensate_artifacts"]
    assert (tcfg.lr, tcfg.scheduler_step, tcfg.scheduler_gamma) == (1e-4, 50000, 0.1)
    assert (tcfg.ray_batch_size, tcfg.patch_size, tcfg.encoder_lr_factor) == (2048, 8, 0.1)
    assert (rcfg.n_coarse, rcfg.n_fine, rcfg.lindisp) == (32, 0, True)
    assert dataclasses.asdict(lcfg) == dataclasses.asdict(jrec.ReconstructionLossConfig())
