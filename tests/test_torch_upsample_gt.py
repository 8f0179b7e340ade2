"""Parity of the port's encoder stack beyond the flagship with the JAX
reference on the CPU: the upsample-gt mode and its teacher upsamplers
(`models.upsampler`), the other decoders (`NoDecoder` x3, the simple
feature pyramid with its monodepth2 decoder), `BilinearDownsampler`,
`flip_avg_gt`, `encoder_freeze`, `separate_gt_version: None`,
`dim_reduction_arch: none`, the per-pixel ray sampler, one `dino_upscaled`
stage-1 step of each upsample-gt variant and the validation render with
the multiscale-crop teacher.

The model is tests/test_torch_training.py's, cut the same way (a ViT-S/8
student and teacher at width 64, depth 3, 2 heads; 32x64 images, B = 2,
V = 4; 256 rays in 8x8 patches; 8 coarse samples), switched to
`mode: upsample-gt` with a per-pixel target (`dino_upscaled`) and no
artifact field, as configs/train_scenedino_kitti_360_upsampler.yaml is.
Weights are drawn with numpy and carried across with `from_jax_params`.

The multiscale-crop teacher draws its crops inside flax's `make_rng`.
The tests catch the key it gets (a `jax.debug.callback` in a wrapper of
`scenedino_tpu.models.upsampler._sample_crop_params`) and rebuild the
crops from it with that function, as the step's other draws are rebuilt
from its key. JAX's validation render passes no "augment" rng and raises
on that teacher; the port draws the crops, and is held against JAX's
function run through a wrapper whose `apply` adds the rng.

Tolerances (the training tests' rules): module outputs atol/rtol 1e-5, or
1e-4 after a ViT or a decoder; the loss dict rtol 1e-5; gradients per
tensor |g - g_ref| <= 1e-3 |g_ref| (L2); after one Adam step the
parameters to 1e-3 x lr where |g_ref| > 1e-4 of its tensor's largest and
> 1e-6 (100 times Adam's eps: nearer to eps, round-off of g moves
lr g / (|g| + eps) by that much), elsewhere |update| <= lr.
"""
import contextlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import scenedino_tpu.core.ray_sampler as jray_sampler
import scenedino_tpu.losses.reconstruction as jrec
import scenedino_tpu.models.dpt as jdpt
import scenedino_tpu.models.encoder as jencoder
import scenedino_tpu.models.upsampler as jupsampler
import scenedino_tpu.renderer.nerf as jnerf
import scenedino_tpu.training.trainer as jtrain
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_torch.core.ray_sampler import PatchRaySampler
from scenedino_torch.core.resize import jax_resize
from scenedino_torch.losses import reconstruction as rec
from scenedino_torch.models import dpt, encoder, upsampler
from scenedino_torch.models.factory import encoder_config_from_dict, make_model
from scenedino_torch.renderer.nerf import RenderConfig
from scenedino_torch.training import trainer
from scenedino_torch.utils.convert import from_jax_params, load_jax_params
from tests.test_torch_training import MODEL, _batch, _grad_rel_err, _jax_draws, _random_params

B, V, H, W = 2, 4, 32, 64
RAYS, PATCH, N_COARSE = 256, 8, 8
ENC = {**MODEL["encoder"], "image_size": [H, W]}
TCFG = dict(lr=1e-3, ray_batch_size=RAYS, patch_size=PATCH, flip_augmentation=False, dino_upscaled=True,
            compensate_artifacts=False)
LR_TOL = 1e-3
# Adam's first update is lr g / (|g| + 1e-8): where |g| is near its eps, the
# round-off of g (a few 1e-3 of an element 1e-4 of its tensor's largest)
# moves the update by ~1e-3 lr. Updates are compared where |g_ref| > 100 eps
# (besides > 1e-4 of the tensor's largest, the training tests' rule)
ADAM_LIVE = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _model_conf(**encoder):
    return {**MODEL, "compensate_artifacts": False,
            "encoder": {**ENC, "mode": "upsample-gt", "upsampler_arch": "bilinear", **encoder}}


def _pair(conf, seed=0):
    """(JAX field, its params, the port's training model on the same weights)."""
    jfield = j_make_model(conf)
    params = _random_params(jfield, _batch(), seed=seed)
    model = make_model(conf, device="cpu", training=True)
    assert load_jax_params(model, params["params"]) == []
    return jfield, params, model


@contextlib.contextmanager
def caught_crop_keys():
    """Records the key of every `_sample_crop_params` call of the JAX
    teacher, jitted or not (a list of numpy keys)."""
    keys = []
    original = jupsampler._sample_crop_params

    def spy(key, batch, n_aug, image_ratio=None):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), key)
        return original(key, batch, n_aug, image_ratio)

    jupsampler._sample_crop_params = spy
    try:
        yield keys
    finally:
        jupsampler._sample_crop_params = original


def _crops_from_key(key, n_images, n_aug=2) -> upsampler.CropDraws:
    return upsampler.CropDraws(*(_t(a) for a in jupsampler._sample_crop_params(jnp.asarray(key), n_images, n_aug)))


# ---------------------------------------------------------------- resizes


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
def test_jax_resize_matches_jax_image_resize(method):
    rng = np.random.default_rng(0)
    for shape, size in (((2, 5, 4, 8), (32, 64)), ((1, 3, 37, 37), (12, 40)), ((1, 2, 9, 9), (9, 20))):
        x = rng.normal(size=shape).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(x), (*shape[:2], *size), method=method)
        np.testing.assert_allclose(jax_resize(_t(x), size, method).numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_jax_bilinear_upscale_is_torch_interpolate():
    """On an upscale JAX's triangle with its border renormalization equals
    F.interpolate(bilinear, align_corners=False), whose source index is
    clamped at the border (the multiscale-crop teacher's upsample)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 6, 4, 8)).astype(np.float32))
    for size in ((32, 64), (13, 45), (192, 640)):
        ref = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
        np.testing.assert_allclose(jax_resize(x, size, "bilinear").numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- modules


@pytest.fixture(scope="module")
def crop_pair():
    return _pair(_model_conf(upsampler_arch="multiscale-crop"), seed=1)


@pytest.mark.parametrize("arch", ["nearest", "bilinear", "bicubic"])
def test_interpolated_gt_matches_reference(arch):
    jfield, params, model = _pair(_model_conf(upsampler_arch=arch), seed=2)
    x = np.random.default_rng(3).uniform(-1, 1, size=(3, 3, H, W)).astype(np.float32)
    ref = jfield.encoder.apply({"params": params["params"]["encoder"]}, jnp.asarray(x), ground_truth=True)[0]
    out = model.encoder(_t(x), ground_truth=True)[0]
    assert out.shape == (3, 64, H, W) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert model.encoder.downsample(torch.zeros(1, 1, 8, 8, 1, 64)) is None


def test_multiscale_crop_gt_matches_reference_with_the_keys_crops(crop_pair):
    jfield, params, model = crop_pair
    x = np.random.default_rng(4).uniform(-1, 1, size=(3, 3, H, W)).astype(np.float32)
    with caught_crop_keys() as keys:
        ref = jfield.encoder.apply({"params": params["params"]["encoder"]}, jnp.asarray(x), ground_truth=True,
                                   rngs={"augment": jax.random.PRNGKey(5)})[0]
    assert len(keys) == 1
    crops = _crops_from_key(keys[0], 3)
    out = model.encoder(_t(x), ground_truth=True, crops=crops)[0]
    assert out.shape == (3, 64, H, W)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(torch.linalg.vector_norm(out, dim=1).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="crop draws"):
        model.encoder(_t(x), ground_truth=True)


def test_sample_crop_params_follows_the_references_distributions():
    d = upsampler.sample_crop_params(torch.Generator().manual_seed(1), 4096, 2)
    ref = [np.asarray(a) for a in jupsampler._sample_crop_params(jax.random.PRNGKey(0), 4096, 2)]
    for got, r, name in zip((d.hw, d.hh, d.cx, d.cy, d.flip), ref, ("hw", "hh", "cx", "cy", "flip")):
        assert got.shape == r.shape == (4096, 2), name
        assert abs(float(got.min()) - r.min()) < 0.02 and abs(float(got.max()) - r.max()) < 0.02, name
        assert abs(float(got.mean()) - r.mean()) < 0.03, name
    assert set(d.flip.unique().tolist()) == {-1.0, 1.0}
    assert (d.cx.abs() <= 1 - d.hw + 1e-6).all() and (d.cy.abs() <= 1 - d.hh + 1e-6).all()


@pytest.mark.parametrize("arch", ["nearest", "bilinear", "bicubic"])
def test_no_decoder_matches_reference(arch):
    """jax.image.resize's filters, not F.interpolate's (a ROADMAP divergence
    of the JAX package from the reference, kept and pinned here); at a
    ratio that is not a whole number, as a 14-pixel patch gives."""
    rng = np.random.default_rng(7)
    grid = rng.normal(size=(2, 24, 5, 9)).astype(np.float32)
    ref = jdpt.NoDecoder(image_size=(H, W), interpolation=arch).apply({}, [jnp.asarray(grid)])[0]
    out = dpt.NoDecoder((H, W), arch)([_t(grid)])[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    if arch != "bilinear":  # on an upscale JAX's bilinear is torch's; its nearest and bicubic are not
        torch_ref = F.interpolate(_t(grid), size=(H, W), mode=arch, **({} if arch == "nearest" else
                                                                       {"align_corners": False}))
        assert float((out - torch_ref / torch.linalg.vector_norm(torch_ref, dim=1, keepdim=True)).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["nearest", "bilinear", "bicubic"])
def test_no_decoder_student_and_field_match_reference(arch):
    conf = _model_conf(decoder_arch=arch)
    jfield, params, model = _pair(conf, seed=8)
    assert model.encoder.latent_size == 64  # the ViT's width: the grid is only resized
    x = np.random.default_rng(9).uniform(-1, 1, size=(2, 3, H, W)).astype(np.float32)
    ref = jfield.encoder.apply({"params": params["params"]["encoder"]}, jnp.asarray(x))[0]
    out = model.encoder(_t(x))[0]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _spf_conf(num_ch_enc):
    return _model_conf(decoder_arch="spf", num_ch_enc=num_ch_enc)


def test_spf_decoder_matches_reference_and_four_widths_are_refused_on_both_sides():
    conf = _spf_conf([8, 8, 16, 16, 16])
    jfield, params, model = _pair(conf, seed=10)
    x = np.random.default_rng(11).uniform(-1, 1, size=(2, 3, H, W)).astype(np.float32)
    shapes = [(2, 16, 2 * H >> s, 2 * W >> s) for s in range(4)]
    # the outputs and the gradients of the whole decoder against JAX's, in one compiled call
    w = [np.random.default_rng(12 + i).normal(size=shape).astype(np.float32) for i, shape in enumerate(shapes)]

    def weighted(p):
        outs = jfield.encoder.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs

    (_, ref), jgrads = jax.jit(jax.value_and_grad(weighted, has_aux=True))(params["params"]["encoder"])
    out = model.encoder(_t(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == shapes
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)
    ref_grads = from_jax_params({"decoder": jgrads["decoder"]})[0]
    sum(torch.sum(o * _t(wi)) for o, wi in zip(out, w)).backward()
    for name, p in model.encoder.decoder.named_parameters():
        assert _grad_rel_err(p.grad, ref_grads[f"decoder.{name}"]) <= 1e-3, name

    four = _spf_conf([8, 8, 16, 16])
    with pytest.raises(IndexError):  # JAX's init (dpt.py:188 reads num_ch_enc[4])
        _random_params(j_make_model(four), _batch())
    with pytest.raises(ValueError, match="five num_ch_enc"):
        make_model(four, device="cpu", training=True)


def test_bilinear_downsampler_matches_reference():
    """F.interpolate's 2x2-tap point sample at the patch centres, in both
    of the downsampler's modes."""
    rng = np.random.default_rng(13)
    down = encoder.BilinearDownsampler(8)
    for shape, mode in (((2, 3, 32, 48, 1, 16), "image"), ((2, 5, 8, 8, 1, 16), "patch")):
        x = rng.normal(size=shape).astype(np.float32)
        ref = jencoder.BilinearDownsampler(patch_size=8).apply({}, jnp.asarray(x), mode)
        out = down(_t(x), mode)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    conf = {**MODEL, "encoder": {**ENC, "downsampler_arch": "bilinear"}}
    jfield, params, model = _pair(conf, seed=14)
    x = rng.normal(size=(2, 3, 16, 24, 1, 64)).astype(np.float32)
    ref = jfield.encoder.apply({"params": params["params"]["encoder"]}, jnp.asarray(x), "image",
                               method=type(jfield.encoder).downsample)
    np.testing.assert_allclose(model.encoder.downsample(_t(x), "image").numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("options", [
    {"flip_avg_gt": True},
    {"separate_gt_version": None},
    {"separate_gt_version": None, "flip_avg_gt": True, "dim_reduction_arch": "none"},
])
def test_teacher_options_match_reference(options):
    conf = {**MODEL, "dino_dims": 64 if options.get("dim_reduction_arch") == "none" else MODEL["dino_dims"],
            "encoder": {**ENC, **options}}
    jfield, params, model = _pair(conf, seed=15)
    if options.get("separate_gt_version", "v1") is None:
        assert "gt_encoder" not in dict(model.encoder.named_children())
        assert model.encoder.teacher is model.encoder.vit_encoder
    x = np.random.default_rng(16).uniform(-1, 1, size=(2, 3, H, W)).astype(np.float32)
    p_enc = {"params": params["params"]["encoder"]}
    ref = jfield.encoder.apply(p_enc, jnp.asarray(x), ground_truth=True)[0]
    out = model.encoder(_t(x), ground_truth=True)[0]
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    feats = np.random.default_rng(17).normal(size=(3, conf["dino_dims"])).astype(np.float32)
    ref = jfield.encoder.apply(p_enc, jnp.asarray(feats), method=type(jfield.encoder).expand_dim)
    np.testing.assert_allclose(model.encoder.expand_dim(_t(feats)).detach().numpy(), np.asarray(ref), atol=1e-5)


def test_encoder_freeze_passes_no_gradient_into_the_student_vit():
    conf = {**MODEL, "encoder": {**ENC, "encoder_freeze": True}}
    jfield, params, model = _pair(conf, seed=18)
    x = np.random.default_rng(19).uniform(-1, 1, size=(2, 3, H, W)).astype(np.float32)
    w = np.random.default_rng(20).normal(size=(2, 16, 2 * H, 2 * W)).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jfield.encoder.apply({"params": p}, jnp.asarray(x))[0] * w)))(
        params["params"]["encoder"])
    ref = from_jax_params(jgrads)[0]
    out = model.encoder(_t(x))[0]
    torch.sum(out * _t(w)).backward()
    for name, p in model.encoder.named_parameters():
        if name.startswith("vit_encoder."):
            assert p.grad is None and float(ref[name].abs().max()) == 0.0, name
        elif name.startswith("decoder."):
            assert _grad_rel_err(p.grad, ref[name]) <= 1e-3, name


# ---------------------------------------------------------------- sampler


@pytest.mark.parametrize("shift", [None, (-3, 2)])
def test_patch_ray_sampler_per_pixel_teacher_matches_reference(shift):
    rng = np.random.default_rng(21)
    b = _batch(5)
    imgs = b["imgs"][:, :2] * 0.5 + 0.5
    feats = rng.normal(size=(B, 2, 12, H, W)).astype(np.float32)
    key = jax.random.PRNGKey(22)
    js = jray_sampler.PatchRaySampler(3.0, 80.0, ray_batch_size=RAYS, patch_size=PATCH, dino_upscaled=True)
    rays, rgb, dgt = js.sample(key, jnp.asarray(imgs), jnp.asarray(b["poses"][:, :2]), jnp.asarray(b["projs"][:, :2]),
                               frame_ids=jnp.asarray([0.0, 1.0]), dino_features=jnp.asarray(feats),
                               grid_shift=None if shift is None else jnp.asarray(shift))
    s = int(shift is not None)
    k_v, k_y, k_x = jax.random.split(key, 3)
    PC = RAYS // PATCH ** 2
    picks = [torch.from_numpy(np.asarray(jax.random.randint(kk, (B, PC), 0, hi)).astype(np.int64))
             for kk, hi in ((k_v, 2), (k_y, H // PATCH - s), (k_x, W // PATCH - s))]
    sampler = PatchRaySampler(3.0, 80.0, RAYS, PATCH, dino_upscaled=True)
    out = sampler.sample(_t(imgs), _t(b["poses"][:, :2]), _t(b["projs"][:, :2]), *picks,
                         frame_ids=torch.tensor([0.0, 1.0]), dino_features=_t(feats), grid_shift=shift)
    assert out[2].shape == (B, RAYS, 12)
    for o, r in zip(out, (rays, rgb, dgt)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="upscaled"):
        sampler.sample(_t(imgs), _t(b["poses"][:, :2]), _t(b["projs"][:, :2]), *picks,
                       dino_features=_t(feats[..., ::2, ::2]))


# ------------------------------------------------------------ whole step


@pytest.fixture(scope="module", params=["bilinear", "multiscale-crop"])
def step_case(request):
    """The JAX step of one upsample-gt variant: loss dict and gradients at
    init, the state after one step, and the crop keys its teacher got."""
    jfield, params, model = _pair(_model_conf(upsampler_arch=request.param), seed=23)
    jt = jtrain.TrainConfig(**TCFG)
    jr = jnerf.RenderConfig(n_coarse=N_COARSE)
    lcfg = jrec.ReconstructionLossConfig()
    state, tx = jtrain.init_train_state(jfield, params, jt)
    assert state.artifact_field is None
    batch, key = {k: jnp.asarray(v) for k, v in _batch().items()}, jax.random.PRNGKey(24)
    with caught_crop_keys() as keys:
        (_, losses), grads = jax.jit(jax.value_and_grad(
            lambda p: jtrain.stage1_forward(jfield, p, batch, key, jt, jr, lcfg, None, training=True),
            has_aux=True))(state.params)
        new_state, step_losses = jax.jit(jtrain.make_train_step(jfield, jt, jr, lcfg, tx))(state, batch, key)
    return dict(arch=request.param, model=model, state=state, losses=losses, grads=grads, new_state=new_state,
                step_losses=step_losses, key=key, crop_keys=keys)


def _draws(case):
    tt = trainer.TrainConfig(**TCFG)
    draws = _jax_draws(case["key"], tt, RenderConfig(n_coarse=N_COARSE))
    if case["arch"] == "multiscale-crop":
        assert len(case["crop_keys"]) == 2 and np.array_equal(*case["crop_keys"])  # the same key in both runs
        draws.crops = _crops_from_key(case["crop_keys"][0], B * (V // 2))
    else:
        assert case["crop_keys"] == []
    return tt, draws


def test_upsample_gt_step_loss_and_gradients_match_reference(step_case):
    model = step_case["model"]
    model.load_state_dict(from_jax_params(step_case["state"].params["params"])[0])
    tt, draws = _draws(step_case)
    model.zero_grad(set_to_none=True)
    loss, losses = trainer.stage1_forward(model, {k: _t(v) for k, v in _batch().items()}, draws, tt,
                                          RenderConfig(n_coarse=N_COARSE), rec.ReconstructionLossConfig())
    loss.backward()
    ref = step_case["losses"]
    assert sorted(losses) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(losses[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)
    ref_grads = from_jax_params(step_case["grads"]["params"])[0]
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(ref_grads)
    errs = {name: _grad_rel_err(params[name].grad, ref_grads[name]) for name in params
            if float(ref_grads[name].abs().max()) > 0}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    for prefix in ("encoder.vit_encoder.", "encoder.decoder.", "heads.", "encoder.dim_reduction."):
        assert any(n.startswith(prefix) for n in errs), prefix
    assert not any(n.startswith("encoder.gt_encoder.") for n in errs)


def test_upsample_gt_train_step_parameters_match_reference(step_case):
    model = step_case["model"]
    model.load_state_dict(from_jax_params(step_case["state"].params["params"])[0])
    tt, draws = _draws(step_case)
    state = trainer.init_train_state(model, tt)
    assert state.artifact_field is None
    losses = trainer.make_train_step(model, tt, RenderConfig(n_coarse=N_COARSE), rec.ReconstructionLossConfig())(
        state, {k: _t(v) for k, v in _batch().items()}, draws)
    for name in ("rec_loss", "nonfinite_consecutive", "nonfinite_total", "nonfinite_gave_up"):
        np.testing.assert_allclose(float(losses[name]), float(step_case["step_losses"][name]), rtol=1e-5,
                                   err_msg=name)
    old = from_jax_params(step_case["state"].params["params"])[0]
    new = from_jax_params(step_case["new_state"].params["params"])[0]
    grads = from_jax_params(step_case["grads"]["params"])[0]
    moved = 0
    for name, p in model.named_parameters():
        lr = tt.lr * (tt.encoder_lr_factor if name.startswith("encoder.vit_encoder.") else 1.0)
        got, g = p.detach(), grads[name]
        assert float((got - old[name]).abs().max()) <= lr * (1 + 1e-3), name
        live = (g.abs() > 1e-4 * float(g.abs().max())) & (g.abs() > ADAM_LIVE)
        np.testing.assert_allclose(got[live].numpy(), new[name][live].numpy(), atol=LR_TOL * lr, rtol=5e-7,
                                   err_msg=name)
        moved += int(live.sum())
    assert moved > 0.5 * sum(p.numel() for n, p in model.named_parameters() if not n.startswith("encoder.gt_"))


def test_artifact_field_with_a_per_pixel_teacher_is_refused(step_case):
    model = step_case["model"]
    tt, draws = _draws(step_case)
    with pytest.raises(ValueError, match="artifact"):
        trainer.stage1_forward(model, {k: _t(v) for k, v in _batch().items()}, draws, tt,
                               RenderConfig(n_coarse=N_COARSE), rec.ReconstructionLossConfig(),
                               torch.zeros(64, H // 8, W // 8))


# ---------------------------------------------------------------- validation


class _WithAugment:
    """A JAX field whose `apply` passes an "augment" rng: what JAX's
    validation render would need to run the multiscale-crop teacher."""

    def __init__(self, field, key):
        self.field, self.key = field, key

    def __getattr__(self, name):
        return getattr(self.field, name)

    def apply(self, *args, **kwargs):
        return self.field.apply(*args, rngs={"augment": self.key}, **kwargs)


def test_eval_forward_with_the_crop_teacher_matches_reference_given_the_key(crop_pair):
    jfield, params, model = crop_pair
    b = _batch(25)
    jt, tt = jtrain.TrainConfig(), trainer.TrainConfig()
    jr, tr = jnerf.RenderConfig(n_coarse=N_COARSE), RenderConfig(n_coarse=N_COARSE)
    batch = {k: jnp.asarray(v[:1]) for k, v in b.items()}
    key, k_aug = jax.random.PRNGKey(26), jax.random.PRNGKey(27)
    with pytest.raises(flax.errors.InvalidRngError):  # raised while tracing
        jax.jit(lambda p, b: jtrain.stage1_eval_forward(jfield, p, b, key, jt, jr))(params, batch)
    with caught_crop_keys() as keys:
        ref = jax.jit(lambda p, b: jtrain.stage1_eval_forward(_WithAugment(jfield, k_aug), p, b, key, jt, jr))(
            params, batch)
    assert len(keys) == 1
    u = _t(jax.random.uniform(jax.random.split(key, 5)[0], (V * H * W, N_COARSE)))
    out = trainer.stage1_eval_forward(model, {k: _t(v[:1]) for k, v in b.items()}, tt, tr, u=u,
                                      crops=_crops_from_key(keys[0], V))
    assert out["dino_gt_grid"].shape == out["dino_pred_grid"].shape == (1, V, H, W, 64)
    for k in ("depth", "rgb"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("dino_pred_grid", "dino_gt_grid"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4, err_msg=k)
    # from a generator: u first, then the crops of every view
    drawn = trainer.stage1_eval_forward(model, {k: _t(v[:1]) for k, v in b.items()}, tt, tr,
                                        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn["dino_gt_grid"]).all()


def test_encoder_config_reads_the_upsampler_recipe():
    from scenedino_torch.utils.config import load

    conf = load("configs/train_scenedino_kitti_360_upsampler.yaml")
    cfg = encoder_config_from_dict(trainer.configs_from_dict(conf)[0]["encoder"])
    assert (cfg.mode, cfg.upsampler_arch, cfg.image_size) == ("upsample-gt", "multiscale-crop", (192, 640))
    assert trainer.configs_from_dict(conf)[1].dino_upscaled


def test_reference_checkpoint_of_an_upsample_gt_model_loads_strictly(crop_pair):
    """A BTSWrapper state dict of an upsample-gt model (student, decoder,
    teacher, dim reduction, heads; no downsampler, no artifact field)
    converts strictly, to the port's state and to JAX's tree."""
    from scenedino_tpu.utils import checkpoint as CK
    from scenedino_torch.utils.convert import convert_scenedino_checkpoint, to_reference_layout

    jfield, params, model = crop_pair
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd = to_reference_layout(state)
    assert not any(".downsampler." in k for k in sd) and "artifact_field" not in sd
    converted = convert_scenedino_checkpoint(sd)
    assert converted.artifact_field is None and converted.head is None
    fresh = make_model(_model_conf(upsampler_arch="multiscale-crop"), device="cpu", seed=3, training=True)
    fresh.load_state_dict(converted.field, strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k
    jtree = CK.convert_scenedino_checkpoint({k: v.numpy() for k, v in sd.items()}, strict=True)
    ref = from_jax_params(jtree["params"] if "params" in jtree else jtree)[0]
    assert sorted(ref) == sorted(state)
    for k, v in ref.items():
        assert torch.equal(v, state[k]), k
