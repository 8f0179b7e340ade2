"""Parity of the port's stage-2 training (`training/downstream.py`, the
stage-2 validator and write-back of `training/validation.py`) with the JAX
reference on the CPU, and the stage-2 run (`cli.train --stage semantic`,
checkpoints, resume, `resume_from`).

The field is tests/test_torch_training.py's tiny flagship (ViT-S/8 cut to
width 64, depth 3; DPT 16; an 8-d field feature expanded to 64; a 16-wide
head; 32x64 images, B = 2, V = 4), its JAX tree drawn with numpy and
loaded strictly into the port; the head is 5 clusters over 4 classes,
code 8, a 10-row buffer of 8-sample crops, 3 crops a frame, 2 neighbours.
The draws are the JAX functions' own, rebuilt from their keys as the
reference splits them (`downstream_forward`: `split(key, 6)` into the
side coin's `uniform`, the side view's `randint`, the render strata's
per-frame `split(., 5)[0]` `uniform`, the crops' key, the head's key and
the dropout rng; `sample_3d_crops`: `split(key, 4)` into the per-frame,
per-crop `gumbel` of the pixel pick, the sphere's `normal` and `uniform`
and the tie-break `uniform`; `seed_cluster_centers`: `split(key, 4)` into
the forward, the subsample's `choice` and the two k-means++ keys); the
dropout masks are the ones flax draws (`jax.random.bernoulli` wrapped).

Tolerances: fp32, JAX under "highest" matmul precision. The render and
everything after it pass through the ViT and the DPT: values atol 1e-4
(1e-5 x the largest magnitude where larger), rtol 1e-4; labels, crop
validity, assignments and counters exactly; gradients per tensor
|g - g_ref| <= 1e-3 |g_ref| (L2 norms, as the stage-1 step's); after one
Adam step the parameters to 1e-3 x lr where the gradient is live, as
tests/test_torch_training.py argues, and after the second to 1e-2 x lr
(the update then divides the first moment of two gradients, which can
nearly cancel, by the second's root).
"""
import dataclasses
import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.models.downstream as jds
import scenedino_tpu.training.downstream as jdown
import scenedino_tpu.training.validation as jval
from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.renderer.nerf import RenderConfig as JRenderConfig
from scenedino_torch.cli import train as cli
from scenedino_torch.models import downstream as ds
from scenedino_torch.models.factory import make_model
from scenedino_torch.renderer.nerf import RenderConfig
from scenedino_torch.training import downstream as down
from scenedino_torch.training import validation
from scenedino_torch.utils import config as yaml_config
from scenedino_torch.utils.checkpoint import load_checkpoint, save_checkpoint, train_state_dict
from scenedino_torch.utils.convert import load_jax_head, load_jax_params
from tests.test_torch_ddp import _adam_mu
from tests.test_torch_downstream import _head_draws, _jbuffers, dropout_masks
from tests.test_torch_training import MODEL, _batch, _random_params

B, V, H, W, K = 2, 4, 32, 64, 8
DCFG = dict(lr=1e-3, render_height=H, render_width=W, n_crops=3, n_samples=8)
HEAD = dict(n_classes=5, gt_classes=4, input_dim=64, code_dim=8, buffer_size=10, patch_sample_size=8,
            knn_neighbors=2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=1e-4):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, ref, atol=max(1e-4, 1e-5 * float(np.abs(ref).max())), rtol=rtol)


def _grad_rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _stage2_batch(seed=0):
    batch = _batch(seed)
    batch["segs"] = np.random.default_rng(seed + 50).integers(0, 4, size=(B, 1, H, W)).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def setup():
    """The JAX field and head, their variables, and the port's on the same weights."""
    jfield = j_make_model(MODEL)
    params = _random_params(jfield, _batch())
    model = make_model(MODEL, device="cpu", training=True)
    load_jax_params(model, params["params"])
    model.eval().requires_grad_(False)
    jhead = jds.SemanticHead(cfg=jds.SemanticHeadConfig(**HEAD))
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda: jhead.init(  # compiled once: op by op the init takes ~10 s
        {"params": k, "dropout": k}, jnp.zeros((1, 1, H, W, 1, 64)), jds.RingBufferState.create(10, 8, 64), k,
        crop_features=jnp.zeros((3, 8, 64)), seg_target=jnp.zeros((1, H, W), jnp.int32), deterministic=True,
        method=jds.SemanticHead.forward_training))()
    rng = np.random.default_rng(3)
    hparams = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                                                           / np.sqrt(x.shape[0] if x.ndim == 2 else 10)),
                                     dict(variables["params"]))
    hvars = {"params": hparams, "state": variables["state"]}
    return dict(jfield=jfield, params=params, model=model, jhead=jhead, hvars=hvars,
                jcfg=jdown.DownstreamTrainConfig(**DCFG), cfg=down.DownstreamTrainConfig(**DCFG),
                jrcfg=JRenderConfig(n_coarse=K), rcfg=RenderConfig(n_coarse=K))


def _port_head(s):
    head = ds.SemanticHead(ds.SemanticHeadConfig(**HEAD))
    load_jax_head(head, s["hvars"])
    return head


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v).long() if k == "segs" else _t(v) for k, v in batch.items()}


def _crop_draws(key, cfg):
    """sample_3d_crops' draws from its key."""
    k_pix, k_dir, k_rad, k_tie = jax.random.split(key, 4)
    NS = cfg.oversampling * cfg.n_samples
    gum = np.stack([np.stack([np.asarray(jax.random.gumbel(kc, (H * W,)))
                              for kc in jax.random.split(kb, cfg.n_crops)]) for kb in jax.random.split(k_pix, B)])
    shape = (B, cfg.n_crops, NS)
    return (_t(gum), _t(jax.random.normal(k_dir, (*shape, 3))), _t(jax.random.uniform(k_rad, (*shape, 1))),
            _t(jax.random.uniform(k_tie, shape)))


def _strata(key, n_coarse=K):
    return torch.stack([_t(jax.random.uniform(jax.random.split(kb, 5)[0], (H * W, n_coarse)))
                        for kb in jax.random.split(key, B)])


def _stage2_draws(key, cfg, filled, masks, training):
    """downstream_forward's draws from its key (`filled`: the buffer's mark
    when the head draws its random rows)."""
    k_view, k_side, k_render, k_crop, k_head, _ = jax.random.split(key, 6)
    coin = bool(jax.random.uniform(k_view) < cfg.side_view_prob)
    side = int(jax.random.randint(k_side, (), min(4, V - 1), V))
    pick, u = _head_draws(k_head, B * cfg.n_crops, HEAD["knn_neighbors"], filled)
    head = ds.HeadDraws(pick, u, _t(np.stack(masks[:4])) if training else None)
    return down.Stage2Draws(coin, side, _strata(k_render), *_crop_draws(k_crop, cfg), head)


def _filled_buffers(seed=5, filled=7):
    rng = np.random.default_rng(seed)
    b = ds.RingBufferState.create(10, 8, 64)
    b.patch_buffer.copy_(_t(rng.normal(size=(10, 8, 64)).astype(np.float32) * 0.1))
    b.gap_buffer.copy_(_t(rng.normal(size=(10, 64)).astype(np.float32)))
    b.idx, b.filled = filled, filled
    return b


def _key_with_side(want: bool, start=20):
    """A key whose side coin comes up `want`."""
    for i in range(start, start + 50):
        key = jax.random.PRNGKey(i)
        if bool(jax.random.uniform(jax.random.split(key, 6)[0]) < 0.5) == want:
            return key
    raise AssertionError("no key found")


def test_sample_3d_crops_matches_reference_and_flags_empty_strata(setup):
    """Frame 0 a spread of depths, some at or past z_far; frame 1 one depth
    everywhere, so every stratum is empty (strict bounds) and each crop
    invalid, with finite features."""
    s = setup
    batch = _stage2_batch()
    rng = np.random.default_rng(9)
    depth = np.stack([rng.uniform(3, 90, size=(H, W)), np.full((H, W), 12.0)]).astype(np.float32)
    key = jax.random.PRNGKey(4)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 1, 4, 4)).copy()
    projs = batch["projs"][:, :1]

    @jax.jit
    def jcrops(params, imgs, depth, poses, projs):  # the encode and the crops in one compiled call
        jstate = s["jfield"].apply(params, imgs, projs, poses, ids_encoder=(0,), method=type(s["jfield"]).encode)
        return jdown.sample_3d_crops(s["jfield"], params, jstate, depth, poses, projs, key, s["jcfg"])

    ref, ref_valid = jcrops(s["params"], jnp.asarray(batch["imgs"][:, :1]), jnp.asarray(depth), jnp.asarray(poses),
                            jnp.asarray(projs))
    state = s["model"].encode(_t(batch["imgs"][:, :1]), _t(projs), _t(poses), ids_encoder=(0,))
    draws = down.Stage2Draws(False, 0, None, *_crop_draws(key, s["cfg"]), None)
    out, valid = down.sample_3d_crops(s["model"], state, _t(depth), _t(poses), _t(projs), draws, s["cfg"])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert not valid[1].any() and valid[0].any()
    assert torch.isfinite(out).all()
    _close(out, ref)


@pytest.fixture(scope="module")
def jax_forward(setup):
    """JAX's downstream_forward, compiled once for each value of `training`."""
    s = setup
    return {training: jax.jit(lambda b, buf, k, training=training: jdown.downstream_forward(
        s["jfield"], s["params"], s["jhead"], s["hvars"], b, buf, k, s["jcfg"], s["jrcfg"], training=training))
        for training in (True, False)}


@pytest.mark.parametrize("mode", ["train-front", "train-side", "eval"])
def test_downstream_forward_matches_reference(setup, jax_forward, mode):
    s = setup
    training = mode != "eval"
    key = _key_with_side(mode != "train-front")
    batch = _stage2_batch(1)
    head = _port_head(s)
    buffers = _filled_buffers()
    jseg, jrend, jbuf, _ = jax_forward[training](_jbatch(batch), _jbuffers(buffers), key)
    masks = _step_masks(s, key) if training else None
    draws = _stage2_draws(key, s["cfg"], int(jbuf.filled), masks, training)
    assert draws.side_coin == (mode != "train-front")
    seg, rend, pbuf = down.downstream_forward(s["model"], head, _tbatch(batch), buffers, draws, s["cfg"], s["rcfg"],
                                              training=training)
    for k in ("depth", "dino_features", "rgb"):
        _close(rend[k], jrend[k])
    for k, v in jseg["stego_corr"].items():
        if k == "crop_valid":
            np.testing.assert_array_equal(seg["stego_corr"][k].numpy(), np.asarray(v))
        else:
            _close(seg["stego_corr"][k], v)
    assert sorted(seg["results"]) == sorted(jseg["results"])
    for name, res in jseg["results"].items():
        for k, v in res.items():
            if k in ("pseudo_segs_pred", "segs_pred"):
                np.testing.assert_array_equal(seg["results"][name][k].numpy(), np.asarray(v), err_msg=name)
            else:
                _close(seg["results"][name][k], v)
    if mode == "train-side":
        assert float(jseg["results"]["direct_linear"]["loss"]) == 0.0  # the side view has no segmentation
    assert (pbuf.idx, pbuf.filled) == (int(jbuf.idx), int(jbuf.filled))
    np.testing.assert_allclose(pbuf.patch_buffer.numpy(), np.asarray(jbuf.patch_buffer), atol=1e-5, rtol=0)


@pytest.mark.parametrize("init_type", ["kmeans++", "random"])
def test_seed_cluster_centers_matches_reference(setup, init_type):
    s = setup
    batch = _stage2_batch(2)
    key, max_points = jax.random.PRNGKey(8), 1000
    ref = jax.jit(lambda b, k: jdown.seed_cluster_centers(s["jfield"], s["params"], s["jhead"], s["hvars"], b, k,
                                                          s["jcfg"], s["jrcfg"], init_type=init_type,
                                                          max_points=max_points))(_jbatch(batch), key)
    k_fwd, k_sub, k_d, k_s = jax.random.split(key, 4)
    n = B * H * W
    sub = _t(np.asarray(jax.random.choice(k_sub, n, (max_points,), replace=False)).astype(np.int64))
    if init_type == "kmeans++":
        from tests.test_torch_downstream import _kmeans_pp_draws

        direct, stego = _kmeans_pp_draws(k_d, max_points, 5), _kmeans_pp_draws(k_s, max_points, 5)
    else:
        direct, stego = _t(jax.random.normal(k_d, (5, 64))), _t(jax.random.normal(k_s, (5, 8)))
    draws = down.SeedDraws(_strata(jax.random.split(k_fwd, 6)[2]), sub, direct, stego)
    head = _port_head(s)
    down.seed_cluster_centers(s["model"], head, _tbatch(batch), draws, s["cfg"], s["rcfg"])
    _close(head.direct_cluster_head.cluster_centers, ref["params"]["direct_cluster_head"]["cluster_centers"])
    _close(head.stego_cluster_head.cluster_centers, ref["params"]["stego_cluster_head"]["cluster_centers"])


def _step_masks(s, key):
    """The dropout masks of a training forward with `key`: flax derives them
    from the dropout rng and the call order alone, so the head's forward on
    small stand-in inputs draws the same ones."""
    with dropout_masks() as masks:
        s["jhead"].apply(s["hvars"], jnp.zeros((1, 1, 2, 2, 1, 64)), jds.RingBufferState.create(10, 8, 64),
                         jax.random.split(key, 6)[4], crop_features=jnp.ones((3, 8, 64)), deterministic=False,
                         crop_valid=jnp.ones(3, bool), method=jds.SemanticHead.forward_training,
                         rngs={"dropout": jax.random.split(key, 6)[5]}, mutable=["state"])
    return masks


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Two JAX stage-2 steps from fresh buffers, their loss dicts, masks,
    the gradients of the first and the states after each."""
    s = setup
    tx = jdown.make_downstream_optimizer(s["jcfg"], s["hvars"]["params"])
    state = jdown.init_downstream_state(s["hvars"], s["jcfg"], jds.SemanticHeadConfig(**HEAD), tx)
    step = jdown.make_downstream_train_step(s["jfield"], s["params"], s["jhead"], s["jcfg"], s["jrcfg"], tx)
    keys = [jax.random.PRNGKey(30), jax.random.PRNGKey(31)]
    batches = [_stage2_batch(3), _stage2_batch(4)]
    out = {"states": [state], "losses": [], "masks": [], "keys": keys, "batches": batches, "step": step}
    for key, batch in zip(keys, batches):
        state, losses = step(state, _jbatch(batch), key)
        out["losses"].append(losses)
        out["masks"].append(_step_masks(s, key))
        out["states"].append(state)
    # the first step's gradients, read back from Adam's first moment (mu = (1 - b1) g): one compile serves
    out["grads"] = {}
    for path, mu in _adam_mu(out["states"][1].opt_state).items():
        *keys_, leaf = path.split("/")
        functools.reduce(lambda d, k: d.setdefault(k, {}), keys_, out["grads"])[leaf] = mu / 0.1
    return out


def test_train_step_matches_reference(setup, jax_steps):
    """Two steps: the loss dicts, every head gradient of the first, the
    parameters and buffers after each."""
    s = setup
    head = _port_head(s)
    state = down.init_downstream_state(head, s["cfg"])
    step = down.make_downstream_train_step(s["model"], head, s["cfg"], s["rcfg"])
    for i, (key, batch) in enumerate(zip(jax_steps["keys"], jax_steps["batches"])):
        jnew = jax_steps["states"][i + 1]
        draws = _stage2_draws(key, s["cfg"], int(jnew.buffers.filled), jax_steps["masks"][i], True)
        before = {n: p.detach().clone() for n, p in head.named_parameters()}
        losses = step(state, _tbatch(batch), draws)
        ref = jax_steps["losses"][i]
        assert sorted(losses) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(float(losses[k]), float(ref[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        if i == 0:
            for name, p in head.named_parameters():
                *path, leaf = name.split(".")
                g = jax_steps["grads"][path[0]]
                for k in path[1:]:
                    g = g[k]
                g = np.asarray(g[{"weight": "kernel"}.get(leaf, leaf)])
                g = g.T if leaf == "weight" else g
                assert _grad_rel_err(p.grad, g) <= 1e-3, name
        new_params = jnew.head_variables["params"]
        for name, p in head.named_parameters():
            *path, leaf = name.split(".")
            ref_p = new_params
            for k in path:
                ref_p = ref_p[k]
            ref_p = np.asarray(ref_p[{"weight": "kernel"}.get(leaf, leaf)])
            ref_p = ref_p.T if leaf == "weight" else ref_p
            lr = s["cfg"].lr * (1.0 if name.startswith("stego_head.") else s["cfg"].head_lr_factor)
            if i == 0:  # Adam's first update is lr sign(g) where the gradient is live
                assert float((p.detach() - before[name]).abs().max()) <= lr * (1 + 1e-3), name
            # after the second step the update is m / sqrt(v) of two gradients: where they
            # nearly cancel, their 1e-3 relative errors weigh 10x more in m
            live = p.grad.abs() > 1e-4 * float(p.grad.abs().max())
            np.testing.assert_allclose(p.detach()[live].numpy(), ref_p[live.numpy()], atol=(1e-3, 1e-2)[i] * lr,
                                       rtol=5e-7, err_msg=name)
        b = state.buffers
        assert (b.idx, b.filled) == (int(jnew.buffers.idx), int(jnew.buffers.filled))
        np.testing.assert_allclose(b.patch_buffer.numpy(), np.asarray(jnew.buffers.patch_buffer), atol=1e-5, rtol=0)
        np.testing.assert_allclose(b.gap_buffer.numpy(), np.asarray(jnew.buffers.gap_buffer), atol=1e-5, rtol=0)
    assert state.step == state.applied == 2


def test_nonfinite_step_is_skipped_like_optax(setup, jax_steps):
    """A NaN image: the head's parameters and Adam moments stay, the
    counters move as the reference's apply_if_finite moves them; after more
    than skip_nonfinite_steps bad steps in a row the update goes through."""
    s = setup
    head = _port_head(s)
    cfg = dataclasses.replace(s["cfg"], skip_nonfinite_steps=2)
    state = down.init_downstream_state(head, cfg)
    step = down.make_downstream_train_step(s["model"], head, cfg, s["rcfg"])
    batch = _tbatch(_stage2_batch(6))
    g = torch.Generator().manual_seed(0)
    step(state, batch, down.draw_stage2(g, cfg, head.cfg, s["rcfg"], B, V))
    snap = {n: p.detach().clone() for n, p in head.named_parameters()}
    moments = {k: v.clone() for k, v in state.optimizer.state[head.stego_head.linear.weight].items()}
    bad = dict(batch, imgs=batch["imgs"].clone())
    bad["imgs"][:, :, :, 3, 5] = float("nan")
    # the reference's step on the same NaN batch from its first state: skipped, counted
    jbad = _jbatch({**_stage2_batch(6), "imgs": bad["imgs"].numpy()})
    jstate, jlosses = jax_steps["step"](jax_steps["states"][1], jbad, jax.random.PRNGKey(50))
    assert (int(jlosses["nonfinite_consecutive"]), int(jlosses["nonfinite_total"]),
            int(jlosses["nonfinite_gave_up"])) == (1, 1, 0)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(jstate.head_variables["params"]),
                                                    jax.tree_util.tree_leaves(
                                                        jax_steps["states"][1].head_variables["params"])))
    for i in (1, 2):
        losses = step(state, bad, down.draw_stage2(g, cfg, head.cfg, s["rcfg"], B, V))
        assert not np.isfinite(float(losses["total_loss"]))
        assert (losses["nonfinite_consecutive"], losses["nonfinite_total"], losses["nonfinite_gave_up"]) == (i, i, 0)
        assert all(torch.equal(p, snap[n]) for n, p in head.named_parameters())
        st = state.optimizer.state[head.stego_head.linear.weight]
        assert all(torch.equal(st[k], v) for k, v in moments.items())
    losses = step(state, bad, down.draw_stage2(g, cfg, head.cfg, s["rcfg"], B, V))
    assert losses["nonfinite_gave_up"] == 1 and state.applied == 2 and state.step == 4
    assert not torch.isfinite(head.stego_head.linear.weight).all()


def test_stage2_validator_and_write_back_match_reference(setup, monkeypatch):
    s = setup
    val_cfg = {"metrics": [{"type": "seg", "agg_type": "unsup_seg", "args": {"n_classes": 5, "gt_classes": 4}},
                           {"type": "stego", "agg_type": "concat"}],
               "save_best": {"metric": "stego_cluster_weighted_miou", "update_model": True}}
    batches = [_stage2_batch(10), _stage2_batch(11)]
    buffers = _filled_buffers(7, 9)
    jstate = jdown.DownstreamTrainState(step=jnp.zeros((), jnp.int32), head_variables=s["hvars"], opt_state=None,
                                        buffers=_jbuffers(buffers))
    key = jax.random.PRNGKey(40)
    jv = jval.make_stage2_validator("validation", val_cfg, s["jfield"], s["params"], s["jhead"], s["jcfg"],
                                    s["jrcfg"], lambda: iter(_jbatch(b) for b in batches))
    ref = jv(jstate, key)
    subs, k = [], key
    for _ in batches:
        k, sub = jax.random.split(k)
        subs.append(sub)
    draws = iter(_stage2_draws(sub, s["cfg"], buffers.filled, None, False) for sub in subs)
    monkeypatch.setattr(down, "draw_stage2", lambda *a, **kw: next(draws))
    head = _port_head(s)
    state = down.DownstreamTrainState(None, buffers)
    v = validation.make_stage2_validator("validation", val_cfg, s["model"], head, s["cfg"], s["rcfg"],
                                         lambda: iter(_tbatch(b) for b in batches))
    out = v(state, None)
    assert sorted(out) == sorted(ref)
    for k_, r in ref.items():
        if k_.endswith(("_assignment", "_confusion_matrix")):
            np.testing.assert_array_equal(out[k_], np.asarray(r), err_msg=k_)
        else:
            np.testing.assert_allclose(np.asarray(out[k_], np.float64), np.asarray(r, np.float64), atol=1e-4,
                                       err_msg=k_)
    assert v.save_best.update_model and v.every == 5000
    new_ref = jval.make_update_model_fn()(jstate.replace(), ref).head_variables["state"]
    validation.make_update_model_fn()(head, state, out)
    for name in ("direct_cluster_head", "stego_cluster_head"):
        np.testing.assert_array_equal(getattr(head, name).pseudo_assignment.numpy(),
                                      np.asarray(new_ref[name]["pseudo_assignment"]))


# --------------------------------------------------------------- the run
def _semantic_config(out, stop, resume_from, cont=False):
    conf = yaml_config.load(os.path.join(ROOT, "configs", "train_semantic_synthetic_convergence.yaml"))
    conf["dataset"].update(length=4, image_size=[24, 48])
    conf["model"]["encoder"]["image_size"] = [24, 48]
    conf["batch_size"] = 2
    conf["num_workers"] = 2
    conf["resume_from"] = resume_from
    conf["downstream"].update(buffer_size=8, patch_sample_size=16)
    conf["training"].update(stop_iteration=stop, checkpoint_every=2, log_every=1, num_epochs=10)
    conf["training"]["continue"] = cont
    conf["validation"]["validation"]["events"][0]["args"]["every"] = 2
    conf["validation"]["validation"]["subset"]["args"] = {"start": 0, "end": 2}
    conf["output"]["path"] = str(out)
    return conf


def test_cli_semantic_trains_validates_checkpoints_and_resumes(tmp_path, caplog):
    """2 steps of the synthetic stage-2 recipe on the CPU from the s1b JAX
    tree (.npz), a validation with the write-back, checkpoints; then a
    resume to 3; the checkpoint loads back equal; the field snapshot and a
    stage-1 checkpoint serve as resume_from."""
    npz = os.path.join(ROOT, "tests", "goldens", "s1b_field_params.npz")
    out = tmp_path / "s2"
    cfg_path = tmp_path / "s2.yaml"
    cfg_path.write_text(yaml_config.dumps(_semantic_config(out, 2, npz)))
    with caplog.at_level(logging.INFO):
        cli.main(["--config", str(cfg_path), "--stage", "semantic", "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    vals = [r for r in caplog.records if hasattr(r, "validator")]
    written = [r for r in caplog.records if hasattr(r, "pseudo_assignment")]
    assert [r.iteration for r in steps] == [1, 2] and all(np.isfinite(list(r.losses.values())).all() for r in steps)
    assert len(vals) == 1 and "stego_cluster_weighted_miou" in vals[0].metrics
    assert len(written) == 1
    for key in ("direct_cluster_assignment", "stego_cluster_assignment"):
        assert written[0].pseudo_assignment[key] == vals[0].arrays[key].tolist()
    assert sorted(p.name for p in out.glob("*.pt")) == ["field_params.pt", "stego_cluster_weighted_miou_best_2.pt",
                                                       "training_checkpoint_2.pt"]
    # the loop writes the assignment back, then saves the best checkpoint: it holds the new assignment
    best = torch.load(out / "stego_cluster_weighted_miou_best_2.pt", weights_only=True)["head"]
    for key in ("direct_cluster", "stego_cluster"):
        assert best[f"{key}_head.pseudo_assignment"].tolist() == written[0].pseudo_assignment[f"{key}_assignment"]
    ckpt = torch.load(out / "training_checkpoint_2.pt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["buffers"]["filled"] >= 1

    conf = _semantic_config(out, 3, npz, cont=True)
    field, head, state, *_ = cli.init_stage2(conf, "cpu")
    load_checkpoint(str(out / "training_checkpoint_2.pt"), head, state)
    saved = train_state_dict(head, state)
    save_checkpoint(str(tmp_path / "again.pt"), head, state)
    again = torch.load(tmp_path / "again.pt", weights_only=True)
    assert again.keys() == saved.keys() and all(
        torch.equal(again["head"][k], v) for k, v in saved["head"].items())
    assert torch.equal(again["buffers"]["patch_buffer"], ckpt["buffers"]["patch_buffer"])

    caplog.clear()
    cfg_path.write_text(yaml_config.dumps(conf))
    with caplog.at_level(logging.INFO):
        cli.main(["--config", str(cfg_path), "--stage", "semantic", "--device", "cpu"])
    resumed = [r for r in caplog.records if hasattr(r, "resumed_from")]
    assert len(resumed) == 1 and resumed[0].iteration == 2
    assert [r.iteration for r in caplog.records if hasattr(r, "losses")] == [3]

    # resume_from: the run's own field snapshot and a stage-1 checkpoint load the same field
    ref = {k: v.clone() for k, v in field.state_dict().items()}
    for source in (str(out / "field_params.pt"), str(out)):
        other = make_model(conf["model"], device="cpu", seed=1, training=True)
        cli.load_field(other, source if source.endswith(".pt") else _stage1_dir(tmp_path, field))
        assert all(torch.equal(v, ref[k]) for k, v in other.state_dict().items())
    with pytest.raises(ValueError, match="unrecognized checkpoint layout"):
        cli.load_field(field, str(out / "training_checkpoint_2.pt"))


def _stage1_dir(tmp_path, field):
    """A directory holding a stage-1 checkpoint of `field`."""
    run = tmp_path / "s1"
    run.mkdir(exist_ok=True)
    torch.save({"field": field.state_dict(), "step": 4}, run / "training_checkpoint_4.pt")
    return str(run)
