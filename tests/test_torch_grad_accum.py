"""Gradient accumulation of the port's stage-1 step against optax's
`apply_if_finite(MultiSteps(...))` (scenedino_tpu/training/trainer.py:118-126,
:629-635), and `fit` through the sample-count schedule, on the CPU.

The model, weights and draws are tests/test_torch_training.py's (the JAX
step's draws rebuilt from its key). With k = 2: two identical
micro-batches give one k = 1 step (within 1e-7; the accumulator's running
mean of two equal gradients is the gradient), and the first leaves the
parameters, the artifact field and Adam's state as they were, bit for
bit; two different micro-batches give JAX's accumulator after the first
and JAX's state after its two calls, the parameters within 1e-5 where
JAX's accumulated gradient, read back from Adam's first moment, is live
(where the two packages' gradients agree within 10 % and exceed 100 x
Adam's eps; elsewhere |update| <= lr), the artifact field within 1e-3 x lr;
a micro-batch with a NaN gradient
(injected by a gradient hook) is dropped whole: the accumulator and its
count do not move and the skip counters do.
"""
import jax
import numpy as np
import pytest
import torch

import scenedino_tpu.losses.reconstruction as jrec
import scenedino_tpu.renderer.nerf as jnerf
import scenedino_tpu.training.trainer as jtrain
from scenedino_torch.losses import reconstruction as rec
from scenedino_torch.models.factory import make_model
from scenedino_torch.renderer.nerf import RenderConfig
from scenedino_torch.training import trainer
from scenedino_torch.training import loop
from scenedino_torch.training.loop import LoopConfig, MetricLogger, fit
from scenedino_torch.utils.convert import artifact_from_jax, from_jax_params
from tests.test_torch_training import (  # noqa: F401  (models: the shared module fixture)
    ART_SHAPE,
    LR_TOL,
    MODEL,
    N_COARSE,
    TCFG,
    H,
    W,
    _batch,
    _grad_rel_err,
    _jax_draws,
    _jbatch,
    _tbatch,
    models,
)
from tests.test_torch_stage1_branches import SCHED

K = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _snapshot(model, state):
    opt = [t.clone() for s in state.optimizer.state.values() for t in s.values()]
    art_opt = [t.clone() for s in state.artifact_optimizer.state.values() for t in s.values()]
    return [p.detach().clone() for p in model.parameters()] + [state.artifact_field.detach().clone()] + opt + art_opt


def _fresh(model, jstate, tcfg):
    model.load_state_dict(from_jax_params(jstate.params["params"])[0])
    return trainer.init_train_state(model, tcfg, artifact_field=artifact_from_jax(jstate.artifact_field))


@pytest.fixture(scope="module")
def jax_accum(models):
    """JAX's state after two k = 2 calls on two different batches and keys."""
    jfield, params, _ = models
    jt = jtrain.TrainConfig(**TCFG, gradient_accum_factor=K)
    state, tx = jtrain.init_train_state(jfield, params, jt, artifact_shape=ART_SHAPE, key=jax.random.PRNGKey(3))
    step = jax.jit(jtrain.make_train_step(jfield, jt, jnerf.RenderConfig(n_coarse=N_COARSE),
                                          jrec.ReconstructionLossConfig(), tx))
    calls = [(_batch(0), jax.random.PRNGKey(12)), (_batch(1), jax.random.PRNGKey(13))]
    states, losses = [state], []
    for batch, key in calls:
        new, l = step(states[-1], _jbatch(batch), key)
        states.append(new)
        losses.append(l)
    return dict(jt=jt, states=states, losses=losses, calls=calls)


def test_identical_micro_batches_equal_one_step(models, jax_accum):
    _, _, model = models
    jt0 = jax_accum["states"][0]
    rcfg, lcfg = RenderConfig(n_coarse=N_COARSE), rec.ReconstructionLossConfig()
    batch, key = jax_accum["calls"][0]
    draws = _jax_draws(key, jax_accum["jt"], jnerf.RenderConfig(n_coarse=N_COARSE))

    one = _fresh(model, jt0, trainer.TrainConfig(**TCFG))
    trainer.make_train_step(model, trainer.TrainConfig(**TCFG), rcfg, lcfg)(one, _tbatch(batch), draws)
    after_one = [p.detach().clone() for p in model.parameters()] + [one.artifact_field.detach().clone()]

    tk = trainer.TrainConfig(**TCFG, gradient_accum_factor=K)
    state = _fresh(model, jt0, tk)
    step = trainer.make_train_step(model, tk, rcfg, lcfg)
    before = _snapshot(model, state)
    step(state, _tbatch(batch), draws)
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(model, state), before))  # nothing moved
    assert (state.step, state.applied, state.mini_step) == (1, 0, 1) and not state.optimizer.state
    step(state, _tbatch(batch), draws)
    assert (state.step, state.applied, state.mini_step) == (2, 1, 0)
    got = [p.detach() for p in model.parameters()] + [state.artifact_field.detach()]
    for a, b in zip(got, after_one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)
    assert all(float(a.abs().max()) == 0 for a in state.acc_grads)  # restarted


def _jax_mean_gradient(opt_state):
    """The mean gradient JAX applied first, from Adam's first moment after
    that one update (mu = (1 - b1) g), both rate groups merged: {port name: tensor}."""
    import optax

    merged = {}
    for masked in opt_state.inner_state.inner_opt_state.inner_states.values():
        mu = masked.inner_state[0].mu
        flat = jax.tree_util.tree_flatten_with_path(mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
        for path, leaf in flat:
            if not isinstance(leaf, optax.MaskedNode):
                merged["/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf) / 0.1
    return from_jax_params(merged)[0]


def test_different_micro_batches_match_reference(models, jax_accum):
    """The accumulator after the first micro-batch against optax's (each
    tensor within 1e-3 of its L2 norm, the stage-1 gradient bound), then the
    parameters after the second as tests/test_torch_training.py holds one
    step, where JAX's accumulated gradient is live."""
    _, _, model = models
    tk = trainer.TrainConfig(**TCFG, gradient_accum_factor=K)
    states = jax_accum["states"]
    state = _fresh(model, states[0], tk)
    step = trainer.make_train_step(model, tk, RenderConfig(n_coarse=N_COARSE), rec.ReconstructionLossConfig())
    old = from_jax_params(states[0].params["params"])[0]
    names = [n for n, _ in model.named_parameters()]
    for i, (batch, key) in enumerate(jax_accum["calls"]):
        losses = step(state, _tbatch(batch), _jax_draws(key, jax_accum["jt"], jnerf.RenderConfig(n_coarse=N_COARSE)))
        ref = jax_accum["losses"][i]
        for name in ("rec_loss", "nonfinite_consecutive", "nonfinite_total"):
            np.testing.assert_allclose(float(losses[name]), float(ref[name]), rtol=1e-5, err_msg=f"{i} {name}")
        if i == 0:
            acc = from_jax_params(states[1].opt_state.inner_state.acc_grads["params"])[0]
            by_param = dict(zip([n for g in state.optimizer.param_groups for n in
                                 [names[[id(q) for q in model.parameters()].index(id(p))] for p in g["params"]]],
                                state.acc_grads))
            errs = {n: _grad_rel_err(by_param[n], acc[n]) for n in by_param if float(acc[n].abs().max()) > 0}
            worst = max(errs, key=errs.get)
            assert errs[worst] <= 1e-3, (worst, errs[worst])
    # JAX's first call left its parameters bit for bit (x + 0)
    for a, b in zip(jax.tree_util.tree_leaves(states[1].params), jax.tree_util.tree_leaves(states[0].params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    new = from_jax_params(states[2].params["params"])[0]
    mean = _jax_mean_gradient(states[2].opt_state)
    moved = 0
    for name, p in model.named_parameters():
        got, ref, g = p.detach(), new[name], mean[name]
        lr = tk.lr * (tk.encoder_lr_factor if name.startswith("encoder.vit_encoder.") else 1.0)
        assert float((got - old[name]).abs().max()) <= lr * (1 + 1e-3), name
        # live: where the two packages' accumulated gradients agree within
        # 10 % and |g| is above 100 x Adam's eps, so that the update's sign
        # and size are set by g, not by its round-off (the mean of two
        # batches' gradients cancels in places, and the ViT's position
        # embedding has gradients near eps here); the gradients themselves
        # are held per tensor above
        pg = torch.zeros_like(g) if p.grad is None else p.grad
        live = ((pg - g).abs() < 0.1 * g.abs()) & (g.abs() > 1e-6)
        np.testing.assert_allclose(got[live].numpy(), ref[live].numpy(), atol=1e-5, rtol=5e-7, err_msg=name)
        moved += int(live.sum())
    assert moved > 0.5 * sum(p.numel() for n, p in model.named_parameters() if not n.startswith("encoder.gt_"))
    np.testing.assert_allclose(state.artifact_field.detach().numpy(), np.asarray(states[2].artifact_field),
                               atol=LR_TOL * tk.lr, rtol=0)
    assert state.applied == 1 and state.step == 2


def test_nonfinite_micro_batch_is_dropped(models, jax_accum):
    _, _, model = models
    tk = trainer.TrainConfig(**TCFG, gradient_accum_factor=K, skip_nonfinite_steps=3)
    state = _fresh(model, jax_accum["states"][0], tk)
    step = trainer.make_train_step(model, tk, RenderConfig(n_coarse=N_COARSE), rec.ReconstructionLossConfig())
    batch, key = jax_accum["calls"][0]
    draws = _jax_draws(key, jax_accum["jt"], jnerf.RenderConfig(n_coarse=N_COARSE))
    step(state, _tbatch(batch), draws)
    acc = [a.clone() for a in state.acc_grads]
    before = _snapshot(model, state)
    head = next(p for n, p in model.named_parameters() if n.startswith("heads."))
    hook = head.register_hook(lambda g: g * float("nan"))
    losses = step(state, _tbatch(batch), draws)
    hook.remove()
    assert (int(losses["nonfinite_consecutive"]), int(losses["nonfinite_total"])) == (1, 1)
    assert (state.mini_step, state.applied, state.step) == (1, 0, 2)
    assert all(torch.equal(a, b) for a, b in zip(state.acc_grads, acc))
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(model, state), before))
    losses = step(state, _tbatch(batch), draws)  # the cycle's second accepted micro-batch applies
    assert int(losses["nonfinite_consecutive"]) == 0 and int(losses["nonfinite_total"]) == 1
    assert (state.mini_step, state.applied, state.step) == (0, 1, 3)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_fit_switches_sample_counts_on_schedule(tmp_path, caplog, monkeypatch):
    """A fit of 4 steps through the schedule (tests/test_trainer_stage1.py's
    test_fit_with_scheduled_step): each step renders with the counts of its
    iteration, and the change is logged (no scalars: the TensorBoard writer's
    import alone takes seconds)."""
    monkeypatch.setattr(loop, "MetricLogger", lambda logdir: MetricLogger(None))
    model = make_model(MODEL, device="cpu", training=True)
    tt = trainer.TrainConfig(**{**TCFG, "ray_batch_size": 64, "compensate_artifacts": False})
    state = trainer.init_train_state(model, tt)
    seen = []

    def make_step(rc):
        step = trainer.make_train_step(model, tt, rc, rec.ReconstructionLossConfig())

        def train_step(state, batch, gen):
            draws = trainer.draw_stage1(gen, tt, rc, 1, 4, H, W)
            seen.append((draws.u.shape[1], 0 if draws.fine is None else draws.fine.u.shape[1]))
            return step(state, batch, draws)

        return train_step

    batch = {k: v[:1] for k, v in _tbatch(_batch()).items()}
    sts = trainer.ScheduledTrainStep(make_step, RenderConfig(n_coarse=8), SCHED)
    cfg = LoopConfig(output_path=str(tmp_path), num_epochs=1, log_every=1, checkpoint_every=100, stop_iteration=4)
    with caplog.at_level("INFO", logger="training"):
        fit(model, state, sts, lambda: iter([batch] * 4), cfg, torch.Generator().manual_seed(0))
    assert seen == [(8, 0), (8, 0), (4, 0), (12, 2)]
    assert sts.current == (12, 2) and state.step == 4
    assert sum("sampling resolution changed" in r.message for r in caplog.records) == 2
