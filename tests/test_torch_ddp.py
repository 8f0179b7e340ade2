"""Data-parallel stage 1 of the port (`scenedino_torch.parallel`) against
JAX's unsharded step, on the CPU: two gloo processes spawned with
`torch.multiprocessing`, each with one item of a global batch of two.

The model, weights and draws are tests/test_torch_training.py's (the JAX
step's draws rebuilt from its key, every rank holding the global draws
and keeping its rows). Held: the ranks' reduced loss dict against the JAX
step's (rtol 1e-5), the averaged gradients against JAX's (each tensor
within 1e-3 of its L2 norm, the stage-1 bound), the parameters after the
step within 1e-5 where the two packages' gradients agree within 10 % and
exceed 100 x Adam's eps (elsewhere |update| <= lr), equal on both ranks;
then a NaN in rank 1's images makes both ranks skip (the averaged
gradients are NaN on both) with the parameters unchanged. The spawn has
its own timeout. JAX's gradients are read back from Adam's first moment
after its step, so that one compile serves. tests/test_torch_ddp_cli.py
runs the CLI under torchrun.
"""
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scenedino_torch.utils.convert import artifact_from_jax, from_jax_params

SPAWN_TIMEOUT = 120  # seconds for the two ranks, model build and two steps included


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, inputs, out_dir):
    """One rank: the port's step on its item of the global batch, then a
    step where rank 1's images are NaN; writes what it saw to out_dir."""
    import torch

    from scenedino_torch.losses import reconstruction as rec
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.parallel.data_parallel import DataParallel
    from scenedino_torch.renderer.nerf import RenderConfig
    from scenedino_torch.training import trainer

    torch.set_num_threads(1)
    dp = DataParallel.init(rank, world, torch.device("cpu"), init_method=f"tcp://localhost:{port}")
    try:
        data = torch.load(inputs, weights_only=False)
        model = make_model(data["model"], device="cpu", training=True)
        model.load_state_dict(data["state_dict"])
        tcfg = trainer.TrainConfig(**data["tcfg"])
        state = trainer.init_train_state(model, tcfg, artifact_field=data["artifact"])
        step = trainer.make_train_step(model, tcfg, RenderConfig(n_coarse=data["n_coarse"]),
                                       rec.ReconstructionLossConfig(), average_gradients=dp.average_)
        n = data["batch"]["imgs"].shape[0]
        mine = dp.rows(n)
        batch = {k: v[mine] for k, v in data["batch"].items()}
        draws = dp.shard_draws(data["draws"], n)
        losses = dp.reduce_losses(step(state, batch, draws))
        names = [name for name, _ in model.named_parameters()]
        out = {"losses": {k: float(v) for k, v in losses.items()},
               "params": {k: p.detach().clone() for k, p in zip(names, model.parameters())},
               "grads": {k: None if p.grad is None else p.grad.clone() for k, p in zip(names, model.parameters())},
               "artifact": state.artifact_field.detach().clone(),
               "artifact_grad": state.artifact_field.grad.clone()}
        bad = dict(batch)
        if rank == 1:
            bad["imgs"] = torch.full_like(batch["imgs"], float("nan"))
        skipped = step(state, bad, draws)
        out["skip"] = {k: float(v) for k, v in skipped.items() if k.startswith("nonfinite_")}
        out["after_skip"] = {k: p.detach().clone() for k, p in zip(names, model.parameters())}
        out["counts"] = (state.step, state.applied)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield


def _adam_mu(opt_state):
    """{JAX path: Adam's first moment} of an apply_if_finite(multi_transform(adam)) state, both groups."""
    import jax
    import optax

    out = {}
    for masked in opt_state.inner_state.inner_states.values():
        flat = jax.tree_util.tree_flatten_with_path(masked.inner_state[0].mu,
                                                    is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
        for path, leaf in flat:
            if not isinstance(leaf, optax.MaskedNode):
                out["/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step (skip budget 1) on tests/test_torch_training.py's model,
    weights, batch and key; its gradients read back from Adam's first
    moment after the step (mu = (1 - b1) g). JAX is imported here, so that
    the spawned ranks, which import this module, do not import it."""
    import jax

    import scenedino_tpu.losses.reconstruction as jrec
    import scenedino_tpu.training.trainer as jtrain
    from tests.test_torch_training import ART_SHAPE, MODEL, _batch, _configs, _jbatch, _random_params
    from scenedino_tpu.models.factory import make_model as j_make_model

    with jax.default_matmul_precision("highest"):
        jfield = j_make_model(MODEL)
        params = _random_params(jfield, _batch())
        jt, _, jr, _ = _configs(skip_nonfinite_steps=1)
        state, tx = jtrain.init_train_state(jfield, params, jt, artifact_shape=ART_SHAPE, key=jax.random.PRNGKey(3))
        key = jax.random.PRNGKey(12)
        step = jax.jit(jtrain.make_train_step(jfield, jt, jr, jrec.ReconstructionLossConfig(), tx))
        new_state, losses = step(state, _jbatch(_batch()), key)
    grads = from_jax_params({k: v / 0.1 for k, v in _adam_mu(new_state.opt_state).items()})[0]
    art_grad = np.asarray(new_state.artifact_opt_state.inner_state[0].mu) / 0.1
    return dict(state=state, new_state=new_state, step_losses=losses, grads=grads, art_grad=art_grad, key=key,
                jt=jt, jr=jr)


def test_two_gloo_ranks_equal_the_unsharded_step(jax_step, tmp_path):
    from tests.test_torch_training import MODEL, N_COARSE, TCFG, _batch, _grad_rel_err, _jax_draws

    jt, jr = jax_step["jt"], jax_step["jr"]
    jstate = jax_step["state"]
    draws = _jax_draws(jax_step["key"], jt, jr)
    inputs = str(tmp_path / "inputs.pt")
    torch.save({"model": MODEL, "state_dict": from_jax_params(jstate.params["params"])[0],
                "artifact": artifact_from_jax(jstate.artifact_field), "tcfg": {**TCFG, "skip_nonfinite_steps": 1},
                "n_coarse": N_COARSE, "draws": draws,
                "batch": {k: torch.from_numpy(v) for k, v in _batch().items()}}, inputs)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_worker, args=(2, _free_port(), inputs, str(tmp_path)), nprocs=2, join=False,
                             start_method="spawn")
    while not ctx.join(timeout=5):
        assert time.perf_counter() - t0 < SPAWN_TIMEOUT, "the ranks did not finish in time"
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    ref = jax_step["step_losses"]
    for r in ranks:
        for name in ref:
            np.testing.assert_allclose(r["losses"][name], float(ref[name]), rtol=1e-5, err_msg=name)
    ref_grads = jax_step["grads"]
    got = ranks[0]["grads"]
    errs = {n: _grad_rel_err(got[n], g) for n, g in ref_grads.items() if float(g.abs().max()) > 0}
    assert not any(n.startswith("encoder.gt_encoder.") for n in errs)  # the frozen teacher: no gradient
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
    assert _grad_rel_err(ranks[0]["artifact_grad"], torch.from_numpy(jax_step["art_grad"])) <= 1e-3

    old = from_jax_params(jstate.params["params"])[0]
    new = from_jax_params(jax_step["new_state"].params["params"])[0]
    moved = 0
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name  # the ranks stay replicas
        lr = TCFG["lr"] * (0.1 if name.startswith("encoder.vit_encoder.") else 1.0)
        assert float((p - old[name]).abs().max()) <= lr * (1 + 1e-3), name
        g, pg = ref_grads[name], got[name] if got[name] is not None else torch.zeros_like(ref_grads[name])
        live = ((pg - g).abs() < 0.1 * g.abs()) & (g.abs() > 1e-6)
        np.testing.assert_allclose(p[live].numpy(), new[name][live].numpy(), atol=1e-5, rtol=5e-7, err_msg=name)
        moved += int(live.sum())
    assert moved > 0.5 * sum(p.numel() for n, p in ranks[0]["params"].items() if not n.startswith("encoder.gt_"))
    np.testing.assert_allclose(ranks[0]["artifact"].numpy(), np.asarray(jax_step["new_state"].artifact_field),
                               atol=1e-3 * TCFG["lr"], rtol=0)

    # a NaN on rank 1 only: both ranks skip
    for r in ranks:
        assert r["skip"] == {"nonfinite_consecutive": 1.0, "nonfinite_total": 1.0, "nonfinite_gave_up": 0.0}
        assert r["counts"] == (2, 1)
        assert all(torch.equal(r["after_skip"][n], p) for n, p in r["params"].items())
