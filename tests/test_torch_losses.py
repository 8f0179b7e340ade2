"""Parity of the port's reconstruction loss (every criterion and invalid
policy) and of `losses/errors.py` with the JAX reference on the CPU.

The loss data are tests/test_torch_training.py's patch-shaped draws with
the colour samples and occupancy proposals the last two policies read.
Tolerances: the loss dict rtol 1e-5, its gradients atol 1e-7 / rtol 1e-4
(tests/test_torch_training.py's); every `errors.py` function's value and,
where the reference differentiates it, its gradient within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.losses.errors as JE
import scenedino_tpu.losses.reconstruction as jrec
from scenedino_torch.losses import errors as E
from scenedino_torch.losses import reconstruction as rec

B, PC, P, VR, K, C = 2, 3, 4, 2, 5, 12
DIFF = ("rgb", "depth", "dino_features", "dino_features_downsampled")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _loss_data(seed=8):
    rng = np.random.default_rng(seed)

    def u(*s):
        return rng.uniform(size=s).astype(np.float32)

    invalid = (rng.uniform(size=(B, PC, P, P, K, VR)) < 0.4).astype(np.float32)
    invalid[0, 0] = 1.0  # every sample invalid in both views: masked rays
    rgb_samps = u(B, PC, P, P, K, VR, 3)
    rgb_samps[1, 0] = 0.5 + 1e-3 * rgb_samps[1, 0]  # colour samples that barely vary: "diverse" drops them
    return {
        "rgb_gt": u(B, PC, P, P, 3),
        "dino_gt": rng.normal(size=(B, PC, 1, 1, C)).astype(np.float32),
        "coarse": {
            "rgb": u(B, PC, P, P, VR, 3),
            "depth": 3.0 + 70 * u(B, PC, P, P),
            "invalid": invalid,
            "weights": u(B, PC, P, P, K) / 2,
            "rgb_samps": rgb_samps,
            "occ": (u(B, PC, P, P, 1) < 0.7).astype(np.float32),
            "dino_features": rng.normal(size=(B, PC, P, P, C)).astype(np.float32),
            "dino_features_downsampled": rng.normal(size=(B, PC, 1, 1, C)).astype(np.float32),
        },
    }


def _both(data, **cfg):
    """(JAX loss dict, its gradients, port loss dict, its gradients) of the DIFF inputs."""
    jcfg, tcfg = jrec.ReconstructionLossConfig(**cfg), rec.ReconstructionLossConfig(**cfg)

    def jloss(c):
        d = jax.tree_util.tree_map(jnp.asarray, {**data, "coarse": {**data["coarse"]}})
        d["coarse"].update(c)
        losses = jrec.reconstruction_loss(d, jcfg)
        return losses["rec_loss"], losses

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(data["coarse"][k]) for k in DIFF})
    leaves = {k: _t(data["coarse"][k]).requires_grad_(True) for k in DIFF}
    d = {"rgb_gt": _t(data["rgb_gt"]), "dino_gt": _t(data["dino_gt"]),
         "coarse": {**{k: _t(v) for k, v in data["coarse"].items()}, **leaves}}
    out = rec.reconstruction_loss(d, tcfg)
    out["rec_loss"].backward()
    return ref, ref_grads, out, {k: leaves[k].grad for k in DIFF}


@pytest.mark.parametrize("criterion,policy", [
    ("l1", "weight_guided"), ("l2", "weight_guided"), ("l1+ssim", "weight_guided"),
    ("l1", "none"), ("l1", "strict"), ("l1", "weight_guided_diverse"), ("l1+ssim", "occ_weight_guided"),
])
def test_criteria_and_policies_match_reference(criterion, policy):
    data = _loss_data()
    ref, ref_grads, out, grads = _both(data, criterion=criterion, invalid_policy=policy)
    assert sorted(out) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(out[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)
    for name in DIFF:
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(ref_grads[name]), atol=1e-7, rtol=1e-4,
                                   err_msg=name)
    mask = rec.invalid_mask(_t(data["coarse"]["invalid"]), _t(data["coarse"]["weights"]), policy,
                            rgb_samps=_t(data["coarse"]["rgb_samps"]), occ=_t(data["coarse"]["occ"]))
    jmask = jrec.invalid_mask(*(jnp.asarray(data["coarse"][k]) for k in ("invalid", "weights")), policy,
                              rgb_samps=jnp.asarray(data["coarse"]["rgb_samps"]), occ=jnp.asarray(data["coarse"]["occ"]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    if policy not in ("none",):
        assert 0 < int(mask.sum()) < mask.numel(), policy  # the policy masks some rays and not all


def test_policies_need_their_inputs():
    inv, w = torch.zeros(2, 3, 1), torch.ones(2, 3)
    for policy in ("weight_guided_diverse", "occ_weight_guided"):
        with pytest.raises(ValueError):
            rec.invalid_mask(inv, w, policy)
    with pytest.raises(ValueError):
        rec.invalid_mask(inv, w, "no_such_policy")
    with pytest.raises(ValueError):
        rec.reconstruction_error(torch.zeros(1, 3, 2, 2), torch.zeros(1, 3, 2, 2), "l3")


def test_lambda_fine_and_median_thresholding_change_nothing():
    """Both are stored and never read, in JAX and in the port."""
    data = _loss_data(9)
    base, base_grads, _, _ = _both(data)
    ref, _, out, grads = _both(data, lambda_fine=1.0, median_thresholding=True)
    for name in ref:
        assert float(ref[name]) == float(base[name])
        np.testing.assert_allclose(out[name].item(), float(base[name]), rtol=1e-5, err_msg=name)
    for name in DIFF:
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(base_grads[name]), atol=1e-7, rtol=1e-4)


# ------------------------------------------------------------ errors.py

def _rng(seed):
    return np.random.default_rng(seed)


def _probs(rng, *shape, zeros=True):
    w = rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)
    if zeros:
        w.reshape(-1, shape[-1])[0, : shape[-1] // 2] = 0.0  # the small-probability paths
    return w


def _cases():
    """name -> (args as numpy arrays, kwargs, indices of the differentiated args)."""
    r = _rng(0)
    alphas = r.uniform(size=(2, 3, 8)).astype(np.float32)
    inv1 = (r.uniform(size=(2, 3, 1)) > 0.5).astype(np.float32)
    w = _probs(r, 2, 5, 6, 8)
    depth = (3 + 20 * r.uniform(size=(2, 5, 6))).astype(np.float32)
    views = r.uniform(size=(4, 6, 4)).astype(np.float32)
    vinv = (r.uniform(size=(4, 6, 4)) > 0.8).astype(np.float32)
    return {
        "normalized_entropy": ((_probs(r, 4, 5, 8),), {}, (0,)),
        "kl_div": ((_probs(r, 4, 5, 8), _probs(r, 4, 5, 8, zeros=False)), {}, (0, 1)),
        "compute_normalized_l1": ((r.normal(size=(2, 2, 5, 6)), r.normal(size=(2, 2, 5, 6))), {}, (0, 1)),
        "compute_3d_smoothness": ((r.normal(size=(2, 3, 7, 4)),), {}, (0,)),
        "compute_occupancy_error": ((r.normal(size=(3, 9)), r.normal(size=(3, 9)), r.uniform(size=(3, 9)) > 0.3),
                                    {}, (0, 1)),
        "depth_regularization": ((r.normal(size=(2, 1, 5, 6)),), {}, (0,)),
        "alpha_regularization": ((alphas, inv1), {}, (0,)),
        "surfaceness_regularization": ((alphas, inv1), {}, (0,)),
        "depth_smoothness_regularization": ((depth,), {}, (0,)),
        "sdf_eikonal_regularization": ((r.normal(size=(2, 1, 4, 5, 6)),), {}, (0,)),
        "weight_entropy_regularization": ((_probs(r, 3, 4, 8),), {}, (0,)),
        "max_alpha_regularization": ((alphas,), {}, (0,)),
        "max_alpha_inputframe_regularization": ((alphas, np.floor(2 * r.uniform(size=(2, 3, 2)))), {}, (0,)),
        "density_grid_regularization": ((3 * r.normal(size=(4, 5, 6)),), {"threshold": 0.5}, (0,)),
        "kl_prop": ((w,), {}, (0,)),
        "alpha_consistency": ((views, vinv), {"consistency_policy": "median"}, (0,)),
        "alpha_consistency_uncert": ((views, vinv, r.uniform(size=(4, 6)).astype(np.float32)), {}, (2,)),
        "entropy_based_smoothness": ((w, depth, (r.uniform(size=(2, 5, 6)) > 0.7).astype(np.float32)), {},
                                     (0, 1)),
        "flow_regularization": ((r.normal(size=(3, 4, 2, 2)), r.normal(size=(3, 4, 2)),
                                 (r.uniform(size=(3, 4, 1)) > 0.5).astype(np.float32)), {}, (0,)),
    }


CASES = _cases()


def _as(x, lib):
    x = np.asarray(x)
    if x.dtype == bool:
        return jnp.asarray(x) if lib == "jax" else torch.from_numpy(x)
    return jnp.asarray(x, jnp.float32) if lib == "jax" else _t(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_errors_match_reference(name):
    args, kw, diff = CASES[name]
    jfn, tfn = getattr(JE, name), getattr(E, name)

    def jsum(*xs):
        return jnp.sum(jfn(*xs, **kw))

    jargs = [_as(a, "jax") for a in args]
    targs = [_as(a, "torch") for a in args]
    for i in diff:
        targs[i].requires_grad_(True)
    ref = np.asarray(jfn(*jargs, **kw))
    out = tfn(*targs, **kw)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6, rtol=1e-6, err_msg=name)
    ref_grads = jax.grad(jsum, argnums=diff)(*jargs)
    out.sum().backward()
    for i, g in zip(diff, ref_grads):
        got = targs[i].grad
        got = torch.zeros_like(targs[i]) if got is None else got
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=1e-6, rtol=1e-6, err_msg=f"{name} arg {i}")


@pytest.mark.parametrize("policy", ["mean", "max", "min", "median"])
def test_alpha_consistency_policies_match_reference(policy):
    args, _, _ = CASES["alpha_consistency"]
    ref = JE.alpha_consistency(*(jnp.asarray(a) for a in args), consistency_policy=policy)
    out = E.alpha_consistency(*(_t(a) for a in args), consistency_policy=policy)
    np.testing.assert_allclose(out.item(), float(ref), atol=1e-6, rtol=1e-6)


def test_lower_median_takes_the_lower_middle_on_an_even_count():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [0.5, 0.25, 1.0, 0.75]])
    assert E._lower_median(x).tolist() == [2.0, 0.5]
    np.testing.assert_array_equal(E._lower_median(x, keepdim=True).numpy(),
                                  np.asarray(JE._lower_median(jnp.asarray(x.numpy()), keepdims=True)))


def test_errors_module_is_whole():
    """Every public function of the reference's errors.py has its counterpart."""
    ref = {n for n, f in vars(JE).items() if callable(f) and not n.startswith("_") and f.__module__ == JE.__name__}
    assert ref <= set(dir(E)) and ref <= set(CASES), sorted(ref - set(CASES))
    assert E.EPS == 2.0 ** -8
    assert dataclasses.asdict(rec.ReconstructionLossConfig()) == dataclasses.asdict(jrec.ReconstructionLossConfig())
