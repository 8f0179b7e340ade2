"""Parity of the port's stage-2 modules with the JAX reference on the CPU:
cosine k-means (`ops/kmeans.py`), the semantic head and its parts
(`models/downstream.py`: five_crop, the STEGO, k-means, linear and MLP
heads, the cross entropy with ignore index, the ring buffer, the kNN's
top-k, `SemanticHead` in all its modes), the STEGO loss and its gradients
(`losses/stego.py`), the head's converter (`utils/convert.load_jax_head`)
and the segmentation metrics and accumulators (`eval/metrics.py`,
`training/validation.py`).

Both sides get the same numbers: inputs and weights drawn with numpy, the
JAX head's variables carried across with `load_jax_head`, and the JAX
functions' own draws rebuilt from their keys as the reference splits them
(k-means++: `split(key)` into the first pick's `randint` and one `gumbel`
row per later centre; the head: `split(key, 3)` into the unused dropout
key, the kNN pick's `randint` and the random row's `randint`, which the
port takes as a uniform u with floor(u filled) equal to it). The dropout
masks are the ones flax draws: `jax.random.bernoulli` is wrapped while the
JAX head runs, and the masks it returns, in call order, go to the port.

Tolerances: fp32, JAX under "highest" matmul precision; values atol/rtol
1e-5 (sums of a few hundred products in other orders); labels, buffers,
assignments, confusions and integer counts exactly; gradients per tensor
|g - g_ref| <= 1e-4 |g_ref| (L2 norms).
"""
import contextlib
import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.metrics as jmetrics
import scenedino_tpu.losses.stego as jstego
import scenedino_tpu.models.downstream as jds
import scenedino_tpu.ops.kmeans as jkm
import scenedino_tpu.training.validation as jval
from scenedino_torch.eval import metrics
from scenedino_torch.losses import stego
from scenedino_torch.models import downstream as ds
from scenedino_torch.ops import kmeans
from scenedino_torch.training import validation
from scenedino_torch.utils.convert import load_jax_head

HEAD = dict(n_classes=5, gt_classes=4, input_dim=12, code_dim=6, buffer_size=6, patch_sample_size=7,
            knn_neighbors=2, mode="3d")
# the 2d head: five crops of a 16x16 map at sample factor 4 are 2x2 pixels
HEADS = {"3d": HEAD, "2d": {**HEAD, "patch_sample_size": 4, "mode": "2d"}, "3d-mlp": {**HEAD, "mlp_head": True}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(out.detach() if isinstance(out, torch.Tensor) else out), np.asarray(ref),
                               atol=atol, rtol=rtol)


def _grad_rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@contextlib.contextmanager
def dropout_masks():
    """The channel masks flax's Dropout draws while the block runs, in call
    order, each flattened to (code_dim,)."""
    masks = []
    orig = jax.random.bernoulli

    def record(key, p=0.5, shape=None, **kw):
        m = orig(key, p=p, shape=shape, **kw)
        masks.append(np.asarray(m).reshape(-1))
        return m

    jax.random.bernoulli = record
    try:
        yield masks
    finally:
        jax.random.bernoulli = orig


# ------------------------------------------------------------------ k-means
def _kmeans_pp_draws(key, N, K):
    """k-means++'s draws from `key`, as kmeans_plus_plus_init splits it."""
    k0, rest = jax.random.split(key)
    first = int(jax.random.randint(k0, (), 0, N))
    keys = jax.random.split(rest, K - 1)
    return kmeans.KMeansPPDraws(first, _t(np.stack([np.asarray(jax.random.gumbel(k, (N,))) for k in keys])))


@pytest.mark.parametrize("N,D,K", [(40, 6, 5), (9, 3, 9)])
def test_kmeans_plus_plus_matches_reference(N, D, K):
    feats = np.random.default_rng(N).normal(size=(N, D)).astype(np.float32)
    feats[1] = feats[0]  # a duplicate point: its probability is 0 once the other is a centre
    key = jax.random.PRNGKey(3)
    ref = jkm.kmeans_plus_plus_init(key, jnp.asarray(feats), K)
    out = kmeans.kmeans_plus_plus_init(_t(feats), K, _kmeans_pp_draws(key, N, K))
    _close(out, ref, atol=1e-6)


def test_kmeans_assign_update_and_fit_match_reference():
    rng = np.random.default_rng(1)
    feats, centers = rng.normal(size=(50, 8)).astype(np.float32), rng.normal(size=(4, 8)).astype(np.float32)
    labels, loss, ip = kmeans.kmeans_cosine_assign(_t(feats), _t(centers))
    rl, rloss, rip = jkm.kmeans_cosine_assign(jnp.asarray(feats), jnp.asarray(centers))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    _close(loss, rloss)
    _close(ip, rip)
    for factor, min_count in ((1.0, 0), (0.5, 12)):
        _close(kmeans.kmeans_cosine_update(_t(feats), labels, _t(centers), factor, min_count),
               jkm.kmeans_cosine_update(jnp.asarray(feats), rl, jnp.asarray(centers), factor, min_count))
    key = jax.random.PRNGKey(5)
    ref = jkm.kmeans_fit(key, jnp.asarray(feats), 4, n_iters=6)
    out = kmeans.kmeans_fit(_t(feats), 4, _kmeans_pp_draws(key, 50, 4), n_iters=6)
    _close(out[0], ref[0])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    _close(out[2], ref[2])


def test_gumbel_draws_have_the_standard_law():
    g = kmeans.gumbel((200000,), torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.01 and abs(g.var().item() - np.pi ** 2 / 6) < 0.03


# ------------------------------------------------------------- head parts
@pytest.mark.parametrize("sample_factor", [1, 4])
@pytest.mark.parametrize("hw", [(16, 16), (16, 24)])
def test_five_crop_matches_reference(sample_factor, hw):
    x = np.random.default_rng(0).normal(size=(2, 2, *hw, 1, 3)).astype(np.float32)
    out = ds.five_crop(_t(x), sample_factor)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jds.five_crop(jnp.asarray(x), sample_factor)))


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (2, 2, 3, 4, 1, 5)], ids=["plain", "views-and-singleton"])
def test_cross_entropy_ignore_values_and_grads_match_reference(shape):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=shape).astype(np.float32)
    n, h, w = shape[0], shape[-4 if len(shape) == 6 else 1], shape[-3 if len(shape) == 6 else 2]
    target = rng.integers(-1, shape[-1], size=(n, h, w)).astype(np.int32)
    ref, rg = jax.value_and_grad(jds.cross_entropy_ignore)(jnp.asarray(logits), jnp.asarray(target))
    x = _t(logits).requires_grad_(True)
    out = ds.cross_entropy_ignore(x, _t(target))
    out.backward()
    _close(out, ref)
    _close(x.grad, rg)
    none = ds.cross_entropy_ignore(_t(logits), torch.full((n, h, w), -1))
    assert none.item() == 0.0 and float(jds.cross_entropy_ignore(jnp.asarray(logits), jnp.full((n, h, w), -1))) == 0.0


def _jbuffers(b: ds.RingBufferState):
    return jds.RingBufferState(jnp.asarray(b.patch_buffer.numpy()), jnp.asarray(b.gap_buffer.numpy()),
                               jnp.asarray(b.idx, jnp.int32), jnp.asarray(b.filled, jnp.int32))


def _assert_buffers_equal(port: ds.RingBufferState, ref, atol=0.0):
    """Contents within `atol` (0: bitwise), cursor and high-water mark exactly."""
    np.testing.assert_allclose(port.patch_buffer.numpy(), np.asarray(ref.patch_buffer), atol=atol, rtol=0)
    np.testing.assert_allclose(port.gap_buffer.numpy(), np.asarray(ref.gap_buffer), atol=atol, rtol=0)
    assert (port.idx, port.filled) == (int(ref.idx), int(ref.filled))


def test_ring_buffer_writes_match_reference():
    """Unmasked writes that wrap, masked writes (the valid rows in order at
    the cursor), a masked write of nothing and one that wraps."""
    rng = np.random.default_rng(4)
    S, P, C = 6, 3, 2
    port = ds.RingBufferState.create(S, P, C)
    ref = jds.RingBufferState.create(S, P, C)
    writes = [(4, None), (3, None), (4, [True, False, True, True]), (3, [False, False, False]),
              (5, [True, True, False, True, True]), (2, [False, True])]
    for n, valid in writes:
        patches = rng.normal(size=(n, P, C)).astype(np.float32)
        gaps = rng.normal(size=(n, C)).astype(np.float32)
        v = None if valid is None else np.array(valid)
        ds.update_ring_buffer(port, _t(patches), _t(gaps), None if v is None else _t(v))
        ref = jds.update_ring_buffer(ref, jnp.asarray(patches), jnp.asarray(gaps), None if v is None else jnp.asarray(v))
        _assert_buffers_equal(port, ref)


def test_top_k_orders_ties_as_lax_top_k():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 3, size=(7, 11)).astype(np.float32)
    x[0] = -np.inf
    x[1, 3:] = -np.inf
    for k in (1, 3, 11):
        values, idx = ds.top_k(_t(x), k)
        rv, ridx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(values.numpy(), np.asarray(rv))


def test_stego_dropout_drops_whole_channels_scaled():
    head = ds.StegoClusterHead(5, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 2, 5, generator=torch.Generator().manual_seed(1))
    mask = torch.tensor([True, False, True, True])
    raw = head.linear(x) + head.nonlinear_2(torch.relu(head.nonlinear_1(x)))
    expect = ds._norm(torch.where(mask, raw / 0.9, torch.zeros_like(raw)))
    out = head(x, mask)
    torch.testing.assert_close(out, expect, rtol=0, atol=0)
    assert (out[..., 1] == 0).all() and (out[..., [0, 2, 3]] != 0).all()
    torch.testing.assert_close(head(x), ds._norm(raw), rtol=0, atol=0)


def _loss_inputs(rng, Nc=3, P=5, Q=4):
    corr = {}
    for name in ("self", "nn", "random"):
        q = P if name == "self" else Q
        corr[f"dino_{name}_corr"] = rng.uniform(-1, 1, size=(Nc, P, q)).astype(np.float32)
        s = rng.uniform(-1, 1, size=(Nc, P, q)).astype(np.float32)
        s[:, 0, :2] = 0.0  # ties of max(stego, 0): jnp.maximum splits their gradient
        corr[f"stego_{name}_corr"] = s
    return corr


@pytest.mark.parametrize("pointwise", [False, True])
@pytest.mark.parametrize("valid", [None, [True, False, True]])
def test_stego_loss_values_and_gradients_match_reference(pointwise, valid):
    corr = _loss_inputs(np.random.default_rng(7))
    heads = {"direct_cluster": {"loss": np.float32(-0.7)}, "stego_linear": {"loss": np.float32(1.3)}}
    jcfg, cfg = jstego.StegoLossConfig(pointwise=pointwise), stego.StegoLossConfig(pointwise=pointwise)

    def jloss(c):
        sc = dict(c)
        if valid is not None:
            sc["crop_valid"] = jnp.asarray(valid)
        return jstego.stego_loss({"stego_corr": sc, "results": {k: {"loss": jnp.asarray(v["loss"])}
                                                                for k, v in heads.items()}}, jcfg)

    ref = jloss({k: jnp.asarray(v) for k, v in corr.items()})
    rgrad = jax.grad(lambda c: jloss(c)["total_loss"])({k: jnp.asarray(v) for k, v in corr.items()})
    tc = {k: _t(v).requires_grad_(True) for k, v in corr.items()}
    sc = dict(tc)
    if valid is not None:
        sc["crop_valid"] = torch.tensor(valid)
    out = stego.stego_loss({"stego_corr": sc, "results": {k: {"loss": torch.tensor(v["loss"])}
                                                          for k, v in heads.items()}}, cfg)
    assert list(out) == list(ref)
    for k in ref:
        _close(out[k], ref[k])
    out["total_loss"].backward()
    for k, t in tc.items():
        _close(t.grad, rgrad[k], atol=1e-7, rtol=1e-5)


def test_stego_loss_config_reads_the_loss_block():
    block = {"random_weight": 0.5, "pointwise": True, "other": 3}
    assert stego.StegoLossConfig.from_dict(block) == stego.StegoLossConfig(random_weight=0.5, pointwise=True)
    assert stego.StegoLossConfig() == stego.StegoLossConfig(**dict(
        (f, getattr(jstego.StegoLossConfig(), f)) for f in stego.StegoLossConfig.__dataclass_fields__))


# ------------------------------------------------------------- the whole head
@functools.lru_cache(maxsize=None)
def _heads(mode: str):
    """(JAX head, its variables, the port's head on the same variables)."""
    conf = HEADS[mode]
    jhead = jds.SemanticHead(cfg=jds.SemanticHeadConfig(**conf))
    k = jax.random.PRNGKey(0)
    C, P = conf["input_dim"], conf["patch_sample_size"]
    variables = jax.jit(lambda: jhead.init(  # compiled once: op by op the init takes ~10 s
        {"params": k, "dropout": k}, jnp.zeros((1, 1, 16, 16, 1, C)),
        jds.RingBufferState.create(conf["buffer_size"], P, C), k, crop_features=jnp.zeros((2, P, C)),
        seg_target=jnp.zeros((1, 16, 16), jnp.int32), deterministic=True,
        method=jds.SemanticHead.forward_training))()
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if "kernel" in name:
            return jnp.asarray(x / np.sqrt(leaf.shape[0]))
        return jnp.asarray(x if "cluster_centers" in name else 0.1 * x)

    params = jax.tree_util.tree_map_with_path(draw, flax.core.unfreeze(variables["params"]))
    n = conf["n_classes"]
    state = {name: {"pseudo_assignment": jnp.asarray((np.arange(n) * 3 + 1) % conf["gt_classes"], jnp.int32)}
             for name in ("direct_cluster_head", "stego_cluster_head")}
    jvars = {"params": params, "state": state}
    head = ds.SemanticHead(ds.SemanticHeadConfig(**conf))
    load_jax_head(head, jvars)
    return jhead, jvars, head


def test_load_jax_head_consumes_every_leaf():
    _, jvars, head = _heads("3d")
    fresh = ds.SemanticHead(head.cfg)
    load_jax_head(fresh, jvars)
    for (name, a), (_, b) in zip(fresh.state_dict().items(), head.state_dict().items()):
        assert torch.equal(a, b), name
    assert fresh.direct_cluster_head.pseudo_assignment.dtype == torch.int64
    missing = {"params": dict(jvars["params"]), "state": jvars["state"]}
    del missing["params"]["stego_linear_head"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_head(ds.SemanticHead(head.cfg), missing)
    extra = {"params": {**jvars["params"], "extra_head": {"kernel": np.zeros((2, 2), np.float32)}},
             "state": jvars["state"]}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_head(ds.SemanticHead(head.cfg), extra)
    with pytest.raises(ValueError, match="collections"):
        load_jax_head(ds.SemanticHead(head.cfg), {**jvars, "batch_stats": {"x": np.zeros(1)}})


def test_head_config_from_dict_matches_reference():
    block = {"n_classes": 10, "gt_classes": 8, "input_dim": 64, "code_dim": 16, "buffer_size": 64,
             "patch_sample_size": 64, "knn_neighbors": 3, "mode": "3d", "cluster_init": "kmeans++"}
    assert dataclasses.asdict(ds.SemanticHeadConfig.from_dict(block)) == dataclasses.asdict(
        jds.SemanticHeadConfig.from_dict(block))
    assert dataclasses.asdict(ds.SemanticHeadConfig()) == dataclasses.asdict(jds.SemanticHeadConfig())


@pytest.mark.parametrize("mode", ["stego_kmeans", "stego_linear", "direct_kmeans", "direct_linear"])
def test_head_inference_modes_match_reference(mode):
    jhead, jvars, head = _heads("3d")
    x = np.random.default_rng(12).normal(size=(2, 5, 7, 12)).astype(np.float32)
    ref = jhead.apply(jvars, jnp.asarray(x), mode=mode)
    np.testing.assert_array_equal(head(_t(x), mode).numpy(), np.asarray(ref))


def test_encode_features_matches_reference():
    jhead, jvars, head = _heads("3d")
    x = np.random.default_rng(13).normal(size=(2, 1, 4, 6, 1, 12)).astype(np.float32)
    x[0, 0, 0, 0] = 0.0  # an all-zero row: safe_normalize keeps it finite
    ref = jhead.apply(jvars, jnp.asarray(x), method=jds.SemanticHead.encode_features)
    for o, r in zip(head.encode_features(_t(x)), ref):
        _close(o, r)


def _port_buffers(rng, conf, filled):
    S, P, C = conf["buffer_size"], conf["patch_sample_size"], conf["input_dim"]
    b = ds.RingBufferState.create(S, P, C)
    if filled > 1:
        b.patch_buffer.copy_(_t(rng.normal(size=(S, P, C)).astype(np.float32)))
        b.gap_buffer.copy_(_t(rng.normal(size=(S, C)).astype(np.float32)))
    b.idx, b.filled = filled % S, filled
    return b


def _copy_buffers(b):
    return ds.RingBufferState(b.patch_buffer.clone(), b.gap_buffer.clone(), b.idx, b.filled)


def _head_draws(key, n_crops, knn, filled):
    """The head's draws from `key` as forward_training splits it; the random
    rows go to the port as the uniform u with floor(u filled) equal to them."""
    _, k_nn, k_rand = jax.random.split(key, 3)
    pick = _t(np.asarray(jax.random.randint(k_nn, (n_crops,), 0, knn)).astype(np.int64))
    hi = max(filled, 1)
    rand = np.asarray(jax.random.randint(k_rand, (n_crops,), 0, hi))
    return pick, _t(((rand + 0.5) / hi).astype(np.float32))


def _run_both(mode, deterministic, filled, seed=14, with_target=True):
    """forward_training of both heads on the same inputs, buffers and draws;
    returns (port seg_data, port buffers, JAX seg_data, JAX buffers, the
    masks, the port's and JAX's total-loss gradients)."""
    jhead, jvars, head = _heads(mode)
    conf = HEADS[mode]
    three_d = conf["mode"] == "3d"
    rng = np.random.default_rng(seed)
    n, h, w, C, P = 2, 16, 16, conf["input_dim"], conf["patch_sample_size"]
    dino = rng.normal(size=(n, 1, h, w, 1, C)).astype(np.float32)
    crops = rng.normal(size=(3, P, C)).astype(np.float32) if three_d else None
    crop_valid = np.array([True, False, True]) if three_d else None
    target = rng.integers(-1, conf["gt_classes"], size=(n, h, w)).astype(np.int32) if with_target else None
    buffers = _port_buffers(rng, conf, filled)
    key, kd = jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 1)

    def japply(params):
        return jhead.apply({"params": params, "state": jvars["state"]}, jnp.asarray(dino), _jbuffers(buffers), key,
                           crop_features=None if crops is None else jnp.asarray(crops),
                           seg_target=None if target is None else jnp.asarray(target), deterministic=deterministic,
                           crop_valid=None if crop_valid is None else jnp.asarray(crop_valid),
                           method=jds.SemanticHead.forward_training, rngs={"dropout": kd}, mutable=["state"])

    def jloss(params):
        out = japply(params)[0]
        return jstego.stego_loss(out[0])["total_loss"], out

    with dropout_masks() as masks:  # one pass: the forward's outputs ride along the gradient
        (_, (jseg, jbuf)), rgrad = jax.value_and_grad(jloss, has_aux=True)(jvars["params"])
    n_crops = 3 if three_d else 5 * n
    calls = 4 if three_d else 3
    pick, u = _head_draws(key, n_crops, conf["knn_neighbors"], int(jbuf.filled))
    draws = ds.HeadDraws(pick, u, None if deterministic else _t(np.stack(masks[:calls])))
    head.zero_grad(set_to_none=True)
    port_buf = _copy_buffers(buffers)
    seg, pbuf = head.forward_training(_t(dino), port_buf, draws, crop_features=None if crops is None else _t(crops),
                                      seg_target=None if target is None else _t(target).long(),
                                      deterministic=deterministic,
                                      crop_valid=None if crop_valid is None else _t(crop_valid))
    stego.stego_loss(seg)["total_loss"].backward()
    grads = {name: p.grad for name, p in head.named_parameters()}
    return seg, pbuf, jseg, jbuf, masks[:calls], grads, rgrad


def _jgrad(rgrad, name):
    """The JAX gradient of the port's parameter `name` in the port's layout."""
    *path, leaf = name.split(".")
    g = np.asarray(functools.reduce(lambda d, k: d[k], path, rgrad)[{"weight": "kernel"}.get(leaf, leaf)])
    return g.T if leaf == "weight" else g


def _assert_seg_data_equal(seg, jseg, atol=1e-5):
    assert sorted(seg["stego_corr"]) == sorted(jseg["stego_corr"])
    for k, v in jseg["stego_corr"].items():
        _close(seg["stego_corr"][k], v, atol=atol)
    assert sorted(seg["results"]) == sorted(jseg["results"])
    for name, res in jseg["results"].items():
        assert sorted(seg["results"][name]) == sorted(res), name
        for k, v in res.items():
            if k in ("pseudo_segs_pred", "segs_pred"):
                np.testing.assert_array_equal(seg["results"][name][k].numpy(), np.asarray(v), err_msg=f"{name}/{k}")
            else:
                _close(seg["results"][name][k], v, atol=atol)


@pytest.mark.parametrize("mode,deterministic,filled", [("3d", False, 4), ("3d", True, 6), ("2d", False, 3),
                                                       ("3d", False, 1), ("3d-mlp", False, 5)],
                         ids=["3d-train", "3d-eval", "2d-train", "3d-train-fresh-buffer", "3d-mlp-probes"])
def test_forward_training_matches_reference(mode, deterministic, filled):
    seg, pbuf, jseg, jbuf, masks, grads, rgrad = _run_both(mode, deterministic, filled)
    if not deterministic:
        assert len(masks) == (3 if mode == "2d" else 4) and all(m.shape == (HEAD["code_dim"],) for m in masks)
    _assert_seg_data_equal(seg, jseg)
    # the rows written are normalized features, computed on each side: fp32 round-off
    _assert_buffers_equal(pbuf, jbuf, atol=1e-6)
    for name, g in grads.items():
        ref = _jgrad(rgrad, name)
        if np.abs(ref).max() == 0:
            assert g is None or not g.any(), name
            continue
        assert g is not None and _grad_rel_err(g, ref) <= 1e-4, (name, _grad_rel_err(g, ref))


def test_knn_top_k_ties_at_filled_one():
    """A fresh buffer in the deterministic forward: every slot but the first
    is masked to -inf, so the kNN's top-k ranks tied -inf slots, which
    jax.lax.top_k orders by index."""
    seg, _, jseg, _, _, _, _ = _run_both("3d", True, 1, seed=21)
    _assert_seg_data_equal(seg, jseg)
    sims = torch.full((3, HEAD["buffer_size"]), -torch.inf)
    sims[:, 0] = 0.0
    np.testing.assert_array_equal(ds.top_k(sims, 3)[1].numpy(), np.asarray(jax.lax.top_k(jnp.asarray(sims.numpy()),
                                                                                         3)[1]))


# ------------------------------------------------------------ seg metrics
def _confusion(rng, n_gt=8, n_pred=10):
    return rng.integers(0, 50, size=(n_gt, n_pred)) * (rng.uniform(size=(n_gt, n_pred)) < 0.4)


def test_seg_confusion_matrix_matches_reference():
    rng = np.random.default_rng(30)
    target = rng.integers(-1, 8, size=(2, 16, 24))
    pred = rng.integers(0, 10, size=(2, 16, 24))
    out = metrics.seg_confusion_matrix(_t(target), _t(pred), 8, 10)
    ref = np.asarray(jmetrics.seg_confusion_matrix(target, pred, 8, 10))
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int64 and out.sum() == (target != -1).sum()


@pytest.mark.parametrize("seed", range(4))
def test_pseudo_assignment_and_scores_match_reference(seed):
    rng = np.random.default_rng(seed)
    conf = _confusion(rng, 8, 10 if seed % 2 else 8)
    a = metrics.pseudo_label_assignment(conf)
    np.testing.assert_array_equal(a, jmetrics.pseudo_label_assignment(conf))
    np.testing.assert_array_equal(metrics.apply_assignment(conf, a), jmetrics.apply_assignment(conf, a))
    for assign in (True, False):
        if not assign and conf.shape[0] != conf.shape[1]:
            continue
        out, ref = metrics.evaluate_confusion(conf, assign), jmetrics.evaluate_confusion(conf, assign)
        assert sorted(out) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_pseudo_assignment_weighs_the_regret():
    conf = np.array([[10, 9, 0], [0, 8, 7]])
    np.testing.assert_array_equal(metrics.pseudo_label_assignment(conf), [0, 0, 1])
    np.testing.assert_array_equal(metrics.SEG_CLASS_WEIGHTS, jmetrics.SEG_CLASS_WEIGHTS)


def test_validation_accumulators_match_reference():
    rng = np.random.default_rng(31)
    acc, racc = validation.SegmentationAccumulator(), jval.SegmentationAccumulator()
    cat, rcat = validation.ConcatAccumulator("stego"), jval.ConcatAccumulator("stego")
    for _ in range(3):
        target = rng.integers(-1, 4, size=(2, 6, 8))
        seg = {"results": {"direct_cluster": {"pseudo_segs_pred": rng.integers(0, 5, size=(2, 1, 6, 8, 1)),
                                              "segs_pred": rng.integers(0, 4, size=(2, 1, 6, 8, 1))},
                           "stego_linear": {"segs_pred": rng.integers(0, 4, size=(2, 1, 6, 8, 1))}},
               "stego_corr": {k: rng.normal(size=(3, 4, 4)).astype(np.float32)
                              for k in ("stego_self_corr", "stego_nn_corr", "stego_random_corr", "dino_nn_corr")}}
        tseg = {"results": {k: {kk: _t(vv) for kk, vv in v.items()} for k, v in seg["results"].items()},
                "stego_corr": {k: _t(v) for k, v in seg["stego_corr"].items()}}
        conf = validation.compute_seg_confusions(tseg, target, 5, 4)
        rconf = jval.compute_seg_confusions(seg, target, 5, 4)
        assert sorted(conf) == sorted(rconf)
        for k in rconf:
            np.testing.assert_array_equal(conf[k], rconf[k])
        acc.update(conf)
        racc.update(rconf)
        cat.update(validation.compute_stego_metrics(tseg))
        rcat.update(jval.compute_stego_metrics(seg))
    out, ref = {**acc.compute(), **cat.compute()}, {**racc.compute(), **rcat.compute()}
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
