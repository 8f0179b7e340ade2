"""The rest of the port's stage 2 against the JAX package on the CPU: the
generic (unfolded) stage-2 render, `mode: 2d` (the train step, the
seeding and the CLI run) and data-parallel stage 2 (two gloo ranks
spawned with `torch.multiprocessing`, one item each of a global batch of
two, against JAX's global-batch step; first, the cluster centres seeded on
rank 0 from the global first batch and broadcast, against JAX's seeding).

The field, head, batches and draws are tests/test_torch_stage2.py's (the
draws rebuilt from JAX's keys as that module rebuilds them; the generic
render's strata from the render key's one `render_rays` draw over the
B*H*W rays, `split(key, 5)[0]`). Tolerances are that module's: values
atol 1e-4 (1e-5 x the largest magnitude where larger) and rtol 1e-4, the
loss dict rtol 1e-4, labels, crop validity and counters exactly, buffers
atol 1e-5, gradients |g - g_ref| <= 1e-3 |g_ref| (L2), parameters after
one Adam step to 1e-3 x lr where the gradient is live. The data-parallel
ranks' reduced losses are held at rtol 1e-5 against the port's one-process
step on the global batch. Its crops are made unequal across the ranks: a
density threshold of 1.25 leaves rank 0 no valid crop of 3 and rank 1 one
in the first step, two and none in the second, and rank 1's item has a
third of its labels ignored, so each ratio loss weighs the ranks by their
counts. JAX's gradients are read back from Adam's first moment after its
step (mu = (1 - b1) g), so one compile serves.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import scenedino_tpu.models.downstream as jds
import scenedino_tpu.training.downstream as jdown
from scenedino_torch.cli import train as cli
from scenedino_torch.models import downstream as ds
from scenedino_torch.parallel.data_parallel import DataParallel
from scenedino_torch.renderer.nerf import RenderConfig
from scenedino_torch.training import downstream as down
from scenedino_torch.utils import config as yaml_config
from scenedino_torch.utils.convert import load_jax_head
from tests.test_torch_ddp import _adam_mu, _free_port
from tests.test_torch_downstream import _head_draws, _jbuffers, _kmeans_pp_draws, dropout_masks
from tests.test_torch_stage2 import (HEAD, MODEL, ROOT, B, H, K, W, _close, _filled_buffers, _grad_rel_err,
                                     _jbatch, _key_with_side, _port_head, _semantic_config, _stage2_batch,
                                     _stage2_draws, _step_masks, _strata, _t, _tbatch, setup)  # noqa: F401
from tests.torch_stage2_ranks import worker

SPAWN_TIMEOUT = 150  # seconds for the two ranks, model builds and two steps included
HEAD_2D = {**HEAD, "mode": "2d", "patch_sample_size": 16}  # a five-crop of the 32x64 map: 4 x 4 samples
DCFG_TINY = dict(render_height=8, render_width=8, n_crops=3, n_samples=5, oversampling=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _assert_seg_data_close(seg, jseg):
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


def _jax_param(tree, name, transpose=True):
    """The JAX leaf of the port's head parameter `name`, in the port's layout."""
    *path, leaf = name.split(".")
    for k in path:
        tree = tree[k]
    x = np.asarray(tree[{"weight": "kernel"}.get(leaf, leaf)])
    return x.T if leaf == "weight" and transpose else x


def _assert_step_params(head, before, grads, ref_params, cfg):
    """After one Adam step: |update| <= lr, and the reference's parameters where the gradient is live."""
    for name, p in head.named_parameters():
        lr = cfg.lr * (1.0 if name.startswith("stego_head.") else cfg.head_lr_factor)
        assert float((p.detach() - before[name]).abs().max()) <= lr * (1 + 1e-3), name
        g = grads[name]
        live = g.abs() > 1e-4 * float(g.abs().max())
        np.testing.assert_allclose(p.detach()[live].numpy(), _jax_param(ref_params, name)[live.numpy()],
                                   atol=1e-3 * lr, rtol=5e-7, err_msg=name)


# ------------------------------------------------------------ the generic render
def test_generic_render_matches_jax_and_the_folded_render(setup):  # noqa: F811
    """use_fast_render off: the port's ImageRaySampler + render_rays_chunked
    forward (every output) against JAX's generic branch; and on the same
    strata the generic render against the port's folded render (K6's plain
    version), which the fold makes exact up to fp32 round-off."""
    s = setup
    jcfg, cfg = (dataclasses.replace(c, use_fast_render=False) for c in (s["jcfg"], s["cfg"]))
    key = _key_with_side(False)
    batch = _stage2_batch(1)
    buffers = _filled_buffers()
    fwd = jax.jit(lambda b, buf, k: jdown.downstream_forward(s["jfield"], s["params"], s["jhead"], s["hvars"], b,
                                                             buf, k, jcfg, s["jrcfg"], training=True))
    jseg, jrend, jbuf, _ = fwd(_jbatch(batch), _jbuffers(buffers), key)
    masks = _step_masks(s, key)
    draws = _stage2_draws(key, cfg, int(jbuf.filled), masks, True)
    k_render = jax.random.split(key, 6)[2]
    draws.u = _t(jax.random.uniform(jax.random.split(k_render, 5)[0], (B * H * W, K))).reshape(B, H * W, K)
    assert not down._fast_render_applies(s["model"], cfg, s["rcfg"])
    seg, rend, pbuf = down.downstream_forward(s["model"], _port_head(s), _tbatch(batch), buffers, draws, cfg,
                                              s["rcfg"], training=True)
    for k in ("depth", "dino_features", "rgb"):
        _close(rend[k], jrend[k])
    _assert_seg_data_close(seg, jseg)
    assert (pbuf.idx, pbuf.filled) == (int(jbuf.idx), int(jbuf.filled))
    np.testing.assert_allclose(pbuf.patch_buffer.numpy(), np.asarray(jbuf.patch_buffer), atol=1e-5, rtol=0)

    folded, *_ = down.render_frames(s["model"], _tbatch(batch), draws.u, 0, s["cfg"], s["rcfg"])
    generic, *_ = down.render_frames(s["model"], _tbatch(batch), draws.u, 0, cfg, s["rcfg"])
    for k in ("depth", "dino_features", "rgb"):
        _close(generic[k], folded[k].numpy())


# ------------------------------------------------------------------- mode 2d
@pytest.fixture(scope="module")
def two_d(setup):  # noqa: F811
    """The 2d head and config in both packages, and one JAX step of them."""
    s = setup
    jcfg, cfg = (dataclasses.replace(c, mode="2d") for c in (s["jcfg"], s["cfg"]))
    jhead = jds.SemanticHead(cfg=jds.SemanticHeadConfig(**HEAD_2D))
    tx = jdown.make_downstream_optimizer(jcfg, s["hvars"]["params"])
    state = jdown.init_downstream_state(s["hvars"], jcfg, jds.SemanticHeadConfig(**HEAD_2D), tx)
    step = jdown.make_downstream_train_step(s["jfield"], s["params"], jhead, jcfg, s["jrcfg"], tx)
    key, batch = jax.random.PRNGKey(30), _stage2_batch(3)
    new_state, losses = step(state, _jbatch(batch), key)
    with dropout_masks() as masks:  # the dropout masks: the same rng and call order on small inputs
        jhead.apply(s["hvars"], jnp.zeros((1, 1, 16, 16, 1, 64)), jds.RingBufferState.create(10, 4, 64),
                    jax.random.split(key, 6)[4], deterministic=False, method=jds.SemanticHead.forward_training,
                    rngs={"dropout": jax.random.split(key, 6)[5]}, mutable=["state"])
    return dict(jcfg=jcfg, cfg=cfg, jhead=jhead, key=key, batch=batch, state=new_state, losses=losses,
                masks=masks)


def test_2d_train_step_matches_jax(setup, two_d):  # noqa: F811
    """No 3D crops: the head's five crops of the rendered map feed the
    buffers and the STEGO terms; the loss dict, the parameters after the
    step and the buffers against JAX's."""
    s, t = setup, two_d
    head = ds.SemanticHead(ds.SemanticHeadConfig(**HEAD_2D))
    load_jax_head(head, s["hvars"])
    state = down.init_downstream_state(head, t["cfg"])
    assert state.buffers.patch_buffer.shape == (10, 16, 64)
    jnew = t["state"]
    k_view, k_side, k_render, _, k_head, _ = jax.random.split(t["key"], 6)
    coin = bool(jax.random.uniform(k_view) < t["cfg"].side_view_prob)
    side = int(jax.random.randint(k_side, (), min(4, 3), 4))
    pick, u = _head_draws(k_head, 5 * B, HEAD["knn_neighbors"], int(jnew.buffers.filled))
    draws = down.Stage2Draws(coin, side, _strata(k_render), None, None, None, None,
                             ds.HeadDraws(pick, u, _t(np.stack(t["masks"][:3]))))
    step = down.make_downstream_train_step(s["model"], head, t["cfg"], s["rcfg"])
    before = {n: p.detach().clone() for n, p in head.named_parameters()}
    losses = step(state, _tbatch(t["batch"]), draws)
    assert sorted(losses) == sorted(t["losses"]) and "crop_valid" not in losses
    for k, v in t["losses"].items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    grads = {n: p.grad for n, p in head.named_parameters()}
    _assert_step_params(head, before, grads, jnew.head_variables["params"], t["cfg"])
    b = state.buffers
    assert (b.idx, b.filled) == (int(jnew.buffers.idx), int(jnew.buffers.filled))
    np.testing.assert_allclose(b.patch_buffer.numpy(), np.asarray(jnew.buffers.patch_buffer), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b.gap_buffer.numpy(), np.asarray(jnew.buffers.gap_buffer), atol=1e-5, rtol=0)


def test_2d_seeding_matches_jax(setup, two_d):  # noqa: F811
    s, t = setup, two_d
    batch, key, max_points = _stage2_batch(2), jax.random.PRNGKey(8), 1000
    ref = jax.jit(lambda b, k: jdown.seed_cluster_centers(s["jfield"], s["params"], t["jhead"], s["hvars"], b, k,
                                                          t["jcfg"], s["jrcfg"], max_points=max_points))(
        _jbatch(batch), key)
    k_fwd, k_sub, k_d, k_s = jax.random.split(key, 4)
    sub = _t(np.asarray(jax.random.choice(k_sub, B * H * W, (max_points,), replace=False))).long()
    draws = down.SeedDraws(_strata(jax.random.split(k_fwd, 6)[2]), sub, _kmeans_pp_draws(k_d, max_points, 5),
                           _kmeans_pp_draws(k_s, max_points, 5))
    head = ds.SemanticHead(ds.SemanticHeadConfig(**HEAD_2D))
    load_jax_head(head, s["hvars"])
    down.seed_cluster_centers(s["model"], head, _tbatch(batch), draws, t["cfg"], s["rcfg"])
    for name in ("direct_cluster_head", "stego_cluster_head"):
        _close(getattr(head, name).cluster_centers, ref["params"][name]["cluster_centers"])


def test_2d_cli_trains(two_d, tmp_path, caplog):
    """cli.train --stage semantic with downstream.mode "2d": the train config
    takes the head's mode, and each step's loss dict has JAX's 2d keys."""
    conf = _semantic_config(tmp_path / "s2", 2, os.path.join(ROOT, "tests", "goldens", "s1b_field_params.npz"))
    conf["downstream"].update(mode="2d", patch_sample_size=9)  # five crops of 24x48: 3 x 3 samples
    conf["validation"] = {}
    assert cli.init_stage2(conf, "cpu")[4].mode == "2d"
    cfg_path = tmp_path / "s2.yaml"
    cfg_path.write_text(yaml_config.dumps(conf))
    with caplog.at_level("INFO"):
        cli.main(["--config", str(cfg_path), "--stage", "semantic", "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    assert [r.iteration for r in steps] == [1, 2]
    for r in steps:
        assert sorted(r.losses) == sorted(two_d["losses"]) and np.isfinite(list(r.losses.values())).all()


# ------------------------------------------------------------ data parallel
DP_THRESHOLD = 1.25


@dataclasses.dataclass(frozen=True)
class _OneProcess(DataParallel):
    """A rank of `world` in one process: `gather_rows` hands back, call by
    call, what every rank would have given, concatenated in rank order."""

    gathered: list = dataclasses.field(default_factory=list)

    def gather_rows(self, t):
        return self.gathered.pop(0)


@pytest.mark.parametrize("mode", ["3d", "2d"])
def test_crop_gather_and_draw_shards_follow_the_global_batch_order(mode):
    """4 items over 2 ranks: the gathered crops, gaps and validity land in
    the global batch's crop order (surface crops item-major, the head's five
    crops crop-major), and each rank's kNN picks and random rows are the
    global draws' at its crops."""
    B, world, C = 4, 2, 6
    head = ds.SemanticHead(ds.SemanticHeadConfig(**{**HEAD, "input_dim": C, "mode": mode}))
    cfg = down.DownstreamTrainConfig(**{**DCFG_TINY, "mode": mode})
    rng = np.random.default_rng(11)
    feats = _t(rng.normal(size=(B, 1, 8, 8, 1, C)).astype(np.float32))
    if mode == "3d":
        crops = _t(rng.normal(size=(B * cfg.n_crops, 5, C)).astype(np.float32))

        def crops_of(rows):  # item-major
            return crops.reshape(B, cfg.n_crops, 5, C)[rows].reshape(-1, 5, C)
    else:
        def crops_of(rows):  # crop-major
            x = ds.five_crop(feats[rows], 4)
            return x.reshape(x.shape[0], -1, C)
    every = crops_of(slice(None))
    valid = torch.from_numpy(rng.random(every.shape[0]) < 0.5)
    gaps = every.mean(1)
    g = torch.Generator().manual_seed(3)
    draws = down.draw_stage2(g, cfg, head.cfg, RenderConfig(n_coarse=2), B, 4)
    assert draws.head.knn_pick.shape == (every.shape[0],)
    locals_ = [crops_of(DataParallel(r, world).rows(B)) for r in range(world)]
    for r in range(world):
        order = down._crop_rows(r, world, B, head, cfg)
        assert torch.equal(locals_[r], every[order])
        parts = (torch.cat([every[down._crop_rows(q, world, B, head, cfg)] for q in range(world)]),
                 torch.cat([gaps[down._crop_rows(q, world, B, head, cfg)] for q in range(world)]),
                 torch.cat([valid[down._crop_rows(q, world, B, head, cfg)] for q in range(world)]))
        dp = _OneProcess(r, world, list(parts))
        got = down.make_crop_gather(dp, B, head, cfg)(locals_[r], gaps[order], valid[order])
        assert all(torch.equal(a, b) for a, b in zip(got, (every, gaps, valid)))
        mine = down.shard_stage2_draws(draws, DataParallel(r, world), B, head, cfg)
        assert torch.equal(mine.head.knn_pick, draws.head.knn_pick[order])
        assert torch.equal(mine.head.rand_u, draws.head.rand_u[order])
        assert torch.equal(mine.u, draws.u[DataParallel(r, world).rows(B)])


def _dp_batch(seed):
    batch = _stage2_batch(seed)
    batch["segs"][1, :, :, : W // 3] = -1  # rank 1's item: a third of its labels ignored
    return batch


@pytest.fixture(scope="module")
def jax_dp_steps(setup):  # noqa: F811
    """Two JAX steps on the global batches, the losses, the buffers after each,
    the first step's gradients (from Adam's first moment) and the masks."""
    s = setup
    jcfg = dataclasses.replace(s["jcfg"], sigma_threshold=DP_THRESHOLD)
    tx = jdown.make_downstream_optimizer(jcfg, s["hvars"]["params"])
    state = jdown.init_downstream_state(s["hvars"], jcfg, jds.SemanticHeadConfig(**HEAD), tx)
    step = jdown.make_downstream_train_step(s["jfield"], s["params"], s["jhead"], jcfg, s["jrcfg"], tx)
    keys, batches = [jax.random.PRNGKey(30), jax.random.PRNGKey(31)], [_dp_batch(3), _dp_batch(4)]
    out = {"keys": keys, "batches": batches, "losses": [], "states": [], "masks": []}
    for key, batch in zip(keys, batches):
        state, losses = step(state, _jbatch(batch), key)
        out["losses"].append(losses)
        out["states"].append(state)
        out["masks"].append(_step_masks(s, key))
    out["grads"] = {k: v / 0.1 for k, v in _adam_mu(out["states"][0].opt_state).items()}
    return out


def test_two_gloo_ranks_equal_the_global_stage2_step(setup, jax_dp_steps, tmp_path):  # noqa: F811
    s, j = setup, jax_dp_steps
    cfg = dataclasses.replace(s["cfg"], sigma_threshold=DP_THRESHOLD)
    draws = [_stage2_draws(key, cfg, int(st.buffers.filled), masks, True)
             for key, st, masks in zip(j["keys"], j["states"], j["masks"])]
    # the single process on the global batch
    head = _port_head(s)
    state = down.init_downstream_state(head, cfg)
    step = down.make_downstream_train_step(s["model"], head, cfg, s["rcfg"])
    single, valid = [], []
    for batch, d in zip(j["batches"], draws):
        seg = down.downstream_forward(s["model"], head, _tbatch(batch), ds.RingBufferState.create(10, 8, 64), d,
                                      cfg, s["rcfg"], training=False)[0]
        valid.append(seg["stego_corr"]["crop_valid"].reshape(B, -1).sum(1).tolist())
        single.append({k: float(v) for k, v in step(state, _tbatch(batch), d).items()})
    assert valid == [[0, 1], [2, 0]]  # the ranks' valid crops differ in both steps

    # the cluster centres of the global first batch: JAX's seeding and its draws, as test_torch_stage2's
    seed_key, max_points = jax.random.PRNGKey(8), 1000
    jcfg = dataclasses.replace(s["jcfg"], sigma_threshold=DP_THRESHOLD)
    centers = jax.jit(lambda b, k: jdown.seed_cluster_centers(s["jfield"], s["params"], s["jhead"], s["hvars"], b, k,
                                                              jcfg, s["jrcfg"], max_points=max_points))(
        _jbatch(j["batches"][0]), seed_key)["params"]
    k_fwd, k_sub, k_d, k_s = jax.random.split(seed_key, 4)
    sub = _t(np.asarray(jax.random.choice(k_sub, B * H * W, (max_points,), replace=False)).astype(np.int64))
    seed_draws = down.SeedDraws(_strata(jax.random.split(k_fwd, 6)[2]), sub, _kmeans_pp_draws(k_d, max_points, 5),
                                _kmeans_pp_draws(k_s, max_points, 5))

    inputs = str(tmp_path / "inputs.pt")
    torch.save({"model": MODEL, "field": s["model"].state_dict(), "head": _port_head(s).state_dict(),
                "head_cfg": HEAD, "cfg": dataclasses.asdict(cfg), "n_coarse": K, "draws": draws,
                "batches": [_tbatch(b) for b in j["batches"]], "seed_batch": _tbatch(j["batches"][0]),
                "seed_draws": seed_draws}, inputs)
    t0 = time.perf_counter()
    ctx = mp.start_processes(worker, args=(2, _free_port(), inputs, str(tmp_path)), nprocs=2, join=False,
                             start_method="spawn")
    while not ctx.join(timeout=5):
        assert time.perf_counter() - t0 < SPAWN_TIMEOUT, "the ranks did not finish in time"
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    for r in ranks:  # rank 0 seeded from the global batch, rank 1 took its centres
        for got, name in zip(r["centers"], ("direct_cluster_head", "stego_cluster_head")):
            _close(got, centers[name]["cluster_centers"])
            assert torch.equal(got, ranks[0]["centers"][name != "direct_cluster_head"]), name

    for i in range(2):
        for r in ranks:
            assert sorted(r["losses"][i]) == sorted(j["losses"][i])
            for k, v in j["losses"][i].items():
                np.testing.assert_allclose(r["losses"][i][k], single[i][k], rtol=1e-5, atol=1e-7, err_msg=k)
                np.testing.assert_allclose(r["losses"][i][k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
        jb = j["states"][i].buffers
        for r in ranks:  # every rank's buffers are the global step's
            patch, gap, idx, filled = r["buffers"][i]
            assert (idx, filled) == (int(jb.idx), int(jb.filled))
            np.testing.assert_allclose(patch.numpy(), np.asarray(jb.patch_buffer), atol=1e-5, rtol=0)
            np.testing.assert_allclose(gap.numpy(), np.asarray(jb.gap_buffer), atol=1e-5, rtol=0)
        for name, p in ranks[0]["params"][i].items():
            assert torch.equal(p, ranks[1]["params"][i][name]), name  # the heads stay replicas
    for name, g in ranks[0]["grads"].items():
        ref = _jax_param(_nest(j["grads"]), name)
        assert _grad_rel_err(g, ref) <= 1e-3, name
    head = _port_head(s)
    before = {n: p.detach().clone() for n, p in head.named_parameters()}
    head.load_state_dict({**head.state_dict(), **ranks[0]["params"][0]})
    _assert_step_params(head, before, ranks[0]["grads"], j["states"][0].head_variables["params"], cfg)


def _nest(flat):
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out = {}
    for path, v in flat.items():
        *keys, leaf = path.split("/")
        d = out
        for k in keys:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out
