"""`scenedino_torch.core.strategies` against `scenedino_tpu.core.strategies`:
every sampler's frame ids equal JAX's for the same draw, the draw taken
from the JAX key as the JAX sampler takes it (a permutation, per-pair
coins, one randint); the getters' dispatch; the draws from a
`torch.Generator` (their support and frequencies); and the training step's
split: `training.trainer.draw_stage1` draws one coin for the sample under
"alternate" and takes the ids of the JAX alternate sampler for it."""
import jax
import numpy as np
import pytest
import torch

import scenedino_tpu.core.strategies as J
from scenedino_torch.core import strategies as S
from scenedino_torch.renderer.nerf import RenderConfig
from scenedino_torch.training import trainer


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ids(x):
    return [int(i) for i in np.asarray(x)]


KEYS = [jax.random.PRNGKey(i) for i in range(6)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_default_encoder_sampler(n):
    assert S.default_encoder_sampler()(n) == _ids(J.default_encoder_sampler()(KEYS[0], n)) == [0]


@pytest.mark.parametrize("base", [True, False])
@pytest.mark.parametrize("n,k", [(8, 3), (8, 8), (4, 2)])
def test_full_encoder_sampler_equals_jax(n, k, base):
    for key in KEYS:
        perm = _ids(jax.random.permutation(key, np.arange(1, n)))
        ref = _ids(J.kitti_360_full_encoder_sampler(k, base)(key, n))
        assert S.kitti_360_full_encoder_sampler(k, base)(n, draw=perm) == ref
    # frame 0 unreachable without the base frame, and one frame fewer at k == n (the reference's quirk)
    if not base and k == n:
        assert len(ref) == n - 1 and 0 not in ref


@pytest.mark.parametrize("base", [True, False])
@pytest.mark.parametrize("n,k,ns", [(8, 2, 4), (8, 3, 8), (4, 2, 6)])
def test_stereo_encoder_sampler_equals_jax(n, k, ns, base):
    for key in KEYS:
        perm = _ids(jax.random.permutation(key, np.arange(1, min(n, ns))))
        ref = _ids(J.kitti_360_stereo_encoder_sampler(k, ns, base)(key, n))
        assert S.kitti_360_stereo_encoder_sampler(k, ns, base)(n, draw=perm) == ref


@pytest.mark.parametrize("shuffle,all_frames", [(False, False), (False, True), (True, False), (True, True)])
def test_single_view_sampler_equals_jax(shuffle, all_frames):
    n = 6
    for key in KEYS:
        perm = _ids(jax.random.permutation(key, np.arange(n)))
        loss, render = J.single_view_loss_sampler(shuffle, all_frames)(key, n)
        got = S.single_view_loss_sampler(shuffle, all_frames)(n, draw=perm if shuffle else None)
        assert got == (_ids(loss), _ids(render))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pair_samplers_equal_jax(n):
    for key in KEYS:
        coins = _ids(jax.random.bernoulli(key, 0.5, (n // 2,)))
        loss, render = J.stereo_view_loss_sampler()(key, n)
        assert S.stereo_view_loss_sampler()(n, draw=coins) == (_ids(loss), _ids(render))
        draws = _ids(jax.random.randint(key, (n // 2,), 0, 3))
        loss, render = J.kitti_360_loss_sampler()(key, n)
        assert S.kitti_360_loss_sampler()(n, draw=draws) == (_ids(loss), _ids(render))
        draw = int(jax.random.randint(key, (), 0, 3))
        loss, render = J.alternate_loss_sampler()(key, n)
        assert S.alternate_loss_sampler()(n, draw=draw) == (_ids(loss), _ids(render))


def test_alternate_sampler_takes_the_evens_or_the_odds():
    fn = S.alternate_loss_sampler()
    assert fn(4, draw=1) == fn(4, draw=2) == ([0, 2], [1, 3])
    assert fn(4, draw=0) == ([1, 3], [0, 2])
    g = torch.Generator().manual_seed(0)
    odds = np.mean([fn(4, g)[0] == [1, 3] for _ in range(600)])
    assert 0.28 < odds < 0.39  # p = 1/3


@pytest.mark.parametrize("name,args", [
    ("kitti_360_full", {"num_encoder_frames": 2}),
    ("kitti_360_stereo", {"num_encoder_frames": 2, "num_stereo_frames": 4}),
    (None, {}),
    ("other", {}),
])
def test_encoder_getter_dispatches_as_jax(name, args):
    config = {"name": name, "args": args}
    fn = S.get_encoder_sampling(config)
    ref = J.get_encoder_sampling(config)
    for key in KEYS:
        n = 8
        m = min(n, args.get("num_stereo_frames", n))
        perm = _ids(jax.random.permutation(key, np.arange(1, m)))
        assert fn(n, draw=perm) == _ids(ref(key, n))


@pytest.mark.parametrize("config", [{"name": "kitti_360"}, {"name": "stereo_view"}, {"name": "alternate"},
                                    {"name": "single_renderer", "args": {"all_frames": True}},
                                    {"name": "single_view"}, {"name": "unknown"}, None])
def test_loss_renderer_getter_dispatches_as_jax(config):
    n = 8
    fn, ref = S.get_loss_renderer_sampling(config), J.get_loss_renderer_sampling(config)
    name = (config or {}).get("name")
    for key in KEYS:
        if name == "stereo_view":
            draw = _ids(jax.random.bernoulli(key, 0.5, (n // 2,)))
        elif name == "alternate":
            draw = int(jax.random.randint(key, (), 0, 3))
        elif name in ("single_renderer", "single_view"):
            draw = None
        else:
            draw = _ids(jax.random.randint(key, (n // 2,), 0, 3))
        loss, render = ref(key, n)
        assert fn(n, draw=draw) == (_ids(loss), _ids(render))


def test_generator_draws_cover_their_support():
    g = torch.Generator().manual_seed(1)
    seen = {tuple(S.kitti_360_full_encoder_sampler(3)(6, g)) for _ in range(200)}
    assert all(s[0] == 0 and len(set(s)) == 3 and max(s) < 6 for s in seen) and len(seen) == 20
    base = np.mean([S.kitti_360_loss_sampler()(2, g)[0] == [0] for _ in range(600)])
    assert 0.6 < base < 0.73  # the base frame is the loss frame with p = 2/3
    with pytest.raises(ValueError, match="permutation"):
        S.kitti_360_full_encoder_sampler(2)(4, draw=[1, 1, 2])


# ------------------------------------------------------------- the training step
@pytest.mark.parametrize("V", [4, 8])
def test_draw_stage1_alternate_draws_one_coin_for_the_sample(V):
    cfg = trainer.TrainConfig(loss_renderer_strategy="alternate", ray_batch_size=64)
    rcfg = RenderConfig(n_coarse=4)
    coins = []
    for seed in range(200):
        d = trainer.draw_stage1(torch.Generator().manual_seed(seed), cfg, rcfg, 1, V, 16, 32)
        assert len(set(d.split_coin)) == 1 and len(d.split_coin) == V // 2
        # the port's coin (1: the odd frames give the loss) is JAX's `randint(0, 3) == 0`
        r = 0 if d.split_coin[0] else 1
        assert trainer.sample_frame_split(d.split_coin) == S.alternate_loss_sampler()(V, draw=r)
        coins.append(d.split_coin[0])
    assert 0.24 < np.mean(coins) < 0.42
    # the first draw of the generator is the coin, as under "kitti_360" the pairs' coins are
    g = torch.Generator().manual_seed(7)
    first = torch.randint(0, 3, (1,), generator=g).item()
    d = trainer.draw_stage1(torch.Generator().manual_seed(7), cfg, rcfg, 1, V, 16, 32)
    assert d.split_coin[0] == int(first == 0)


def test_the_step_takes_the_two_splits_the_jax_step_runs():
    """"alternate" draws one coin for the sample; every other name takes the
    KITTI-360 split (a coin per pair), as JAX's stage1_forward does
    (trainer.py:182-188): the same generator gives the same draws for each."""
    rcfg = RenderConfig(n_coarse=4)
    ref = trainer.draw_stage1(torch.Generator().manual_seed(3), trainer.TrainConfig(ray_batch_size=64), rcfg,
                              1, 8, 16, 32)
    for name in ("kitti_360", "single_view", "stereo_view", "anything_else"):
        cfg = trainer.TrainConfig(loss_renderer_strategy=name, ray_batch_size=64)
        d = trainer.draw_stage1(torch.Generator().manual_seed(3), cfg, rcfg, 1, 8, 16, 32)
        assert d.split_coin == ref.split_coin and torch.equal(d.u, ref.u), name
    alt = trainer.draw_stage1(torch.Generator().manual_seed(3),
                              trainer.TrainConfig(loss_renderer_strategy="alternate", ray_batch_size=64),
                              rcfg, 1, 8, 16, 32)
    assert len(set(alt.split_coin)) == 1
    conf = {"model": {"loss_renderer_strategy": {"name": "alternate"}}}
    assert trainer.configs_from_dict(conf)[1].loss_renderer_strategy == "alternate"
    assert trainer.configs_from_dict({"model": {"loss_renderer_strategy": {"name": "single_view"}}}
                                     )[1].loss_renderer_strategy == "single_view"
