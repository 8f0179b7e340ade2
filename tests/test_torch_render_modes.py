"""Parity of the port's render modes and options, and of its ray samplers,
with the JAX reference on the CPU.

The renders query a small closed-form field (density, two render views'
colours, an 8-d feature; the same formula in jnp and torch), so that they
hold the renderer alone: `surface` (density only, no colour), `neus` (the
colour reduced with NeuS-reweighted weights, the feature with the plain
ones), density noise under training on both passes (a fine pass of
importance and depth samples), `white_bkgd` and `sample_from_dist`, each
against `scenedino_tpu.renderer.nerf.render_rays` on the draws its key
gives (split as JAX splits it, then handed to the port), at
tests/test_torch_training.py's 1e-4. The samplers take the draws JAX's
keys give: gathered pixels bit for bit, computed rays within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.core.ray_sampler as JS
import scenedino_tpu.renderer.nerf as jnerf
from scenedino_torch.core import ray_sampler as S
from scenedino_torch.renderer.nerf import FineDraws, RenderConfig, render_rays, render_rays_chunked

B, R = 2, 24
RNG = np.random.default_rng(0)
W_SIGMA = RNG.normal(size=(3,)).astype(np.float32)
W_RGB = RNG.normal(size=(3, 6)).astype(np.float32)
W_DINO = RNG.normal(size=(3, 8)).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _field(lib):
    """(xyz (B, P, 3), only_density) -> (rgb (B, P, 6) | None, invalid (B, P, 2), sigma (B, P), dino (B, P, 8))."""
    if lib == "jax":
        def fn(xyz, only_density=False):
            sigma = jax.nn.softplus(jnp.sin(xyz) @ jnp.asarray(W_SIGMA) + 0.2 * xyz[..., 2] - 2.0)
            invalid = jnp.stack([xyz[..., 0] > 1.5, xyz[..., 1] < -1.0], -1).astype(jnp.float32)
            dino = jnp.tanh(xyz @ jnp.asarray(W_DINO) * 0.1)
            rgb = None if only_density else jax.nn.sigmoid(xyz @ jnp.asarray(W_RGB) * 0.1)
            return rgb, invalid, sigma, dino
        return fn

    def fn(xyz, only_density=False):
        sigma = torch.nn.functional.softplus(torch.sin(xyz) @ _t(W_SIGMA) + 0.2 * xyz[..., 2] - 2.0)
        invalid = torch.stack([xyz[..., 0] > 1.5, xyz[..., 1] < -1.0], -1).float()
        dino = torch.tanh(xyz @ _t(W_DINO) * 0.1)
        rgb = None if only_density else torch.sigmoid(xyz @ _t(W_RGB) * 0.1)
        return rgb, invalid, sigma, dino
    return fn


def _rays(seed=5):
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(B, R, 3)) * 0.2
    dirs = rng.normal(size=(B, R, 3)) * [0.3, 0.2, 0.0] + [0, 0, 1]
    return np.concatenate([origins, dirs, np.full((B, R, 1), 3.0), np.full((B, R, 1), 80.0)], -1).astype(np.float32)


def _draws(key, cfg, training, dist=False):
    """The port's draws of `jnerf.render_rays(key)`: (u, t, noise, FineDraws)."""
    k_coarse, k_fine, k_fine_depth, k_noise_c, k_noise_f = jax.random.split(key, 5)
    n = B * R
    t = None
    if dist:
        k_u, k_t = jax.random.split(k_coarse)
        u = _t(jax.random.uniform(k_u, (n, cfg.n_coarse)))
        t = _t(jax.random.uniform(k_t, (n, cfg.n_coarse)))
    else:
        u = _t(jax.random.uniform(k_coarse, (n, cfg.n_coarse)))
    noisy = training and cfg.noise_std > 0
    noise = _t(jax.random.normal(k_noise_c, (n, cfg.n_coarse))) if noisy else None
    fine = None
    if cfg.using_fine:
        fine = FineDraws()
        n_imp = cfg.n_fine - cfg.n_fine_depth
        if n_imp:
            k_u, k_j = jax.random.split(k_fine)
            fine.u, fine.t = _t(jax.random.uniform(k_u, (n, n_imp))), _t(jax.random.uniform(k_j, (n, n_imp)))
        if cfg.n_fine_depth:
            fine.noise = _t(jax.random.normal(k_fine_depth, (n, cfg.n_fine_depth)))
        if noisy:
            fine.sigma_noise = _t(jax.random.normal(k_noise_f, (n, cfg.n_coarse + cfg.n_fine)))
    return u, t, noise, fine


CASES = {
    "surface": (dict(render_mode="surface"), False),
    "neus": (dict(render_mode="neus", surface_sigmoid_scale=0.7), False),
    "noise": (dict(noise_std=0.5, n_fine=6, n_fine_depth=2), True),
    "noise_not_training": (dict(noise_std=0.5), False),
    "white_bkgd": (dict(white_bkgd=True, n_fine=4), False),
    "neus_white_bkgd_noise": (dict(render_mode="neus", white_bkgd=True, noise_std=0.3), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_modes_match_reference(case):
    kw, training = CASES[case]
    kw = {"n_coarse": 12, **kw}
    rays, key = _rays(), jax.random.PRNGKey(len(case))
    want = dict(want_weights=True, want_alphas=True, want_z_samps=True, want_rgb_samps=True)
    ref = jnerf.render_rays(_field("jax"), jnp.asarray(rays), key, jnerf.RenderConfig(**kw), training=training,
                            **want)
    cfg = RenderConfig(**kw)
    u, _, noise, fine = _draws(key, cfg, training)
    out = render_rays(_field("torch"), _t(rays), u, cfg, fine=fine, noise=noise, training=training, **want)
    assert sorted(out) == sorted(ref)
    for level in ref:
        assert sorted(out[level]) == sorted(ref[level]), level
        for name, r in ref[level].items():
            if r is None:
                assert out[level][name] is None, (level, name)
                continue
            np.testing.assert_allclose(out[level][name].numpy(), np.asarray(r), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{level} {name}")
    if case == "surface":
        assert out["coarse"]["rgb"] is None and "rgb_samps" not in out["coarse"]
    if case == "neus":  # the colour's weights are reweighted, the feature's are not
        plain = render_rays(_field("torch"), _t(rays), u, RenderConfig(n_coarse=12), want_weights=True)
        assert torch.allclose(plain["coarse"]["dino_features"], out["coarse"]["dino_features"], atol=1e-6)
        assert not torch.allclose(plain["coarse"]["rgb"], out["coarse"]["rgb"], atol=1e-3)


def test_noise_needs_its_draws():
    cfg = RenderConfig(n_coarse=4, noise_std=1.0)
    u = torch.rand(B * R, 4)
    with pytest.raises(ValueError, match="noise"):
        render_rays(_field("torch"), _t(_rays()), u, cfg, training=True)
    render_rays(_field("torch"), _t(_rays()), u, cfg)  # not training: no noise, no draws needed
    with pytest.raises(ValueError, match="render_mode"):
        render_rays(_field("torch"), _t(_rays()), u, RenderConfig(n_coarse=4, render_mode="sdf"))


@pytest.mark.parametrize("lindisp", [True, False])
def test_sample_from_dist_matches_reference(lindisp):
    rays, key = _rays(6), jax.random.PRNGKey(7)
    rng = np.random.default_rng(8)
    prop_w = rng.uniform(size=(B, R, 10)).astype(np.float32) ** 3
    prop_z = np.sort(3 + 77 * rng.uniform(size=(B, R, 10)), -1).astype(np.float32)
    kw = dict(n_coarse=9, lindisp=lindisp)
    ref = jnerf.render_rays(_field("jax"), jnp.asarray(rays), key, jnerf.RenderConfig(**kw), want_z_samps=True,
                            sample_from_dist=(jnp.asarray(prop_w), jnp.asarray(prop_z)))
    u, t, _, _ = _draws(key, RenderConfig(**kw), False, dist=True)
    out = render_rays(_field("torch"), _t(rays), u, RenderConfig(**kw), want_z_samps=True,
                      sample_from_dist=(_t(prop_w), _t(prop_z)), t=t)
    for name, r in ref["coarse"].items():
        np.testing.assert_allclose(out["coarse"][name].numpy(), np.asarray(r), atol=1e-4, rtol=1e-4, err_msg=name)


def test_chunked_render_with_noise_and_proposals_equals_one_pass():
    cfg = RenderConfig(n_coarse=6, noise_std=0.4, n_fine=3, n_fine_depth=1)
    g = torch.Generator().manual_seed(0)
    u, t = torch.rand(B * R, 6, generator=g), torch.rand(B * R, 6, generator=g)
    noise = torch.randn(B * R, 6, generator=g)
    fine = FineDraws.draw(g, B * R, cfg, training=True)
    assert fine.sigma_noise.shape == (B * R, 9)
    prop = (torch.rand(B, R, 5, generator=g), torch.sort(3 + 70 * torch.rand(B, R, 5, generator=g), -1).values)
    kw = dict(fine=fine, noise=noise, training=True, sample_from_dist=prop, t=t, want_weights=True)
    one = render_rays(_field("torch"), _t(_rays()), u, cfg, **kw)
    chunked = render_rays_chunked(_field("torch"), _t(_rays()), u, cfg, chunk=7, **kw)
    for level in one:
        for name, v in one[level].items():
            assert torch.allclose(chunked[level][name], v, atol=1e-6), (level, name)


# ------------------------------------------------------------- samplers

def _views(seed, Bv=2, V=3, C=3, H=16, W=24):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(Bv, V, C, H, W)).astype(np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (Bv, V, 4, 4)).copy()
    poses[:, :, :3, 3] = rng.normal(size=(Bv, V, 3)) * 0.3
    ks = np.broadcast_to(np.array([[1.1, 0, 0.05], [0, 1.6, -0.02], [0, 0, 1]], np.float32), (Bv, V, 3, 3)).copy()
    return imgs, poses, ks


def test_jittered_patch_sampler_matches_reference():
    imgs, poses, ks = _views(1)
    Bv, V, C, H, W = imgs.shape
    js = JS.JitteredPatchRaySampler(3.0, 80.0, ray_batch_size=32, patch_size=4, jitter_scale=0.8)
    key = jax.random.PRNGKey(3)
    ref_rays, ref_rgb, ref_dino = js.sample(key, *(jnp.asarray(x) for x in (imgs, poses, ks)))
    k_jit, k_v, k_y, k_x = jax.random.split(key, 4)
    PC = 2
    off = _t((jax.random.uniform(k_jit, (2,)) - 0.5) * 0.8)
    picks = [torch.from_numpy(np.asarray(jax.random.randint(k, (Bv, PC), 0, hi)).astype(np.int64))
             for k, hi in ((k_v, V), (k_y, H - 4), (k_x, W - 4))]
    ps = S.JitteredPatchRaySampler(3.0, 80.0, ray_batch_size=32, patch_size=4, jitter_scale=0.8)
    rays, rgb, dino = ps.sample(_t(imgs), _t(poses), _t(ks), off, *picks)
    assert dino is None and ref_dino is None
    np.testing.assert_allclose(rays.numpy(), np.asarray(ref_rays), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), atol=1e-6, rtol=1e-6)
    off, pv, py, px = ps.draw(Bv, V, H, W, torch.Generator().manual_seed(0))
    assert off.shape == (2,) and float(off.abs().max()) <= 0.4
    assert pv.shape == (Bv, PC) and int(pv.max()) < V and int(py.max()) < H - 4 and int(px.max()) < W - 4


def test_random_and_point_samplers_match_reference():
    imgs, poses, ks = _views(2)
    Bv, V, C, H, W = imgs.shape
    key = jax.random.PRNGKey(4)
    ref_rays, ref_rgb, _ = JS.RandomRaySampler(3.0, 80.0, ray_batch_size=40).sample(
        key, *(jnp.asarray(x) for x in (imgs, poses, ks)))
    idx = torch.from_numpy(np.asarray(jax.random.randint(key, (Bv, 40), 0, V * H * W)).astype(np.int64))
    rs = S.RandomRaySampler(3.0, 80.0, ray_batch_size=40)
    rays, rgb, _ = rs.sample(_t(imgs), _t(poses), _t(ks), idx)
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(ref_rgb))  # a gather of the same pixels
    np.testing.assert_array_equal(rays[..., 6:9].numpy(), np.asarray(ref_rays)[..., 6:9])  # near, far, frame id
    np.testing.assert_allclose(rays.numpy(), np.asarray(ref_rays), atol=1e-6, rtol=1e-6)
    drawn = rs.draw(Bv, V, H, W, torch.Generator().manual_seed(1))
    assert drawn.shape == (Bv, 40) and int(drawn.max()) < V * H * W

    pts = np.random.default_rng(3).normal(size=(Bv, 7, 3)).astype(np.float32) * 5 + [0, 0, 10]
    ref = JS.PointBasedRaySampler(3.0, 80.0).sample(jnp.asarray(pts), jnp.asarray(poses[:, 1]))
    out = S.PointBasedRaySampler(3.0, 80.0).sample(_t(pts), _t(poses[:, 1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("conf", [
    {},
    {"sample_mode": "patch", "z_near": 2.0, "args": {"ray_batch_size": 256, "patch_size": 4, "dino_upscaled": True}},
    {"sample_mode": "random", "z_far": 50.0, "args": {"ray_batch_size": 128}},
    {"sample_mode": "image", "args": {"height": 8, "width": 16}},
])
def test_sampler_factory_matches_reference(conf):
    ref, out = JS.get_ray_sampler(conf), S.get_ray_sampler(conf)
    assert type(out).__name__ == type(ref).__name__
    mine = dataclasses.asdict(out)
    assert {k: v for k, v in dataclasses.asdict(ref).items() if k in mine} == mine
    with pytest.raises(ValueError):
        S.get_ray_sampler({"sample_mode": "nope"})
