"""The port's fine sampling and fine render pass (scenedino_torch.core.sampling,
scenedino_torch.renderer.nerf) against the reference's on the same inputs
and draws.

The draws are rebuilt from the JAX key as the reference code draws them:
`sample_fine` splits its key into (k_u, k_j) and draws `uniform` from
each; `sample_fine_depth` draws `normal`; `render_rays` splits its key
into (coarse, fine, fine_depth, noise, noise) and hands the pieces down.

Bounds: `sample_fine` picks a coarse stratum by comparing u with the CDF
of the weights, a step function; both CDFs are fp32 cumulative sums in
their own order, so a u within a few ulps of a CDF value may pick the
neighbouring stratum. Where both pick the same stratum the depths agree
to atol 1e-5 (m), and at most 1e-3 of the samples may pick another.
`sample_fine_depth` agrees to atol 1e-5. The whole render (coarse and fine
pass, outputs and the field parameters' gradients) agrees to rtol 1e-4
(fp32 sums in other orders through the compositing and its backward);
`_searchsorted_right` agrees exactly, ties included; `render_rays_chunked`
equals `render_rays`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import scenedino_tpu.core.sampling as jsampling
import scenedino_tpu.renderer.nerf as jnerf
from scenedino_torch.core import sampling
from scenedino_torch.renderer import nerf

NEAR, FAR = 3.0, 80.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rays(rng, n):
    """(n, 8) rays from near the origin, looking down +z with a spread."""
    o = rng.uniform(-0.5, 0.5, size=(n, 3))
    d = np.concatenate([rng.uniform(-0.6, 0.6, size=(n, 2)), np.ones((n, 1))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), NEAR), np.full((n, 1), FAR)], -1).astype(np.float32)


def test_searchsorted_right_ties_match_exactly():
    """A u equal to a CDF value counts that value (side="right"), on both packages."""
    cdf = np.array([[0.0, 0.25, 0.5, 0.75, 1.0], [0.0, 0.0, 0.5, 0.5, 1.0]], np.float32)
    u = np.array([[0.0, 0.25, 0.3, 0.75, 1.0, 0.9999], [0.0, 0.5, 0.25, 1.0, 0.75, 0.4999]], np.float32)
    ours = sampling._searchsorted_right(torch.from_numpy(cdf), torch.from_numpy(u)).numpy()
    ref = np.asarray(jsampling._searchsorted_right(jnp.asarray(cdf), jnp.asarray(u)))
    expect = np.stack([np.searchsorted(c, x, side="right") for c, x in zip(cdf, u)])
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, expect)


def test_take_per_row_matches_reference():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(6, 9)).astype(np.float32)
    ids = rng.integers(0, 9, size=(6, 5))
    ours = sampling._take_per_row(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    ref = np.asarray(jsampling._take_per_row(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("lindisp", [True, False])
def test_sample_fine_matches_reference(lindisp):
    rng = np.random.default_rng(2)
    R, Kc, N = 4096, 32, 16
    rays = _rays(rng, R)
    # peaked weights, as a trained field gives, with exact zeros
    w = rng.gamma(0.3, size=(R, Kc)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.2] = 0.0
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsampling.sample_fine(key, jnp.asarray(rays), jnp.asarray(w), N, Kc, lindisp))
    k_u, k_j = jax.random.split(key)
    u = _t(jax.random.uniform(k_u, (R, N), dtype=jnp.float32))
    t = _t(jax.random.uniform(k_j, (R, N)))
    ours = sampling.sample_fine(_t(rays), _t(w), N, Kc, lindisp, u=u, t=t).numpy()
    # the stratum each side picked
    wt = _t(w) + 1e-5
    cdf_t = torch.cat([torch.zeros(R, 1), torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)], -1)
    wj = jnp.asarray(w) + 1e-5
    cdf_j = jnp.concatenate([jnp.zeros((R, 1)), jnp.cumsum(wj / jnp.sum(wj, -1, keepdims=True), -1)], -1)
    same = (sampling._searchsorted_right(cdf_t, u).numpy()
            == np.asarray(jsampling._searchsorted_right(cdf_j, jnp.asarray(u.numpy()))))
    assert same.mean() >= 1 - 1e-3, same.mean()
    np.testing.assert_allclose(ours[same], ref[same], atol=1e-5, rtol=0)
    assert ours.min() >= NEAR - 1e-4 and ours.max() <= FAR + 1e-3


def test_sample_fine_depth_matches_reference():
    rng = np.random.default_rng(4)
    R, N = 1024, 8
    rays = _rays(rng, R)
    depth = rng.uniform(1.0, 90.0, size=R).astype(np.float32)  # some beyond near and far: clamped
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jsampling.sample_fine_depth(key, jnp.asarray(rays), jnp.asarray(depth), N, 1.5))
    noise = _t(jax.random.normal(key, (R, N)))
    ours = sampling.sample_fine_depth(_t(rays), _t(depth), N, 1.5, noise=noise).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    assert ours.min() == NEAR and ours.max() == FAR


# ------------------------------------------------------------- the render
D_H, D_DINO = 16, 6


def _field_params(seed=6):
    rng = np.random.default_rng(seed)
    return {
        "w1": (0.08 * rng.normal(size=(3, D_H))).astype(np.float32),
        "b1": (0.5 * rng.normal(size=(D_H,))).astype(np.float32),
        "ws": (0.6 * rng.normal(size=(D_H,))).astype(np.float32),
        "wc": (0.5 * rng.normal(size=(D_H, 3))).astype(np.float32),
        "wd": (0.5 * rng.normal(size=(D_H, D_DINO))).astype(np.float32),
    }


def _jfield(p):
    def fn(xyz, only_density=False):
        h = jnp.tanh(xyz @ p["w1"] + p["b1"])
        sigma = jax.nn.softplus(4.0 * (h @ p["ws"]))
        rgb = jax.nn.sigmoid(h @ p["wc"])
        return rgb, jnp.zeros(xyz.shape[:2] + (1,)), sigma, h @ p["wd"]
    return fn


def _tfield(p):
    def fn(xyz, only_density=False):
        h = torch.tanh(xyz @ p["w1"] + p["b1"])
        sigma = F.softplus(4.0 * (h @ p["ws"]))
        rgb = torch.sigmoid(h @ p["wc"])
        return rgb, torch.zeros(*xyz.shape[:2], 1), sigma, h @ p["wd"]
    return fn


def _jax_draws(key, BR, cfg):
    """render_rays' draws from `key`, rebuilt as the reference draws them."""
    k_coarse, k_fine, k_fine_depth, _, _ = jax.random.split(key, 5)
    u = _t(jax.random.uniform(k_coarse, (BR, cfg.n_coarse), jnp.float32))
    n_imp = cfg.n_fine - cfg.n_fine_depth
    k_u, k_j = jax.random.split(k_fine)
    fine = nerf.FineDraws(
        _t(jax.random.uniform(k_u, (BR, n_imp), dtype=jnp.float32)) if n_imp else None,
        _t(jax.random.uniform(k_j, (BR, n_imp))) if n_imp else None,
        _t(jax.random.normal(k_fine_depth, (BR, cfg.n_fine_depth))) if cfg.n_fine_depth else None,
    )
    return u, fine


@pytest.mark.parametrize("n_fine_depth", [0, 4])
def test_render_rays_fine_pass_matches_reference(n_fine_depth):
    rng = np.random.default_rng(7)
    B, R = 2, 128
    rays = _rays(rng, B * R).reshape(B, R, 8)
    params = _field_params()
    jcfg = jnerf.RenderConfig(n_coarse=16, n_fine=16, n_fine_depth=n_fine_depth)
    tcfg = nerf.RenderConfig(n_coarse=16, n_fine=16, n_fine_depth=n_fine_depth)
    key = jax.random.PRNGKey(8)
    cot = {lvl: {k: rng.normal(size=s).astype(np.float32)
                 for k, s in (("rgb", (B, R, 3)), ("depth", (B, R)), ("dino_features", (B, R, D_DINO)))}
           for lvl in ("coarse", "fine")}

    def jloss(p):
        out = jnerf.render_rays(_jfield(p), jnp.asarray(rays), key, jcfg, want_weights=True, want_z_samps=True)
        loss = sum(jnp.sum(out[lvl][k] * cot[lvl][k]) for lvl in cot for k in cot[lvl])
        return loss, out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tparams = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    u, fine = _jax_draws(key, B * R, tcfg)
    out = nerf.render_rays(_tfield(tparams), _t(rays), u, tcfg, want_weights=True, want_z_samps=True, fine=fine)
    assert sorted(out) == ["coarse", "fine"] and out["fine"]["z_samps"].shape == (B, R, 32)
    for lvl in ("coarse", "fine"):
        assert sorted(out[lvl]) == sorted(ref[lvl])
        for k, r in ref[lvl].items():
            np.testing.assert_allclose(out[lvl][k].detach().numpy(), np.asarray(r), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{lvl}/{k}")
    sum((out[lvl][k] * _t(cot[lvl][k])).sum() for lvl in cot for k in cot[lvl]).backward()
    for k, g in jgrads.items():
        np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=k)


def test_render_rays_needs_the_fine_draws():
    rays = _t(_rays(np.random.default_rng(9), 8)).reshape(1, 8, 8)
    cfg = nerf.RenderConfig(n_coarse=4, n_fine=4)
    with pytest.raises(ValueError, match="fine"):
        nerf.render_rays(_tfield({k: _t(v) for k, v in _field_params().items()}), rays, torch.rand(8, 4), cfg)


@pytest.mark.parametrize("n_fine,n_fine_depth", [(0, 0), (8, 3)])
def test_render_rays_chunked_equals_render_rays(n_fine, n_fine_depth):
    rng = np.random.default_rng(10)
    B, R = 2, 300
    rays = _t(_rays(rng, B * R)).reshape(B, R, 8)
    cfg = nerf.RenderConfig(n_coarse=12, n_fine=n_fine, n_fine_depth=n_fine_depth)
    g = torch.Generator().manual_seed(11)
    u = torch.rand(B * R, cfg.n_coarse, generator=g)
    fine = nerf.FineDraws.draw(g, B * R, cfg)
    field = _tfield({k: _t(v) for k, v in _field_params().items()})
    whole = nerf.render_rays(field, rays, u, cfg, want_weights=True, fine=fine)
    for chunk in (64, 128, 299):
        parts = nerf.render_rays_chunked(field, rays, u, cfg, chunk=chunk, want_weights=True, fine=fine)
        assert sorted(parts) == sorted(whole)
        for lvl in whole:
            assert sorted(parts[lvl]) == sorted(whole[lvl])
            for k, v in whole[lvl].items():
                torch.testing.assert_close(parts[lvl][k], v, rtol=1e-6, atol=1e-6, msg=f"{chunk} {lvl}/{k}")
