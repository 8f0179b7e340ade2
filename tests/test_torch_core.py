"""Parity of the port's core math (scenedino_torch.core) with the JAX
reference (scenedino_tpu.core) on the CPU, at small shapes.

Inputs come from a seeded numpy RNG and go through both packages. Unless
a test says otherwise the tolerance is fp32 round-off: atol/rtol 1e-5 on
values of order 1-100 (the two sides order their sums differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scenedino_tpu.core import cameras as jcam
from scenedino_tpu.core import compositing as jcomp
from scenedino_tpu.core import encoding as jenc
from scenedino_tpu.core import grid_sample as jgs
from scenedino_tpu.core import ray_sampler as jrs
from scenedino_tpu.core import rays as jrays
from scenedino_tpu.core import safe_normalize as j_safe_normalize
from scenedino_tpu.core import sampling as jsamp
from scenedino_tpu.core.resize import torch_interpolate
from scenedino_torch.core import cameras, compositing, encoding, grid_sample, ray_sampler, rays, safe_normalize, sampling

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _pose(rng, angle=0.3, shift=1.0):
    """A rigid 4x4 transform: rotation about a random axis plus a shift."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3) * shift
    return T


K_NDC = np.array([[0.7, 0.0, 0.05], [0.0, 2.3, -0.1], [0.0, 0.0, 1.0]], np.float32)


def test_safe_normalize_matches_and_has_finite_grad_at_zero():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(
        safe_normalize(_t(x), eps=1e-12).numpy(), np.asarray(j_safe_normalize(jnp.asarray(x), eps=1e-12)), **TOL
    )
    xt = _t(x).requires_grad_(True)
    safe_normalize(xt, eps=1e-6).sum().backward()
    assert torch.isfinite(xt.grad).all()
    # the zero row's gradient is I / eps, like torch's F.normalize
    np.testing.assert_allclose(xt.grad[2].numpy(), np.full(7, 1e6, np.float32), rtol=1e-6)


def test_project_matches_reference_including_clamps():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 4 + np.array([0, 0, 6], np.float32)
    pts[:10, 2] = -3.0  # behind the camera: z clamps to EPS in the divide, xy to +-2
    w2c = _pose(rng)
    xy, z, cam = cameras.project(_t(pts), _t(w2c), _t(K_NDC))
    jxy, jz, jdist, _ = jcam.project_points(jnp.asarray(pts)[None], jnp.asarray(w2c)[None, None],
                                            jnp.asarray(K_NDC)[None, None])
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy[0, 0]), **TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz[0, 0]), **TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(cam, dim=-1).numpy(), np.asarray(jdist[0, 0, :, 0]), **TOL)
    assert float(xy.abs().max()) == 2.0


def test_rays_from_k_matches_reference():
    rng = np.random.default_rng(2)
    poses = np.stack([_pose(rng), _pose(rng)])
    ks = np.stack([K_NDC, K_NDC * np.array([[1.1], [0.9], [1.0]], np.float32)])
    r, xy = rays.rays_from_k(_t(poses), _t(ks), 12, 8, 3.0, 80.0)
    jr, jxy = jrays.rays_from_k(jnp.asarray(poses), jnp.asarray(ks), 12, 8, 3.0, 80.0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), **TOL)


@pytest.mark.parametrize("inv_z", [True, False])
def test_positional_code_matches_reference(inv_z):
    rng = np.random.default_rng(3)
    z = rng.uniform(0.0, 90.0, size=(64, 1)).astype(np.float32)
    zn = encoding.normalize_z(_t(z), 3.0, 80.0, inv_z=inv_z)
    np.testing.assert_allclose(zn.numpy(), np.asarray(jenc.normalize_z(jnp.asarray(z), 3.0, 80.0, inv_z=inv_z)), **TOL)
    x = rng.uniform(-2, 2, size=(64, 3)).astype(np.float32)
    code = encoding.positional_encoding(_t(x), 6, 1.5, True)
    jcode = jenc.positional_encoding(jnp.asarray(x), 6, 1.5, True)
    assert code.shape == (64, encoding.positional_encoding_dims(6, 3, True)) == jcode.shape
    np.testing.assert_allclose(code.numpy(), np.asarray(jcode), **TOL)


@pytest.mark.parametrize("inv_z", [True, False])
def test_normalize_z_is_jitted_jax_bit_for_bit(inv_z):
    """The port's normalize_z against the JAX package's under jax.jit, bit
    for bit, over 10^5 seeded depths at the shipped z_near 3, z_far 80 (and
    0.1 to 80): a tenth below eps (1e-3, clamped under inv_z), the rest
    log-uniform to 200 m. Jitted XLA folds (x - 1/far) / (1/near - 1/far) * 2
    - 1 into x + (-f32(1/far)), times f32(2) / f32(1/near - 1/far), plus -1,
    the multiply and the add one fused multiply-add on the CPU
    (encoding.zn_constants); JAX op by op rounds each operation."""
    rng = np.random.default_rng(15)
    z = np.concatenate([rng.uniform(0.0, 1e-3, 10_000),
                        np.exp(rng.uniform(np.log(1e-3), np.log(200.0), 90_000))]).astype(np.float32)
    for d_min, d_max in ((3.0, 80.0), (0.1, 80.0)):
        ref = np.asarray(jax.jit(lambda z: jenc.normalize_z(z, d_min, d_max, inv_z=inv_z))(jnp.asarray(z)))
        got = encoding.normalize_z(_t(z), d_min, d_max, inv_z=inv_z).numpy()
        assert got.dtype == ref.dtype == np.float32
        assert np.array_equal(got.view(np.int32), ref.view(np.int32)), (d_min, int((got != ref).sum()))
    sub, scale = encoding.zn_constants(3.0, 80.0, inv_z)
    assert (sub, scale) == ((np.float32(0.0125), np.float32(6.23376656)) if inv_z
                            else (np.float32(3.0), np.float32(0.0259740259)))  # the compiled HLO's constants
    t = _t(z[10_000:10_100]).requires_grad_(True)
    encoding.normalize_z(t, 3.0, 80.0, inv_z=inv_z).sum().backward()
    want = -scale / z[10_000:10_100] ** 2 if inv_z else np.full(100, scale, np.float32)
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("lindisp", [True, False])
def test_sample_coarse_with_the_same_draws(lindisp):
    rng = np.random.default_rng(4)
    R, K = 50, 32
    flat = np.zeros((R, 8), np.float32)
    flat[:, 6] = 3.0
    flat[:, 7] = 80.0
    flat[:, :6] = rng.normal(size=(R, 6))
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (R, K)))  # the draws sample_coarse makes inside
    z = sampling.sample_coarse(_t(flat), K, lindisp, u=_t(u))
    jz = jsamp.sample_coarse(key, jnp.asarray(flat), K, lindisp)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    assert (z[:, 1:] > z[:, :-1]).all()
    with pytest.raises(ValueError):
        sampling.sample_coarse(_t(flat), K, lindisp, u=_t(u[:, :4]))


@pytest.mark.parametrize("depth_statistic", ["expectation", "median"])
@pytest.mark.parametrize("cap", [True, False])
def test_composite_rays_matches_reference(depth_statistic, cap):
    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(3, 80, size=(40, 16)), -1).astype(np.float32)
    sig = rng.normal(size=(40, 16)).astype(np.float32) * 2
    sig[:5] = 1e6  # saturated rays
    out = compositing.composite_rays(_t(sig), _t(z), cap, depth_statistic)
    ref = jcomp.composite_rays(jnp.asarray(sig), jnp.asarray(z), cap, depth_statistic)
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(ref.weights), **TOL)
    np.testing.assert_allclose(out.alphas.numpy(), np.asarray(ref.alphas), **TOL)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref.depth), atol=1e-4, rtol=1e-5)


def test_saturated_alphas_keep_the_transmittance_floor():
    z = _t(np.linspace(3, 80, 8, dtype=np.float32)[None])
    w, a = compositing.alpha_composite(torch.full((1, 8), 1e9), compositing.deltas_from_z(z))
    jw, _ = jcomp.alpha_composite(jnp.full((1, 8), 1e9), jcomp.deltas_from_z(jnp.asarray(z.numpy())))
    assert a[0, 0] == 1.0
    # max(1 - a, 1e-10): the sample after a saturated one keeps a 1e-10 share
    assert float(w[0, 1]) == pytest.approx(1e-10, rel=1e-6)
    # atol: XLA flushes fp32 denormals (the 1e-40 weight) to zero, torch keeps them
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1.2e-38)


def test_median_depth_takes_the_sample_where_the_cdf_ties():
    w = np.array([[0.25, 0.25, 0.25, 0.25], [0.125, 0.125, 0.25, 0.5], [0.0, 0.0, 0.0, 0.0]], np.float32)
    z = np.array([[4, 5, 6, 7], [4, 5, 6, 7], [4, 5, 6, 7]], np.float32)
    med = compositing.weight_median_depth(_t(w), _t(z))
    jmed = jcomp.weight_median_depth(jnp.asarray(w), jnp.asarray(z))
    # the index counts cdf < 0.5: rows 0 and 1 reach 0.5 exactly at samples
    # 1 and 2 and take them; an all-zero row runs off the end and clamps
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    assert med.tolist() == [5.0, 6.0, 7.0]


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(3, 14), (11, 5)])
def test_f_interpolate_matches_the_references_twin(mode, size):
    """The port calls F.interpolate(antialias=False) directly where the JAX
    package uses its torch_interpolate twin (pos-embed bicubic a=-0.75,
    bilinear resizes)."""
    x = np.random.default_rng(6).normal(size=(1, 7, 9, 5)).astype(np.float32)
    ref = torch_interpolate(jnp.asarray(x), size, mode=mode)
    out = F.interpolate(_t(x).permute(0, 3, 1, 2), size=size, mode=mode, align_corners=False, antialias=False)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)


def test_alpha_composite_gradient_at_zero_sigma_is_the_references():
    """sigma exactly 0 (a softplus that underflowed in fp32) sits on the tie
    of max(sigma, 0): JAX gives each side half the gradient, and so must
    the port (`torch.clamp` passed all of it: [0.236, 0.236, 0.236, 0.236]
    against the reference's [0.118, 0.236, 0.118, 0.236])."""
    sigma = np.array([0.0, 0.3, 0.0, 1.2], np.float32)
    delta = np.full(4, 0.5, np.float32)
    coeff = np.arange(1, 5, dtype=np.float32)

    def jloss(s):
        w, a = jcomp.alpha_composite(s, jnp.asarray(delta), hard_alpha_cap=False)
        return jnp.sum(w * coeff) + jnp.sum(a)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(sigma)))
    st = _t(sigma).requires_grad_(True)
    w, a = compositing.alpha_composite(st, _t(delta), hard_alpha_cap=False)
    (torch.sum(w * _t(coeff)) + torch.sum(a)).backward()
    np.testing.assert_allclose(st.grad.numpy(), ref, **TOL)
    # the old form gives the tie the whole gradient: twice the reference's
    sc = _t(sigma).requires_grad_(True)
    alphas = 1.0 - torch.exp(-_t(delta) * torch.clamp_min(sc, 0.0))
    shifted = torch.cat([torch.ones(1), torch.clamp_min(1.0 - alphas[:-1], 1e-10)])
    (torch.sum(alphas * torch.cumprod(shifted, 0) * _t(coeff)) + torch.sum(alphas)).backward()
    np.testing.assert_allclose(sc.grad.numpy()[[0, 2]], 2 * ref[[0, 2]], **TOL)
    assert ref[0] != 0.0


def test_project_points_matches_reference():
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(2, 50, 3)) * [3, 1, 10] + [0, 0, 8]).astype(np.float32)
    w2c = np.stack([np.stack([_pose(rng, 0.2, 0.5) for _ in range(3)]) for _ in range(2)])
    ks = np.broadcast_to(K_NDC, (2, 3, 3, 3)).copy()
    ref = jcam.project_points(jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(ks))
    out = cameras.project_points(_t(pts), _t(w2c), _t(ks))
    for o, r, name in zip(out, ref, ("xy", "z", "distance", "invalid")):
        if name == "invalid":
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, atol=1e-4, rtol=1e-5)
    assert 0 < int(np.asarray(ref[3]).sum()) < ref[3].size  # both inside and outside points


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_views_matches_reference(mode):
    """Including points past the border (clamped) and exact pixel-centre ties."""
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(2, 3, 5, 6, 9)).astype(np.float32)
    xy = rng.uniform(-1.3, 1.3, size=(2, 3, 40, 2)).astype(np.float32)
    xy[0, 0, :9, 0] = (np.arange(9) + 0.5) / 9 * 2 - 1  # pixel centres
    xy[0, 0, :9, 1] = (np.arange(9) % 6) / 6 * 2 - 1  # pixel edges (nearest ties)
    ref = jgs.grid_sample_views(jnp.asarray(feats), jnp.asarray(xy), mode=mode)
    out = grid_sample.grid_sample_views(_t(feats), _t(xy), mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shift", [None, (-3, 2), (0, -4)])
def test_patch_ray_sampler_matches_reference_on_the_same_picks(shift):
    """The same key on the JAX side and the picks it draws
    (ray_sampler.py:79-89) handed to the port."""
    rng = np.random.default_rng(9)
    B, V, H, W, P, R = 2, 2, 32, 48, 8, 128
    imgs = rng.uniform(size=(B, V, 3, H, W)).astype(np.float32)
    poses = np.stack([np.stack([_pose(rng, 0.1, 0.3) for _ in range(V)]) for _ in range(B)])
    ks = np.broadcast_to(K_NDC, (B, V, 3, 3)).copy()
    dino = rng.normal(size=(B, V, 5, H // P, W // P)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jshift = None if shift is None else jnp.asarray(shift)
    jsampler = jrs.PatchRaySampler(3.0, 80.0, ray_batch_size=R, patch_size=P)
    ref = jsampler.sample(key, jnp.asarray(imgs), jnp.asarray(poses), jnp.asarray(ks),
                          frame_ids=jnp.asarray([1.0, 2.0]), dino_features=jnp.asarray(dino), grid_shift=jshift)
    k_v, k_y, k_x = jax.random.split(key, 3)
    s = int(shift is not None)
    picks = [torch.from_numpy(np.asarray(jax.random.randint(k, (B, R // P ** 2), 0, hi)).astype(np.int64))
             for k, hi in ((k_v, V), (k_y, H // P - s), (k_x, W // P - s))]
    sampler = ray_sampler.PatchRaySampler(3.0, 80.0, ray_batch_size=R, patch_size=P)
    out = sampler.sample(_t(imgs), _t(poses), _t(ks), *picks, frame_ids=_t([1.0, 2.0]),
                         dino_features=_t(dino), grid_shift=shift)
    for o, r, name in zip(out, ref, ("rays", "rgb_gt", "dino_gt")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, **TOL)
    np.testing.assert_array_equal(sampler.reconstruct(out[1]).numpy(),
                                  np.asarray(jsampler.reconstruct(ref[1])))
    drawn = sampler.draw(B, V, H, W, shift is not None, torch.Generator().manual_seed(0))
    for d, hi in zip(drawn, (V, H // P - s, W // P - s)):
        assert d.shape == (B, R // P ** 2) and 0 <= int(d.min()) and int(d.max()) < hi
