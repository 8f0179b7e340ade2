"""The port's field paths at every width the JAX package takes, against JAX
on the CPU: `render_novel_view_fused` (both depth statistics),
`render_novel_view_probe`, `fast_query_fused`, and `render_encode_view` /
`render_encode_view_batched` (in the fp32 and bf16 states), at hidden widths
132 and 264 (past the card's shipped 128, and 132 not a multiple of 8),
output widths 130 and 769 (the flagship's dino_dims 768), num_freqs 16 (99
point-code and 33 z-code columns) and 320 samples a ray, on tiny grids: the
shapes the kernels' wide walk takes on the card (csrc/wide_walk.cuh).

Both sides get the same numbers: a random folded state drawn with numpy
(handed to JAX and to the port as they are), the same novel pose, and the
strata JAX draws inside from its key (`uniform` of `split(key, 5)[0]`,
fast_field.py:581 and :294; the probe's draws as
tests/test_torch_probe_samples.py rebuilds them), returned by the jitted
reference itself. Each group of cases is one `jax.jit`, but the bf16 state's
references run op by op: XLA's CPU runtime has no bf16 x bf16 -> fp32 dot
under jit (tests/test_torch_encode_view.py runs them so too). On the CPU the
kernels' wrappers take their plain versions.

Tolerances: fp32 as tests/test_torch_long_rays.py's (rtol 1e-4; atol 1e-4,
or 1e-5 x the largest magnitude where that is larger) at num_freqs 8; the
same shapes at num_freqs 16 to rtol 1e-3 and an atol of 5e-3: the code's
top frequency 1.5 x 2^15 turns one ulp of a normalized depth (1.2e-7) into
~6e-3 rad. The port's `normalize_z` now gives jitted XLA's bits
(`core.encoding.zn_constants`), but the depths it is handed still differ
by an ulp: jitted XLA's CPU code contracts the stratified samples'
`z_steps + u * step` and blend and the ray directions' norm into fused
multiply-adds (4008 of 131,072 lindisp samples and 2075 of 6144 direction
components differ from the port's, or from JAX op by op). Features are off
by up to 1.0e-3 here (1.3e-3 before normalize_z matched), against 7e-6 at
num_freqs 8.
The bf16 state as tests/test_torch_encode_view.py's (depth 5e-2 m, feature
and colour 5e-3 with the median error below 1e-5; the median depth the
reference's sample or its neighbour on at most 1 % of rays).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.kernels import launches, reset_launches
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops import fast_field as ff
from test_torch_encode_view import _check
from test_torch_long_rays import K_NDC, STATISTICS, H, W, _close, _pose, _strata, _t
from test_torch_probe_samples import PROBE_H, PROBE_W, _probe_draws

FREQS = (8, 16)  # num_freqs 16: 99 point-code and 33 z-code columns; 8 the fp32 anchor at tight tolerances
WIDTHS = ((132, 130, 32), (264, 769, 320))  # hidden, outputs, samples a ray


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _configs(E, freqs):
    return JFieldConfig(dino_dims=E - 1, num_freqs=freqs), FieldConfig(dino_dims=E - 1, num_freqs=freqs)


def _near(out, ref, freqs):
    """fp32: tests/test_torch_long_rays.py's tolerance, or num_freqs 16's (the module's docstring)."""
    if freqs < 16:
        _close(out, ref)
        return
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out), ref, atol=max(5e-3, 1e-5 * float(np.abs(ref).max())), rtol=1e-3)


def _state(seed, D, E, freqs, h=H, w=W, B=1, dtype=jnp.float32):
    """A folded (B, 1)-view state of hidden width D and E outputs at num_freqs
    `freqs`: a random grid twice the render size h x w and weights (W_code
    and W2 scaled by their fan-in), the encode cameras at the origin (moved
    along x from frame to frame); grid, W_code, W2 and the colour images
    stored in `dtype`, as build_fast_state stores them."""
    rng = np.random.default_rng(seed)
    C = FieldConfig(num_freqs=freqs).code_dims
    w2c = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 1, 4, 4)).copy()
    w2c[:, 0, 0, 3] = -0.2 * np.arange(B)
    ks = np.broadcast_to(K_NDC, (B, 1, 3, 3)).copy()
    b2 = rng.normal(size=E) * 0.2
    b2[0] += 0.5
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    cast = lambda x: f32(x).astype(dtype)  # noqa: E731
    return jff.FastFieldState(
        folded_grid=cast(rng.normal(size=(B, 1, 2 * h, 2 * w, D))), w_code=cast(rng.normal(size=(C, D)) * C ** -0.5),
        b1=f32(rng.normal(size=D) * 0.1), w2=cast(rng.normal(size=(D, E)) * D ** -0.5), b2=f32(b2),
        feat_ks=f32(ks), feat_w2c=f32(w2c), color_imgs=cast(rng.uniform(size=(B, 1, h, w, 3))), color_ks=f32(ks),
        color_w2c=f32(w2c))


def _to_port(jfs) -> ff.FastFieldState:
    def conv(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    return ff.FastFieldState(*(None if getattr(jfs, f) is None else conv(getattr(jfs, f))
                               for f in ff.FastFieldState._fields))


@pytest.mark.parametrize("D,E,K,freqs", [(*WIDTHS[0], 8), *[(*w, 16) for w in WIDTHS]])
def test_render_novel_view_fused_at_every_width_matches_reference(D, E, K, freqs):
    jfs = _state(D + K, D, E, freqs)
    jcfg, cfg = _configs(E, freqs)
    key = jax.random.PRNGKey(D)
    pose = _pose()
    *ref, u = jax.jit(lambda fs: [jff.render_novel_view_fused(fs, jcfg, jnp.asarray(pose), jnp.asarray(K_NDC), H, W,
                                                              key, n_coarse=K, depth_statistic=stat)
                                  for stat in STATISTICS] + [_strata(key, H * W, K)])(jfs)
    fs, u = _to_port(jfs), _t(u)
    reset_launches()
    for stat, want in zip(STATISTICS, ref):
        got = ff.render_novel_view_fused(fs, cfg, _t(pose), _t(K_NDC), H, W, u=u, n_coarse=K, depth_statistic=stat)
        for o, r in zip(got, want):
            assert tuple(o.shape) == r.shape
            _near(o, r, freqs)
    assert set(launches().values()) == {0}  # CPU tensors take the plain versions


def test_render_novel_view_probe_at_every_width_matches_reference():
    """E 769, 320 probe samples a probe ray (K3 over five of its 64-point
    tiles on the card), at num_freqs 8: the probe's weights pick each
    pixel's depths from their CDF, and at num_freqs 16 the jitted
    reference's depths (the module's docstring) moved 2 % of the pixels'
    draws to the next bin here (measured before normalize_z matched); the card holds that width's K3
    against its plain version (tests/test_torch_kernels.py, chip_smoke.py
    phase 19)."""
    D, E, n_probe, freqs = 264, 769, 320, 8
    jfs = _state(n_probe, D, E, freqs, h=PROBE_H, w=PROBE_W)
    jcfg, cfg = _configs(E, freqs)
    key = jax.random.PRNGKey(n_probe)
    pose = _pose()
    ref, draws = jax.jit(lambda fs: (jff.render_novel_view_probe(fs, jcfg, jnp.asarray(pose), jnp.asarray(K_NDC),
                                                                  PROBE_H, PROBE_W, key, n_probe=n_probe),
                                     _probe_draws(key, n_probe)))(jfs)
    got = ff.render_novel_view_probe(_to_port(jfs), cfg, _t(pose), _t(K_NDC), PROBE_H, PROBE_W,
                                     draws=ff.ProbeDraws(*map(_t, draws)), n_probe=n_probe)
    for o, r in zip(got, ref):
        assert tuple(o.shape) == r.shape
        _close(o, r)


def test_fast_query_fused_at_every_width_matches_reference():
    rng = np.random.default_rng(5)
    xyz = np.concatenate([rng.uniform(-2, 2, size=(320, 2)), rng.uniform(3, 44, size=(320, 1))], -1)
    xyz = xyz.astype(np.float32)  # in front of the camera, some outside its view
    cases = [(freqs, D, E) for freqs in FREQS for D, E, _ in WIDTHS]
    states = [(_state(D, D, E, freqs), *_configs(E, freqs)) for freqs, D, E in cases]
    refs = jax.jit(lambda fss: [jff.fast_query_fused(fs, jcfg, jnp.asarray(xyz), segments=8, band=8)
                                for fs, (_, jcfg, _) in zip(fss, states)])([s[0] for s in states])
    for (jfs, _, cfg), (freqs, D, E), ref in zip(states, cases, refs):
        sigma, feat = ff.fast_query_fused(_to_port(jfs), cfg, _t(xyz))
        assert sigma.shape == (320,) and feat.shape == (320, E - 1)
        _near(sigma, ref[0], freqs)
        _near(feat, ref[1], freqs)


@pytest.mark.parametrize("freqs", FREQS)
def test_render_encode_view_at_every_width_matches_reference(freqs):
    """The fp32 fold: each width (num_freqs 8: the first), both depth
    statistics, then the batched render of two frames at the first width,
    the references in one jit."""
    cases = [(_state(D + 1, D, E, freqs), *_configs(E, freqs), K) for D, E, K in WIDTHS[:1 if freqs < 16 else 2]]
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(jax.random.PRNGKey(12), 2)
    D, E, K = WIDTHS[0]
    batched = _state(D + 2, D, E, freqs, B=2)
    jcfg_b, cfg_b = _configs(E, freqs)

    def reference(states, bstate):
        single = [[jff.render_encode_view(fs, jcfg, H, W, key, n_coarse=k, depth_statistic=stat)
                   for stat in STATISTICS] + [_strata(key, H * W, k)]
                  for fs, (_, jcfg, _, k) in zip(states, cases)]
        return single, jff.render_encode_view_batched(bstate, jcfg_b, H, W, keys, n_coarse=K), \
            [_strata(k_, H * W, K) for k_ in keys]

    single, ref_b, u_b = jax.jit(reference)([c[0] for c in cases], batched)
    for (jfs, _, cfg, k), (*refs, u) in zip(cases, single):
        for stat, ref in zip(STATISTICS, refs):
            out = ff.render_encode_view(_to_port(jfs), cfg, H, W, u=_t(u), n_coarse=k, depth_statistic=stat)
            for o, r in zip(out, ref):
                assert tuple(o.shape) == r.shape
                _near(o, r, freqs)
    out = ff.render_encode_view_batched(_to_port(batched), cfg_b, H, W, u=torch.stack([_t(u) for u in u_b]),
                                        n_coarse=K)
    for o, r in zip(out, ref_b):
        assert tuple(o.shape) == r.shape
        _near(o, r, freqs)


def test_render_encode_view_of_the_bf16_state_at_every_width_matches_reference():
    """The bf16 state at D 264, E 769, 320 samples, num_freqs 8, both depth
    statistics; the references op by op (the module's docstring), which
    costs a compile of each op at each shape: one shape here, the 33-column
    z code and the other width held on the card (tests/test_torch_kernels.py,
    chip_smoke.py phase 19)."""
    D, E, K = WIDTHS[1]
    jfs = _state(D + 3, D, E, 8, dtype=jnp.bfloat16)
    jcfg, cfg = _configs(E, 8)
    key = jax.random.PRNGKey(13)
    refs = [jff.render_encode_view(jfs, jcfg, H, W, key, n_coarse=K, depth_statistic=stat) for stat in STATISTICS]
    fs, u = _to_port(jfs), _t(jax.jit(lambda: _strata(key, H * W, K))())
    z = ff.encode_view_inputs(fs, cfg, H, W, u=u[None], n_coarse=K)[0][1]
    for stat, ref in zip(STATISTICS, refs):
        out = ff.render_encode_view(fs, cfg, H, W, u=u, n_coarse=K, depth_statistic=stat)
        _check(out, ref, jnp.bfloat16, z, stat == "median")
