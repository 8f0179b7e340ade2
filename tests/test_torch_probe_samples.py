"""The port's probe-guided render at more probe samples than the card's
one-tile rays, against JAX on the CPU: `render_novel_view_probe` at n_probe
96 (K3 over two of its 64-point tiles a probe ray; the gathered histogram
rows 768 bytes, past the gather's one-warp-many-rows layout) and 17 (the
rows padded to 16-byte multiples for the card's gather).

Both sides get the same numbers: tests/test_torch_long_rays.py's random
fp32 folded state at a 16x32 raster (JAX's probe takes a height that
stride x rows_per_seg divides), the same novel pose, and the probe's draws
JAX makes from its key (`split(key, 3)`, fast_field.py:748, then the bin
picks' `split`, sampling.py:81), rebuilt here from that key as
tests/test_torch_probe.py rebuilds them. On the CPU the kernels' wrappers
take their plain versions; the JAX reference and the draws are one
`jax.jit`.

Tolerances, as tests/test_torch_probe.py's: rtol 1e-4 and an atol of
1e-4, or of 1e-5 x the largest magnitude where that is larger.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops import fast_field as ff
from test_torch_long_rays import K_NDC, _close, _pose, _state, _t, _to_port


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


PROBE_H, PROBE_W = 16, 32  # JAX's probe takes H a multiple of stride x rows_per_seg


def _probe_draws(key, n_probe, s=4, n_fine=10, n_uniform=2):
    """The draws of JAX's probe render from `key` (inside a jitted reference):
    (probe strata, bin picks, places in the bins, safety strata)."""
    kp, kf, ku = jax.random.split(key, 3)
    k_u, k_t = jax.random.split(kf)
    R, Rp = PROBE_H * PROBE_W, (PROBE_H // s) * (PROBE_W // s)
    return [jax.random.uniform(kp, (Rp, n_probe)), jax.random.uniform(k_u, (R, n_fine)),
            jax.random.uniform(k_t, (R, n_fine)), jax.random.uniform(ku, (R, n_uniform))]


@pytest.mark.parametrize("n_probe", [96, 17])
def test_render_novel_view_probe_at_more_probe_samples_matches_reference(n_probe):
    h, w = PROBE_H, PROBE_W
    jfs = _state(n_probe, h=h, w=w)
    jcfg, cfg = JFieldConfig(dino_dims=6), FieldConfig(dino_dims=6)
    key = jax.random.PRNGKey(n_probe)
    pose = _pose()
    ref, draws = jax.jit(lambda fs: (jff.render_novel_view_probe(fs, jcfg, jnp.asarray(pose), jnp.asarray(K_NDC), h,
                                                                  w, key, n_probe=n_probe),
                                     _probe_draws(key, n_probe)))(jfs)
    got = ff.render_novel_view_probe(_to_port(jfs), cfg, _t(pose), _t(K_NDC), h, w,
                                     draws=ff.ProbeDraws(*map(_t, draws)), n_probe=n_probe)
    for o, r in zip(got, ref):
        assert tuple(o.shape) == r.shape
        _close(o, r)
