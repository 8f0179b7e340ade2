"""The port's encode-view render past the card's one-tile rays and one-step
z code, against JAX on the CPU: `render_encode_view` (K6's path) at 96, 128
and 256 samples a ray (two, two and four of K6's 64-row tiles a ray), each
with the expectation and the weight-median depth, and at num_freqs 8 (17
z-code columns, past one k16 step of the card's code product).

Both sides get tests/test_torch_long_rays.py's random fp32 folded state
and the strata JAX draws inside from its key (`uniform` of
`split(key, 5)[0]`, fast_field.py:294), returned by the jitted reference
itself; on the CPU the kernel's wrapper takes its plain version. Each JAX
reference is one `jax.jit` that returns both depth statistics and the
strata. Tolerances, as tests/test_torch_query.py's fp32 runs: rtol 1e-4
and an atol of 1e-4, or of 1e-5 x the largest magnitude where that is
larger.
"""
import jax
import pytest
import torch

from scenedino_tpu.models.field import FieldConfig as JFieldConfig
from scenedino_tpu.ops import fast_field as jff
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops import fast_field as ff
from test_torch_long_rays import STATISTICS, H, W, _close, _state, _strata, _t, _to_port


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("K,num_freqs", [(96, 6), (128, 6), (256, 6), (32, 8)])
def test_render_encode_view_past_64_samples_and_16_code_columns_matches_reference(K, num_freqs):
    """num_freqs 8: W_code has 3 + 6 x 8 = 51 rows, of which the z code
    takes 1 + 2 x 8 = 17."""
    jcfg = JFieldConfig(dino_dims=6, num_freqs=num_freqs)
    cfg = FieldConfig(dino_dims=6, num_freqs=num_freqs)
    jfs = _state(K + num_freqs, code_dims=cfg.code_dims)
    key = jax.random.PRNGKey(K + 1)
    *ref, u = jax.jit(lambda fs: [jff.render_encode_view(fs, jcfg, H, W, key, n_coarse=K, depth_statistic=stat)
                                  for stat in STATISTICS] + [_strata(key, H * W, K)])(jfs)
    fs, u = _to_port(jfs), _t(u)
    for stat, want in zip(STATISTICS, ref):
        got = ff.render_encode_view(fs, cfg, H, W, u=u, n_coarse=K, depth_statistic=stat)
        for o, r in zip(got, want):
            assert tuple(o.shape) == r.shape
            _close(o, r)

