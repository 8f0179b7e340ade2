"""The port's fused novel-view render past the card's one-tile rays, against
JAX on the CPU: `render_novel_view_fused` (K2's path) at 96, 128 and 256
samples a ray (two, two and four of K2's 64-point tiles a ray;
tests/test_probe_quality.py and tools/probe_quality_trained.py render at
256, tests/test_probe_quality_trained.py at 128), each with the
expectation and the weight-median depth. The encode view at such sample
counts is tests/test_torch_long_encode_view.py's, the probe render
tests/test_torch_probe_samples.py's; both take this file's helpers.

Both sides get the same numbers: a random fp32 folded state (numpy draws,
handed to JAX and to the port as they are), the same novel pose, and the
strata JAX draws inside from its key (`uniform` of `split(key, 5)[0]`,
fast_field.py:581), returned by the jitted reference itself. On the CPU the
kernels' wrappers take their plain versions. Each JAX reference is one
`jax.jit` that returns both depth statistics and the strata.

Tolerances, as tests/test_torch_fast_field.py's and test_torch_query.py's
fp32 runs: depth, feature and colour to rtol 1e-4 and an atol of 1e-4, or
of 1e-5 x the largest magnitude where that is larger (fp32 round-off of
the lookup, the two products and the compositing summed in other orders).
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

K_NDC = np.array([[0.7, 0.0, 0.02], [0.0, 2.3, -0.05], [0.0, 0.0, 1.0]], np.float32)
H, W = 4, 8
STATISTICS = ("expectation", "median")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    atol = max(1e-4, 1e-5 * float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(out), ref, atol=atol, rtol=1e-4)


def _state(seed, code_dims=39, D=16, E=7, h=H, w=W):
    """A folded fp32 state: random grid and weights, the encode camera at the
    origin; the grid twice the render size h x w (the encode view's 2x2
    mean)."""
    rng = np.random.default_rng(seed)
    eye = np.eye(4, dtype=np.float32)[None, None]
    b2 = rng.normal(size=E) * 0.2
    b2[0] += 0.5
    arr = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    return jff.FastFieldState(
        folded_grid=arr(rng.normal(size=(1, 1, 2 * h, 2 * w, D))),
        w_code=arr(rng.normal(size=(code_dims, D)) * 0.3), b1=arr(rng.normal(size=D) * 0.1),
        w2=arr(rng.normal(size=(D, E)) * 0.3), b2=arr(b2),
        feat_ks=arr(K_NDC[None, None]), feat_w2c=arr(eye),
        color_imgs=arr(rng.uniform(size=(1, 1, h, w, 3))), color_ks=arr(K_NDC[None, None]), color_w2c=arr(eye),
    )


def _to_port(jfs) -> ff.FastFieldState:
    return ff.FastFieldState(*(None if getattr(jfs, f) is None else _t(np.asarray(getattr(jfs, f), np.float32))
                               for f in ff.FastFieldState._fields))


def _strata(key, R, K):
    """The strata JAX's renders draw from `key` (inside a jitted reference)."""
    return jax.random.uniform(jax.random.split(key, 5)[0], (R, K))


def _pose():
    c, s = np.cos(0.05), np.sin(0.05)
    return np.array([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.0], [0, 0, 0, 1]], np.float32)


@pytest.mark.parametrize("K", [96, 128, 256])
def test_render_novel_view_fused_past_64_samples_matches_reference(K):
    jfs = _state(K)
    jcfg, cfg = JFieldConfig(dino_dims=6), FieldConfig(dino_dims=6)
    key = jax.random.PRNGKey(K)
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
            _close(o, r)
        assert np.all((np.asarray(want[0]) >= 3.0) & (np.asarray(want[0]) <= 80.0))
    assert set(launches().values()) == {0}  # CPU tensors take the plain versions
