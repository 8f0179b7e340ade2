"""The K1 backward on the CPU against JAX: `attention_bwd_plain` and the
autograd Function `attention` (which takes the plain versions for CPU
tensors) against `jax.vjp` of `jax.nn.dot_product_attention` and of the
Pallas module's own reference `mha_reference`
(jax/experimental/pallas/ops/tpu/flash_attention.py:1530), the latter
padded to a multiple of 128 tokens and masked by segment ids as
`scenedino_tpu/models/vit.py:_flash_mhsa` pads for the kernel.

fp32 throughout; tolerance atol 1e-5 / rtol 1e-4: fp32 round-off of
products over up to 130 tokens, summed in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference

from scenedino_torch.kernels import attention, attention_bwd_dkv, attention_bwd_dq, launches
from scenedino_torch.kernels.attention import (
    attention_bwd_plain,
    attention_fwd,
    attention_lse_plain,
    attention_plain,
)

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(n, seed, B=2, H=3, D=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, H, D)).astype(np.float32) for _ in range(4)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_dot_product_grads(q, k, v, do):
    _, vjp = jax.vjp(jax.nn.dot_product_attention, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _jax_mha_reference_grads(q, k, v, do, block=128):
    """vjp of mha_reference on (B, H, NP, D), NP the next multiple of `block`,
    pad rows masked by segment ids (0 pad, 1 real); the pad sliced off.
    Its backward takes sm_scale = 1 only, so q is scaled before the call."""
    B, N, H, D = q.shape
    NP = -(-N // block) * block
    ids = jnp.broadcast_to((jnp.arange(NP) < N).astype(jnp.float32)[None], (B, NP))

    def f(q, k, v):
        def prep(x):
            return jnp.pad(x.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, NP - N), (0, 0)))

        out = mha_reference(prep(q * float(D) ** -0.5), prep(k), prep(v), None,
                            segment_ids=SegmentIds(q=ids, kv=ids))
        return out[:, :, :N].transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("n", [1, 65, 130])
def test_plain_backward_matches_jax_dot_product_attention(n):
    q, k, v, do = _inputs(n, seed=n)
    ref = _jax_dot_product_grads(q, k, v, do)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o = attention_plain(tq, tk, tv)
    got = attention_bwd_plain(tq, tk, tv, o, tdo, attention_lse_plain(tq, tk))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), r, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("n", [65, 130])
def test_autograd_function_matches_mha_reference_vjp(n):
    q, k, v, do = _inputs(n, seed=10 + n)
    ref = _jax_mha_reference_grads(q, k, v, do)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    before = launches()
    out = attention(*leaves)
    out.backward(_t(do))
    assert launches() == before  # CPU tensors take the plain versions
    for name, leaf, r in zip("qkv", leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, err_msg=f"d{name}", **TOL)


def test_split_wrappers_equal_the_plain_backward():
    """dq then dkv (the kernels' split, with di handed from one to the
    other) give the plain backward's numbers on CPU tensors."""
    q, k, v, do = map(_t, _inputs(33, seed=3))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    np.testing.assert_allclose(lse.numpy(), attention_lse_plain(q, k).numpy())
    dq, di = attention_bwd_dq(q, k, v, o, do, lse)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di)
    assert di.shape == (2, 3, 33)
    for got, ref in zip((dq, dk, dv), attention_bwd_plain(q, k, v, o, do, lse)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)


def test_no_graph_no_lse():
    q = torch.randn(1, 9, 2, 64)
    assert attention_fwd(q, q, q)[1] is None
    with torch.no_grad():
        out = attention(q.requires_grad_(True), q, q)
    assert out.grad_fn is None
