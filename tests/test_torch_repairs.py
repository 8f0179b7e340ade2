"""The ViT's attention dispatch and the smoke recipe's transcription.

The port's `Attention` makes the reference's choice
(scenedino_tpu/models/vit.py:183-188): the K1 kernel for bf16 compute,
N >= 512 tokens and a CUDA tensor, `dot_product_attention` otherwise. The
predicate is tested on its own (no card here); the plain branch is held
against `jax.nn.dot_product_attention` on the same numpy inputs: in fp32
to atol/rtol 1e-6 (the same fp32 products and softmax, summed in another
order), in bf16 to one bf16 ulp at |x| ~ 1 (2^-8, after both round the
fp32 probabilities and the output to bf16; a rounding may fall the other
way). The singular-pose repair is tested in test_torch_training.py; here
the grid sample's handling of the non-finite coordinates it produces.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scenedino_torch.models import vit
from scenedino_torch.models.factory import SYNTHETIC_SMOKE_TRAIN

BF16_TOL = 2.0 ** -8
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("use_flash,dtype,n,device,expect", [
    (None, torch.bfloat16, 512, CUDA, True),
    (None, torch.bfloat16, 1921, CUDA, True),
    (None, torch.bfloat16, 511, CUDA, False),
    (None, torch.bfloat16, 73, CUDA, False),
    (None, None, 1921, CUDA, False),  # fp32 compute
    (None, torch.float32, 1921, CUDA, False),
    (None, torch.bfloat16, 1921, CPU, False),
    (True, None, 73, CPU, True),
    (False, torch.bfloat16, 1921, CUDA, False),
])
def test_flash_dispatch_predicate(use_flash, dtype, n, device, expect):
    assert vit.flash_attention_wanted(use_flash, dtype, n, device) is expect


def _qkv(seed, n, heads=2, d=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, n, heads, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,d", [(73, 32), (130, 64)])
def test_plain_branch_matches_jax_in_fp32(n, d):
    q, k, v = _qkv(n, n, d=d)
    ref = np.asarray(jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = vit.dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [73, 520])
def test_plain_branch_matches_jax_in_bf16(n):
    q, k, v = _qkv(n + 1, n)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    ref = np.asarray(jax.nn.dot_product_attention(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    out = vit.dot_product_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_TOL, rtol=0)
    # the probabilities go to bf16 as JAX's do: fp32 ones (attention_plain's) differ more
    from scenedino_torch.kernels.attention import attention_plain

    assert np.abs(out.float().numpy() - ref).mean() < np.abs(attention_plain(tq, tk, tv).float().numpy() - ref).mean()


@pytest.mark.parametrize("use_flash,dtype,kernel_calls", [(None, torch.bfloat16, 0), (None, None, 0),
                                                          (True, None, 1)])
def test_attention_module_takes_the_chosen_branch(monkeypatch, use_flash, dtype, kernel_calls):
    """On CPU tensors at N = 512 the default never reaches the kernel op;
    use_flash=True does (which, on the CPU, takes its plain version)."""
    calls = []
    real = vit.attention

    def counting(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)

    monkeypatch.setattr(vit, "attention", counting)
    torch.manual_seed(0)
    layer = vit.Attention(64, 2, dtype=dtype, use_flash=use_flash)
    x = torch.randn(1, 512, 64)
    out, keys = layer(x, return_keys=True)
    assert len(calls) == kernel_calls
    assert out.shape == (1, 512, 64) and keys.shape == (1, 2, 512, 32)
    assert out.dtype == (dtype or torch.float32) and torch.isfinite(out.float()).all()


def _listify(x):
    if isinstance(x, dict):
        return {k: _listify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_listify(v) for v in x]
    return x


def test_smoke_training_dict_matches_the_yaml():
    path = os.path.join(os.path.dirname(__file__), "..", "configs", "train_synthetic_smoke.yaml")
    with open(path) as f:
        conf = yaml.safe_load(f)
    d = _listify(SYNTHETIC_SMOKE_TRAIN)
    assert not conf.get("with_amp", False) and "with_amp" not in d
    for key in ("seed", "batch_size", "model", "renderer"):
        assert d[key] == conf[key], key
    for key in ("n_views", "image_size", "type"):
        assert d["dataset"][key] == conf["dataset"][key], key
    for key in ("optimizer", "ray_sampler"):
        assert d["training"][key] == conf["training"][key], key
    assert sorted(d["training"]) == ["optimizer", "ray_sampler"]  # the rest is the CLI's loop


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_of_nonfinite_coordinates_matches_the_reference(mode):
    """A singular pose projects to NaN: the reference's gathers give NaN
    (bilinear) or pixel 0 (nearest; +-inf the edges), and the port's
    backward must not write out of bounds."""
    from scenedino_torch.core import grid_sample
    import scenedino_tpu.core.grid_sample as jgs

    rng = np.random.default_rng(3)
    feats = rng.normal(size=(1, 2, 4, 6, 8)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, size=(1, 2, 7, 2)).astype(np.float32)
    xy[0, 0, 1, 0] = np.nan
    xy[0, 1, 2] = np.nan
    xy[0, 1, 3, 1] = np.inf
    xy[0, 1, 4, 0] = -np.inf
    ref = np.asarray(jgs.grid_sample_views(jnp.asarray(feats), jnp.asarray(xy), mode))
    tf = torch.from_numpy(feats).requires_grad_(True)
    out = grid_sample.grid_sample_views(tf, torch.from_numpy(xy), mode)
    np.testing.assert_array_equal(np.isfinite(out.detach().numpy()), np.isfinite(ref))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=1e-5)
    out.nan_to_num().sum().backward()
    assert torch.isfinite(tf.grad).all()
