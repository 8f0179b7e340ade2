"""RAFT-large (`scenedino_torch/models/raft.py`) and the RAFT feature
processor against the JAX package's on the CPU.

- `correlation_pyramid` and `lookup_pyramid` at (2, 8, 12) with 8 channels,
  4 levels, radius 4, at fractional coordinates reaching outside the map:
  atol 1e-5; the window's tap order (x slowest), as
  tests/test_raft.py:202 pins it.
- `convex_upsample` on a random mask: atol 1e-5.
- A 2-iteration forward at 64x64 through `make_raft_flow_fn` (images in
  [0, 1]) on seeded weights drawn in JAX's layout (the batch norms'
  variances positive) and carried across by `utils.convert.from_jax_params`,
  and the "raft" image processor (the feature trunk resized to the image)
  on the same weights: both references in one jitted call; flow atol 1e-4
  pixels (fp32 round-off through two recurrent updates; 5e-6 measured on
  flows up to 7 pixels) and rtol 1e-5, features atol 1e-4.
- `convert_raft_state_dict` on a synthetic state dict under torchvision's
  raft_large names (written out here, as tests/test_raft.py writes its
  own; every batch norm's statistics seeded): exactly JAX's converted
  tree as the port maps it, every key consumed, frozen batch-norm
  statistics included.
fp32, JAX at "highest" matmul precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.models.raft as J
from scenedino_tpu.core.image_processor import make_image_processor as jmake_processor
from scenedino_torch.core.image_processor import make_image_processor
from scenedino_torch.models import raft as R
from scenedino_torch.utils.convert import from_jax_params
from tests.test_torch_stage1_branches import _draw_tree

S = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_correlation_pyramid_and_lookup_match_jax():
    rng = np.random.default_rng(0)
    B, H, W, C = 2, 8, 12, 8
    f1, f2 = (rng.normal(size=(B, H, W, C)).astype(np.float32) for _ in range(2))
    coords = np.stack([rng.uniform(-3, W + 3, (B, H, W)), rng.uniform(-3, H + 3, (B, H, W))], -1).astype(np.float32)
    coords[0, 0, 0] = (2.0, 3.0)  # on the grid

    @jax.jit
    def ref(a, b, c):
        pyr = J.correlation_pyramid(a, b, 4)
        return pyr, J.lookup_pyramid(pyr, c, 4)

    jpyr, jlook = ref(*map(jnp.asarray, (f1, f2, coords)))
    pyr = R.correlation_pyramid(_t(f1).permute(0, 3, 1, 2), _t(f2).permute(0, 3, 1, 2), 4)
    assert [tuple(p.shape) for p in pyr] == [(B * H * W, 1, H >> i, W >> i) for i in range(4)]
    for p, jp in zip(pyr, jpyr):
        np.testing.assert_allclose(p[:, 0].numpy(), np.asarray(jp)[..., 0], atol=1e-5, rtol=1e-5)
    look = R.lookup_pyramid(pyr, _t(coords), 4).numpy()
    assert look.shape == (B, H, W, 4 * 81)
    np.testing.assert_allclose(look, np.asarray(jlook), atol=1e-5, rtol=1e-5)


def test_lookup_tap_order_x_varies_slowest():
    rng = np.random.default_rng(3)
    f1 = _t(rng.normal(size=(1, 4, 5, 5)))
    pyr = R.correlation_pyramid(f1, f1, 1)
    ys, xs = torch.meshgrid(torch.arange(5.0), torch.arange(5.0), indexing="ij")
    out = R.lookup_pyramid(pyr, torch.stack([xs, ys], -1)[None], 1)
    corr0 = pyr[0].reshape(5, 5, 5, 5)
    assert torch.allclose(out[0, 2, 2, 1], corr0[2, 2, 2, 1])  # tap 1: (dx = -1, dy = 0)
    assert torch.allclose(out[0, 2, 2, 3], corr0[2, 2, 1, 2])  # tap 3: (dx = 0, dy = -1)


def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(1)
    flow = rng.normal(size=(2, 3, 5, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 3, 5, 576)).astype(np.float32)
    ref = np.asarray(jax.jit(J.convex_upsample)(jnp.asarray(flow), jnp.asarray(mask)))
    out = R.convex_upsample(_t(flow).permute(0, 3, 1, 2), _t(mask).permute(0, 3, 1, 2))
    assert out.shape == (2, 2, 24, 40)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def raft_run():
    """Seeded weights in JAX's layout, the JAX flow_fn's flow and the raft
    processor's features from one jitted call."""
    rng = np.random.default_rng(2)
    img0 = rng.random((1, 3, S, S)).astype(np.float32)
    img1 = np.roll(img0, 2, -1) * 0.9 + 0.05
    views = rng.uniform(-1, 1, (1, 2, 3, S, S)).astype(np.float32)
    x = jnp.zeros((1, 3, S, S))
    params = _draw_tree(jax.eval_shape(lambda: J.RAFT(iters=2).init(jax.random.PRNGKey(0), x, x)), 5)["params"]

    @jax.jit
    def ref(p, a, b, v):
        return (J.make_raft_flow_fn(p, iters=2)(a, b), jmake_processor({"type": "raft"}, raft_params=p)(v))

    flow, feats = ref(params, *map(jnp.asarray, (img0, img1, views)))
    return dict(params=params, img0=img0, img1=img1, views=views, flow=np.asarray(flow), feats=np.asarray(feats))


def test_two_iteration_flow_matches_jax(raft_run):
    state, skipped = from_jax_params(raft_run["params"])
    assert skipped == []
    flow_fn = R.make_raft_flow_fn(state, iters=2)
    with torch.no_grad():
        flow = flow_fn(_t(raft_run["img0"]), _t(raft_run["img1"])).numpy()
    assert flow.shape == (1, 2, S, S) and np.isfinite(flow).all()
    assert np.abs(raft_run["flow"]).max() > 1.0
    np.testing.assert_allclose(flow, raft_run["flow"], atol=1e-4, rtol=1e-5)


def test_raft_feature_processor_matches_jax(raft_run):
    state = from_jax_params(raft_run["params"])[0]
    with pytest.raises(NotImplementedError, match="RaftExtractor needs converted torchvision RAFT weights"):
        make_image_processor({"type": "raft"})
    with torch.no_grad():
        feats = make_image_processor({"type": "raft"}, raft_params=state)(_t(raft_run["views"])).numpy()
    assert feats.shape == (1, 2, 256, S, S)
    np.testing.assert_allclose(feats, raft_run["feats"], atol=1e-4, rtol=1e-4)


def _torchvision_raft_large(seed=2):
    """A state dict under torchvision raft_large's names and shapes (0.18):
    the feature encoder with instance norms (no entries), the context
    encoder with batch norms, the update block, the mask predictor."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, kh, kw):
        sd[f"{key}.weight"] = (rng.normal(size=(cout, cin, kh, kw)) * 0.05).astype(np.float32)
        sd[f"{key}.bias"] = (rng.normal(size=cout) * 0.05).astype(np.float32)

    def bn(key, c):
        sd[f"{key}.weight"] = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.running_mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.running_var"] = (1 + 0.1 * np.abs(rng.normal(size=c))).astype(np.float32)
        sd[f"{key}.num_batches_tracked"] = np.array(3)

    for prefix, batch in (("feature_encoder", False), ("context_encoder", True)):
        conv(f"{prefix}.convnormrelu.0", 64, 3, 7, 7)
        if batch:
            bn(f"{prefix}.convnormrelu.1", 64)
        cin = 64
        for stage, cout in enumerate((64, 96, 128), start=1):
            for blk in (0, 1):
                base = f"{prefix}.layer{stage}.{blk}"
                conv(f"{base}.convnormrelu1.0", cout, cin if blk == 0 else cout, 3, 3)
                conv(f"{base}.convnormrelu2.0", cout, cout, 3, 3)
                if batch:
                    bn(f"{base}.convnormrelu1.1", cout)
                    bn(f"{base}.convnormrelu2.1", cout)
                if blk == 0 and stage > 1:
                    conv(f"{base}.downsample.0", cout, cin, 1, 1)
                    if batch:
                        bn(f"{base}.downsample.1", cout)
            cin = cout
        conv(f"{prefix}.conv", 256, 128, 1, 1)
    me = "update_block.motion_encoder"
    for name, cout, cin, k in (("convcorr1", 256, 4 * 81, 1), ("convcorr2", 192, 256, 3), ("convflow1", 128, 2, 7),
                               ("convflow2", 64, 128, 3), ("conv", 126, 192 + 64, 3)):
        conv(f"{me}.{name}.0", cout, cin, k, k)
    for gru, (kh, kw) in (("convgru1", (1, 5)), ("convgru2", (5, 1))):
        for gate in ("convz", "convr", "convq"):
            conv(f"update_block.recurrent_block.{gru}.{gate}", 128, 128 + 256, kh, kw)
    conv("update_block.flow_head.conv1", 256, 128, 3, 3)
    conv("update_block.flow_head.conv2", 2, 256, 3, 3)
    conv("mask_predictor.convrelu.0", 256, 128, 3, 3)
    conv("mask_predictor.conv", 64 * 9, 256, 1, 1)
    return sd


def test_converter_matches_jax_on_torchvision_names():
    sd = _torchvision_raft_large()
    sd["context_encoder.convnormrelu.1.running_var"] = np.full(64, 1.5, np.float32)  # statistics carried
    ours = R.convert_raft_state_dict(sd)
    ref, skipped = from_jax_params(J.convert_raft_state_dict(sd))
    assert skipped == [] and sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    model = R.RAFT(iters=1)
    model.load_state_dict(ours, strict=True)
    assert float(model.context_encoder.norm_in.var[0].detach()) == 1.5
    n_sd = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert len(ours) == n_sd
