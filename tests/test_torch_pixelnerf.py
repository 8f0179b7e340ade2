"""pixelNeRF's encoders (`scenedino_torch/models/pixelnerf.py`) against the
JAX package's on the CPU, on seeded weights drawn in JAX's layout (the
batch norms' variances positive) and carried across by
`utils.convert.from_jax_params`.

- `_resize_align_corners` against JAX's scale-and-translate form on maps
  of 2x3, 3x4 and 5x7 pixels: atol 1e-5 (the two forms round their taps
  differently: 2e-6 seen); on a map of one row, torch's
  align_corners=True (the row repeated) where JAX zeros the outputs past
  the row's half extent, and JAX's first half.
- `SpatialEncoder` (ResNet-18, 4 layers, with the first pool; 5 layers
  without it) and `ImageEncoder` (ResNet-18, latent 32 through `fc`) at
  40x56, where the pyramid's upsampling is not a whole factor: all three in
  one jitted call, atol 1e-4 (fp32 sums in other orders through 17
  convolutions), rtol 1e-5.
- `convert_torchvision_resnet` on a synthetic ResNet-18 state dict under
  torchvision's names: exactly JAX's converted tree as the port maps it,
  every key but `num_batches_tracked` consumed; `make_backbone` builds
  "spatial" and "global".
fp32, JAX at "highest" matmul precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.models.pixelnerf as J
from scenedino_torch.models import pixelnerf as P
from scenedino_torch.models.backbone_util import make_backbone
from scenedino_torch.utils.convert import from_jax_params
from tests.test_torch_stage1_branches import _draw_tree

H, W = 40, 56
ENCODERS = {
    "spatial-pool": (dict(backbone="resnet18", num_layers=4, use_first_pool=True), "SpatialEncoder"),
    "spatial-nopool": (dict(backbone="resnet18", num_layers=5, use_first_pool=False), "SpatialEncoder"),
    "global": (dict(backbone="resnet18", latent_size=32), "ImageEncoder"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_resize_align_corners_matches_jax():
    """Equal on maps of 2 pixels or more an axis. On an axis of one pixel
    torch's align_corners=True repeats it, while JAX's scale-and-translate
    zeros the outputs that sample past the pixel's half extent (the second
    half of the axis): there the port keeps the reference's torch result and
    equals JAX on the first half."""
    rng = np.random.default_rng(0)
    cases = (((2, 3), (6, 7)), ((3, 4), (9, 10)), ((5, 7), (20, 28)), ((1, 3), (6, 7)))
    xs = [rng.normal(size=(2, h, w, 3)).astype(np.float32) for (h, w), _ in cases]
    refs = jax.jit(lambda vs: [J._resize_align_corners(v, *o) for v, (_, o) in zip(vs, cases)])(xs)
    for x, ref, ((h, w), (oh, ow)) in zip(xs, refs, cases):
        ref = np.asarray(ref)
        out = P._resize_align_corners(_t(x).permute(0, 3, 1, 2), oh, ow).permute(0, 2, 3, 1).numpy()
        if h == 1:
            np.testing.assert_array_equal(out, np.broadcast_to(out[:, :1], out.shape))
            out, ref = out[:, :oh // 2], ref[:, :oh // 2]
            assert np.abs(ref).min() > 0
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5, err_msg=f"{(h, w)} -> {(oh, ow)}")


@pytest.fixture(scope="module")
def references():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, H, W)).astype(np.float32)
    mods = {name: getattr(J, kind)(**kw) for name, (kw, kind) in ENCODERS.items()}
    params = {name: _draw_tree(jax.eval_shape(lambda m=m: m.init(jax.random.PRNGKey(0), jnp.asarray(x))), i)
              for i, (name, m) in enumerate(mods.items())}
    outs = jax.jit(lambda ps, v: {n: mods[n].apply(ps[n], v) for n in mods})(params, jnp.asarray(x))
    return x, params, outs


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoders_match_jax(references, name):
    x, params, outs = references
    kw, kind = ENCODERS[name]
    model = make_backbone({"type": "global" if kind == "ImageEncoder" else "spatial", **kw})
    assert isinstance(model, getattr(P, kind))
    state, skipped = from_jax_params(params[name]["params"])
    assert skipped == []
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = model(_t(x))
    ref = outs[name]
    if kind == "SpatialEncoder":
        out, ref = out[0], ref[0]
        assert out.shape == (2, model.latent_size, H // 2, W // 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def _torchvision_resnet18(seed=2):
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key] = (rng.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k * k)).astype(np.float32)

    def bn(key, c):
        sd[f"{key}.weight"] = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.running_mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{key}.running_var"] = (1 + 0.1 * np.abs(rng.normal(size=c))).astype(np.float32)
        sd[f"{key}.num_batches_tracked"] = np.array(7)

    conv("model.conv1.weight", 64, 3, 7)
    bn("model.bn1", 64)
    cin = 64
    for li, w in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            base = f"model.layer{li}.{bi}"
            conv(f"{base}.conv1.weight", w, cin if bi == 0 else w, 3)
            bn(f"{base}.bn1", w)
            conv(f"{base}.conv2.weight", w, w, 3)
            bn(f"{base}.bn2", w)
            if bi == 0 and li > 1:
                conv(f"{base}.downsample.0.weight", w, cin, 1)
                bn(f"{base}.downsample.1", w)
        cin = w
    return sd


def test_torchvision_converter_matches_jax():
    sd = _torchvision_resnet18()
    ours = P.convert_torchvision_resnet(sd)
    ref, skipped = from_jax_params(J.convert_torchvision_resnet(sd))
    assert skipped == [] and sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    assert len(ours) == sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    model = make_backbone({"type": "spatial", "backbone": "resnet18", "num_layers": 5})
    model.load_state_dict({f"model.{k}": v for k, v in ours.items()}, strict=True)
