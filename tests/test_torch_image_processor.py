"""The image processors and the flow utilities (`scenedino_torch/core/
image_processor.py`, `core/flow.py`) against the JAX package's on the CPU.

- rgb, patch (3 and 5), the automasking wrapper: atol 1e-6.
- perceptual with 3 layers at 24x32 on a seeded LPIPS-VGG trunk drawn in
  JAX's layout (`utils.convert.from_jax_params`): the taps unit-normalized
  and resized as `jax.image.resize`: atol 1e-5.
- flow and flow_occlusion on 2 frame pairs with the same analytic stand-in
  flow network on both sides (flows of up to 8 pixels at 16x24): the flow
  channels atol 1e-6, the occlusion masks equal; `compute_occlusions` on
  random flows equal.
- the processors' refusals without weights, with JAX's messages.
All JAX references in one jitted call; fp32, "highest" matmul precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.core.flow as JF
import scenedino_tpu.core.image_processor as J
from scenedino_tpu.eval.lpips import VGG16Features
from scenedino_torch.core import flow as FL
from scenedino_torch.core import image_processor as P
from scenedino_torch.utils.convert import from_jax_params
from tests.test_torch_stage1_branches import _draw_tree

H, W = 24, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jflow(a, b):
    return 8.0 * jnp.tanh(3.0 * (a - b)[:, :2]) + 0.25


def _flow(a, b):
    return 8.0 * torch.tanh(3.0 * (a - b)[:, :2]) + 0.25


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (2, 4, 3, H, W)).astype(np.float32)
    small = imgs[..., :16, :24]
    thr = rng.random((2, H, W)).astype(np.float32)
    f0, f1 = (rng.normal(0, 3, (3, 2, 16, 24)).astype(np.float32) for _ in range(2))
    trunk = _draw_tree(jax.eval_shape(lambda: VGG16Features().init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))),
                       1)["params"]

    @jax.jit
    def run(imgs, small, thr, f0, f1, trunk):
        return {
            "rgb": J.make_image_processor({"type": "RGB"})(imgs),
            "patch3": J.make_image_processor({"type": "patch"})(imgs),
            "patch5": J.make_image_processor({"type": "patch", "patch_size": 5})(imgs),
            "auto": J.automasking_wrapper(J.rgb_processor)(imgs, thr),
            "perceptual": J.make_image_processor({"type": "perceptual", "layers": 3}, vgg_params=trunk)(imgs),
            "flow": J.make_image_processor({"type": "flow"}, flow_fn=_jflow)(small),
            "flow_occlusion": J.make_image_processor({"type": "flow_occlusion"}, flow_fn=_jflow)(small),
            "occ": JF.compute_occlusions(f0, f1),
        }

    out = run(imgs, small, thr, f0, f1, trunk)
    return dict(imgs=imgs, small=small, thr=thr, f0=f0, f1=f1, trunk=trunk,
                out=jax.tree_util.tree_map(np.asarray, out))


def test_rgb_patch_and_automasking_match_jax(refs):
    imgs, out = _t(refs["imgs"]), refs["out"]
    np.testing.assert_allclose(P.make_image_processor({"type": "RGB"})(imgs).numpy(), out["rgb"], atol=1e-6)
    np.testing.assert_allclose(P.make_image_processor(None)(imgs).numpy(), out["rgb"], atol=1e-6)
    for name, conf in (("patch3", {"type": "patch"}), ("patch5", {"type": "patch", "patch_size": 5})):
        got = P.make_image_processor(conf)(imgs).numpy()
        assert got.shape == out[name].shape
        np.testing.assert_allclose(got, out[name], atol=1e-6, err_msg=name)
    got = P.automasking_wrapper(P.rgb_processor)(imgs, _t(refs["thr"])).numpy()
    assert got.shape == (2, 4, 4, H, W)
    np.testing.assert_allclose(got, out["auto"], atol=1e-6)


def test_perceptual_processor_matches_jax(refs):
    trunk = from_jax_params(refs["trunk"])[0]
    with torch.no_grad():
        got = P.make_image_processor({"type": "perceptual", "layers": 3}, vgg_params=trunk)(_t(refs["imgs"])).numpy()
    assert got.shape == (2, 4, sum(P.PERCEPTUAL_CHANNELS[:3]), H, W)
    np.testing.assert_allclose(got, refs["out"]["perceptual"], atol=1e-5, rtol=1e-5)


def test_flow_processors_and_occlusions_match_jax(refs):
    out, small = refs["out"], _t(refs["small"])
    for kind in ("flow", "flow_occlusion"):
        got = P.make_image_processor({"type": kind}, flow_fn=_flow)(small).numpy()
        ref = out[kind]
        assert got.shape == ref.shape == (2, 4, 5 if kind == "flow" else 6, 16, 24)
        np.testing.assert_allclose(got[:, :, :5], ref[:, :, :5], atol=1e-6, err_msg=kind)
        if kind == "flow_occlusion":
            np.testing.assert_array_equal(got[:, :, 5:], ref[:, :, 5:])
            assert 0 < got[:, :, 5:].mean() < 1
    occ = FL.compute_occlusions(_t(refs["f0"]), _t(refs["f1"]))
    for a, b in zip(occ, out["occ"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_refusals_match_jax():
    for conf, kw, exc in (({"type": "perceptual"}, {}, NotImplementedError),
                          ({"type": "flow"}, {}, NotImplementedError),
                          ({"type": "flow_occlusion"}, {}, NotImplementedError),
                          ({"type": "raft"}, {}, NotImplementedError),
                          ({"type": "sobel"}, {}, ValueError)):
        with pytest.raises(exc) as ours:
            P.make_image_processor(conf, **kw)
        with pytest.raises(exc) as ref:
            J.make_image_processor(conf, **kw)
        assert str(ours.value) == str(ref.value)
