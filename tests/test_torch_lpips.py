"""The port's LPIPS (`eval/lpips.py`) against the JAX package's on the CPU:
AlexNet and VGG16 trunks with random weights, written as a published
`lpips` state dict in each accepted naming and read back by both
packages' converters (and JAX's tree carried across by
`utils.convert.from_jax_params`, equal), on 2x3x64x64 images in [-1, 1]:
rel 1e-5. Without
a weights file both packages' `load_lpips` raise `FileNotFoundError`.
`compute_nvs_metrics` with an LPIPS function: the port's against JAX's
(PSNR and SSIM as tests/test_torch_eval_forward.py holds them, LPIPS rel
1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.lpips as J
import scenedino_tpu.training.validation as jvalidation
from scenedino_torch.eval import lpips
from scenedino_torch.training import validation
from scenedino_torch.utils.convert import from_jax_params

# torchvision's conv indices of each trunk with (in, out, kernel), and each index's lpips slice
TRUNKS = {
    "alex": [(0, 3, 64, 11, 1), (3, 64, 192, 5, 2), (6, 192, 384, 3, 3), (8, 384, 256, 3, 4), (10, 256, 256, 3, 5)],
    "vgg": [(0, 3, 64, 3, 1), (2, 64, 64, 3, 1), (5, 64, 128, 3, 2), (7, 128, 128, 3, 2), (10, 128, 256, 3, 3),
            (12, 256, 256, 3, 3), (14, 256, 256, 3, 3), (17, 256, 512, 3, 4), (19, 512, 512, 3, 4),
            (21, 512, 512, 3, 4), (24, 512, 512, 3, 5), (26, 512, 512, 3, 5), (28, 512, 512, 3, 5)],
}
NAMINGS = ("net", "slice", "features")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _state_dict(net, naming, seed=0):
    """Random weights as a published lpips file holds them: the trunk under
    `net.<i>` (with `lin<k>` heads), `net.slice<s>.<i>` (with `lins.<k>`) or
    `features.<i>` (torchvision's own; `lin<k>` heads)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, cin, cout, k, sl in TRUNKS[net]:
        prefix = {"net": f"net.{i}", "slice": f"net.slice{sl}.{i}", "features": f"features.{i}"}[naming]
        sd[f"{prefix}.weight"] = torch.from_numpy((rng.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k * k))
                                                  .astype(np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(rng.normal(scale=0.1, size=cout).astype(np.float32))
    for j, c in enumerate(lpips.ALEX_CHANNELS if net == "alex" else lpips.VGG_CHANNELS):
        head = f"lins.{j}" if naming == "slice" else f"lin{j}"
        sd[f"{head}.model.1.weight"] = torch.from_numpy(np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(2, 3, 64, 64)).astype(np.float32)
    return x, np.clip(x + rng.normal(scale=0.3, size=x.shape), -1, 1).astype(np.float32)


@pytest.mark.parametrize("net", ["alex", "vgg"])
@pytest.mark.parametrize("naming", NAMINGS)
def test_lpips_matches_jax_through_each_naming(net, naming, images, tmp_path):
    sd = _state_dict(net, naming, seed=len(naming))
    path = tmp_path / f"lpips_{net}.pt"
    torch.save(sd, path)
    model = lpips.load_lpips(str(path), net, device="cpu")
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    x, y = images
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    jmodel = J.LPIPS(net=net)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": J.convert_lpips_state_dict(sd, net)}, jnp.asarray(x),
                                           jnp.asarray(y)))
    assert ours.shape == ref.shape == (2,) and (ours > 0).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    # JAX's converted tree carried across by utils.convert gives the same module, strictly
    carried, skipped = from_jax_params(J.convert_lpips_state_dict(sd, net))
    assert skipped == [] and sorted(carried) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(carried[k], v), k
    with torch.no_grad():
        assert float(model(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) == 0.0


def test_load_lpips_without_weights_raises_in_both_packages(tmp_path):
    for path in (None, str(tmp_path / "absent.pt")):
        with pytest.raises(FileNotFoundError, match="LPIPS weights not found"):
            lpips.load_lpips(path, "alex", device="cpu")
        with pytest.raises(FileNotFoundError, match="LPIPS weights not found"):
            J.load_lpips(path, "alex")
    with pytest.raises(KeyError, match="trunk conv 0"):
        lpips.convert_lpips_state_dict({}, "vgg")


def test_compute_nvs_metrics_with_lpips_matches_jax(images, tmp_path):
    sd = _state_dict("alex", "net")
    torch.save(sd, tmp_path / "alex.pt")
    model = lpips.load_lpips(str(tmp_path / "alex.pt"), device="cpu")
    jmodel, jparams = J.LPIPS(net="alex"), {"params": J.convert_lpips_state_dict(sd, "alex")}
    rng = np.random.default_rng(5)
    data = {"rgb": rng.uniform(0, 1, size=(1, 3, 72, 72, 1, 3)).astype(np.float32),
            "imgs_gt": rng.uniform(0, 1, size=(1, 3, 3, 72, 72)).astype(np.float32)}
    ours = validation.compute_nvs_metrics(data, lpips_fn=model)
    ref = jvalidation.compute_nvs_metrics({k: jnp.asarray(v) for k, v in data.items()},
                                          lpips_fn=lambda a, b: jax.jit(jmodel.apply)(jparams, a, b))
    assert sorted(ours) == sorted(ref) == ["lpips", "psnr", "ssim"]
    np.testing.assert_allclose(ours["lpips"], ref["lpips"], rtol=1e-5)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5)
    assert sorted(validation.compute_nvs_metrics(data)) == ["psnr", "ssim"]
