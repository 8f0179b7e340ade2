"""The PyTorch port stands alone: no module of `scenedino_torch/`, and not
`chip_smoke.py`, imports JAX, flax or the JAX package, nor PyYAML, PIL or
OpenCV (the card's machine has none of the three: the port reads configs
with its own `utils.config` and PNGs and JPEGs with `datasets.image_io`); its entry points
refuse to run quietly on the CPU; its weight converter accounts for every
leaf of a real parameter tree.

The import check reads the sources (ast): a `sys.modules` check cannot
work here because the test process imports JAX before anything else.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from scenedino_torch.models.factory import SCENEDINO_KITTI_360, make_model
from scenedino_torch.utils.convert import TRAINING_ONLY, flatten_params, from_jax_params, load_jax_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "scenedino_tpu", "yaml", "PIL", "cv2")
SOURCES = sorted((ROOT / "scenedino_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_the_whole_package():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"chip_smoke.py", "scenedino_torch/kernels/attention.py",
            "scenedino_torch/ops/fast_field.py", "scenedino_torch/utils/convert.py",
            "scenedino_torch/training/trainer.py", "scenedino_torch/renderer/nerf.py",
            "scenedino_torch/losses/errors.py", "scenedino_torch/parallel/data_parallel.py",
            "scenedino_torch/tools/diag_depth_convergence.py", "scenedino_torch/tools/softmax_sweep.py",
            "scenedino_torch/models/monodepth2.py", "scenedino_torch/core/ray_sampler.py",
            "scenedino_torch/losses/reconstruction.py", "scenedino_torch/kernels/row_gather.py",
            "scenedino_torch/tools/probe_gather.py", "scenedino_torch/tools/bench_gather.py",
            "scenedino_torch/eval/sscbench.py", "scenedino_torch/utils/timing.py",
            "scenedino_torch/utils/config.py", "scenedino_torch/cli/train.py", "scenedino_torch/training/loop.py",
            "scenedino_torch/training/validation.py", "scenedino_torch/datasets/synthetic.py",
            "scenedino_torch/kernels/encode_view.py", "scenedino_torch/ops/kmeans.py",
            "scenedino_torch/models/downstream.py", "scenedino_torch/losses/stego.py",
            "scenedino_torch/training/downstream.py", "scenedino_torch/tools/bench_encode_view.py",
            "scenedino_torch/datasets/image_io.py", "scenedino_torch/eval/seg2d.py", "scenedino_torch/eval/crf.py",
            "scenedino_torch/cli/evaluate.py", "scenedino_torch/cli/evaluate_sscbench.py",
            "scenedino_torch/core/resize.py", "scenedino_torch/models/encoder.py", "scenedino_torch/models/field.py",
            "scenedino_torch/models/factory.py", "scenedino_torch/utils/checkpoint.py",
            "scenedino_torch/datasets/re10k.py", "scenedino_torch/core/strategies.py",
            "scenedino_torch/cli/process_re10k.py", "scenedino_torch/parallel/mesh.py",
            "scenedino_torch/parallel/render_sharding.py", "scenedino_torch/models/dummy.py",
            "scenedino_torch/models/raft.py", "scenedino_torch/models/pixelnerf.py",
            "scenedino_torch/models/multi_view_head.py", "scenedino_torch/core/image_processor.py",
            "scenedino_torch/core/flow.py", "scenedino_torch/cli/sweep.py", "scenedino_torch/cli/demo_gradio.py"} <= names


def test_entry_point_without_a_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_model() rightly runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(SCENEDINO_KITTI_360)


def test_converter_consumes_every_leaf_of_the_s1b_fixture():
    """Every leaf maps to one tensor, the training-only subtrees too: a
    training model takes the whole tree strictly, a serving model skips
    exactly the TRAINING_ONLY subtrees, all of each."""
    import yaml

    npz = np.load(ROOT / "tests" / "goldens" / "s1b_field_params.npz")
    flat = {k: npz[k] for k in npz.files}
    state, skipped = from_jax_params(flat)
    leaves = flatten_params(flat)
    assert not skipped and len(state) == len(leaves) == len(flat)
    conf = yaml.safe_load((ROOT / "configs" / "train_synthetic_convergence.yaml").read_text())["model"]
    assert load_jax_params(make_model(conf, device="cpu", training=True), flat) == []
    serving_skipped = load_jax_params(make_model(conf, device="cpu"), flat)
    for path in leaves:
        training_only = any(path.startswith(p + "/") for p in TRAINING_ONLY)
        assert (path in serving_skipped) == training_only, path
    assert {p.split("/")[1] for p in serving_skipped} == {"gt_encoder", "downsampler", "dim_reduction"}
    # Dense kernels arrive transposed, conv kernels as OIHW, LN scale as weight
    assert state["heads.normal_head.lin_in.weight"].shape == (64, 71)
    assert state["encoder.decoder.conv_0.weight"].shape == (32, 16, 3, 3)
    assert "encoder.vit_encoder.vit.blocks.0.norm1.weight" in state
    # the training-only subtrees, in the same layouts
    assert state["encoder.gt_encoder.vit.blocks.2.attn.qkv.weight"].shape == (192, 64)
    assert state["encoder.downsampler.salience_conv.weight"].shape == (1, 64, 1, 1)
    assert state["encoder.downsampler.patch_weight"].shape == (8, 8)
    assert state["encoder.dim_reduction.linear_in.weight"].shape == (128, 16)
    assert state["encoder.dim_reduction.linear_out.weight"].shape == (64, 128)
