"""The evaluation CLIs on checkpoints in the reference's torch layout, on
the CPU (`--device cpu`), on the tiny synthetic SSCBench tree of
tests/test_torch_sscbench.py.

For each encoder (DINO v1, and DINOv2: the tiny field of
tests/test_torch_stage2.py with `version: v2`, its ViT-S/14 cut to width
64, depth 3, 2 heads, 32x64 images pre-resized to 28x56), the same field
and head are written twice: as a `.pt` in the reference's BTSWrapper
names (`utils.convert.to_reference_layout`, under "model" as the
reference's trainer saves it) and as a stage-2 run directory of the port.
`cli.evaluate_sscbench` on each must print the same table and accumulate
the same confusion numbers, exactly: the same weights through the same
CPU path. The v2 run also holds the field it evaluated to the JAX
SceneField on encode (atol 1e-4 / rtol 1e-4, fp32 at "highest"
precision). The `--variant dinov2` flag and `variant: dinov2` reach the
DINOv2 preset (checked without building it: the preset is full width).
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedino_tpu.models.factory import make_model as j_make_model
from scenedino_tpu.models.field import SceneField as JSceneField
from scenedino_torch.cli import evaluate, evaluate_sscbench
from scenedino_torch.models import factory
from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
from scenedino_torch.training.downstream import DownstreamTrainConfig, init_downstream_state
from scenedino_torch.utils.checkpoint import save_checkpoint, save_field_snapshot
from scenedino_torch.utils.config import save_run_config
from scenedino_torch.utils.convert import load_jax_head, load_jax_params, to_reference_layout
from tests.test_torch_sscbench import ssc_tree  # noqa: F401  (the shared module fixture)
from tests.test_torch_stage2 import HEAD, MODEL, setup  # noqa: F401  (the shared module fixture)
from tests.test_torch_training import _batch, _random_params

MODEL_V2 = {**MODEL, "encoder": {**MODEL["encoder"], "version": "v2", "separate_gt_version": "v2"}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _write_both(root, conf, field, head):
    """`root/checkpoint.pt` in the reference's layout and `root/run`, a
    stage-2 run directory of the port, of the same field and head."""
    artifact = torch.zeros(field.encoder.gt_encoder.latent_size, 2, 4)
    ref = to_reference_layout(field.state_dict(), head.state_dict(), artifact)
    torch.save({"model": ref}, root / "checkpoint.pt")
    run = root / "run"
    run.mkdir()
    save_field_snapshot(str(run / "field_params.pt"), field)
    save_checkpoint(str(run / "training_checkpoint_1.pt"), head, init_downstream_state(head, DownstreamTrainConfig()))
    save_run_config(str(run), {"seed": 0, "model": conf, "downstream": HEAD,
                               "dataset": {"type": "synthetic", "image_size": [32, 64]}})
    return root / "checkpoint.pt", run


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, setup):  # noqa: F811
    """Both encoders' fields and heads, each written in both layouts; the v2
    field's JAX twin and parameters."""
    out = {}
    root = tmp_path_factory.mktemp("v1")
    head = SemanticHead(SemanticHeadConfig(**HEAD))
    load_jax_head(head, setup["hvars"])
    out["v1"] = _write_both(root, MODEL, setup["model"], head)

    jfield = j_make_model(MODEL_V2)
    params = _random_params(jfield, _batch(), seed=11)
    field = factory.make_model(MODEL_V2, device="cpu", training=True)
    assert load_jax_params(field, params["params"]) == []
    root = tmp_path_factory.mktemp("v2")
    out["v2"] = _write_both(root, MODEL_V2, field, head)
    out["v2-jax"] = (jfield, params)
    return out


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_sscbench_cli_on_a_reference_checkpoint(checkpoints, ssc_tree, version, capsys):  # noqa: F811
    ckpt, run = checkpoints[version]
    base = ["--data", str(ssc_tree), "--voxel-gt", str(ssc_tree / "voxel_gt"), "--config", str(run),
            "--device", "cpu", "--max-frames", "1"]
    table, acc = evaluate_sscbench.main(base + ["--ckpt", str(ckpt)])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(table))
    port_table, port_acc = evaluate_sscbench.main(base + ["--ckpt", str(run)])
    table.pop("sec_per_frame"), port_table.pop("sec_per_frame")
    assert table == port_table
    for size, r in port_acc.results.items():
        for k, v in r.items():
            np.testing.assert_array_equal(acc.results[size][k], v, err_msg=f"{size} {k}")
    assert all(0.0 <= v <= 1.0 for s in ("12.8", "25.6", "51.2") for v in table[s].values())


def test_the_evaluated_v2_field_matches_the_jax_field(checkpoints):
    """The field that the v2 checkpoint loads into, on one frame, against JAX's SceneField."""
    ckpt, run = checkpoints["v2"]
    field, head = evaluate.eval_model({"model": MODEL_V2, "downstream": HEAD}, str(ckpt), "cpu")
    assert field.encoder.vit_encoder.version == "v2" and field.encoder.gt_patch_size == 16
    jfield, params = checkpoints["v2-jax"]
    b = _batch(3)
    imgs, projs, poses = b["imgs"][:1, :2], b["projs"][:1, :2], b["poses"][:1, :2]
    ref = jax.jit(lambda p, i, k, c: jfield.apply(p, i, k, c, ids_encoder=(0,), with_loss_feats=True,
                                                  method=JSceneField.encode))(
        params, jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(poses))
    with torch.no_grad():
        state = field.encode(*(torch.from_numpy(a) for a in (imgs, projs, poses)), ids_encoder=(0,),
                             with_loss_feats=True)
    for name in ("feat_grid", "loss_feats"):
        np.testing.assert_allclose(getattr(state, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


class _Built(Exception):
    """Raised by a stand-in to stop a CLI once the model it asked for is known."""


def test_the_dinov2_variant_reaches_the_preset(monkeypatch, ssc_tree):  # noqa: F811
    """`--variant dinov2` (SSCBench) and `variant: dinov2` (both evaluators'
    eval_model) build the DINOv2 preset at the run's image size."""
    asked = {}

    def fake_eval_model(config, ckpt, device, image_size=(192, 640)):
        asked["config"], asked["size"] = copy.deepcopy(config), tuple(image_size)
        raise _Built

    def fake_make_model(conf, device=None, seed=0, training=False):
        asked["model"], asked["training"] = copy.deepcopy(conf), training
        raise _Built

    monkeypatch.setattr(evaluate, "eval_model", fake_eval_model)
    with pytest.raises(_Built):
        evaluate_sscbench.main(["--data", str(ssc_tree), "--voxel-gt", str(ssc_tree / "voxel_gt"), "--ckpt", "x.pt",
                                "--variant", "dinov2", "--device", "cpu"])
    assert asked["config"] == {"variant": "dinov2"} and asked["size"] == (192, 640)
    monkeypatch.undo()
    monkeypatch.setattr(factory, "make_model", fake_make_model)
    with pytest.raises(_Built):
        evaluate.eval_model({"variant": "dinov2"}, "x.pt", "cpu", (96, 320))
    assert asked["model"] == factory.variant_config("dinov2", (96, 320)) and asked["training"]
    assert asked["model"]["encoder"]["version"] == asked["model"]["encoder"]["separate_gt_version"] == "v2"
