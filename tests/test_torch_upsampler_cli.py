"""configs/train_scenedino_kitti_360_upsampler.yaml (the upsample-gt
recipe: the multiscale-crop teacher, a per-pixel target, no artifact
field) through the port's training CLI on the CPU, on
tests/test_torch_kitti360.py's seeded KITTI-360 tree after the port's
resize CLI, at the smoke recipe's tiny width (a ViT-S/8 cut to width 64,
depth 3, 2 heads; DPT 32; 8 samples a ray): 2 steps, a validation on the
velodyne depths, a checkpoint. Its parity with JAX is held step by step
in tests/test_torch_upsample_gt.py; here the recipe's own blocks run.
"""
import logging
import os

import numpy as np
import pytest
import torch

from scenedino_torch.cli import preprocess_kitti_360 as pp
from scenedino_torch.cli import train as train_cli
from scenedino_torch.utils import config as yaml_config
from tests.test_torch_kitti360 import TGT, write_kitti_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_upsampler_recipe_runs_through_the_cli(tmp_path, caplog):
    root = write_kitti_tree(tmp_path / "kitti", n_frames=16)
    pp.main(["resize", "-d", str(root), "-r", *map(str, TGT), "--workers", "2"])
    conf = yaml_config.load(os.path.join(ROOT, "configs", "train_scenedino_kitti_360_upsampler.yaml"))
    enc = conf["model"]["encoder"]
    assert (enc["mode"], enc["upsampler_arch"], conf["model"]["compensate_artifacts"]) == (
        "upsample-gt", "multiscale-crop", False)
    assert conf["training"]["ray_sampler"]["args"]["dino_upscaled"]
    conf["dataset"].update(data_path=str(root), pose_path=str(root / "data_poses"),
                           split_path=str(root / "splits"), image_size=list(TGT), fisheye_offset=[2, 3, 4])
    smoke = yaml_config.load(os.path.join(ROOT, "configs", "train_synthetic_smoke.yaml"))["model"]["encoder"]
    enc.update({k: smoke[k] for k in ("encoder_arch", "num_ch_enc", "intermediate_features", "decoder_out_dim",
                                      "dino_pca_dim", "vit_overrides")}, image_size=list(TGT))
    conf["model"]["dino_dims"] = 16
    conf["model"]["decoder_heads"][0]["args"]["d_hidden"] = 16
    conf["renderer"]["n_coarse"] = 8
    conf.update(with_amp=False, num_workers=2, batch_size=2)
    conf["training"].update(stop_iteration=2, checkpoint_every=2, log_every=1)
    conf["training"]["ray_sampler"]["args"]["ray_batch_size"] = 256
    vconf = conf["validation"]["validation"]
    vconf["events"][0]["args"]["every"] = 2
    vconf["subset"]["args"] = {"start": 0, "end": 2}
    conf["output"]["path"] = str(tmp_path / "run")
    (tmp_path / "up.yaml").write_text(yaml_config.dumps(conf))
    with caplog.at_level(logging.INFO):
        train_cli.main(["--config", str(tmp_path / "up.yaml"), "--device", "cpu"])
    steps = [r for r in caplog.records if hasattr(r, "losses")]
    vals = [r for r in caplog.records if hasattr(r, "validator")]
    assert [r.iteration for r in steps] == [1, 2]
    assert all(np.isfinite(list(r.losses.values())).all() for r in steps)
    assert steps[-1].losses["nonfinite_total"] == 0
    assert len(vals) == 1 and np.isfinite(vals[0].metrics["depth_abs_rel"])
    assert -1.0 <= vals[0].metrics["dino_cos_sim"] <= 1.0
    ckpt = torch.load(tmp_path / "run" / "training_checkpoint_2.pt", weights_only=True)
    assert not any(k.startswith("encoder.downsampler.") for k in ckpt["field"])
    assert ckpt.get("artifact_field") is None
