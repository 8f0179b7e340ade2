"""`torchrun --nproc_per_node 2 -m scenedino_torch.cli.train --device cpu`
(gloo) on a tiny synthetic config (tests/test_torch_training.py's model,
32x64 images, a global batch of two), one step, against the same config
in one process; only rank 0 writes the run directory's files. The
torchrun has its own timeout. tests/test_torch_ddp.py holds the
data-parallel step itself against JAX's unsharded step.
"""
import os
import socket
import subprocess
import sys

import torch

TORCHRUN_TIMEOUT = 150  # seconds for both ranks: imports, model build, one step, the checkpoint
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


TINY = """seed: 0
batch_size: 2
num_workers: 1
output: {path: %s}
dataset: {type: synthetic, length: 4, n_views: 4, image_size: [32, 64]}
model:
  predict_dino: true
  dino_dims: 8
  compensate_artifacts: true
  encoder:
    mode: downsample-prediction
    decoder_arch: dpt
    downsampler_arch: featup
    encoder_arch: vit-s
    version: v1
    separate_gt_version: v1
    dim_reduction_arch: mlp
    num_ch_enc: [8, 8, 16, 16]
    intermediate_features: [0, 1, 2]
    decoder_out_dim: 16
    dino_pca_dim: 8
    image_size: [32, 64]
    vit_overrides: {width: 64, depth: 3, num_heads: 2}
  decoder_heads:
    - {type: resnet, name: normal_head, args: {n_blocks: 0, d_hidden: 16}}
  final_prediction_head: normal_head
renderer: {n_coarse: 8}
training:
  num_epochs: 1
  checkpoint_every: 1
  log_every: 1
  stop_iteration: 1
  optimizer: {args: {lr: 1.0e-3}}
  ray_sampler: {args: {patch_size: 8, ray_batch_size: 256}}
"""


def test_torchrun_trains_data_parallel_like_one_process(tmp_path):
    """cli.train under torchrun (2 gloo ranks, one item each) against the
    same config in one process: the checkpoint's parameters, and only rank
    0 writes (one checkpoint, one config file, one scalars directory)."""
    from scenedino_torch.cli import train as cli
    from scenedino_torch.training import loop
    from scenedino_torch.utils.config import load

    one, two = tmp_path / "one", tmp_path / "two"
    for d in (one, two):
        (tmp_path / f"{d.name}.yaml").write_text(TINY % d)
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port",
           str(_free_port()), "-m", "scenedino_torch.cli.train", "--config", str(tmp_path / "two.yaml"),
           "--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    field, _ = cli.run_stage1(load(str(tmp_path / "one.yaml")), device="cpu")
    out, _ = proc.communicate(timeout=TORCHRUN_TIMEOUT)
    assert proc.returncode == 0, out[-4000:]
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    assert [p.name for p in two.glob("training_checkpoint_*.pt")] == ["training_checkpoint_1.pt"]
    assert out.count("checkpoint ") == 1  # rank 1 wrote none
    ckpt = torch.load(loop.find_latest_checkpoint(str(two)), weights_only=True)
    ref = torch.load(loop.find_latest_checkpoint(str(one)), weights_only=True)
    for name, p in ref["field"].items():
        diff = (ckpt["field"][name].float() - p.float()).abs()
        # Adam's first update is +-lr wherever |g| >> eps: an entry whose
        # gradient is round-off may flip; those are few
        assert float(diff.max()) <= 2e-3 * (1 + 1e-3), name
        assert float((diff > 1e-5).float().mean()) < 2e-3, name
    assert torch.allclose(ckpt["artifact_field"], ref["artifact_field"], atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(field.state_dict().values(), ref["field"].values()))
