"""SceneDINO in PyTorch for NVIDIA Hopper.

A port of the JAX package `scenedino_tpu` (the reference, which stays in
the repository unchanged). It covers these paths:

    serving:  models.factory.make_model -> SceneField.encode (DINO ViT + DPT)
              -> ops.fast_field.build_fast_state -> ops.fast_field.render_novel_view_fused,
              or ops.fast_field.encode_prefolded -> render_novel_view_probe,
              fast_query_fused (the SSCBench voxel query) or render_encode_view
    training: models.factory.make_model(training=True)
              -> training.trainer.make_train_step (the stage-1 step);
              cli.train (python -m scenedino_torch.cli.train --config ...):
              the stage-1 run, with training.loop, the validation render
              (training.trainer.stage1_eval_forward) and checkpoints;
              cli.train --stage semantic: stage 2, the semantic head
              (models.downstream) distilled from a frozen field by
              training.downstream, validated with the pseudo-assignment
              write-back (training.validation)
    evaluation: cli.evaluate_sscbench (the SSCBench voxel grid; --mode s4c
              the S4C baseline), cli.evaluate (2D segmentation, the window
              or the exact CRF), the validator's occupancy, LPIPS and
              panels, TSDF fusion (eval/)
    the rest: the multi-view heads and IBRNet (models.multi_view_head),
              pixelNeRF's encoders (models.pixelnerf), RAFT and the image
              processors (models.raft, core.image_processor, core.flow),
              the dummy encoders, the hyperparameter sweep (cli.sweep) and
              the interactive demo's runner (cli.demo_gradio.demo_run)

Hand-written CUDA kernels carry them (`kernels/`, sources in `csrc/`):
the ViT attention forward and its backward (dq; dk and dv), the fused
point pipeline of serving in three output modes (render, probe, query),
a row gather, and the encode-view render's per-sample work (K6). Entry points run on the GPU unless the
caller asks for the CPU with `device="cpu"`; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says
    otherwise. With no CUDA and no explicit device it raises rather than
    quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
