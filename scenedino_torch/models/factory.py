"""Model factory (counterpart of `scenedino_tpu/models/factory.py`): the
DINO encoder family, and through `backbone_util.make_backbone` the other
encoders (Monodepth2, the S4C baseline's: `s4c_baseline_config`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from scenedino_torch import resolve_device
from scenedino_torch.models.encoder import DinoModuleConfig
from scenedino_torch.models.field import FieldConfig, SceneField

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _dtype(value):
    if isinstance(value, str):
        return _DTYPES[value]
    return value


def encoder_config_from_dict(conf: Dict[str, Any]) -> DinoModuleConfig:
    """An `encoder:` config block; the defaults are the reference's."""
    return DinoModuleConfig(
        mode=conf.get("mode", "downsample-prediction"),
        downsampler_arch=conf.get("downsampler_arch", "featup"),
        upsampler_arch=conf.get("upsampler_arch"),
        separate_gt_version=conf.get("separate_gt_version", "v1"),
        dim_reduction_arch=conf.get("dim_reduction_arch", "mlp"),
        dino_pca_dim=conf.get("dino_pca_dim", 64),
        encoder_freeze=conf.get("encoder_freeze", False),
        flip_avg_gt=conf.get("flip_avg_gt", False),
        decoder_arch=conf.get("decoder_arch", "dpt"),
        encoder_arch=conf.get("encoder_arch", "vit-b"),
        version=conf.get("version", "v1"),
        num_ch_enc=tuple(conf.get("num_ch_enc", (64, 64, 128, 256))),
        intermediate_features=tuple(conf.get("intermediate_features", (3, 6, 9))),
        decoder_out_dim=conf.get("decoder_out_dim", 256),
        image_size=tuple(conf.get("image_size", (192, 640))),
        key_features=conf.get("key_features", False),
        grad_checkpointing=conf.get("grad_checkpointing", False),
        dtype=_dtype(conf.get("dtype")),
        vit_overrides=tuple(sorted(conf["vit_overrides"].items())) if conf.get("vit_overrides") else None,
    )


def make_model(conf: Dict[str, Any], device=None, seed: int = 0, training: bool = False) -> SceneField:
    """Build SceneField from a model config dict, with parameters drawn from
    `seed`, on `device` (CUDA unless "cpu" is asked for). Serving models
    (`training=False`, in eval mode) hold the student only; training
    models also hold the frozen teacher, the downsampler and the
    dimension reduction, drawn after the student's parameters."""
    from scenedino_torch.models.backbone_util import make_backbone

    device = resolve_device(device)
    enc_conf = conf.get("encoder", {})
    code = conf.get("code", {})
    fcfg = FieldConfig(
        z_near=conf.get("z_near", 3.0),
        z_far=conf.get("z_far", 80.0),
        inv_z=conf.get("inv_z", True),
        code_mode=conf.get("code_mode", "z"),
        learn_empty=conf.get("learn_empty", False),
        sample_color=conf.get("sample_color", True),
        predict_dino=conf.get("predict_dino", True),
        dino_dims=conf.get("dino_dims", 64),
        num_freqs=code.get("num_freqs", 6),
        freq_factor=code.get("freq_factor", 1.5),
        include_input=code.get("include_input", True),
    )
    heads = conf.get(
        "decoder_heads",
        [{"type": "resnet", "name": "normal_head", "args": {"n_blocks": 0, "d_hidden": 128}}],
    )
    head_confs = tuple(
        (h.get("name", f"head_{i}"), {"type": h.get("type", "resnet"), "args": h.get("args", {})})
        for i, h in enumerate(heads)
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        field = SceneField(
            make_backbone(enc_conf, training=training), fcfg, head_confs,
            final_pred_head=conf.get("final_prediction_head", head_confs[0][0]),
        )
    return field.to(device).train(training)


# The shipped SceneDINO flagship (configs/model/dino_downsampler.yaml)
SCENEDINO_KITTI_360 = {
    "predict_dino": True,
    "dino_dims": 64,
    "inv_z": True,
    "learn_empty": False,
    "code_mode": "z",
    "z_near": 3.0,
    "z_far": 80.0,
    "encoder": {
        "mode": "downsample-prediction",
        "decoder_arch": "dpt",
        "downsampler_arch": "featup",
        "encoder_arch": "vit-b",
        "version": "v1",
        "separate_gt_version": "v1",
        "dim_reduction_arch": "mlp",
        "num_ch_enc": (64, 64, 128, 256),
        "intermediate_features": (3, 6, 9),
        "decoder_out_dim": 256,
        "dino_pca_dim": 64,
        "image_size": (192, 640),
        "key_features": False,
    },
    "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
    "decoder_heads": [
        {"type": "resnet", "name": "normal_head", "args": {"n_blocks": 0, "d_hidden": 128}}
    ],
    "final_prediction_head": "normal_head",
}


def scenedino_dinov2_config() -> Dict[str, Any]:
    """configs/model/dinov2_downsampler.yaml: the flagship with a DINOv2
    ViT-B/14 student and teacher (the ssc-kitti-360-dinov2 checkpoint's)."""
    conf = {**SCENEDINO_KITTI_360}
    conf["encoder"] = {**conf["encoder"], "version": "v2", "separate_gt_version": "v2"}
    return conf


def s4c_baseline_config(n_classes: int = 19) -> Dict[str, Any]:
    """The S4C baseline that the reference's SSC evaluator builds for
    `-m s4c` (evaluate_model_sscbench.py:179-217): a Monodepth2 encoder
    (d_out 64), the n_blocks=0 head with d_hidden 64, code_mode "z",
    learn_empty off. The S4C net's class logits are the field's feature
    channels (dino_dims = n_classes), so the SSC query runs unchanged: the
    encoder's `expand_dim` is the identity and the evaluator softmaxes the
    channels into the class probabilities it alpha-weights."""
    return {
        "predict_dino": True,
        "dino_dims": n_classes,
        "inv_z": True,
        "learn_empty": False,
        "code_mode": "z",
        "z_near": 3.0,
        "z_far": 80.0,
        "encoder": {"type": "monodepth2", "d_out": 64, "scales": (0, 1, 2, 3)},
        "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
        "decoder_heads": [{"type": "resnet", "name": "normal_head", "args": {"n_blocks": 0, "d_hidden": 64}}],
        "final_prediction_head": "normal_head",
    }


def variant_config(variant: str = "dino", image_size=(192, 640)) -> Dict[str, Any]:
    """The model of an evaluation's `variant` preset (the reference's
    `cli/demo.py` build_model): "dino" (ViT-B/8) or "dinov2" (ViT-B/14), fp32,
    at `image_size`."""
    presets = {"dino": SCENEDINO_KITTI_360, "dinov2": scenedino_dinov2_config()}
    if variant not in presets:
        raise ValueError(f"variant must be one of {sorted(presets)}, got {variant!r}")
    conf = dict(presets[variant])
    conf["encoder"] = {**conf["encoder"], "image_size": tuple(image_size)}
    return conf


# The shipped stage-1 recipe (configs/train_scenedino_kitti_360.yaml): the
# model block with the artifact field on, and the blocks the training step
# reads. Data paths and validation are not part of the step.
SCENEDINO_KITTI_360_TRAIN = {
    "seed": 0,
    "with_amp": True,
    "batch_size": 4,
    "model": {**SCENEDINO_KITTI_360, "compensate_artifacts": True},
    "renderer": {"n_coarse": 32, "n_fine": 0, "lindisp": True, "hard_alpha_cap": True},
    "training": {
        "optimizer": {"args": {"lr": 1.0e-4}},
        "scheduler": {"step_size": 50000, "gamma": 0.1},
        "ray_sampler": {
            "z_near": 3,
            "z_far": 80,
            "sample_mode": "patch",
            "args": {"patch_size": 8, "ray_batch_size": 2048, "snap_to_grid": True, "dino_upscaled": False},
        },
    },
}


# The synthetic smoke recipe (configs/train_synthetic_smoke.yaml), as the
# training step reads it: fp32 (no `with_amp`), a ViT-S/8 cut to width 64,
# depth 3 and 2 heads (head dim 32; 73 tokens at 48x96), 8 coarse samples.
# Of the dataset block only the shapes; the output and validation blocks
# are not part of the step.
SYNTHETIC_SMOKE_TRAIN = {
    "seed": 0,
    "batch_size": 2,
    "dataset": {"type": "synthetic", "n_views": 4, "image_size": (48, 96)},
    "model": {
        "predict_dino": True,
        "dino_dims": 16,
        "compensate_artifacts": True,
        "inv_z": True,
        "code_mode": "z",
        "z_near": 3,
        "z_far": 80,
        "encoder": {
            "mode": "downsample-prediction",
            "decoder_arch": "dpt",
            "downsampler_arch": "featup",
            "encoder_arch": "vit-s",
            "version": "v1",
            "separate_gt_version": "v1",
            "dim_reduction_arch": "mlp",
            "num_ch_enc": (16, 16, 32, 32),
            "intermediate_features": (0, 1, 2),
            "decoder_out_dim": 32,
            "dino_pca_dim": 16,
            "image_size": (48, 96),
            "vit_overrides": {"width": 64, "depth": 3, "num_heads": 2},
        },
        "code": {"num_freqs": 6, "freq_factor": 1.5, "include_input": True},
        "decoder_heads": [{"type": "resnet", "name": "normal_head", "args": {"n_blocks": 0, "d_hidden": 64}}],
        "final_prediction_head": "normal_head",
    },
    "renderer": {"n_coarse": 8, "lindisp": True, "hard_alpha_cap": True},
    "training": {
        "optimizer": {"args": {"lr": 1.0e-4}},
        "ray_sampler": {"z_near": 3, "z_far": 80, "sample_mode": "patch",
                        "args": {"patch_size": 8, "ray_batch_size": 256}},
    },
}
