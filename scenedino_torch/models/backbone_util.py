"""Backbone factory (counterpart of `scenedino_tpu/models/backbone_util.py`;
reference `scenedino/models/backbones/backbone_util.py:7-19`): the DINO
stack, Monodepth2 (the S4C baseline's encoder), pixelNeRF's spatial and
global encoders (`models.pixelnerf`) and IBRNet with NeuRay
(`models.multi_view_head.IBRNetWithNeuRay`); the shipped configs select
the DINO stack.
"""
from __future__ import annotations

from typing import Any, Dict

from torch import nn


def make_backbone(conf: Dict[str, Any], training: bool = False) -> nn.Module:
    """The encoder of an `encoder:` config block by its `type` (dino by
    default); `training` builds a DINO encoder's training-only parts."""
    kind = conf.get("type", "dino")
    if kind in ("dino", "dinov2"):
        from scenedino_torch.models.encoder import DinoModule
        from scenedino_torch.models.factory import encoder_config_from_dict

        return DinoModule(encoder_config_from_dict(conf), training=training)
    if kind == "monodepth2":
        from scenedino_torch.models.monodepth2 import Monodepth2

        return Monodepth2(d_out=conf.get("d_out", 128), scales=tuple(conf.get("scales", (0, 1, 2, 3))),
                          num_ch_dec=tuple(conf["num_ch_dec"]) if conf.get("num_ch_dec") else None)
    if kind == "spatial":
        from scenedino_torch.models.pixelnerf import SpatialEncoder

        return SpatialEncoder(backbone=conf.get("backbone", "resnet34"), num_layers=conf.get("num_layers", 4),
                              use_first_pool=conf.get("use_first_pool", True))
    if kind == "global":
        from scenedino_torch.models.pixelnerf import ImageEncoder

        return ImageEncoder(backbone=conf.get("backbone", "resnet34"), latent_size=conf.get("latent_size", 128))
    if kind == "ibrnet":
        from scenedino_torch.models.multi_view_head import IBRNetWithNeuRay

        return IBRNetWithNeuRay(neuray_in_dim=conf.get("neuray_in_dim", 32), in_feat_ch=conf.get("in_feat_ch", 32),
                                att_feat=conf.get("att_feat", 16), rbs=conf.get("rbs", 2048))
    raise NotImplementedError(f"backbone {kind!r}: dino, dinov2, monodepth2, spatial, global and ibrnet are "
                              "implemented")
