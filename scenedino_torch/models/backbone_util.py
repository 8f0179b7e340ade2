"""Backbone factory (counterpart of `scenedino_tpu/models/backbone_util.py`;
reference `scenedino/models/backbones/backbone_util.py:7-19`): the DINO
stack, or Monodepth2 (the S4C baseline's encoder). pixelNeRF's spatial and
global encoders and IBRNet come in slice 22 (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

SLICE_22 = ("spatial", "global", "ibrnet")


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
    if kind in SLICE_22:
        raise NotImplementedError(f"backbone {kind!r} comes in slice 22 (ROADMAP queue 1)")
    raise NotImplementedError(f"backbone {kind!r}: dino, dinov2 and monodepth2 are implemented")
