"""Optical-flow utilities of the flow-supervision processors (counterpart
of `scenedino_tpu/core/flow.py`; reference `scenedino/common/geometry.py:211-236`
and `scenedino/common/image_processor.py:190-263`).

`compute_occlusions` splats each frame's pixels along its flow into the
other frame; `pack_flow_channels` appends the normalized flow (and the
occlusion masks) of consecutive frame pairs to the images. The flow
network is any `flow_fn(img0, img1) -> (B, 2, H, W)` of pixel-unit flow,
e.g. `models.raft.make_raft_flow_fn`.
"""
from __future__ import annotations

import torch


def _ndc_flow(flow: torch.Tensor) -> torch.Tensor:
    H, W = flow.shape[-2:]
    return torch.cat([flow[:, 0:1] * 2.0 / W, flow[:, 1:2] * 2.0 / H], 1)


def compute_occlusions(flow0: torch.Tensor, flow1: torch.Tensor):
    """flow0 / flow1 (B, 2, H, W): forward and backward flow in pixels ->
    (mask0, mask1), each (B, 1, H, W) in {0, 1}: mask0[p] is 1 where some
    pixel of frame 1 lands on p under the backward flow. The landing pixel
    is the rounded (half to even) normalized position times the size,
    clipped to the frame: rows from y, columns from x (geometry.py:230-234)."""
    B, _, H, W = flow0.shape
    dev = flow0.device
    yy, xx = torch.meshgrid(torch.linspace(-1.0, 1.0, H, device=dev), torch.linspace(-1.0, 1.0, W, device=dev),
                            indexing="ij")
    xy = torch.stack([xx, yy])[None]
    xy_0 = (xy + _ndc_flow(flow0)).reshape(B, 2, -1)
    xy_1 = (xy + _ndc_flow(flow1)).reshape(B, 2, -1)

    def splat(xy_t):
        py = torch.round((xy_t[:, 1] * 0.5 + 0.5) * H).long().clamp(0, H - 1)
        px = torch.round((xy_t[:, 0] * 0.5 + 0.5) * W).long().clamp(0, W - 1)
        mask = torch.zeros(B, H * W, dtype=flow0.dtype, device=dev)
        mask.scatter_(1, py * W + px, 1.0)
        return mask.reshape(B, 1, H, W)

    return splat(xy_1), splat(xy_0)


def pack_flow_channels(images: torch.Tensor, flow_fwd: torch.Tensor, flow_bwd: torch.Tensor,
                       with_occlusions: bool = False) -> torch.Tensor:
    """images (B, V, C, H, W), V even: views (2p, 2p + 1) are a pair;
    flow_fwd / flow_bwd (B*V/2, 2, H, W) in pixels -> (B, V, C + 2 [+ 1], H, W):
    each view's image, its flow normalized by the frame's size, and with
    `with_occlusions` its occlusion mask."""
    B, V, C, H, W = images.shape
    img = images.reshape(B * V // 2, 2, C, H, W)
    parts = [img, torch.stack([_ndc_flow(flow_fwd), _ndc_flow(flow_bwd)], 1)]
    if with_occlusions:
        occ0, occ1 = compute_occlusions(flow_fwd, flow_bwd)
        parts.append(torch.stack([occ0, occ1], 1))
    return torch.cat(parts, 2).reshape(B, V, -1, H, W)
