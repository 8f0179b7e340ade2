"""The stage-1 reconstruction loss (counterpart of
`scenedino_tpu/losses/reconstruction.py:134-199`):

  * the photometric error ("l1", "l2" or "l1+ssim"), amin over the render
    views, masked by the invalid policy ("none", "strict",
    "weight_guided", "weight_guided_diverse" or "occ_weight_guided");
  * cosine DINO distance between the patch-pooled prediction and the
    teacher, `nanmean` (the reference computes the cosine whatever
    `dino_criterion` says, and so does the port);
  * edge-aware smoothness of the normalized inverse depth and of the
    per-pixel 768-d DINO prediction (temperature 25).

`lambda_fine` and `median_thresholding` are stored and never read, as in
the reference, whose body reads only `data["coarse"]`.

Data are patch-shaped: rgb (B, PC, P, P, V, 3), rgb_gt (B, PC, P, P, 3),
depth (B, PC, P, P), invalid (B, PC, P, P, K, V), weights
(B, PC, P, P, K), rgb_samps (B, PC, P, P, K, V, 3) and occ
(B, PC, P, P, 1) where a policy needs them, dino_features
(B, PC, P, P, C), dino_features_downsampled and dino_gt (B, PC, 1, 1, C).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from scenedino_torch.core import absolute, clip, safe_normalize
from scenedino_torch.losses.ssim import l1_ssim


@dataclasses.dataclass(frozen=True)
class ReconstructionLossConfig:
    criterion: str = "l1+ssim"
    dino_criterion: str = "cosine"
    invalid_policy: str = "weight_guided"
    lambda_coarse: float = 1.0
    lambda_fine: float = 0.0
    reconstruct_dino: bool = True
    lambda_dino_coarse: float = 0.2
    temperature_dino: float = 5.0
    lambda_edge_aware_smoothness: float = 0.001
    lambda_dino_edge_aware_smoothness: float = 0.25
    median_thresholding: bool = False


def cosine_error(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """1 - cosine similarity over the last axis, finite at zero vectors."""
    return 1.0 - torch.sum(safe_normalize(pred, eps=eps) * safe_normalize(gt, eps=eps), -1)


def reconstruction_error(pred: torch.Tensor, gt: torch.Tensor, criterion: str) -> torch.Tensor:
    """Per-pixel error of (B*, C, H, W) images -> (B*, H, W) (reconstruction.py:47-58)."""
    if criterion == "l1":
        return absolute(pred - gt).mean(1)
    if criterion == "l2":
        return ((pred - gt) ** 2 / 2.0).mean(1)
    if criterion == "l1+ssim":
        return l1_ssim(pred, gt)
    raise ValueError(criterion)


def invalid_mask(invalids: torch.Tensor, weights: torch.Tensor, policy: str = "weight_guided",
                 rgb_samps: Optional[torch.Tensor] = None, occ: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-ray bool mask of unreliable supervision (reconstruction.py:71-108):
    invalids (..., K, V) in [0, 1], weights (..., K) -> (..., 1).
    "weight_guided": in every render view more than 0.9 of the weight lies
    on invalid samples; "weight_guided_diverse" also drops rays whose
    colour samples (rgb_samps (..., K, V, 3)) barely vary along the ray;
    "occ_weight_guided" also drops rays without an occupancy proposal
    (occ (..., 1) <= 0.5)."""
    if policy in (None, "none"):
        return torch.zeros(invalids.shape[:-2] + (1,), dtype=torch.bool, device=invalids.device)
    if policy == "strict":
        return torch.all(torch.any(invalids > 0.5, -2), -1, keepdim=True)
    if policy not in ("weight_guided", "weight_guided_diverse", "occ_weight_guided"):
        raise ValueError(policy)
    w = torch.sum(invalids * weights[..., None], -2)  # (..., V)
    if policy == "weight_guided":
        return torch.all(w > 0.9, -1, keepdim=True)
    if policy == "weight_guided_diverse":
        if rgb_samps is None:
            raise ValueError("invalid_policy 'weight_guided_diverse' needs the colour samples (rgb_samps)")
        ray_std = torch.std(rgb_samps, -3, correction=0).mean(-1)  # (..., V)
        return torch.all((w > 0.9) | (ray_std < 0.01), -1, keepdim=True)
    if occ is None:
        raise ValueError("invalid_policy 'occ_weight_guided' needs the occupancy proposals (occ)")
    return torch.all(w > 0.9, -1, keepdim=True) | ~(occ > 0.5)


def edge_aware_smoothness(gt_img: torch.Tensor, inp: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """First-order smoothness of inp (B, C, H, W) weighted by exp(-t |grad gt_img|)
    (gt_img (B, 3, H, W)). Returns (B, H, W)."""
    dx = absolute(inp[:, :, :, :-1] - inp[:, :, :, 1:]).mean(1, keepdim=True)
    dy = absolute(inp[:, :, :-1, :] - inp[:, :, 1:, :]).mean(1, keepdim=True)
    i_dx = absolute(gt_img[:, :, :, :-1] - gt_img[:, :, :, 1:]).mean(1, keepdim=True)
    i_dy = absolute(gt_img[:, :, :-1, :] - gt_img[:, :, 1:, :]).mean(1, keepdim=True)
    dx = dx * torch.exp(-temperature * i_dx)
    dy = dy * torch.exp(-temperature * i_dy)
    return (F.pad(dx, (0, 1)) + F.pad(dy, (0, 0, 0, 1)))[:, 0]


def _to_image_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, PC, H, W, C) -> (B*PC, C, H, W)."""
    B, PC, H, W, C = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(B * PC, C, H, W)


def reconstruction_loss(data: Dict, cfg: ReconstructionLossConfig = ReconstructionLossConfig()
                        ) -> Dict[str, torch.Tensor]:
    """The stage-1 loss dict; "rec_loss" is the optimized total."""
    losses = {}
    coarse = data["coarse"]
    inv = invalid_mask(coarse["invalid"], coarse["weights"], cfg.invalid_policy,
                       rgb_samps=coarse.get("rgb_samps"), occ=coarse.get("occ"))

    rgb = coarse["rgb"]  # (B, PC, H, W, V, 3)
    B, PC, H, W, V, C = rgb.shape
    gt = data["rgb_gt"][..., None, :3].expand(rgb.shape)
    pred = rgb.permute(0, 1, 4, 5, 2, 3).reshape(-1, C, H, W)
    gt = gt.permute(0, 1, 4, 5, 2, 3).reshape(-1, C, H, W)
    err = reconstruction_error(pred, gt, cfg.criterion).reshape(B, PC, V, H, W).permute(0, 1, 3, 4, 2)
    err = torch.amin(err, -1) * (1.0 - inv[..., 0].to(err.dtype))
    losses["loss_rgb_coarse"] = err.mean()
    total = losses["loss_rgb_coarse"] * cfg.lambda_coarse

    if cfg.reconstruct_dino and "dino_features" in coarse:
        dino = coarse.get("dino_features_downsampled", coarse["dino_features"])
        d_err = cosine_error(cfg.temperature_dino * dino, cfg.temperature_dino * data["dino_gt"])
        losses["loss_dino_coarse"] = torch.nanmean(d_err)
        total = total + losses["loss_dino_coarse"] * cfg.lambda_coarse * cfg.lambda_dino_coarse

    gt_img = _to_image_layout(data["rgb_gt"][..., :3])
    if cfg.lambda_edge_aware_smoothness > 0 and "depth" in coarse:
        disp = 1.0 / clip(coarse["depth"].reshape(-1, 1, H, W), 1e-3, 80.0)
        disp = disp / disp.mean((2, 3), keepdim=True)
        losses["edge_aware_smoothness"] = edge_aware_smoothness(gt_img, disp, temperature=1.0).mean()
        total = total + losses["edge_aware_smoothness"] * cfg.lambda_edge_aware_smoothness

    if cfg.lambda_dino_edge_aware_smoothness > 0 and "dino_features" in coarse:
        dino_img = _to_image_layout(coarse["dino_features"])
        losses["dino_edge_aware_smoothness"] = edge_aware_smoothness(gt_img, dino_img, temperature=25.0).mean()
        total = total + losses["dino_edge_aware_smoothness"] * cfg.lambda_dino_edge_aware_smoothness

    losses["rec_loss"] = total
    return losses
