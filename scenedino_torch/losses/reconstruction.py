"""The stage-1 reconstruction loss (counterpart of
`scenedino_tpu/losses/reconstruction.py:134-199`) with the shipped terms
(configs/training/loss/scenedino.yaml):

  * photometric "l1+ssim", amin over the render views, masked by the
    "weight_guided" invalid policy;
  * cosine DINO distance between the patch-pooled prediction and the
    teacher, `nanmean`;
  * edge-aware smoothness of the normalized inverse depth (1e-3) and of
    the per-pixel 768-d DINO prediction (0.25, temperature 25).

Data are patch-shaped: rgb (B, PC, P, P, V, 3), rgb_gt (B, PC, P, P, 3),
depth (B, PC, P, P), invalid (B, PC, P, P, K, V), weights
(B, PC, P, P, K), dino_features (B, PC, P, P, C),
dino_features_downsampled and dino_gt (B, PC, 1, 1, C).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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


def invalid_mask(invalids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """"weight_guided": a ray is invalid when, in every render view, more
    than 0.9 of its weight lies on invalid samples. (..., K, V), (..., K) -> (..., 1) bool."""
    w = torch.sum(invalids * weights[..., None], -2)
    return torch.all(w > 0.9, -1, keepdim=True)


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
    if (cfg.criterion, cfg.dino_criterion, cfg.invalid_policy) != ("l1+ssim", "cosine", "weight_guided") \
            or cfg.lambda_fine > 0 or cfg.median_thresholding:
        raise NotImplementedError(
            "the port's reconstruction loss has the shipped terms: l1+ssim, cosine DINO, the "
            f"weight_guided invalid policy, coarse only; got {cfg}"
        )
    losses = {}
    coarse = data["coarse"]
    inv = invalid_mask(coarse["invalid"], coarse["weights"])

    rgb = coarse["rgb"]  # (B, PC, H, W, V, 3)
    B, PC, H, W, V, C = rgb.shape
    gt = data["rgb_gt"][..., None, :3].expand(rgb.shape)
    pred = rgb.permute(0, 1, 4, 5, 2, 3).reshape(-1, C, H, W)
    gt = gt.permute(0, 1, 4, 5, 2, 3).reshape(-1, C, H, W)
    err = l1_ssim(pred, gt).reshape(B, PC, V, H, W).permute(0, 1, 3, 4, 2)
    err = torch.amin(err, -1) * (1.0 - inv[..., 0].to(err.dtype))
    losses["loss_rgb_coarse"] = err.mean()
    total = losses["loss_rgb_coarse"] * cfg.lambda_coarse

    if cfg.reconstruct_dino:
        dino = coarse.get("dino_features_downsampled", coarse["dino_features"])
        d_err = cosine_error(cfg.temperature_dino * dino, cfg.temperature_dino * data["dino_gt"])
        losses["loss_dino_coarse"] = torch.nanmean(d_err)
        total = total + losses["loss_dino_coarse"] * cfg.lambda_coarse * cfg.lambda_dino_coarse

    gt_img = _to_image_layout(data["rgb_gt"][..., :3])
    if cfg.lambda_edge_aware_smoothness > 0:
        disp = 1.0 / clip(coarse["depth"].reshape(-1, 1, H, W), 1e-3, 80.0)
        disp = disp / disp.mean((2, 3), keepdim=True)
        losses["edge_aware_smoothness"] = edge_aware_smoothness(gt_img, disp, temperature=1.0).mean()
        total = total + losses["edge_aware_smoothness"] * cfg.lambda_edge_aware_smoothness

    if cfg.lambda_dino_edge_aware_smoothness > 0:
        dino_img = _to_image_layout(coarse["dino_features"])
        losses["dino_edge_aware_smoothness"] = edge_aware_smoothness(gt_img, dino_img, temperature=25.0).mean()
        total = total + losses["dino_edge_aware_smoothness"] * cfg.lambda_dino_edge_aware_smoothness

    losses["rec_loss"] = total
    return losses
