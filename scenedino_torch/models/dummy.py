"""Dummy encoders for overfit and debug runs (counterpart of
`scenedino_tpu/models/dummy.py`; reference
`scenedino/training/trainer_overfit.py:21-44`).

`DinoDummyEncoder` replaces the ViT with learned constant maps, so the
field, the renderer and the losses run end to end without pretrained
weights: the student's map is a learned (1, feat_dim, H, W) tensor, the
teacher's a learned (1, dino_dim, H/P, W/P) patch grid given without a
graph (the frozen teacher's stop-gradient). It carries a DINO encoder's
interface (`latent_size`, `teacher`, `gt_patch_size`, `crop_views`,
`downsample` through `BilinearDownsampler`, `expand_dim` through
`MlpDimReduction` from `dino_pca_dim` to `dino_dim` channels), so the
stage-1 step runs unchanged. The other dummy, `field.EncoderDummy`, is
the reference's plain constant map.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from scenedino_torch.models.encoder import BilinearDownsampler, MlpDimReduction


@dataclasses.dataclass(frozen=True)
class GtInfo:
    """What the training step reads of a teacher: its patch size, image
    size and width."""

    patch_size: int
    image_size: Tuple[int, int]
    latent_size: int


class DinoDummyEncoder(nn.Module):
    """A learned constant student map and a learned constant teacher grid
    (EncoderDinoDummy, trainer_overfit.py:32-44)."""

    def __init__(self, size: Tuple[int, int], feat_dim: int = 16, dino_dim: int = 24, patch_size: int = 8,
                 dino_pca_dim: int = 8):
        super().__init__()
        H, W = size
        self.size, self.feat_dim, self.dino_dim, self.patch_size = tuple(size), feat_dim, dino_dim, patch_size
        self.feat = nn.Parameter(torch.randn(1, feat_dim, H, W))
        self.gt_feat = nn.Parameter(torch.randn(1, dino_dim, H // patch_size, W // patch_size))
        self.dim_reduction = MlpDimReduction(dino_pca_dim, dino_dim, latent_channels=16)
        self.downsampler = BilinearDownsampler(patch_size)

    @property
    def latent_size(self) -> int:
        return self.feat_dim

    @property
    def teacher(self) -> GtInfo:
        return GtInfo(self.patch_size, self.size, self.dino_dim)

    @property
    def gt_patch_size(self) -> int:
        return self.patch_size

    @property
    def crop_views(self) -> int:
        return 0

    def forward(self, x: torch.Tensor, ground_truth: bool = False, fold_matrix: Optional[torch.Tensor] = None,
                crops=None) -> List[torch.Tensor]:
        """[the student's map (B, feat_dim, H, W)], or with `ground_truth`
        [the teacher's grid (B, dino_dim, H/P, W/P)] without a graph."""
        if fold_matrix is not None:
            raise ValueError("a dummy encoder has no final conv to fold a matrix into")
        B = x.shape[0]
        if ground_truth:
            return [self.gt_feat.detach().expand(B, *self.gt_feat.shape[1:])]
        return [self.feat.expand(B, *self.feat.shape[1:])]

    def downsample(self, x: torch.Tensor, mode: str = "patch") -> torch.Tensor:
        return self.downsampler(x, mode)

    def expand_dim(self, features: torch.Tensor) -> torch.Tensor:
        return self.dim_reduction(features)
