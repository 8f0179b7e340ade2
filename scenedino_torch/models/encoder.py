"""The DINO encoder stack (counterpart of `scenedino_tpu/models/encoder.py`).

Inputs are images in [-1, 1]; the ViTs see ImageNet-normalized [0, 1]
images. The DINOv2 family (versions v2, reg and fit3d: internal patch 14)
sees them resized by 14/16 with `jax.image.resize`'s antialiased bilinear
filter (`core.resize.antialias_resize`), so its grid is that of an
external patch of 16. `DinoModule` is the student (ViT + DPT decoder)
that serving runs; built with `training=True` it also holds the
training-only parts: the frozen teacher ViT (`gt_encoder`, run without a
graph like the reference's `stop_gradient`), the FeatUp
`PatchSalienceDownsampler` that pools rendered pixel features back to the
teacher's patch grid, and the dimension reduction that expands the 64-d
field feature to the 768-d DINO space (`MlpDimReduction`, or
`OrthogonalLinearDimReduction` for `dim_reduction_arch:
orthogonal-linear`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from scenedino_torch.core import safe_normalize
from scenedino_torch.core.resize import antialias_resize
from scenedino_torch.models.dpt import DPTHead
from scenedino_torch.models.vit import make_vit

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_input(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW images -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device, dtype=x.dtype)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device, dtype=x.dtype)[None, :, None, None]
    return (x * 0.5 + 0.5 - mean) / std


# versions whose ViT has patch 14 and sees the image resized by 14/16
RESIZED_VERSIONS = ("v2", "reg", "fit3d")


def _vit_name(backbone: str, version: str) -> str:
    size = {"vit-s": "small", "vit-b": "base"}[backbone]
    if version == "v1":
        return f"dino_{size}8"
    if version == "v1_16":
        return f"dino_{size}16"
    if version == "v2":
        return f"dinov2_{size}"
    if version == "reg":
        return f"dinov2_reg_{size}"
    if version == "fit3d":  # FiT3D: DINOv2-reg fine-tuned, the same architecture
        return f"fit3d_{size}"
    raise NotImplementedError(f"unknown DINO version {version!r}")


def external_patch_size(version: str) -> int:
    """The patch of the grid a version's encoder returns: 16 for v1_16 and
    the DINOv2 family (14 inside, after the 14/16 resize), else 8."""
    return 16 if version in RESIZED_VERSIONS + ("v1_16",) else 8


class DinoViTEncoder(nn.Module):
    """ViT wrapper returning [*intermediate grids (B, C, Gh, Gw), final normalized grid]."""

    def __init__(self, backbone: str = "vit-b", version: str = "v1",
                 intermediate_features: Tuple[int, ...] = (3, 6, 9), key_features: bool = False,
                 dtype=None, vit_overrides: Optional[Tuple[Tuple[str, int], ...]] = None,
                 grad_checkpointing: bool = False):
        super().__init__()
        self.version = version
        self.n_taps = len(intermediate_features)
        self.key_features = key_features
        overrides = dict(vit_overrides or ())
        if grad_checkpointing:
            overrides["remat"] = True
        self.vit = make_vit(
            _vit_name(backbone, version),
            intermediate_layers=tuple(intermediate_features),
            want_key_features=key_features,
            dtype=dtype,
            overrides=overrides or None,
        )

    @property
    def latent_size(self) -> int:
        return self.vit.cfg.width

    @property
    def patch_size(self) -> int:
        """External patch size: the stride of the returned grids in input pixels."""
        return external_patch_size(self.version)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = normalize_input(x)
        if self.version in RESIZED_VERSIONS:
            H, W = x.shape[-2:]
            x = antialias_resize(x, (H * 14 // 16, W * 14 // 16))
        out = self.vit(x)
        p = self.vit.cfg.patch_size
        gh, gw = x.shape[-2] // p, x.shape[-1] // p

        def to_grid(tokens):  # (B, N, C) -> (B, C, Gh, Gw)
            B, N, C = tokens.shape
            return tokens.transpose(1, 2).reshape(B, C, gh, gw)

        result = [to_grid(out[f"intermediate_features.{i}"]) for i in range(self.n_taps)]
        if self.key_features:
            kf = out["key_features"]  # (B, H, N, D)
            B, Hh, N, D = kf.shape
            result.append(to_grid(safe_normalize(kf.transpose(1, 2).reshape(B, N, Hh * D), eps=1e-12)))
        else:
            result.append(to_grid(out["features_normalized"]))
        return result


class MlpDimReduction(nn.Module):
    """64 -> 128 -> 768 with a ReLU, then L2-normalized (encoder.py:130-142)."""

    def __init__(self, reduced_channels: int = 64, full_channels: int = 768, latent_channels: int = 128):
        super().__init__()
        self.linear_in = nn.Linear(reduced_channels, latent_channels)
        self.linear_out = nn.Linear(latent_channels, full_channels)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.linear_in(features.float()))
        return safe_normalize(self.linear_out(h), eps=1e-12)


class OrthogonalLinearDimReduction(nn.Module):
    """A learned (full, reduced) matrix, initialized to the identity's first
    columns, applied transposed, plus a bias, then L2-normalized
    (encoder.py:145-161)."""

    def __init__(self, reduced_channels: int = 64, full_channels: int = 768):
        super().__init__()
        self.weights = nn.Parameter(torch.eye(full_channels, reduced_channels))
        self.bias = nn.Parameter(torch.zeros(full_channels))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return safe_normalize(features.float() @ self.weights.T + self.bias, eps=1e-12)


DIM_REDUCTIONS = {"mlp": MlpDimReduction, "orthogonal-linear": OrthogonalLinearDimReduction}


class PatchSalienceDownsampler(nn.Module):
    """FeatUp salience pooling (encoder.py:187-242): a 1x1-conv salience
    map, a learned per-patch-pixel weight and bias, a softmax over the
    patch's pixels, the weighted sum, then an L2 normalization."""

    def __init__(self, channels: int = 768, patch_size: int = 16):
        super().__init__()
        self.channels = channels
        self.patch_size = patch_size
        self.patch_weight = nn.Parameter(1.0 + 0.01 * torch.randn(patch_size, patch_size))
        self.patch_bias = nn.Parameter(0.01 * torch.randn(patch_size, patch_size))
        self.salience_conv = nn.Conv2d(channels, 1, 1)
        nn.init.kaiming_normal_(self.salience_conv.weight, mode="fan_in", nonlinearity="linear")
        nn.init.zeros_(self.salience_conv.bias)

    def forward(self, x: torch.Tensor, mode: str = "image") -> torch.Tensor:
        """"patch": x (B, Pn, P, P, 1, C) -> (B, Pn, C); "image": x (B, V, H, W, 1, C)
        -> (B, V, H/P, W/P, C)."""
        P, C = self.patch_size, x.shape[-1]
        if C != self.channels:
            raise ValueError(f"PatchSalienceDownsampler built for {self.channels}-d features, got {C}-d")
        x = x.float()
        if mode == "patch":
            B, Pn = x.shape[:2]
        elif mode == "image":
            B, V, H, W = x.shape[:4]
            gh, gw = H // P, W // P
            x = x.reshape(B, V, gh, P, gw, P, 1, C).transpose(3, 4).reshape(B, V * gh * gw, P, P, 1, C)
            Pn = V * gh * gw
        else:
            raise ValueError(f"mode must be 'patch' or 'image', got {mode!r}")
        w = self.salience_conv.weight.reshape(C).float()
        sal = x[..., 0, :] @ w + self.salience_conv.bias.float()  # (B, Pn, P, P)
        sal = sal * self.patch_weight + self.patch_bias
        wts = torch.softmax(sal.reshape(B, Pn, -1), -1).reshape(B, Pn, x.shape[2], x.shape[3], 1, 1)
        pooled = safe_normalize(torch.sum(wts * x, dim=(2, 3)), eps=1e-12)  # (B, Pn, 1, C)
        if mode == "patch":
            return pooled[..., 0, :]
        return pooled.reshape(B, V, gh, gw, C)


@dataclasses.dataclass(frozen=True)
class DinoModuleConfig:
    """The configs/model/dino_downsampler.yaml `encoder:` block. The
    teacher, downsampler and dimension-reduction fields are read only
    when the module is built for training."""

    mode: str = "downsample-prediction"
    downsampler_arch: Optional[str] = "featup"
    separate_gt_version: Optional[str] = "v1"
    dim_reduction_arch: str = "mlp"
    dino_pca_dim: int = 64
    encoder_freeze: bool = False
    flip_avg_gt: bool = False
    decoder_arch: str = "dpt"
    encoder_arch: str = "vit-b"
    version: str = "v1"
    num_ch_enc: Tuple[int, ...] = (64, 64, 128, 256)
    intermediate_features: Tuple[int, ...] = (3, 6, 9)
    decoder_out_dim: int = 256
    key_features: bool = False
    grad_checkpointing: bool = False  # recompute the *student* ViT blocks in the backward
    dtype: Optional[torch.dtype] = None  # compute dtype: None (fp32) or torch.bfloat16
    vit_overrides: Optional[Tuple[Tuple[str, int], ...]] = None  # e.g. (("depth", 3), ("width", 64))


class DinoModule(nn.Module):
    """Student encoder: forward(x (B, 3, H, W) in [-1, 1]) -> [(B, d_out, Hf, Wf)];
    with `training=True` also the teacher (`forward(x, ground_truth=True)`),
    `downsample` and `expand_dim`."""

    def __init__(self, cfg: DinoModuleConfig, training: bool = False):
        super().__init__()
        if cfg.decoder_arch != "dpt":
            raise NotImplementedError(f"the port covers the DPT decoder, got {cfg.decoder_arch!r}")
        self.cfg = cfg
        self.vit_encoder = DinoViTEncoder(
            backbone=cfg.encoder_arch,
            version=cfg.version,
            intermediate_features=tuple(cfg.intermediate_features),
            key_features=cfg.key_features,
            dtype=cfg.dtype,
            vit_overrides=cfg.vit_overrides,
            grad_checkpointing=cfg.grad_checkpointing,
        )
        self.decoder = DPTHead(self.vit_encoder.latent_size, tuple(cfg.num_ch_enc),
                               cfg.decoder_out_dim, cfg.dtype)
        if not training:
            return
        unsupported = {
            "mode": cfg.mode != "downsample-prediction",
            "downsampler_arch": cfg.downsampler_arch != "featup",
            "separate_gt_version": cfg.separate_gt_version is None,
            "dim_reduction_arch": cfg.dim_reduction_arch not in DIM_REDUCTIONS,
            "encoder_freeze": cfg.encoder_freeze,
            "flip_avg_gt": cfg.flip_avg_gt,
        }
        bad = [name for name, is_bad in unsupported.items() if is_bad]
        if bad:
            raise NotImplementedError(
                f"the port trains the downsample-prediction featup configuration with a separate teacher and "
                f"the MLP or orthogonal-linear expansion (the rest, the upsample-gt mode among it, waits in ROADMAP "
                f"queue 1, item 3); unsupported: {[(n, getattr(cfg, n)) for n in bad]}"
            )
        self.gt_encoder = DinoViTEncoder(
            backbone=cfg.encoder_arch,
            version=cfg.separate_gt_version,
            intermediate_features=(),
            key_features=cfg.key_features,
            dtype=cfg.dtype,
            vit_overrides=cfg.vit_overrides,
        )
        self.gt_encoder.requires_grad_(False)
        self.downsampler = PatchSalienceDownsampler(self.gt_encoder.latent_size, self.gt_patch_size)
        self.dim_reduction = DIM_REDUCTIONS[cfg.dim_reduction_arch](cfg.dino_pca_dim, self.vit_encoder.latent_size)

    @property
    def latent_size(self) -> int:
        return self.cfg.decoder_out_dim

    @property
    def gt_patch_size(self) -> int:
        """External patch size of the teacher (8 for DINO v1, 16 for v1_16 and
        the DINOv2 family), read from the config as the reference reads it."""
        return external_patch_size(self.cfg.separate_gt_version or self.cfg.version)

    def forward(self, x: torch.Tensor, ground_truth: bool = False,
                fold_matrix: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        if ground_truth:
            if not hasattr(self, "gt_encoder"):
                raise RuntimeError("the teacher exists only in a DinoModule built with training=True")
            with torch.no_grad():
                return [self.gt_encoder(x)[-1]]
        feats = self.vit_encoder(x)
        return self.decoder(feats, fold_matrix=fold_matrix)

    def downsample(self, x: torch.Tensor, mode: str = "patch") -> torch.Tensor:
        return self.downsampler(x, mode)

    def expand_dim(self, features: torch.Tensor) -> torch.Tensor:
        return self.dim_reduction(features)
