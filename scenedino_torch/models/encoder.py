"""The DINO encoder stack (counterpart of `scenedino_tpu/models/encoder.py`).

Inputs are images in [-1, 1]; the ViTs see ImageNet-normalized [0, 1]
images. The DINOv2 family (versions v2, reg and fit3d: internal patch 14)
sees them resized by 14/16 with `jax.image.resize`'s antialiased bilinear
filter (`core.resize.jax_resize`), so its grid is that of an
external patch of 16. `DinoModule` is the student (ViT + decoder: DPT,
the simple feature pyramid, or `NoDecoder`'s resize for `decoder_arch`
nearest / bilinear / bicubic) that serving runs; built with
`training=True` it also holds the training-only parts: the frozen teacher
ViT (`gt_encoder`, run without a graph like the reference's
`stop_gradient`; with `separate_gt_version: None` the student is its own
teacher), and for `mode: downsample-prediction` the FeatUp
`PatchSalienceDownsampler` (or, for `downsampler_arch: bilinear`, the
`BilinearDownsampler`) that pools rendered pixel features back to the
teacher's patch grid, or for `mode: upsample-gt` the teacher upsampler
(`models.upsampler`: `InterpolatedGT`, `MultiScaleCropGT`) that brings
the teacher to the pixels; and the dimension reduction that expands the
64-d field feature to the 768-d DINO space (`MlpDimReduction`,
`OrthogonalLinearDimReduction` for `dim_reduction_arch:
orthogonal-linear`, the identity for `none`). `flip_avg_gt` averages the
teacher with its run on the mirrored image; `encoder_freeze` passes no
gradient into the student ViT.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from scenedino_torch.core import safe_normalize
from scenedino_torch.core.resize import jax_resize, torch_interpolate
from scenedino_torch.models.dpt import DPTHead, NoDecoder, SimpleFeaturePyramidDecoder
from scenedino_torch.models.upsampler import InterpolatedGT, MultiScaleCropGT
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
            x = jax_resize(x, (H * 14 // 16, W * 14 // 16), "bilinear")
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


class BilinearDownsampler(nn.Module):
    """Pixel features to the patch grid by `F.interpolate(mode="bilinear")`,
    a 2x2-tap point sample at the output pixel centres, not an area mean
    (encoder.py:164-184): x (B, V, H, W, 1, C) -> (B, V, H/P, W/P, C). A
    patch batch (B, PC, P, P, 1, C) gives (B, PC, 1, 1, C)."""

    def __init__(self, patch_size: int = 16):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x: torch.Tensor, mode: str = "image") -> torch.Tensor:
        B, V, H, W, _, C = x.shape
        th, tw = H // self.patch_size, W // self.patch_size
        out = torch_interpolate(x.reshape(B * V, H, W, C).float(), (th, tw), mode="bilinear")
        return out.reshape(B, V, th, tw, C)


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

    mode: str = "downsample-prediction"  # | "upsample-gt"
    downsampler_arch: Optional[str] = "featup"  # | "bilinear"
    upsampler_arch: Optional[str] = None  # upsample-gt: "nearest" | "bilinear" | "bicubic" | "multiscale-crop"
    separate_gt_version: Optional[str] = "v1"
    dim_reduction_arch: str = "mlp"
    dino_pca_dim: int = 64
    encoder_freeze: bool = False
    flip_avg_gt: bool = False
    decoder_arch: str = "dpt"  # | "spf" | "nearest" | "bilinear" | "bicubic"
    encoder_arch: str = "vit-b"
    version: str = "v1"
    num_ch_enc: Tuple[int, ...] = (64, 64, 128, 256)
    intermediate_features: Tuple[int, ...] = (3, 6, 9)
    decoder_out_dim: int = 256
    image_size: Tuple[int, int] = (192, 640)  # the NoDecoder and teacher-upsampler output size
    key_features: bool = False
    grad_checkpointing: bool = False  # recompute the *student* ViT blocks in the backward
    dtype: Optional[torch.dtype] = None  # compute dtype: None (fp32) or torch.bfloat16
    vit_overrides: Optional[Tuple[Tuple[str, int], ...]] = None  # e.g. (("depth", 3), ("width", 64))


NO_DECODERS = ("nearest", "bilinear", "bicubic")


def make_decoder(cfg: DinoModuleConfig, vit_width: int) -> nn.Module:
    """The student's decoder for `cfg.decoder_arch` (encoder.py:291-319)."""
    if cfg.decoder_arch == "dpt":
        return DPTHead(vit_width, tuple(cfg.num_ch_enc), cfg.decoder_out_dim, cfg.dtype)
    if cfg.decoder_arch in NO_DECODERS:
        return NoDecoder(cfg.image_size, cfg.decoder_arch)
    if cfg.decoder_arch == "spf":  # fixed decoder widths, 4 scales, skips (dinov2_module.py:37-47)
        return SimpleFeaturePyramidDecoder(vit_width, tuple(cfg.num_ch_enc), (128, 128, 256, 256, 512),
                                           cfg.decoder_out_dim, (0, 1, 2, 3), True)
    raise NotImplementedError(f"unknown decoder_arch {cfg.decoder_arch!r}")


def make_gt_upsampler(cfg: DinoModuleConfig) -> nn.Module:
    """The teacher upsampler of `mode: upsample-gt` (encoder.py:344-352)."""
    if cfg.upsampler_arch in ("nearest", "bilinear", "bicubic"):
        return InterpolatedGT(cfg.upsampler_arch, cfg.image_size)
    if cfg.upsampler_arch == "multiscale-crop":
        return MultiScaleCropGT(4)
    raise NotImplementedError(f"unknown upsampler_arch {cfg.upsampler_arch!r}")


class DinoModule(nn.Module):
    """Student encoder: forward(x (B, 3, H, W) in [-1, 1]) -> [(B, d_out, Hf, Wf), ...];
    with `training=True` also the teacher (`forward(x, ground_truth=True)`),
    `downsample` and `expand_dim`."""

    def __init__(self, cfg: DinoModuleConfig, training: bool = False):
        super().__init__()
        self.cfg = cfg
        self.training_parts = training
        self.vit_encoder = DinoViTEncoder(
            backbone=cfg.encoder_arch,
            version=cfg.version,
            intermediate_features=tuple(cfg.intermediate_features),
            key_features=cfg.key_features,
            dtype=cfg.dtype,
            vit_overrides=cfg.vit_overrides,
            grad_checkpointing=cfg.grad_checkpointing,
        )
        self.decoder = make_decoder(cfg, self.vit_encoder.latent_size)
        if not training:
            return
        if cfg.mode not in ("downsample-prediction", "upsample-gt"):
            raise NotImplementedError(f"unknown encoder mode {cfg.mode!r}")
        if cfg.dim_reduction_arch not in DIM_REDUCTIONS and cfg.dim_reduction_arch != "none":
            raise NotImplementedError(f"unknown dim_reduction_arch {cfg.dim_reduction_arch!r}")
        if cfg.separate_gt_version is not None:
            self.gt_encoder = DinoViTEncoder(
                backbone=cfg.encoder_arch,
                version=cfg.separate_gt_version,
                intermediate_features=(),
                key_features=cfg.key_features,
                dtype=cfg.dtype,
                vit_overrides=cfg.vit_overrides,
            )
            self.gt_encoder.requires_grad_(False)
        if cfg.mode == "downsample-prediction":
            if cfg.downsampler_arch == "featup":
                self.downsampler = PatchSalienceDownsampler(self.teacher.latent_size, self.gt_patch_size)
            elif cfg.downsampler_arch == "bilinear":
                self.downsampler = BilinearDownsampler(self.gt_patch_size)
            else:
                raise NotImplementedError(f"unknown downsampler_arch {cfg.downsampler_arch!r}")
        else:
            self.gt_upsampler = make_gt_upsampler(cfg)
        if cfg.dim_reduction_arch != "none":
            self.dim_reduction = DIM_REDUCTIONS[cfg.dim_reduction_arch](cfg.dino_pca_dim,
                                                                        self.vit_encoder.latent_size)

    @property
    def latent_size(self) -> int:
        """Channels of the student's feature map: the decoder's width, or
        the ViT's where the grid is only resized (`NoDecoder`)."""
        if self.cfg.decoder_arch in NO_DECODERS:
            return self.vit_encoder.latent_size
        return self.cfg.decoder_out_dim

    @property
    def teacher(self) -> "DinoViTEncoder":
        """The frozen teacher ViT: `gt_encoder`, or the student's ViT itself
        with `separate_gt_version: None`."""
        gt = self._modules.get("gt_encoder")
        return self.vit_encoder if gt is None else gt

    @property
    def crop_views(self) -> int:
        """Crops the teacher draws per image (`models.upsampler.CropDraws`):
        0 unless its upsampler is the multiscale-crop one."""
        up = self._modules.get("gt_upsampler")
        return up.crop_views if up is not None else 0

    @property
    def gt_patch_size(self) -> int:
        """External patch size of the teacher (8 for DINO v1, 16 for v1_16 and
        the DINOv2 family), read from the config as the reference reads it."""
        return external_patch_size(self.cfg.separate_gt_version or self.cfg.version)

    def forward(self, x: torch.Tensor, ground_truth: bool = False,
                fold_matrix: Optional[torch.Tensor] = None, crops=None) -> List[torch.Tensor]:
        """The student's maps; with `ground_truth` the teacher's features,
        without a graph: the patch grid, or with `mode: upsample-gt` the
        per-pixel map (`crops`: the multiscale-crop teacher's draws)."""
        cfg = self.cfg
        if ground_truth:
            if not self.training_parts:
                raise RuntimeError("the teacher exists only in a DinoModule built with training=True")
            with torch.no_grad():
                if cfg.mode == "upsample-gt":
                    return [self.gt_upsampler(self.teacher, x, crops)]
                gt = self.teacher(x)[-1]
                if cfg.flip_avg_gt:
                    gt = safe_normalize(gt + self.teacher(x.flip(-1))[-1].flip(-1), dim=1, eps=1e-12)
                return [gt]
        with torch.set_grad_enabled(torch.is_grad_enabled() and not cfg.encoder_freeze):
            feats = self.vit_encoder(x)
        if cfg.decoder_arch == "dpt":
            return self.decoder(feats, fold_matrix=fold_matrix)
        if fold_matrix is not None:
            raise NotImplementedError("fold_matrix requires the DPT decoder")
        return self.decoder(feats)

    def downsample(self, x: torch.Tensor, mode: str = "patch") -> Optional[torch.Tensor]:
        """The prediction pooled to the teacher's grid; None in upsample-gt mode."""
        if self.cfg.mode != "downsample-prediction":
            return None
        return self.downsampler(x, mode)

    def expand_dim(self, features: torch.Tensor) -> torch.Tensor:
        dim_reduction = self._modules.get("dim_reduction")
        return features if dim_reduction is None else dim_reduction(features)
