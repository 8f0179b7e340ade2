"""DINO-family Vision Transformer (counterpart of `scenedino_tpu/models/vit.py`).

Pre-LN timm blocks with exact GELU and LayerNorm eps 1e-6, optional
LayerScale and register tokens, feature taps returned from the forward
pass: "features_normalized" (L2-normalized final-norm tokens),
"intermediate_features.{i}" (raw block outputs at the configured depths)
and "key_features" (the last block's keys), prefix tokens stripped.

The residual stream is fp32 like the reference's (its fp32 class token
promotes the concatenated tokens); each sublayer computes in the compute
dtype. Attention makes the reference's choice: the K1 kernel
(`kernels.attention`) for a bf16 ViT at N >= 512 tokens on CUDA, else
`dot_product_attention`, the counterpart of `jax.nn.dot_product_attention`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from scenedino_torch.core import safe_normalize
from scenedino_torch.core.resize import torch_interpolate
from scenedino_torch.kernels import attention
from scenedino_torch.models.layers import conv2d, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_registers: int = 0  # 4 for DINOv2-reg
    layerscale: bool = False  # True for DINOv2
    class_token: bool = True
    ln_eps: float = 1e-6
    pos_embed_size: Tuple[int, int] = (224, 224)  # grid the stored pos-embed was trained at
    intermediate_layers: Tuple[int, ...] = (3, 6, 9)
    dtype: Optional[torch.dtype] = None  # compute dtype; parameters stay fp32
    # recompute each block's activations in the backward (the reference's
    # nn.remat); parameter names are unchanged
    remat: bool = False

    @property
    def num_pos_prefix_tokens(self) -> int:
        """Prefix tokens covered by the stored pos-embed (cls only)."""
        return 1 if self.class_token else 0

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.num_registers


VIT_PRESETS = {
    "dino_small8": ViTConfig(8, 384, 12, 6),
    "dino_small16": ViTConfig(16, 384, 12, 6),
    "dino_base8": ViTConfig(8, 768, 12, 12),
    "dino_base16": ViTConfig(16, 768, 12, 12),
    "dinov2_small": ViTConfig(14, 384, 12, 6, layerscale=True, pos_embed_size=(518, 518)),
    "dinov2_base": ViTConfig(14, 768, 12, 12, layerscale=True, pos_embed_size=(518, 518)),
    "dinov2_reg_small": ViTConfig(14, 384, 12, 6, num_registers=4, layerscale=True, pos_embed_size=(518, 518)),
    "dinov2_reg_base": ViTConfig(14, 768, 12, 12, num_registers=4, layerscale=True, pos_embed_size=(518, 518)),
    "fit3d_small": ViTConfig(14, 384, 12, 6, num_registers=4, layerscale=True, pos_embed_size=(518, 518)),
    "fit3d_base": ViTConfig(14, 768, 12, 12, num_registers=4, layerscale=True, pos_embed_size=(518, 518)),
    "mae_base": ViTConfig(16, 768, 12, 12),
    "vmae_large": ViTConfig(16, 1024, 24, 16),
    "synclr_base": ViTConfig(16, 768, 12, 12),
    "mocov3_base": ViTConfig(16, 768, 12, 12),
    "msn_base": ViTConfig(16, 768, 12, 12),
    "self_patch_small": ViTConfig(16, 384, 12, 6, class_token=False),
    "i_jepa_huge": ViTConfig(14, 1280, 32, 16, class_token=False),
}


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_orig, grid_new,
                          num_prefix_tokens: int = 1) -> torch.Tensor:
    """Bicubic-resize the patch position embeddings (1, T + Gh*Gw, C) to a
    new grid: torch bicubic (a = -0.75), align_corners=False, no antialias,
    as two matmuls with cached matrices (`core.resize`)."""
    if tuple(grid_orig) == tuple(grid_new):
        return pos_embed
    prefix, patch = pos_embed[:, :num_prefix_tokens], pos_embed[:, num_prefix_tokens:]
    gh, gw = grid_orig
    patch = torch_interpolate(patch.reshape(1, gh, gw, -1), tuple(grid_new), mode="bicubic")
    return torch.cat([prefix, patch.reshape(1, grid_new[0] * grid_new[1], -1)], 1)


def flash_attention_wanted(use_flash: Optional[bool], dtype, n_tokens: int, device: torch.device) -> bool:
    """The reference's choice (scenedino_tpu/models/vit.py:183-188): a
    forced `use_flash`, else the K1 kernel for bf16 compute, N >= 512 and a
    CUDA tensor (the TPU's counterpart)."""
    if use_flash is not None:
        return use_flash
    return dtype == torch.bfloat16 and n_tokens >= 512 and device.type == "cuda"


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, N, H, D), as
    `jax.nn.dot_product_attention` computes it: logits in fp32, scaled after
    the product, softmax in fp32, probabilities cast to the input dtype and
    the product with v in the input dtype."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * q.shape[-1] ** -0.5
    probs = torch.softmax(logits, -1).to(k.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


class Attention(nn.Module):
    """timm MHSA with a qkv projection; optionally returns the keys.
    `use_flash`: None chooses as `flash_attention_wanted` does; a bool forces."""

    def __init__(self, dim: int, num_heads: int, dtype=None, use_flash: Optional[bool] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_flash = use_flash
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, return_keys: bool = False):
        B, N, C = x.shape
        H = self.num_heads
        qkv = linear(x, self.qkv, self.dtype).reshape(B, N, 3, H, C // H)
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))  # (B, N, H, D)
        if flash_attention_wanted(self.use_flash, self.dtype, N, x.device):
            out = attention(q, k, v)
        else:
            out = dot_product_attention(q, k, v)
        out = linear(out.reshape(B, N, C), self.proj, self.dtype)
        if return_keys:
            return out, k.transpose(1, 2)  # (B, H, N, D) like timm's getitem_4
        return out


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block with optional LayerScale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, layerscale: bool,
                 ln_eps: float, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        if layerscale:
            self.ls1 = nn.Parameter(torch.full((dim,), 1e-5))
            self.ls2 = nn.Parameter(torch.full((dim,), 1e-5))
        self.layerscale = layerscale

    def forward(self, x: torch.Tensor, return_keys: bool = False):
        h = layer_norm(x, self.norm1, self.dtype)
        keys = None
        if return_keys:
            h, keys = self.attn(h, return_keys=True)
        else:
            h = self.attn(h)
        if self.layerscale:
            h = h * self.ls1.to(h.dtype)
        x = x + h
        h = self.mlp(layer_norm(x, self.norm2, self.dtype))
        if self.layerscale:
            h = h * self.ls2.to(h.dtype)
        x = x + h
        return (x, keys) if return_keys else x


class VisionTransformer(nn.Module):
    """forward(images (B, 3, H, W), ImageNet-normalized) -> dict of taps."""

    def __init__(self, cfg: ViTConfig, want_key_features: bool = False):
        super().__init__()
        self.cfg = cfg
        self.want_key_features = want_key_features
        P, C = cfg.patch_size, cfg.width
        self.patch_embed = nn.Conv2d(3, C, P, stride=P)
        if cfg.class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        if cfg.num_registers > 0:
            self.reg_token = nn.Parameter(torch.zeros(1, cfg.num_registers, C))
        g0 = (cfg.pos_embed_size[0] // P, cfg.pos_embed_size[1] // P)
        self.grid0 = g0
        self.pos_embed = nn.Parameter(
            torch.randn(1, cfg.num_pos_prefix_tokens + g0[0] * g0[1], C) * 0.02
        )
        self.blocks = nn.ModuleList(
            Block(C, cfg.num_heads, cfg.mlp_ratio, cfg.layerscale, cfg.ln_eps, cfg.dtype)
            for _ in range(cfg.depth)
        )
        self.norm = nn.LayerNorm(C, eps=cfg.ln_eps)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, _, H, W = images.shape
        P = cfg.patch_size
        gh, gw = H // P, W // P
        T = cfg.num_prefix_tokens
        x = conv2d(images, self.patch_embed, cfg.dtype).flatten(2).transpose(1, 2).float()
        tokens = []
        if cfg.class_token:
            tokens.append(self.cls_token.float().expand(B, -1, -1))
        if cfg.num_registers > 0:
            tokens.append(self.reg_token.float().expand(B, -1, -1))
        x = torch.cat(tokens + [x], 1)

        Tp = cfg.num_pos_prefix_tokens
        pos = interpolate_pos_embed(self.pos_embed.float(), self.grid0, (gh, gw), num_prefix_tokens=Tp)
        if cfg.num_registers > 0:  # registers carry no positional code
            zeros = pos.new_zeros(1, cfg.num_registers, cfg.width)
            pos = torch.cat([pos[:, :Tp], zeros, pos[:, Tp:]], 1)
        x = x + pos

        out: Dict[str, torch.Tensor] = {}
        taps = sorted(set(cfg.intermediate_layers))
        key_feats = None
        for i, blk in enumerate(self.blocks):
            if i == cfg.depth - 1 and self.want_key_features:
                x, key_feats = blk(x, return_keys=True)
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
            if i in taps:
                out[f"intermediate_features.{taps.index(i)}"] = x[:, T:]
        feats = layer_norm(x, self.norm, cfg.dtype)[:, T:]
        out["features_normalized"] = safe_normalize(feats, dim=-1, eps=1e-12)
        if key_feats is not None:
            out["key_features"] = key_feats[:, :, T:]
        return out


def make_vit(name: str, intermediate_layers: Sequence[int] = (3, 6, 9),
             want_key_features: bool = False, dtype=None, overrides=None) -> VisionTransformer:
    cfg = dataclasses.replace(
        VIT_PRESETS[name], intermediate_layers=tuple(intermediate_layers), dtype=dtype,
        **(overrides or {}),
    )
    return VisionTransformer(cfg, want_key_features=want_key_features)
