"""The legacy BTS multi-view attention heads and IBRNet with NeuRay
(counterpart of `scenedino_tpu/models/multi_view_head.py`; reference
`scenedino/models/prediction_heads/multi_view_head.py`,
`independent_tokens.py`, `mlp.py:302-616` and
`scenedino/models/backbones/ibrnet.py:243-403`).

A head takes the per-view features of each point, `sampled_features`
(..., V, d_in), with `invalid_features` (..., V) (bool) and reduces the view
axis itself: (..., 1, d_out). No shipped config selects these heads;
`heads.make_head` builds them by type.

The attention over the V + 1 view tokens is written out (matmul, softmax),
as JAX's einsums are. `nn.TransformerEncoder` is not used: its eval /
no-grad fast path turns a float key-padding mask from an additive bias
into -inf masking, while the reference trains these heads on the slow
path, where the mask is added to the logits. So:
- `MultiViewHead` adds its float 0/1 mask (`mask_mode="additive"`: a
  "masked" view's logits gain +1.0); `"fill"` gives -1e9 masking.
- The view dropout `1 - dropout(1 - invalid)` keeps torch's 1 / (1 - p)
  rescale in training, so a kept view's "invalid" value is negative,
  1 - 1 / (1 - p) (multi_view_head.py:101-111); with the additive mask it
  is a small bias. JAX draws the keep mask with `jax.random.bernoulli`;
  here it is an explicit input (`keep`) or drawn from a `torch.Generator`.
  In the field the heads run without it (`deterministic`), as in JAX.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch.models.heads import ResnetFC, _kaiming


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(..., S, H * d) -> (..., H, S, d)."""
    return t.reshape(*t.shape[:-1], H, -1).movedim(-2, -3)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(..., H, S, d) -> (..., S, H * d)."""
    t = t.movedim(-3, -2)
    return t.reshape(*t.shape[:-2], -1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class TorchEncoderLayer(nn.Module):
    """`nn.TransformerEncoderLayer` (batch first, post-norm, relu) on its
    slow path: a float key-padding mask (..., S) is added to the logits of
    those keys. Dropout off."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int, layer_norm_eps: float = 1e-5):
        super().__init__()
        assert d_model % n_heads == 0
        self.n_heads = n_heads
        self.in_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        H = self.n_heads
        q, k, v = (_heads(t, H) for t in self.in_proj(x).chunk(3, -1))
        logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if key_padding_mask is not None:
            logits = logits + key_padding_mask[..., None, None, :].to(logits.dtype)
        out = self.out_proj(_merge(torch.softmax(logits, -1) @ v))
        x = self.norm1(x + out)
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class IBREncoderLayer(nn.Module):
    """The IBR-style encoder layer (mlp.py EncoderLayer:555, post-norm):
    bias-free q / k / v / output projections, a point's invalid view
    removed as query and as key (-1e9 where either mask is 1), residual +
    LayerNorm (eps 1e-6) after the attention and after the FFN."""

    def __init__(self, d_model: int, n_heads: int, d_k: int, d_v: int, d_inner: int):
        super().__init__()
        self.n_heads = n_heads
        self.w_qs = nn.Linear(d_model, n_heads * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_heads * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_heads * d_v, bias=False)
        self.fc = nn.Linear(n_heads * d_v, d_model, bias=False)
        self.attn_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.w_1 = nn.Linear(d_model, d_inner)
        self.w_2 = nn.Linear(d_inner, d_model)
        self.ffn_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        H = self.n_heads
        q, k, v = _heads(self.w_qs(x), H), _heads(self.w_ks(x), H), _heads(self.w_vs(x), H)
        logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if key_padding_mask is not None:
            m = key_padding_mask.to(logits.dtype)
            m_sym = 1.0 - (1.0 - m[..., :, None]) * (1.0 - m[..., None, :])
            logits = torch.where(m_sym[..., None, :, :] == 1.0, torch.full_like(logits, -1e9), logits)
        x = self.attn_norm(x + self.fc(_merge(torch.softmax(logits, -1) @ v)))
        return self.ffn_norm(x + self.w_2(F.relu(self.w_1(x))))


class AttnStack(nn.Module):
    """`n_layers` encoder layers (make_attn_layers, multi_view_head.py:32-47):
    kind "torch" (additive float mask) or "ibr" (symmetric fill mask)."""

    def __init__(self, d_model: int, n_layers: int = 3, n_heads: int = 4, kind: str = "torch"):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            if kind == "torch":
                layer = TorchEncoderLayer(d_model, n_heads, d_model)
            elif kind == "ibr":
                layer = IBREncoderLayer(d_model, n_heads, d_model, d_model, d_model)
            else:
                raise ValueError(kind)
            setattr(self, f"layer_{i}", layer)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, key_padding_mask)
        return x


# ---------------------------------------------------------------------------
# embedding encoders (mlp.py make_embedding_encoder:419-451)
# ---------------------------------------------------------------------------


class PoswiseFFEmb(nn.Module):
    """`PoswiseFF_emb4enc` (mlp.py:361-396): a pre-LN two-layer ELU FFN plus
    a learned linear residual."""

    def __init__(self, d_in: int, d_hid: int, d_out: int):
        super().__init__()
        self.w_match = nn.Linear(d_in, d_out)
        self.pre_layer_norm = nn.LayerNorm(d_in, eps=1e-6)
        self.w_1 = nn.Linear(d_in, d_hid)
        self.w_2 = nn.Linear(d_hid, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(F.elu(self.w_1(self.pre_layer_norm(x)))) + self.w_match(x)


class EmbeddingEncoder(nn.Module):
    """The per-view feature compressor in front of the attention: pwf, ff,
    ffh or hpwf."""

    def __init__(self, kind: str, d_in: int, d_out: int):
        super().__init__()
        self.kind = kind
        if kind == "pwf":
            self.pwf = PoswiseFFEmb(d_in, 2 * d_out, d_out)
        elif kind == "ff":
            self.fc1, self.fc2 = nn.Linear(d_in, 2 * d_out), nn.Linear(2 * d_out, d_out)
        elif kind == "ffh":
            self.fc1 = nn.Linear(d_in, d_out)
        elif kind == "hpwf":
            self.fc1, self.fc2 = nn.Linear(d_in, 2 * d_out), nn.Linear(2 * d_out, d_out)
            self.ln = nn.LayerNorm(2 * d_out, eps=1e-6)
        else:
            raise ValueError(f"unknown embedding encoder: {kind}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "pwf":
            return self.pwf(x)
        if self.kind == "ff":
            return self.fc2(F.elu(self.fc1(x)))
        if self.kind == "ffh":
            return self.fc1(x)
        return self.fc2(self.ln(F.elu(self.fc1(x))))


# ---------------------------------------------------------------------------
# view-independent tokens (independent_tokens.py)
# ---------------------------------------------------------------------------


def masked_mean_variance(x: torch.Tensor, weight: torch.Tensor):
    """`fused_mean_variance` (independent_tokens.py:50-54): the weighted
    mean and variance over the view axis (-2), kept as an axis of 1."""
    mean = (x * weight).sum(-2, keepdim=True)
    var = (weight * (x - mean) ** 2).sum(-2, keepdim=True)
    return mean, var


class FixedViewIndependentToken(nn.Module):
    """A learned readout token (independent_tokens.py:32-40), drawn as
    torch.rand draws it."""

    def __init__(self, d_model: int):
        super().__init__()
        self.readout_token = nn.Parameter(torch.rand(1, d_model))

    def forward(self, view_tokens: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.readout_token.expand(*view_tokens.shape[:-2], 1, self.readout_token.shape[-1])


class DataViewIndependentToken(nn.Module):
    """elu(layer([mean, var])) of the valid views' tokens
    (independent_tokens.py:57-74)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.layer = nn.Linear(2 * d_model, d_model)

    def forward(self, view_tokens: torch.Tensor, invalid_features=None, **kwargs) -> torch.Tensor:
        mask = 1.0 - invalid_features.to(view_tokens.dtype)
        w = mask / (mask.sum(-1, keepdim=True) + 1e-8)
        mean, var = masked_mean_variance(view_tokens, w[..., None])
        return F.elu(self.layer(torch.cat([mean, var], -1)))


class _NeuRayCore(nn.Module):
    """The IBRNet-with-NeuRay aggregation shared by `NeuRayIndependentToken`
    and `IBRNetWithNeuRay`: direction features, NeuRay visibility weights,
    two rounds of weighted mean / variance pooling over the views, the
    geometry FFN; one token a sample. Layers `<mlp>_<i>` as JAX names them."""

    def __init__(self, in_feat_ch: int = 32, att_feat: int = 16, neuray_dim: int = 32):
        super().__init__()
        spec = {"ray_dir_fc": (4, (16, in_feat_ch)), "neuray_fc": (neuray_dim, (8, 1)),
                "base_fc": (4 * in_feat_ch + in_feat_ch + neuray_dim, (64, 32)), "vis_fc": (32, (32, 33)),
                "vis_fc2": (32, (32, 1)), "geometry_fc": (2 * 32 + 1, (2 * att_feat, att_feat))}
        for name, (d_in, dims) in spec.items():
            for i, d in enumerate(dims):
                setattr(self, f"{name}_{i}", _kaiming(nn.Linear(d_in, d)))
                d_in = d
        self._dims = {name: len(spec[name][1]) for name in spec}

    def _mlp(self, name: str, x: torch.Tensor, final_act=None) -> torch.Tensor:
        n = self._dims[name]
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x)
            if i < n - 1:
                x = F.elu(x)
        return final_act(x) if final_act is not None else x

    def forward(self, feat, neuray_tok, ray_diff, mask):
        """feat (..., V, in_feat_ch), neuray_tok (..., V, neuray_dim),
        ray_diff (..., V, 4), mask (..., V, 1) float validity -> (..., att_feat)."""
        feat = feat + F.elu(self._mlp("ray_dir_fc", ray_diff))
        weight = mask / (mask.sum(-2, keepdim=True) + 1e-8)
        weight0 = torch.sigmoid(self._mlp("neuray_fc", neuray_tok)) * weight
        mean0, var0 = masked_mean_variance(feat, weight0)
        mean1, var1 = masked_mean_variance(feat, weight)
        globalfeat = torch.cat([mean0, var0, mean1, var1], -1)
        x = torch.cat([globalfeat.expand(*feat.shape[:-1], globalfeat.shape[-1]), feat, neuray_tok], -1)
        x = F.elu(self._mlp("base_fc", x))
        x_vis = F.elu(self._mlp("vis_fc", x * weight))
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        vis = self._mlp("vis_fc2", x * vis, torch.sigmoid) * mask
        weight = vis / (vis.sum(-2, keepdim=True) + 1e-8)
        mean, var = masked_mean_variance(x, weight)
        globalfeat = torch.cat([mean[..., 0, :], var[..., 0, :], weight.mean(-2)], -1)
        return F.elu(self._mlp("geometry_fc", globalfeat))


class NeuRayIndependentToken(nn.Module):
    """The NeuRay / IBRNet aggregation as the readout token
    (independent_tokens.py:77-240). It needs `bottleneck_feats` (..., V,
    rbs) and `ray_diff` (..., V, 4) beside the view tokens; the
    reference's field never supplies them (bts.py:47-55), so only a caller
    that passes them runs it."""

    require_bottleneck_feats = True

    def __init__(self, n_points_per_ray: int, d_model: int, in_feat_ch: int = 32, rbs: int = 2048):
        super().__init__()
        self.n_points_per_ray, self.d_model = n_points_per_ray, d_model
        self.img_feat2low_0 = _kaiming(nn.Linear(rbs, rbs // 4))
        self.img_feat2low_1 = _kaiming(nn.Linear(rbs // 4, in_feat_ch))
        self.core = _NeuRayCore(in_feat_ch, d_model, neuray_dim=d_model)

    def forward(self, view_tokens, bottleneck_feats=None, ray_diff=None, invalid_features=None, **kwargs):
        if bottleneck_feats is None or ray_diff is None:
            raise ValueError("NeuRayIndependentToken needs bottleneck_feats and ray_diff")
        K = self.n_points_per_ray

        def per_ray(t):  # (N, V, C) -> (N/K, K, V, C)
            return t.reshape(-1, K, *t.shape[-2:])

        mask = (~invalid_features.reshape(-1, K, invalid_features.shape[-1]))[..., None].to(view_tokens.dtype)
        bf = self.img_feat2low_1(F.elu(self.img_feat2low_0(per_ray(bottleneck_feats))))
        tok = self.core(bf, per_ray(view_tokens), per_ray(ray_diff), mask)
        return tok.reshape(-1, 1, self.d_model)


class IBRNetWithNeuRay(nn.Module):
    """The IBRNet + NeuRay aggregation backbone (ibrnet.py:243-403):
    forward(rgb_feat (R, S, V, rbs), neuray_feat (R, S, V, neuray_in_dim),
    ray_diff (R, S, V, 4), mask (R, S, V, 1)) -> (R, S, att_feat)."""

    def __init__(self, neuray_in_dim: int = 32, in_feat_ch: int = 32, att_feat: int = 16, rbs: int = 2048):
        super().__init__()
        self.img_feat2low_0 = _kaiming(nn.Linear(rbs, rbs // 4))
        self.img_feat2low_1 = _kaiming(nn.Linear(rbs // 4, in_feat_ch))
        self.core = _NeuRayCore(in_feat_ch, att_feat, neuray_dim=neuray_in_dim)

    def forward(self, rgb_feat, neuray_feat, ray_diff, mask):
        rf = self.img_feat2low_1(F.elu(self.img_feat2low_0(rgb_feat)))
        return self.core(rf, neuray_feat, ray_diff, mask.to(rgb_feat.dtype))


def make_independent_token(conf: Dict[str, Any], d_model: int) -> nn.Module:
    """independent_tokens.py:8-17."""
    kind = conf.get("type", "FixedViewIndependentToken")
    if kind == "FixedViewIndependentToken":
        return FixedViewIndependentToken(d_model)
    if kind == "DataViewIndependentToken":
        return DataViewIndependentToken(d_model)
    if kind == "NeuRayIndependentToken":
        args = dict(conf.get("args", {}))
        return NeuRayIndependentToken(args["n_points_per_ray"], d_model, in_feat_ch=args.get("in_feat_ch", 32),
                                      rbs=args.get("rbs", 2048))
    raise NotImplementedError(f"unsupported token type: {kind}")


# ---------------------------------------------------------------------------
# view dropout (multi_view_head.py:98-117)
# ---------------------------------------------------------------------------


def _dropout_views(invalid: torch.Tensor, rate: float, do_mvh: bool, deterministic: bool,
                   keep: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`1 - Dropout(1 - invalid)` with torch's 1 / (1 - p) rescale in
    training (a kept valid view maps to 1 - 1 / (1 - p) < 0); the identity
    (as float) when deterministic or at rate 0. `keep` (..., V) is the
    Bernoulli(1 - p) draw, else drawn from `generator`; with `do_mvh` view
    0 (the pgt-loss view) is never dropped."""
    inv = invalid.float()
    if rate == 0.0 or deterministic:
        return inv
    valid = 1.0 - inv
    if keep is None:
        keep = torch.rand(valid.shape, generator=generator, device=generator.device if generator is not None
                          else valid.device).to(valid.device) < 1.0 - rate
    dropped = 1.0 - valid * keep.float() / (1.0 - rate)
    if do_mvh:
        return torch.cat([inv[..., :1], dropped[..., 1:]], -1)
    return dropped


def _blend(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Channel 0 of each view's x as its logit, an invalid (== 1) view's at
    -1e9, a softmax over the views blends channels 1: -> (..., C - 1)."""
    w = torch.softmax(torch.where(inv == 1.0, torch.full_like(x[..., 0], -1e9), x[..., 0]), -1)
    return (x[..., 1:] * w[..., None]).sum(-2)


def _resnet(d_in: int, d_out: int, args: Dict[str, Any], beta: bool = False) -> ResnetFC:
    return ResnetFC(d_in, d_out, d_hidden=args.get("d_hidden", 128), n_blocks=args.get("n_blocks", 5),
                    beta=args.get("beta", 0.0) if beta else 0.0)


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------


class MultiViewHead(nn.Module):
    """Attention aggregation (multi_view_head.py:50-177): embed each view's
    features, put a view-independent readout token first, run the attention
    stack under the float invalidity mask, read token 0 out, and predict
    with a 2-layer ELU FFN (`density_0`, `density_1`)."""

    def __init__(self, d_in: int, d_out: int, d_enc: int, emb_encoder: Optional[str] = "ff",
                 attn_kind: str = "torch", n_attn_layers: int = 3, n_heads: int = 4,
                 token_conf: Optional[Dict[str, Any]] = None, dropout_views_rate: float = 0.0,
                 do_mvh: bool = False, mask_mode: str = "additive"):
        super().__init__()
        self.dropout_views_rate, self.do_mvh, self.mask_mode = dropout_views_rate, do_mvh, mask_mode
        self.emb_encoder = (EmbeddingEncoder(emb_encoder, d_in, d_enc) if emb_encoder not in (None, "none")
                            else None)
        self.independent_token = make_independent_token(token_conf or {"type": "FixedViewIndependentToken"}, d_enc)
        self.attn = AttnStack(d_enc, n_attn_layers, n_heads, attn_kind)
        self.density_0 = nn.Linear(d_enc, d_enc // 2)
        self.density_1 = nn.Linear(d_enc // 2, d_out)

    def forward(self, sampled_features: torch.Tensor, invalid_features: torch.Tensor = None,
                deterministic: bool = True, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
        assert invalid_features is not None
        inv = _dropout_views(invalid_features, self.dropout_views_rate, self.do_mvh, deterministic, keep, generator)
        x = sampled_features if self.emb_encoder is None else self.emb_encoder(sampled_features)
        tok = self.independent_token(x, invalid_features=invalid_features, **kwargs)
        padded = torch.cat([tok.to(x.dtype), x], -2)
        pad_inv = torch.cat([torch.zeros_like(inv[..., :1]), inv], -1)
        if self.mask_mode == "fill":
            pad_inv = torch.where(pad_inv > 0, -1e9, 0.0)
        out = self.attn(padded, pad_inv)[..., 0, :]
        return self.density_1(F.elu(self.density_0(out)))[..., None, :]


class SimpleMultiViewHead(nn.Module):
    """A softmax-weighted blend of the views (multi_view_head.py:180-256):
    an inner ResnetFC `mlp` gives each view (logit, d_out); invalid views'
    logits are -1e9."""

    def __init__(self, d_in: int, d_out: int, mlp_args: Optional[Dict[str, Any]] = None,
                 dropout_views_rate: float = 0.0, do_mvh: bool = True):
        super().__init__()
        self.dropout_views_rate, self.do_mvh = dropout_views_rate, do_mvh
        self.mlp = _resnet(d_in, d_out + 1, mlp_args or {}, beta=True)

    def forward(self, sampled_features, invalid_features=None, deterministic=True, keep=None, generator=None,
                **kwargs):
        assert invalid_features is not None
        inv = _dropout_views(invalid_features, self.dropout_views_rate, self.do_mvh, deterministic, keep, generator)
        return _blend(self.mlp(sampled_features), inv)[..., None, :]


class MultiViewHead2(nn.Module):
    """The composable variant (multi_view_head.py:259-402): an inner
    ResnetFC, then a readout token and the attention stack, or a softmax
    blend; an optional second ResnetFC `mlp2`."""

    def __init__(self, d_in: int, d_out: int, mlp_args: Optional[Dict[str, Any]] = None,
                 mlp2_args: Optional[Dict[str, Any]] = None, mlp2_d_in: Optional[int] = None,
                 attn_conf: Optional[Dict[str, Any]] = None, token_conf: Optional[Dict[str, Any]] = None,
                 dropout_views_rate: float = 0.0, do_mvh: bool = True, mask_mode: str = "additive"):
        super().__init__()
        self.dropout_views_rate, self.do_mvh, self.mask_mode = dropout_views_rate, do_mvh, mask_mode
        d_mid = mlp2_d_in if mlp2_args is not None else d_out + 1
        self.mlp = _resnet(d_in, d_mid, mlp_args or {})
        self.independent_token = make_independent_token(token_conf, d_mid) if token_conf is not None else None
        self.attn = None
        if attn_conf is not None:
            self.attn = AttnStack(d_mid, attn_conf.get("n_layers", 3), attn_conf.get("n_heads", 4),
                                  "ibr" if attn_conf.get("IBRAttn", False) else "torch")
        self.mlp2 = None
        if mlp2_args is not None:
            self.mlp2 = _resnet(d_mid, d_out + (0 if token_conf is not None else 1), mlp2_args)

    def forward(self, sampled_features, invalid_features=None, deterministic=True, keep=None, generator=None,
                **kwargs):
        assert invalid_features is not None
        inv = _dropout_views(invalid_features, self.dropout_views_rate, self.do_mvh, deterministic, keep, generator)
        x = self.mlp(sampled_features)
        if self.independent_token is not None:
            tok = self.independent_token(x, invalid_features=invalid_features, **kwargs)
            x = torch.cat([tok.to(x.dtype), x], -2)
            inv = torch.cat([torch.zeros_like(inv[..., :1]), inv], -1)
        if self.attn is not None:
            x = self.attn(x, torch.where(inv > 0, -1e9, 0.0) if self.mask_mode == "fill" else inv)
        if self.independent_token is not None:
            readout = x[..., 0, :]
            if self.mlp2 is not None:
                return self.mlp2(readout)[..., None, :]
            return readout[..., None, 1:]
        if self.mlp2 is not None:
            x = self.mlp2(x)
        return _blend(x, inv)[..., None, :]


class MultiViewHead3(nn.Module):
    """Blend, then refine (multi_view_head.py:405-490): the softmax blend of
    an inner ResnetFC's features, then a second ResnetFC `mlp2` to d_out."""

    def __init__(self, d_in: int, d_out: int, mlp_args: Optional[Dict[str, Any]] = None,
                 mlp2_args: Optional[Dict[str, Any]] = None, mlp2_d_in: int = 64, dropout_views_rate: float = 0.0,
                 do_mvh: bool = True):
        super().__init__()
        self.dropout_views_rate, self.do_mvh = dropout_views_rate, do_mvh
        self.mlp = _resnet(d_in, mlp2_d_in + 1, mlp_args or {})
        self.mlp2 = _resnet(mlp2_d_in, d_out, mlp2_args or {})

    def forward(self, sampled_features, invalid_features=None, deterministic=True, keep=None, generator=None,
                **kwargs):
        assert invalid_features is not None
        inv = _dropout_views(invalid_features, self.dropout_views_rate, self.do_mvh, deterministic, keep, generator)
        return self.mlp2(_blend(self.mlp(sampled_features), inv))[..., None, :]


def make_multi_view_head(kind: str, conf: Dict[str, Any], d_in: int, d_out: int) -> nn.Module:
    """`make_head`'s branch for the multi-view heads
    (prediction_heads/__init__.py:22-28); `d_in` the per-view feature width.
    The reference's flax twin infers input widths, and its MultiViewHead's
    d_enc default is the `d_in` given in the config (0 without one); here
    it is the feature width."""
    if kind == "MultiViewHead":
        emb = conf.get("embedding_encoder", {}) or {}
        attn = conf.get("attn_layers", {}) or {}
        return MultiViewHead(
            d_in, d_out, d_enc=emb.get("d_out", d_in), emb_encoder=emb.get("type", "none"),
            attn_kind="ibr" if attn.get("IBRAttn", False) else "torch", n_attn_layers=attn.get("n_layers", 3),
            n_heads=attn.get("n_heads", 4),
            token_conf=dict(conf.get("independent_token", {"type": "FixedViewIndependentToken"})),
            dropout_views_rate=conf.get("dropout_views_rate", 0.0), do_mvh=conf.get("dropout_multiviewhead", False))
    if kind == "SimpleMultiViewHead":
        return SimpleMultiViewHead(d_in, d_out, mlp_args=dict(conf.get("mlp", {}).get("args", {}) or {}),
                                   dropout_views_rate=conf.get("dropout_views_rate", 0.0),
                                   do_mvh=conf.get("dropout_multiviewhead", False))
    if kind == "MultiViewHead2":
        mlp2 = conf.get("mlp2")
        return MultiViewHead2(
            d_in, d_out, mlp_args=dict(conf.get("mlp", {}).get("args", {}) or {}),
            mlp2_args=dict(mlp2.get("args", {}) or {}) if mlp2 else None, mlp2_d_in=mlp2.get("d_in") if mlp2 else None,
            attn_conf=dict(conf["attn_layers"]) if conf.get("attn_layers") else None,
            token_conf=dict(conf["independent_token"]) if conf.get("independent_token") else None,
            dropout_views_rate=conf.get("dropout_views_rate", 0.0), do_mvh=conf.get("dropout_multiviewhead", False))
    if kind == "MultiViewHead3":
        mlp2 = conf.get("mlp2", {})
        return MultiViewHead3(d_in, d_out, mlp_args=dict(conf.get("mlp", {}).get("args", {}) or {}),
                              mlp2_args=dict(mlp2.get("args", {}) or {}), mlp2_d_in=mlp2.get("d_in", 64),
                              dropout_views_rate=conf.get("dropout_views_rate", 0.0),
                              do_mvh=conf.get("dropout_multiviewhead", False))
    raise ValueError(kind)
