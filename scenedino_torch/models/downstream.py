"""The unsupervised-semantics head of stage 2 (counterpart of
`scenedino_tpu/models/downstream.py:32-370`): the STEGO projection head,
cosine k-means cluster heads on raw DINO and STEGO space, linear (or MLP)
probes with ignore index -1, five-crop 2D sampling, the kNN / random ring
buffers, and the pseudo-label -> GT assignment written back from
validation.

Parameter names follow the reference's flax modules (`stego_head.linear`,
`direct_cluster_head.cluster_centers`, ...), so `utils.convert` maps a JAX
tree by name. `pseudo_assignment` is a buffer of each cluster head, not a
parameter: validation writes it.

Every draw is an input (`HeadDraws`): the kNN pick, the random buffer rows,
and one dropout channel mask per call of the STEGO head. Its dropout drops
whole channels: a mask of the code width, broadcast over every other axis,
covers the whole call (flax's `Dropout(broadcast_dims=...)`; not one mask
per sample as in `torch.nn.Dropout2d`).

The ring buffers are updated in place (the reference returns new arrays):
at the flagship widths they hold 453 MB, which a copy a step would double.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from scenedino_torch.core import safe_normalize
from scenedino_torch.ops.kmeans import kmeans_cosine_assign


DROPOUT_RATE = 0.1  # the STEGO head's channel dropout (semantic_head.py:294)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return safe_normalize(x, eps=1e-10)


def five_crop(features: torch.Tensor, sample_factor: int = 1) -> torch.Tensor:
    """Five overlapping crops (semantic_head.py:15-34):
    (n, v, h, w, 1, c) -> (5n, v, L, L, 1, c), L = 2 (min(h, w) // 4) / sample_factor."""
    n, v, h, w, _, c = features.shape
    cs = sample_factor // 2
    L = min(h, w) // 4
    centers = [(h // 2, w // 2), (3 * h // 4, w // 4), (3 * h // 4, 3 * w // 4), (h // 4, w // 4),
               (h // 4, 3 * w // 4)]
    crops = [features[:, :, cy - L + cs:cy + L + cs:sample_factor, cx - L + cs:cx + L + cs:sample_factor]
             for cy, cx in centers]
    return torch.cat(crops, 0)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default Dense kernel init: a normal of variance 1 / fan_in
    truncated at two standard deviations (the std corrected for the cut)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """`nn.Linear` with flax's default init: lecun-normal kernel, zero bias."""

    def __init__(self, d_in: int, d_out: int, generator: Optional[torch.Generator] = None):
        super().__init__(d_in, d_out)
        lecun_normal_(self.weight, d_in, generator)
        with torch.no_grad():
            self.bias.zero_()


class StegoClusterHead(nn.Module):
    """Linear and nonlinear 1x1 paths summed, channel dropout, L2-normalized
    (semantic_head.py:285-305)."""

    def __init__(self, input_dim: int, code_dim: int = 64, mid_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = mid_channels or input_dim
        self.linear = Dense(input_dim, code_dim, generator)
        self.nonlinear_1 = Dense(input_dim, mid, generator)
        self.nonlinear_2 = Dense(mid, code_dim, generator)

    def forward(self, x: torch.Tensor, dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., input_dim); dropout_mask (code_dim,) bool keeps a channel
        (scaled by 1 / (1 - rate)) or drops it; None is the deterministic call."""
        out = self.linear(x) + self.nonlinear_2(torch.relu(self.nonlinear_1(x)))
        if dropout_mask is not None:
            out = torch.where(dropout_mask, out / (1.0 - DROPOUT_RATE), torch.zeros_like(out))
        return _norm(out)


class KMeansParamHead(nn.Module):
    """Learnable cosine-k-means centroids (semantic_head.py:308-375);
    `pseudo_assignment` maps cluster id -> GT class id."""

    def __init__(self, dim: int, n_classes: int = 19, gt_classes: int = 19,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cluster_centers = nn.Parameter(torch.randn(n_classes, dim, generator=generator))
        self.register_buffer("pseudo_assignment", torch.arange(n_classes) % gt_classes)

    def forward(self, features: torch.Tensor, weight: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        flat = features.reshape(-1, features.shape[-1])
        labels, loss, _ = kmeans_cosine_assign(flat, self.cluster_centers)
        w = torch.ones_like(loss) if weight is None else weight.reshape(-1).to(loss.dtype)
        pseudo = labels.reshape(features.shape[:-1])
        return {"pseudo_segs_pred": pseudo, "segs_pred": self.pseudo_assignment[pseudo], "loss": torch.mean(loss * w)}


def cross_entropy_ignore(logits: torch.Tensor, target: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    """Mean cross entropy over the targets that are not `ignore_index`; logits
    with view / singleton axes beyond the target's are reduced to view 0 as
    the reference does (semantic_head.py:470-476)."""
    while logits.ndim - 1 > target.ndim:
        logits = logits[..., 0, :] if logits.ndim >= 3 and logits.shape[-2] == 1 else logits[:, 0]
    valid = target != ignore_index
    tgt = torch.where(valid, target, torch.zeros_like(target)).long()
    nll = -torch.log_softmax(logits, -1).gather(-1, tgt[..., None])[..., 0]
    return torch.sum(torch.where(valid, nll, torch.zeros_like(nll))) / torch.clamp_min(valid.sum(), 1)


class LinearHead(nn.Module):
    """Linear probe and CE with ignore index -1 (semantic_head.py:460-477)."""

    def __init__(self, input_dim: int, gt_classes: int = 19, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Dense(input_dim, gt_classes, generator)

    def forward(self, features: torch.Tensor, target: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        logit = self.linear(features).float()
        out = {"segs_pred": torch.argmax(logit, -1), "logits": logit}
        if target is not None:
            out["loss"] = cross_entropy_ignore(logit, target)
        return out


class MLPHead(nn.Module):
    """Two-layer probe (semantic_head.py:480-501)."""

    def __init__(self, input_dim: int, gt_classes: int = 19, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear1 = Dense(input_dim, 2 * input_dim, generator)
        self.linear2 = Dense(2 * input_dim, gt_classes, generator)

    def forward(self, features: torch.Tensor, target: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        logit = self.linear2(torch.relu(self.linear1(features))).float()
        out = {"segs_pred": torch.argmax(logit, -1), "logits": logit}
        if target is not None:
            out["loss"] = cross_entropy_ignore(logit, target)
        return out


@dataclasses.dataclass
class RingBufferState:
    """kNN / random sampling buffers (semantic_head.py:70-71, 156-179,
    437-449): patch_buffer (S, P, C) per-crop patch features, gap_buffer
    (S, C) their pooled features, the write cursor `idx` and the high-water
    mark `filled` (created at 1, so the random draw's bound is positive)."""

    patch_buffer: torch.Tensor
    gap_buffer: torch.Tensor
    idx: int = 0
    filled: int = 1

    @staticmethod
    def create(buffer_size: int, patch_sample_size: int, input_dim: int, device=None,
               dtype=torch.float32) -> "RingBufferState":
        return RingBufferState(torch.zeros(buffer_size, patch_sample_size, input_dim, device=device, dtype=dtype),
                               torch.zeros(buffer_size, input_dim, device=device, dtype=dtype))


def update_ring_buffer(state: RingBufferState, patches: torch.Tensor, gaps: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> RingBufferState:
    """Write rows at the cursor, in place (semantic_head.py:437-449). valid
    (n,) bool: rows flagged False are not written; the valid rows keep their
    order (a stable sort, as the reference's) and go in at consecutive ring
    positions. Returns `state`, its cursor and high-water mark moved."""
    S, n = state.patch_buffer.shape[0], patches.shape[0]
    if valid is None:
        count, order = n, torch.arange(n, device=patches.device)
    else:
        order = torch.argsort(torch.logical_not(valid).to(torch.uint8), stable=True)[:int(valid.sum())]
        count = order.shape[0]
    rows = (state.idx + torch.arange(count, device=patches.device)) % S
    state.patch_buffer[rows] = patches[order].to(state.patch_buffer.dtype)
    state.gap_buffer[rows] = gaps[order].to(state.gap_buffer.dtype)
    new_idx = (state.idx + count) % S
    wrapped = new_idx < state.idx if valid is None else state.idx + count >= S
    state.filled = S if wrapped else max(new_idx, state.filled, 1)
    state.idx = new_idx
    return state


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest, equal values in
    index order (torch.topk promises no order among ties)."""
    values, idx = torch.sort(x, stable=True, dim=-1, descending=True)
    return values[..., :k], idx[..., :k]


@dataclasses.dataclass(frozen=True)
class SemanticHeadConfig:
    """configs/downstream/*.yaml defaults."""

    n_classes: int = 19
    gt_classes: int = 19
    input_dim: int = 768
    code_dim: int = 64
    buffer_size: int = 256
    patch_sample_size: int = 576
    knn_neighbors: int = 4
    mode: str = "3d"  # "3d" surface crops | "2d" five-crop
    mlp_head: bool = False
    apply_crf: bool = False

    @classmethod
    def from_dict(cls, dconf: dict) -> "SemanticHeadConfig":
        """From a `downstream:` config block; unknown keys are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dconf.items() if k in known})


@dataclasses.dataclass
class HeadDraws:
    """The draws of one `forward_training`: knn_pick (Nc,) int in
    [0, knn_neighbors), which of a crop's neighbours pairs with it;
    rand_u (Nc,) in [0, 1), a random buffer row floor(u max(filled, 1));
    dropout (calls, code_dim) bool, one channel mask per call of the STEGO
    head in call order (the full map, the crops in 3d mode, the kNN rows,
    the random rows), or None for the deterministic forward."""

    knn_pick: torch.Tensor
    rand_u: torch.Tensor
    dropout: Optional[torch.Tensor] = None

    @staticmethod
    def draw(n_crops: int, cfg: SemanticHeadConfig, generator: Optional[torch.Generator] = None, device=None,
             deterministic: bool = False) -> "HeadDraws":
        pick = torch.randint(0, cfg.knn_neighbors, (n_crops,), generator=generator, device=device)
        u = torch.rand(n_crops, generator=generator, device=device)
        masks = None
        if not deterministic:
            calls = 4 if cfg.mode == "3d" else 3
            masks = torch.rand(calls, cfg.code_dim, generator=generator, device=device) < 1.0 - DROPOUT_RATE
        return HeadDraws(pick, u, masks)


class SemanticHead(nn.Module):
    """Umbrella downstream head (semantic_head.py:41-283)."""

    def __init__(self, cfg: SemanticHeadConfig = SemanticHeadConfig(), generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        self.stego_head = StegoClusterHead(c.input_dim, c.code_dim, generator=generator)
        self.direct_cluster_head = KMeansParamHead(c.input_dim, c.n_classes, c.gt_classes, generator)
        self.stego_cluster_head = KMeansParamHead(c.code_dim, c.n_classes, c.gt_classes, generator)
        probe = MLPHead if c.mlp_head else LinearHead
        self.direct_linear_head = probe(c.input_dim, c.gt_classes, generator)
        self.stego_linear_head = probe(c.code_dim, c.gt_classes, generator)

    def forward(self, features: torch.Tensor, mode: str = "stego_kmeans") -> torch.Tensor:
        """Inference: input_dim features -> GT-class prediction (semantic_head.py:107-120)."""
        features = _norm(features)
        if mode == "stego_kmeans":
            return self.stego_cluster_head(self.stego_head(features))["segs_pred"]
        if mode == "stego_linear":
            return self.stego_linear_head(self.stego_head(features))["segs_pred"]
        if mode == "direct_kmeans":
            return self.direct_cluster_head(features)["segs_pred"]
        if mode == "direct_linear":
            return self.direct_linear_head(features)["segs_pred"]
        raise NotImplementedError(mode)

    def encode_features(self, dino_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized features and their STEGO codes (deterministic): what the
        two cluster heads see in training, for seeding their centres."""
        d = _norm(dino_features.detach())
        return d, self.stego_head(d)

    def forward_training(self, dino_features: torch.Tensor, buffers: RingBufferState, draws: HeadDraws,
                         crop_features: Optional[torch.Tensor] = None, seg_target: Optional[torch.Tensor] = None,
                         deterministic: bool = False, crop_valid: Optional[torch.Tensor] = None,
                         gather_crops: Optional[Callable] = None):
        """The training forward (semantic_head.py:122-235).

        dino_features (n, v, h, w, 1, C) rendered features (detached);
        crop_features (Nc, P, C) the 3D surface crops and crop_valid (Nc,)
        their validity (invalid crops stay in the arrays, are not written to
        the buffer and are masked out of the loss). gather_crops(crops, gaps,
        valid) -> the global batch's (data parallelism: every rank's crops in
        the global order) gives the rows the buffers take. Returns
        ({"stego_corr": the six correlation tensors (+ crop_valid), "results":
        each head's outputs, and with seg_target "n_labelled", its count of
        labelled pixels}, buffers, updated in place unless deterministic).
        """
        c = self.cfg
        masks: List[Optional[torch.Tensor]] = [None] * 4 if deterministic else list(draws.dropout)
        dino_features = _norm(dino_features.detach())
        n, v, h, w, _, C = dino_features.shape
        three_d = c.mode == "3d" and crop_features is not None
        # in 3d mode only the heads read the map's codes, detached: no graph for its (n v h w, C) hidden layer
        with torch.no_grad() if three_d else contextlib.nullcontext():
            stego_features = self.stego_head(dino_features.reshape(n * v, h, w, C), masks.pop(0))
        stego_features = stego_features.reshape(n, v, h, w, 1, -1)

        if three_d:
            cropped = _norm(crop_features.detach())
            stego_self = self.stego_head(cropped, masks.pop(0))
        else:
            crop_valid = None  # 2D five-crops are always valid
            cd = five_crop(dino_features[:, :1], 4)
            cs = five_crop(stego_features[:, :1], 4)
            cropped = cd.reshape(cd.shape[0], -1, C)
            stego_self = cs.reshape(cs.shape[0], -1, cs.shape[-1])
        gap = _norm(torch.mean(cropped, -2))

        if not deterministic:
            written = (cropped.detach(), gap.detach(), crop_valid)
            if gather_crops is not None:
                written = gather_crops(*written)
            update_ring_buffer(buffers, *written[:2], valid=written[2])

        # kNN and random pairs from the buffer (semantic_head.py:168-179)
        sims = gap @ buffers.gap_buffer.T
        slot_valid = torch.arange(buffers.gap_buffer.shape[0], device=sims.device) < buffers.filled
        sims = torch.where(slot_valid[None], sims, torch.full_like(sims, -torch.inf))
        topk = top_k(sims, c.knn_neighbors + 1)[1][:, 1:]
        Nc = cropped.shape[0]
        nn_idx = topk[torch.arange(Nc, device=sims.device), draws.knn_pick]
        dino_nn = buffers.patch_buffer[nn_idx]
        stego_nn = self.stego_head(dino_nn, masks.pop(0))
        hi = max(buffers.filled, 1)
        rand_idx = torch.clamp(torch.floor(draws.rand_u * hi).long(), 0, hi - 1)
        dino_rand = buffers.patch_buffer[rand_idx]
        stego_rand = self.stego_head(dino_rand, masks.pop(0))

        def corr(a, b):
            return torch.einsum("npf,nqf->npq", _norm(a), _norm(b))

        stego_corr = {
            "dino_self_corr": corr(cropped, cropped),
            "stego_self_corr": corr(stego_self, stego_self),
            "dino_nn_corr": corr(cropped, dino_nn),
            "stego_nn_corr": corr(stego_self, stego_nn),
            "dino_random_corr": corr(cropped, dino_rand),
            "stego_random_corr": corr(stego_self, stego_rand),
        }
        if crop_valid is not None:
            stego_corr["crop_valid"] = crop_valid

        # the heads train on detached features (semantic_head.py:196-221)
        det_dino, det_stego = dino_features.detach(), stego_features.detach()
        results = {"direct_cluster": self.direct_cluster_head(det_dino),
                   "stego_cluster": self.stego_cluster_head(det_stego)}
        out = {"stego_corr": stego_corr, "results": results}
        if seg_target is not None:
            results["direct_linear"] = self.direct_linear_head(det_dino, seg_target)
            results["stego_linear"] = self.stego_linear_head(det_stego, seg_target)
            out["n_labelled"] = torch.sum(seg_target != -1)
        return out, buffers
