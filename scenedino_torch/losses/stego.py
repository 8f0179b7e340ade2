"""The STEGO correspondence-distillation loss (counterpart of
`scenedino_tpu/losses/stego.py:14-67`), with the shipped constants
(`configs/training/loss/semantic.yaml`): random / kNN / self weights
0.6702 / 0.4156 / 0.0815, shifts 0.8709 / 0.1846 / 0.4361, not pointwise.

`max(stego, 0)` goes through `core.maximum`, so at a tie (a correlation of
exactly 0) the gradient splits as `jnp.maximum`'s does.

Under data parallelism (`dp`, a `parallel.data_parallel.DataParallel`) each
rank holds its share of the global batch; the ratio terms then divide by
the global count (the valid crops, the labelled pixels) and `pointwise`
centres on the global mean, each rank's term scaled by the world size, so
that the mean over the ranks of each term, and of its gradient, is the
global batch's. The plain means are over equal shares and need nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from scenedino_torch.core import maximum


@dataclasses.dataclass(frozen=True)
class StegoLossConfig:
    random_weight: float = 0.6702352279261414
    knn_weight: float = 0.4156436438453117
    self_weight: float = 0.08146997886146659
    random_shift: float = 0.8709334888837256
    knn_shift: float = 0.18458300726748128
    self_shift: float = 0.43610463774158115
    pointwise: bool = False

    @classmethod
    def from_dict(cls, conf: Optional[dict]) -> "StegoLossConfig":
        """From a `training.loss:` block; other keys are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (conf or {}).items() if k in known})


def _mean(x: torch.Tensor, dp=None) -> torch.Tensor:
    """The mean of x, over every rank's equal share under `dp` (no gradient then)."""
    return torch.mean(x) if dp is None else dp.sum(torch.mean(x)) / dp.world


def _stego_term(dino_corr, stego_corr, weight, shift, pointwise, valid=None, dp=None):
    """-w max(stego, 0) (dino - shift), averaged (stego_loss.py:73-81); with
    `valid` (Nc,) the mean runs over the valid crops only."""
    if pointwise:  # the DINO correlations carry no gradient
        old_mean = _mean(dino_corr, dp)
        dino_corr = dino_corr - torch.mean(dino_corr, -1, keepdim=True)
        dino_corr = dino_corr - _mean(dino_corr, dp) + old_mean
    loss = -weight * maximum(stego_corr, 0.0) * (dino_corr - shift)
    if valid is None:
        return torch.mean(loss)
    w = valid.to(loss.dtype)
    per_crop = torch.mean(loss.reshape(loss.shape[0], -1), -1)
    if dp is None:
        return torch.sum(per_crop * w) / torch.clamp_min(torch.sum(w), 1.0)
    return torch.sum(per_crop * w) * dp.world / torch.clamp_min(dp.sum(torch.sum(w)), 1.0)


def stego_loss(seg_data: Dict, cfg: StegoLossConfig = StegoLossConfig(), dp=None) -> Dict[str, torch.Tensor]:
    """seg_data: `SemanticHead.forward_training`'s output. Returns the loss
    dict; "total_loss" is what the step minimizes (stego_loss.py:26-71).
    `dp`: this rank's terms of the global batch's loss (module docstring)."""
    losses = {}
    total = 0.0
    if "stego_corr" in seg_data:
        sc = seg_data["stego_corr"]
        valid = sc.get("crop_valid")
        terms = (("self_loss", "self"), ("knn_loss", "nn"), ("random_loss", "random"))
        for name, corr in terms:
            kind = name.split("_")[0]
            losses[name] = _stego_term(sc[f"dino_{corr}_corr"], sc[f"stego_{corr}_corr"],
                                       getattr(cfg, f"{kind}_weight"), getattr(cfg, f"{kind}_shift"),
                                       cfg.pointwise, valid, dp)
        total = losses["self_loss"] + losses["knn_loss"] + losses["random_loss"]
    results = seg_data.get("results", {})
    for name in ("direct_cluster", "stego_cluster", "direct_linear", "stego_linear"):
        term = results.get(name, {}).get("loss")
        if term is not None and dp is not None and name.endswith("_linear"):
            # the probes' mean over this rank's labelled pixels -> its share of the global mean
            n = seg_data["n_labelled"].to(term.dtype)
            term = term * (dp.world * torch.clamp_min(n, 1.0) / torch.clamp_min(dp.sum(n), 1.0))
        if term is not None:
            losses[f"{name}_loss"] = term
            total = total + term
    losses["total_loss"] = total
    return losses
