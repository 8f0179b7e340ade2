"""Validation metrics on the host (counterpart of
`scenedino_tpu/eval/metrics.py:33-273`): depth errors, PSNR, the DINO
cosine similarity, skimage's SSIM and the SSIM index (stage 1); the
occupancy metrics and the foreground adjusted Rand index; the segmentation
confusion, the pseudo-label assignment and the (weighted) IoU scores
(stage 2).

Inputs are numpy arrays or tensors (copied to the host); the depth and
image metrics compute in float32 like the reference, SSIM in float64.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _host(x, dtype=np.float32) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x, dtype)


def scale_depth_median(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """pred times the median of gt / pred over the mask (metrics.py:16-40);
    an even count takes the mean of the two middle ratios, as jnp.nanmedian."""
    ratio = np.where(mask, gt / np.maximum(pred, np.float32(1e-8)), np.float32(np.nan))
    return pred * np.nanmedian(ratio).astype(np.float32)


def depth_metrics(pred, gt, mask=None, scaling: Optional[str] = "median") -> Dict[str, np.float32]:
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 of depths pred, gt (...,)
    over mask (gt > 0 by default), after median scaling unless `scaling` is
    None; pred clamped below at 1e-3 (metrics.py:43-113)."""
    pred, gt = _host(pred), _host(gt)
    mask = gt > 0 if mask is None else np.asarray(mask, bool)
    if scaling == "median":
        pred = scale_depth_median(pred, gt, mask)
    pred = np.maximum(pred, np.float32(1e-3))
    n = np.float32(max(int(mask.sum()), 1))

    def masked_mean(x):
        return np.sum(np.where(mask, x, np.float32(0.0)), dtype=np.float32) / n

    gt_safe = np.maximum(gt, np.float32(1e-8))
    thresh = np.maximum(gt / pred, pred / gt_safe)
    return {
        "abs_rel": masked_mean(np.abs(gt - pred) / gt_safe),
        "sq_rel": masked_mean((gt - pred) ** 2 / gt_safe),
        "rmse": np.sqrt(masked_mean((gt - pred) ** 2)),
        "rmse_log": np.sqrt(masked_mean((np.log(gt_safe) - np.log(pred)) ** 2)),
        "a1": masked_mean((thresh < 1.25).astype(np.float32)),
        "a2": masked_mean((thresh < 1.25 ** 2).astype(np.float32)),
        "a3": masked_mean((thresh < 1.25 ** 3).astype(np.float32)),
    }


def psnr(pred, gt) -> np.float32:
    mse = np.mean((_host(pred) - _host(gt)) ** 2, dtype=np.float32)
    return np.float32(-10.0) * np.log10(np.maximum(mse, np.float32(1e-12)))


def dino_cosine_similarity(pred, gt, eps: float = 1e-8) -> torch.Tensor:
    """Mean cosine similarity over the channel axis (metrics.py:195-215), in
    fp32 on the inputs' device: a 0-d tensor."""
    pred, gt = (torch.as_tensor(x).float() for x in (pred, gt))
    pn = pred / torch.clamp(torch.linalg.vector_norm(pred, dim=-1, keepdim=True), min=eps)
    gn = gt / torch.clamp(torch.linalg.vector_norm(gt, dim=-1, keepdim=True), min=eps)
    return (pn * gn).sum(-1).mean()


def ssim_index(pred, gt) -> torch.Tensor:
    """Mean SSIM index of NCHW image batches (the 3x3 Gaussian window of
    `losses.ssim`, zero pad): a 0-d tensor where the inputs lie."""
    from scenedino_torch.losses.ssim import ssim_error

    return ssim_error(torch.as_tensor(pred).float(), torch.as_tensor(gt).float(), eval_mode=True).mean()


def occupancy_metrics(pred_occ, gt_occ, mask=None) -> Dict[str, np.float32]:
    """Occupancy accuracy, precision, recall and IoU over `mask` (all points
    by default) (metrics.py:116-151); no invisible-empty metrics, which
    need a visibility mask (`compute_occ_metrics_visible`)."""
    pred = _host(pred_occ, bool).reshape(-1)
    gt = _host(gt_occ, bool).reshape(-1)
    mask = np.ones_like(gt) if mask is None else _host(mask, bool).reshape(-1)
    tp = np.sum(pred & gt & mask)
    fp = np.sum(pred & ~gt & mask)
    fn = np.sum(~pred & gt & mask)
    tn = np.sum(~pred & ~gt & mask)

    def ratio(a, b):
        return np.float32(a / max(b, 1))

    return {"o_acc": ratio(tp + tn, tp + tn + fp + fn), "o_prec": ratio(tp, tp + fp), "o_rec": ratio(tp, tp + fn),
            "o_iou": ratio(tp, tp + fp + fn)}


def compute_occ_metrics_visible(pred_occ, gt_occ, is_visible) -> Dict[str, np.float32]:
    """Occupancy metrics with the visibility rule (metrics.py:116-151,
    wrapper.py create_occ_eval): only points that are not visible can be
    occupied (gt &= ~visible); o_* over all points, ie_* over the
    invisible-empty set; t_ie and t_no_nop_nv are counts."""
    pred = _host(pred_occ, bool).reshape(-1)
    vis = _host(is_visible, bool).reshape(-1)
    gt = _host(gt_occ, bool).reshape(-1) & ~vis

    def mean_where(x, m):
        return np.float32(np.sum(x & m) / max(int(np.sum(m)), 1))

    def mean(x):  # as XLA takes a mean: the fp32 sum times the fp32 reciprocal of the count
        return np.float32(np.sum(x)) * (np.float32(1) / np.float32(x.size))

    return {
        "o_acc": mean(pred == gt),
        "o_prec": mean_where(gt, pred),
        "o_rec": mean_where(pred, gt),
        "ie_acc": mean_where(pred == gt, ~vis),
        "ie_prec": mean_where(~gt, ~pred & ~vis),
        "ie_rec": mean_where(~pred, ~gt & ~vis),
        "ie_r": mean(~gt & ~vis),
        "t_ie": np.int64(np.sum(~gt & ~vis)),
        "t_no_nop_nv": np.int64(np.sum((~gt & ~pred) & (~vis & ~gt))),
    }


def fg_ari(pred_labels, gt_labels, fg_mask) -> float:
    """Foreground adjusted Rand index (metrics.py FG_ARI:483) of the labels
    under `fg_mask`, from their contingency table; 0 without foreground."""
    fg = _host(fg_mask, bool).reshape(-1)
    pred = _host(pred_labels, np.int64).reshape(-1)[fg]
    gt = _host(gt_labels, np.int64).reshape(-1)[fg]
    if len(gt) == 0:
        return 0.0
    _, pi = np.unique(pred, return_inverse=True)
    _, gi = np.unique(gt, return_inverse=True)
    cont = np.zeros((gi.max() + 1, pi.max() + 1), np.int64)
    np.add.at(cont, (gi, pi), 1)
    nij = (cont * (cont - 1) / 2).sum()
    a, b = cont.sum(1), cont.sum(0)
    ai, bj = (a * (a - 1) / 2).sum(), (b * (b - 1) / 2).sum()
    n = len(gt)
    total = n * (n - 1) / 2
    expected = ai * bj / total if total > 0 else 0.0
    max_idx = (ai + bj) / 2
    if max_idx == expected:
        return 1.0
    return float((nij - expected) / (max_idx - expected))


def ssim_skimage(pred, gt, data_range: float = 1.0, win_size: int = 7) -> float:
    """`skimage.metrics.structural_similarity(pred, gt, data_range=1,
    channel_axis=-1)`, the NVS metric the reference reports: per channel a
    7x7 uniform window, the sample-covariance correction NP / (NP - 1),
    K1 = 0.01, K2 = 0.03, the mean over the border-cropped region.
    pred, gt (H, W, C)."""
    from scipy.ndimage import uniform_filter

    pred, gt = _host(pred, np.float64), _host(gt, np.float64)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cov_norm = win_size ** 2 / (win_size ** 2 - 1)
    pad = (win_size - 1) // 2
    vals = []
    for ch in range(pred.shape[-1]):
        x, y = pred[..., ch], gt[..., ch]

        def f(im):
            return uniform_filter(im, size=win_size)

        ux, uy = f(x), f(y)
        vx = cov_norm * (f(x * x) - ux * ux)
        vy = cov_norm * (f(y * y) - uy * uy)
        vxy = cov_norm * (f(x * y) - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


# ------------------------------------------------------------ segmentation
# [road, sidewalk, building, wall, fence, pole, traffic light, traffic sign,
#  vegetation, terrain, sky, person, rider, car, truck, bus, train,
#  motorcycle, bicycle] (the reference's metrics.py:378-380), mean 1
SEG_CLASS_WEIGHTS = np.array([4, 2, 2, 1, 1, 1, 1, 1, 2, 2, 1, 1, 1, 2, 1, 1, 1, 1, 1], np.float64)
SEG_CLASS_WEIGHTS = SEG_CLASS_WEIGHTS / SEG_CLASS_WEIGHTS.mean()


def seg_confusion_matrix(target, pred, n_gt: int, n_pred: Optional[int] = None, ignore_index: int = -1) -> np.ndarray:
    """Confusion counts (actual x prediction) over the targets that are not
    `ignore_index` (metrics.py:230-247): (n_gt, n_pred) int64. As the JAX
    package counts (`jnp.bincount` with a length): a pair whose flat index
    target * n_pred + pred lies past the table is dropped, one below 0 is
    counted at [0, 0] (targets outside the classes, such as KITTI-360's
    unmapped semantic ids >= n_gt, reach it)."""
    n_pred = n_pred or n_gt
    target = _host(target, np.int64).reshape(-1)
    pred = _host(pred, np.int64).reshape(-1)
    valid = target != ignore_index
    idx = np.maximum(np.where(valid, target * n_pred + pred, 0), 0)
    keep = valid & (idx < n_gt * n_pred)
    counts = np.bincount(idx[keep], minlength=n_gt * n_pred)
    return counts.reshape(n_gt, n_pred).astype(np.int64)


def pseudo_label_assignment(confusion) -> np.ndarray:
    """Pseudo class -> GT class map that maximizes the matched counts, every
    GT class covered at least once (the reference's PuLP ILP,
    metrics.py:431-456): each pseudo column defaults to its argmax GT row;
    coverage forces an injective GT -> pseudo override, chosen by the
    Hungarian method on the regret matrix conf[i, j] - colmax[j] (the cost of
    moving column j off its argmax)."""
    from scipy.optimize import linear_sum_assignment

    conf = np.asarray(confusion, np.float64)
    n_pseudo = conf.shape[1]
    colmax_idx = np.argmax(conf, axis=0)
    regret = conf - conf[colmax_idx, np.arange(n_pseudo)][None, :]
    rows, cols = linear_sum_assignment(regret, maximize=True)
    assignment = colmax_idx.copy()
    assignment[cols] = rows
    return assignment.astype(np.int64)


def apply_assignment(confusion, assignment) -> np.ndarray:
    """Fold the pseudo columns into their GT columns (metrics.py:401-409)."""
    confusion = np.asarray(confusion)
    out = np.zeros((confusion.shape[0],) * 2, confusion.dtype)
    np.add.at(out.T, np.asarray(assignment), confusion.T)
    return out


def seg_scores(confusion, weights: Optional[np.ndarray] = None) -> Dict:
    """Per-class IoU, mIoU, weighted mIoU and accuracy (metrics.py:411-428)."""
    conf = np.asarray(confusion, np.float64)
    tp = np.diag(conf)
    denom = conf.sum(1) + conf.sum(0) - tp
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
    w = weights if weights is not None else SEG_CLASS_WEIGHTS[:len(iou)]
    return {"per_class_iou": iou, "miou": float(iou.mean()), "weighted_miou": float((iou * w).mean()),
            "acc": float(tp.sum() / max(conf.sum(), 1))}


def evaluate_confusion(confusion, assign_pseudo: bool = True, weights: Optional[np.ndarray] = None) -> Dict:
    """SegmentationMetric.compute (metrics.py:393-428): the pseudo
    assignment (when asked), the folded confusion and its scores."""
    conf = np.asarray(confusion)
    out: Dict = {}
    if assign_pseudo:
        out["assignment"] = pseudo_label_assignment(conf)
        conf = apply_assignment(conf, out["assignment"])
    out.update(seg_scores(conf, weights))
    out["confusion_matrix"] = conf
    return out
