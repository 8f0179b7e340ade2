"""Validation during training (counterpart of
`scenedino_tpu/training/validation.py`): per validation batch the stage-1
full-frame render or the stage-2 downstream forward, host-side metric
accumulation, the `save_best` policy the loop applies, and stage 2's
write-back of the validation's pseudo assignment into the cluster heads.

A `Validator` runs `fn(state, generator) -> metrics` every `every`
iterations; stage 1's metrics are flat scalars named "<type>_<metric>"
(`depth_abs_rel`, `dino_cos_sim`, `nvs_psnr`, `occ_o_acc`, ...) and, under
"images", the TensorBoard panels of the first batch
(`eval.vis2d.tb_visualize`); stage 2's are "<head>_<score>"
(`stego_cluster_weighted_miou`, ...) with the assignments and confusion
matrices as arrays and the STEGO correlations concatenated.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from scenedino_torch.core.geometry import distance_to_z
from scenedino_torch.eval.metrics import (
    SEG_CLASS_WEIGHTS,
    compute_occ_metrics_visible,
    depth_metrics,
    dino_cosine_similarity,
    evaluate_confusion,
    psnr,
    seg_confusion_matrix,
    ssim_skimage,
)

logger = logging.getLogger("validation")


@dataclasses.dataclass(frozen=True)
class SaveBestConfig:
    """`save_best:` block of a validation config: checkpoint when
    sign * metric improves."""

    metric: str
    sign: float = 1.0
    update_model: bool = False
    dry_run: bool = False

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["SaveBestConfig"]:
        if not d:
            return None
        return SaveBestConfig(
            metric=d["metric"],
            sign=float(d.get("sign", 1.0)),
            update_model=bool(d.get("update_model", False)),
            dry_run=bool(d.get("dry_run", False)),
        )


class DictMeanAccumulator:
    """Mean of per-batch scalar dicts, keys flattened as f"{name}_{key}";
    a NaN value is skipped and counts for its key only."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def update(self, values: Dict[str, Any]):
        for k, v in values.items():
            v = float(np.mean(np.asarray(v)))
            if np.isnan(v):
                logger.warning("metric %s/%s is NaN; skipped", self.name, k)
                continue
            self._sums[k] = self._sums.get(k, 0.0) + v
            self._counts[k] = self._counts.get(k, 0) + 1

    def compute(self) -> Dict[str, float]:
        return {f"{self.name}_{k}": v / self._counts[k] for k, v in self._sums.items()}


class ConcatAccumulator:
    """Per-batch arrays concatenated (ConcatenateMetric, metrics.py:459-480),
    reported as f"{name}_{key}" arrays."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        self._parts: Dict[str, list] = {}

    def update(self, values: Dict[str, Any]):
        for k, v in values.items():
            self._parts.setdefault(k, []).append(np.asarray(v).reshape(-1))

    def compute(self) -> Dict[str, np.ndarray]:
        return {f"{self.name}_{k}": np.concatenate(v) for k, v in self._parts.items() if v}


class SegmentationAccumulator:
    """Summed confusion matrices by result name, then the pseudo assignment
    and the scores (SegmentationMetric, metrics.py:370-456): compute() gives
    f"{key}_assignment", f"{key}_per_class_iou", f"{key}_miou",
    f"{key}_weighted_miou", f"{key}_acc" and f"{key}_confusion_matrix"."""

    def __init__(self, name: str = "seg", assign_pseudo: bool = True):
        self.name = name
        self.assign_pseudo = assign_pseudo
        self.reset()

    def reset(self):
        self._sums: Dict[str, np.ndarray] = {}

    def update(self, confusions: Dict[str, Any]):
        for k, m in confusions.items():
            m = np.asarray(m, np.int64)
            self._sums[k] = self._sums[k] + m if k in self._sums else m.copy()

    def compute(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, conf in self._sums.items():
            ev = evaluate_confusion(conf, assign_pseudo=self.assign_pseudo, weights=SEG_CLASS_WEIGHTS[:conf.shape[0]])
            if self.assign_pseudo:
                out[key + "_assignment"] = ev["assignment"]
            for score in ("per_class_iou", "miou", "weighted_miou", "acc", "confusion_matrix"):
                out[f"{key}_{score}"] = ev[score]
        return out


def compute_depth_metrics(data: Dict[str, np.ndarray], scaling: Optional[str] = None,
                          to_z: bool = False) -> Dict[str, float]:
    """The first view's depth against its ground truth (wrapper.py:12-26).
    to_z converts the rendered ray distance to camera z first
    (`core.geometry.distance_to_z`), for wide-angle cameras."""
    if "depths_gt" not in data:
        return {}
    depth = np.asarray(data["depth"], np.float32)
    if to_z and "projs" in data:
        depth = distance_to_z(torch.from_numpy(depth), torch.from_numpy(np.asarray(data["projs"]))).numpy()
    pred = depth[:, 0]
    gt = np.asarray(data["depths_gt"], np.float32)
    gt0 = gt.reshape(pred.shape[0], -1, *pred.shape[1:])[:, 0]
    return {k: float(v) for k, v in depth_metrics(pred, gt0, scaling=scaling).items()}


def compute_dino_metrics(data: Dict[str, Any]) -> Dict[str, float]:
    """l1, l2 and cos_sim of the pooled prediction grid against the
    teacher's, in fp32 where the grids lie (the validator passes them on the
    device: a per-pixel teacher's grids are 768 x H x W a view)."""
    pred, gt = (torch.as_tensor(data[k]).float() for k in ("dino_pred_grid", "dino_gt_grid"))
    diff = pred - gt
    return {
        "l1": float(diff.abs().mean()),
        "l2": float(diff.square().mean()),
        "cos_sim": float(dino_cosine_similarity(pred, gt)),
    }


def compute_nvs_metrics(data: Dict[str, np.ndarray], lpips_fn: Optional[Callable] = None) -> Dict[str, float]:
    """Novel-view quality of the stereo frame (the middle view) of the first
    item, 5 % border crop: PSNR, skimage SSIM and, given `lpips_fn` (such as
    `eval.lpips.load_lpips`'s module: NCHW images -> (B,) distances), LPIPS.
    As the reference does (metrics.py:185), LPIPS sees the [0, 1] images
    unchanged, though its scaling layer expects [-1, 1]."""
    if "rgb" not in data:
        return {}
    rgb = np.asarray(data["rgb"], np.float32)  # (B, V, H, W, Vr, 3)
    sf = rgb.shape[1] // 2
    pred = rgb[:1, sf, :, :, 0, :]  # (1, H, W, 3)
    gt = np.asarray(data["imgs_gt"], np.float32)[:1, sf].transpose(0, 2, 3, 1)
    h, w = pred.shape[1:3]
    y0, y1 = int(math.ceil(0.05 * h)), int(math.floor(0.95 * h))
    x0, x1 = int(math.ceil(0.05 * w)), int(math.floor(0.95 * w))
    pred, gt = pred[:, y0:y1, x0:x1], gt[:, y0:y1, x0:x1]
    out = {"psnr": float(psnr(pred, gt)), "ssim": ssim_skimage(pred[0], gt[0], data_range=1.0)}
    if lpips_fn is not None:
        device = next(lpips_fn.parameters()).device if isinstance(lpips_fn, torch.nn.Module) else "cpu"

        def nchw(x):  # on the LPIPS module's device
            return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(device)

        with torch.no_grad():
            out["lpips"] = float(lpips_fn(nchw(pred), nchw(gt)).float().mean())
    return out


def compute_seg_confusions(seg_data: Dict, target, n_classes: int, gt_classes: int) -> Dict[str, np.ndarray]:
    """Per head result, the (gt, pseudo or gt) confusion of its view-0
    predictions against `target` (metrics.py:230-247)."""
    out = {}
    tgt = np.asarray(target).reshape(-1)
    for key, result in seg_data["results"].items():
        pred = result.get("pseudo_segs_pred", result.get("segs_pred"))
        pred = pred.detach().cpu().numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
        if pred.ndim >= 4:  # (B, V, H, W, ...): view 0
            pred = pred[:, 0]
        pred = pred.reshape(-1)
        if pred.shape[0] != tgt.shape[0]:
            raise ValueError(f"{key}: {pred.shape[0]} predictions for {tgt.shape[0]} targets")
        n_pred = n_classes if "pseudo_segs_pred" in result else gt_classes
        out[key] = seg_confusion_matrix(tgt, pred, gt_classes, n_pred)
    return out


def compute_stego_metrics(seg_data: Dict) -> Dict[str, np.ndarray]:
    """The STEGO correlation tensors (metrics.py:218-228)."""
    if "stego_corr" not in seg_data:
        return {}
    c = seg_data["stego_corr"]
    return {k: c[k].detach().float().cpu().numpy() for k in ("stego_self_corr", "stego_nn_corr", "stego_random_corr")}


@dataclasses.dataclass
class Validator:
    """One validation config: `fn(state, generator) -> metrics` every `every`
    training iterations; the loop applies `save_best`."""

    name: str
    fn: Callable[[Any, torch.Generator], Dict[str, Any]]
    every: int = 5000
    save_best: Optional[SaveBestConfig] = None

    def __call__(self, state, generator: torch.Generator) -> Dict[str, Any]:
        return self.fn(state, generator)


def subset_indices(subset_conf: Optional[dict], n: int, seed: int = 0) -> np.ndarray:
    """`subset:` block: {"type": "range", "args": {start, end}} or
    {"type": "random", "args": {"size": k}}; all of range(n) when absent."""
    if not subset_conf:
        return np.arange(n)
    t = subset_conf.get("type", "range")
    args = subset_conf.get("args", {}) or {}
    if t == "range":
        return np.arange(args.get("start", 0), min(args.get("end", n), n))
    if t == "random":
        return np.random.RandomState(seed).choice(n, size=min(args.get("size", n), n), replace=False)
    raise ValueError(f"unknown subset type: {t!r}")


def _to_host(data: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in data.items()}


def make_stage1_validator(name: str, val_cfg: dict, field, tcfg, rcfg,
                          batches_fn: Callable[[], Iterable], lpips_fn: Optional[Callable] = None) -> Validator:
    """Stage-1 validator: `stage1_eval_forward` over each batch, then the
    depth, dino, nvs and occ metrics the config lists (configs/validation/
    scenedino.yaml; save_best on dino_cos_sim) and, under "images", the
    panels of the first batch's first item. Batches are dicts of tensors on
    the field's device; the occupancy metric reads a batch's `occ_pts`,
    `is_occupied` and `is_visible` (wrapper.py create_occ_eval:128-183,
    the density above the metric's `occ_threshold`, 0.5 by default).
    `lpips_fn` adds LPIPS to the nvs metrics (the JAX validator passes
    none)."""
    from scenedino_torch.eval.vis2d import tb_visualize
    from scenedino_torch.training.trainer import stage1_eval_forward

    metrics_conf = val_cfg.get("metrics", []) or []
    metric_types = [m["type"] for m in metrics_conf]
    metric_args = {m["type"]: (m.get("args") or {}) for m in metrics_conf}

    def run(state, generator: torch.Generator) -> Dict[str, Any]:
        accs = {t: DictMeanAccumulator(t) for t in metric_types if t in ("depth", "dino", "nvs", "occ")}
        panels = None
        for batch in batches_fn():
            out = stage1_eval_forward(field, batch, tcfg, rcfg, generator=generator)
            if "dino" in accs:  # on the device: the grids never go to the host
                accs["dino"].update(compute_dino_metrics(out))
            data = _to_host({k: v for k, v in out.items() if k not in ("dino_pred_grid", "dino_gt_grid")})
            if "depth" in accs:
                accs["depth"].update(compute_depth_metrics(data, **metric_args.get("depth", {})))
            if "nvs" in accs:
                accs["nvs"].update(compute_nvs_metrics(data, lpips_fn))
            if "occ" in accs and "occ_densities" in data:
                thr = metric_args.get("occ", {}).get("occ_threshold", 0.5)
                occ = compute_occ_metrics_visible(data["occ_densities"] > thr, batch["is_occupied"],
                                                  batch["is_visible"])
                accs["occ"].update({k: float(v) for k, v in occ.items()})
            if panels is None:  # the reference logs its visualization of each validation (base_trainer.py:368-378)
                panels = tb_visualize({
                    "imgs": batch["imgs"][0],
                    "depth": data["depth"][0, 0],
                    "rgb": data["rgb"][0, 0, :, :, 0, :],
                    "rgb_gt": data["imgs_gt"][0, 0].transpose(1, 2, 0),
                    "dino_features": out["dino_pred_grid"][0, 0],
                    "dino_gt": out["dino_gt_grid"][0, 0],
                })
        metrics: Dict[str, Any] = {}
        for acc in accs.values():
            metrics.update(acc.compute())
        if panels:
            metrics["images"] = panels
        return metrics

    return Validator(name=name, fn=run, every=_events_every(val_cfg),
                     save_best=SaveBestConfig.from_dict(val_cfg.get("save_best")))


def make_stage2_validator(name: str, val_cfg: dict, field, head, cfg, rcfg,
                          batches_fn: Callable[[], Iterable]) -> Validator:
    """Stage-2 validator: the deterministic downstream forward of each batch
    (view 0, no buffer write, the buffers of the train state) -> the seg
    confusions with the pseudo assignment, and the STEGO correlations
    (configs/validation/semantic.yaml; save_best on
    stego_cluster_weighted_miou with update_model). Each batch's draws come
    from the loop's generator."""
    from scenedino_torch.training.downstream import downstream_forward, draw_stage2

    n_classes, gt_classes = head.cfg.n_classes, head.cfg.gt_classes
    metric_confs = val_cfg.get("metrics", []) or []

    def run(state, generator: torch.Generator) -> Dict[str, Any]:
        seg_acc = stego_acc = None
        for m in metric_confs:
            if m["type"] == "seg":
                args = m.get("args", {}) or {}
                if "n_classes" in args and args["n_classes"] != n_classes:
                    raise ValueError(f"validation {name}: seg n_classes {args['n_classes']} != the head's {n_classes}")
                seg_acc = SegmentationAccumulator("seg", assign_pseudo=m.get("agg_type", "unsup_seg") == "unsup_seg")
            elif m["type"] == "stego":
                stego_acc = ConcatAccumulator("stego")
        for batch in batches_fn():
            B, V = batch["imgs"].shape[:2]
            draws = draw_stage2(generator, cfg, head.cfg, rcfg, B, V, training=False)
            with torch.no_grad():
                seg_data = downstream_forward(field, head, batch, state.buffers, draws, cfg, rcfg, training=False)[0]
            if seg_acc is not None and "segs" in batch:
                seg_acc.update(compute_seg_confusions(seg_data, batch["segs"][:, 0].cpu().numpy(), n_classes,
                                                      gt_classes))
            if stego_acc is not None:
                stego_acc.update(compute_stego_metrics(seg_data))
        metrics: Dict[str, Any] = {}
        for acc in (seg_acc, stego_acc):
            if acc is not None:
                metrics.update(acc.compute())
        return metrics

    return Validator(name=name, fn=run, every=_events_every(val_cfg),
                     save_best=SaveBestConfig.from_dict(val_cfg.get("save_best")))


def make_update_model_fn() -> Callable[[Any, Any, Dict[str, Any]], None]:
    """The pseudo-assignment write-back (semantic_head.py:243-246 via
    base_trainer.py:466-470): `update(head, state, metrics)` writes a
    validation's assignments into the cluster heads' `pseudo_assignment`
    and logs the buffers as they then read (record attribute
    `pseudo_assignment`)."""

    def update(head, state, metrics: Dict[str, Any]) -> None:
        written = {}
        for module, key in ((head.direct_cluster_head, "direct_cluster_assignment"),
                            (head.stego_cluster_head, "stego_cluster_assignment")):
            if key in metrics:
                value = torch.as_tensor(np.asarray(metrics[key]), dtype=module.pseudo_assignment.dtype)
                module.pseudo_assignment.copy_(value.to(module.pseudo_assignment.device))
                written[key] = module.pseudo_assignment.tolist()
        if written:
            logger.info("pseudo assignments written at step %d: %s", state.step, written,
                        extra={"iteration": state.step, "pseudo_assignment": written})

    return update


def _events_every(val_cfg: dict, default: int = 5000) -> int:
    """The ITERATION_COMPLETED `every` of an `events:` list, else `every`."""
    for ev in val_cfg.get("events", []) or []:
        if ev.get("type") == "ITERATION_COMPLETED":
            return int((ev.get("args") or {}).get("every", default))
    return int(val_cfg.get("every", default))
