"""2D unsupervised segmentation evaluator (the port's
`scenedino_tpu/eval/seg2d.py:30-200`; reference
`scenedino/evaluation/unified_evaluator.py`, `base_evaluator.py`).

Each frame: encode, a full-frame render of the encode camera, the 64 ->
768 expansion, the semantic head in each mode (optionally refined by the
window CRF as "<mode>_crf"), and the 19x19 confusion against the target;
then the pseudo-label assignment for the cluster heads and the (weighted)
mIoU and accuracy (metrics.py:370-456).

The render takes the fast path where the reference does (one frame, a
foldable head, the field's own z range): the fp32 fold and the
encode-view render, K6 on the three-TF32-pass state. Otherwise the generic
path: `ImageRaySampler` rays through `render_rays_chunked` of the field.
The strata of frame i are an explicit input (`draws(i)`), else drawn from
a generator seeded from `seed + i`. `run_sharded` evaluates a group of
frames at a time over a list of devices, one frame each, with the same
draws, so its confusions and metrics are `run()`'s exactly.

The CRF (`apply_crf`) is the window CRF where the tensors lie
(`crf_method="window"`, eval/crf.py) or the exact permutohedral lattice on
the host (`"exact"`, eval/permutohedral.py), as the reference's pydensecrf
call runs; the exact CRF refines a frame's four modes in one
pass over the frame's lattices and logs its host ms (`crf_ms`).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from scenedino_torch.core.ray_sampler import ImageRaySampler
from scenedino_torch.eval.metrics import evaluate_confusion, seg_confusion_matrix
from scenedino_torch.ops.fast_field import build_fast_state, can_fold, render_encode_view
from scenedino_torch.parallel import mesh
from scenedino_torch.renderer.nerf import RenderConfig, render_rays_chunked

MODES = ("stego_kmeans", "stego_linear", "direct_kmeans", "direct_linear")
logger = logging.getLogger("evaluation")


@dataclasses.dataclass
class Seg2DEvaluator:
    """field: a `SceneField` with its 64 -> 768 expansion; head: a
    `SemanticHead`. Both on the device the frames go to."""

    field: torch.nn.Module
    head: torch.nn.Module
    image_size: tuple = (192, 640)
    z_near: float = 3.0
    z_far: float = 80.0
    n_coarse: int = 32
    chunk: int = 15360
    n_classes: int = 19
    modes: tuple = MODES
    # the CRF over each mode's labels (semantic_head.py:224-240: the one-hot
    # labels as unary, the rendered colours as appearance): "window" or "exact"
    apply_crf: bool = False
    crf_method: str = "window"
    use_fast_render: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.crf_method not in ("window", "exact"):
            raise ValueError(f"crf_method must be 'window' or 'exact', got {self.crf_method!r}")
        H, W = self.image_size
        self.sampler = ImageRaySampler(self.z_near, self.z_far, H, W)
        self.rcfg = RenderConfig(n_coarse=self.n_coarse)

    @property
    def result_modes(self):
        return tuple(self.modes) + (tuple(m + "_crf" for m in self.modes) if self.apply_crf else ())

    def uses_fast_render(self, n_frames: int = 1) -> bool:
        """The reference's condition (seg2d.py:83-92): the folded render
        builds rays from the field's z range, so another range takes the
        generic path."""
        field = self.field
        return (self.use_fast_render and n_frames == 1 and can_fold(field)
                and (self.z_near, self.z_far) == (field.cfg.z_near, field.cfg.z_far))

    @torch.no_grad()
    def render(self, imgs: torch.Tensor, projs: torch.Tensor, poses: torch.Tensor, u: torch.Tensor):
        """Encode and render one frame's encode view: imgs (1, V, 3, H, W),
        the whole sample (V = 1 for Cityscapes and BDD, 8 for a KITTI-360
        item), of which view 0 is encoded (`ids_encoder=(0,)`, as
        scenedino_tpu/eval/seg2d.py:77-80); u (H*W, n_coarse) the strata.
        Returns (depth (H, W), dino64 (H, W, D), rgb (H, W, 3))."""
        H, W = self.image_size
        field, rcfg = self.field, self.rcfg
        state = field.encode(imgs, projs, poses, ids_encoder=(0,))
        if self.uses_fast_render(imgs.shape[0]):
            fs = build_fast_state(field, state, compute_dtype=torch.float32)
            return render_encode_view(fs, field.cfg, H, W, u=u, n_coarse=rcfg.n_coarse, lindisp=rcfg.lindisp,
                                      hard_alpha_cap=rcfg.hard_alpha_cap)
        rays = self.sampler.sample(poses, projs)

        def field_fn(xyz, only_density=False):
            return field(state, xyz, only_density=only_density)

        out = render_rays_chunked(field_fn, rays[..., :8], u, rcfg, chunk=self.chunk)["coarse"]
        return out["depth"].reshape(H, W), out["dino_features"].reshape(H, W, -1), out["rgb"].reshape(H, W, -1)[..., :3]

    @torch.no_grad()
    def labels(self, rendered) -> Dict[str, torch.Tensor]:
        """Each mode's (H, W) labels (and "<mode>_crf"), and "depth", from a
        frame's `render`."""
        H, W = self.image_size
        depth, dino64, rgb = rendered
        dino768 = self.field.expand_dim(dino64)
        preds = {mode: self.head(dino768, mode=mode).reshape(H, W) for mode in self.modes}
        if self.apply_crf:
            # the rendered colours are in [0, 1] already (encode stores them so)
            image = torch.clamp(rgb, 0.0, 1.0)
            if self.crf_method == "exact":
                preds.update(self._exact_crf(image, preds))
            else:
                from scenedino_torch.eval.crf import dense_crf

                eye = torch.eye(self.n_classes, device=dino768.device)
                for mode in self.modes:
                    preds[mode + "_crf"] = torch.argmax(dense_crf(image, eye[preds[mode]]), -1)
        preds["depth"] = depth.reshape(H, W)
        return preds

    def _exact_crf(self, image: torch.Tensor, preds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each mode's "<mode>_crf" labels by the exact CRF on the host (the
        reference's pydensecrf placement), back on the labels' device."""
        from scenedino_torch.eval.permutohedral import crf_kernels, dense_crf_exact

        t0 = time.perf_counter()
        eye = np.eye(self.n_classes, dtype=np.float32)
        onehots = np.stack([eye[preds[mode].cpu().numpy()] for mode in self.modes])
        probs = dense_crf_exact(None, onehots, kernels=crf_kernels(image.float().cpu().numpy()))
        out = {mode + "_crf": torch.from_numpy(p.argmax(-1)).to(preds[mode].device)
               for mode, p in zip(self.modes, probs)}
        crf_ms = (time.perf_counter() - t0) * 1e3
        logger.info("exact CRF of %d modes: %.1f ms", len(self.modes), crf_ms, extra={"crf_ms": crf_ms})
        return out

    def predict(self, imgs: torch.Tensor, projs: torch.Tensor, poses: torch.Tensor,
                u: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`labels` of the frame's `render`."""
        return self.labels(self.render(imgs, projs, poses, u))

    def draws(self, i: int, device) -> torch.Tensor:
        """Frame i's strata (H*W, n_coarse), from a generator seeded from seed + i."""
        H, W = self.image_size
        g = torch.Generator(device=device).manual_seed(self.seed + i)
        return torch.rand(H * W, self.n_coarse, generator=g, device=device)

    def run(self, dataset: Sequence, max_frames: Optional[int] = None,
            draws: Optional[Callable[[int], torch.Tensor]] = None) -> Dict:
        """Accumulate the confusions over a dataset (seg2d samples, or
        KITTI-360 items with "segs") against each sample's "segs"[0] and
        score them. `draws(i)` gives frame i's strata (default `self.draws`). Each
        frame's host ms (read, predict with the confusions) is logged."""
        device = next(self.field.parameters()).device
        conf = {m: np.zeros((self.n_classes, self.n_classes), np.int64) for m in self.result_modes}
        n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        for i in range(n):
            t0 = time.perf_counter()
            sample = dataset[i]
            t1 = time.perf_counter()
            u = draws(i) if draws is not None else self.draws(i, device)
            batch = [torch.as_tensor(sample[k])[None].to(device) for k in ("imgs", "projs", "poses")]
            preds = self.predict(*batch, u=u.to(device))
            target = np.asarray(sample["segs"][0])
            for m in self.result_modes:
                conf[m] += seg_confusion_matrix(target, preds[m], self.n_classes)
            t2 = time.perf_counter()
            read_ms, frame_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
            logger.info("frame %d: read %.1f ms, predict and confusions %.1f ms", i, read_ms, frame_ms,
                        extra={"frame": i, "read_ms": read_ms, "frame_ms": frame_ms})
        results = {m: evaluate_confusion(conf[m], assign_pseudo="kmeans" in m) for m in self.result_modes}
        results["n_frames"] = n
        return results

    def run_sharded(self, dataset: Sequence, devices=None, max_frames: Optional[int] = None,
                    draws: Optional[Callable[[int], torch.Tensor]] = None) -> Dict:
        """`run` over a list of devices (reference seg2d.py:179-279; default:
        every visible card, or the one device the field is on): frame g0 + j
        of each group goes to device j, which renders it through its replica
        of the field and head with frame g0 + j's draws; the integer
        confusions come back to the host and are summed in frame order, so
        every metric is `run()`'s exactly. The last group may be short. Each
        group's host ms (read, predict with the confusions) is logged."""
        if self.apply_crf and self.crf_method == "exact":
            raise ValueError("crf_method='exact' is supported by run() only")
        home = next(self.field.parameters()).device
        devices = mesh.make_mesh(device=home) if devices is None else [torch.device(d) for d in devices]
        fields, heads = (mesh.replicate(m, devices) for m in (self.field, self.head))
        evaluators = {d: dataclasses.replace(self, field=fields[d], head=heads[d]) for d in fields}
        conf = {m: np.zeros((self.n_classes, self.n_classes), np.int64) for m in self.result_modes}
        n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
        for g0 in range(0, n, len(devices)):
            t0 = time.perf_counter()
            samples = [dataset[i] for i in range(g0, min(g0 + len(devices), n))]
            t1 = time.perf_counter()

            def share(j: int, d: torch.device) -> Dict[str, np.ndarray]:
                sample = samples[j]
                u = draws(g0 + j) if draws is not None else self.draws(g0 + j, d)
                batch = [torch.as_tensor(sample[k])[None].to(d) for k in ("imgs", "projs", "poses")]
                preds = evaluators[d].predict(*batch, u=u.to(d))
                target = np.asarray(sample["segs"][0])
                return {m: seg_confusion_matrix(target, preds[m], self.n_classes) for m in self.result_modes}

            for frame in mesh.run_shares(share, devices[:len(samples)]):
                for m in self.result_modes:
                    conf[m] += frame[m]
            t2 = time.perf_counter()
            read_ms, group_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
            logger.info("frames %d-%d: read %.1f ms, predict and confusions %.1f ms", g0, g0 + len(samples) - 1,
                        read_ms, group_ms, extra={"frame": g0, "frames": list(range(g0, g0 + len(samples))),
                                                  "read_ms": read_ms, "group_ms": group_ms})
        results = {m: evaluate_confusion(conf[m], assign_pseudo="kmeans" in m) for m in self.result_modes}
        results["n_frames"] = n
        return results
