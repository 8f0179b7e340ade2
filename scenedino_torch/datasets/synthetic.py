"""Synthetic multi-view dataset (counterpart of
`scenedino_tpu/datasets/synthetic.py`, numpy, the same arrays).

Renders lambertian scenes of coloured boxes on a ground plane with exact
analytic geometry, so a training run has a real photometric signal and
known depth without any data on disk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


def _render_scene(pose_c2w, K_ndc, H, W, boxes, rng_color, textured=True):
    """Ray-march a scene of axis-aligned boxes + ground plane. Returns
    (rgb (3, H, W) in [0,1], depth (H, W), seg (H, W) int: 0=ground,
    1=sky, 2+k=box k).

    textured: modulate surface albedo by a function of the 3D hit POINT
    (world coordinates), so the pattern is consistent across views. Flat
    lambertian surfaces make depth photometrically unidentifiable inside
    regions (only occlusion edges + the smoothness prior constrain it);
    world-anchored texture makes multi-view depth a well-posed target, so
    convergence runs can assert depth against the analytic GT."""
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy = np.meshgrid(xs, ys)
    fx, fy = K_ndc[0, 0], K_ndc[1, 1]
    cx, cy = K_ndc[0, 2], K_ndc[1, 2]
    dirs = np.stack([(gx - cx) / fx, (gy - cy) / fy, np.ones_like(gx)], -1)
    R = pose_c2w[:3, :3]
    o = pose_c2w[:3, 3]
    d = dirs @ R.T
    rgb = np.zeros((H, W, 3), np.float32)
    depth = np.full((H, W), 1e5, np.float32)
    seg = np.full((H, W), 1, np.int32)

    def _albedo_mod(t, mask, freq):
        """Smooth world-anchored pattern at the hit points o + t*d in
        [1-a, 1+a] (smooth, not a checker: band-limited so the 2x-grid
        encoder can represent it at these resolutions).

        The third term carries deliberately HIGHER x-frequency
        (4.1*freq ~ 7.8 rad/m on the ground): stereo disparity is
        horizontal, and horizontal image gradients on the ground come
        almost entirely from x-variation of the albedo (the z-variation
        projects vertically). With only the base freq (1.9 rad/m -> 87 px
        x-period at 4 m) the near-ground photometric loss was nearly flat
        along the disparity direction and a trained field settled ~9%
        deep with almost no loss penalty (docs/convergence/README.md,
        round-4 diagnosis). The 0.81 m x-period term stays above the
        2 px Nyquist limit out to ~35 m at 96x192."""
        if not textured:
            return np.ones((mask.sum(),), np.float32)
        p = o[None, :] + t[mask][:, None] * d[mask]
        return (
            1.0
            + 0.22 * np.sin(freq * p[:, 0]) * np.cos(freq * p[:, 2])
            + 0.12 * np.sin(1.7 * freq * p[:, 1] + 1.3)
            + 0.18 * np.sin(4.1 * freq * p[:, 0] + 0.7) * np.cos(0.9 * freq * p[:, 2])
        ).astype(np.float32)

    # ground plane y = 1.5 (y down)
    t_g = (1.5 - o[1]) / np.where(np.abs(d[..., 1]) > 1e-6, d[..., 1], 1e-6)
    hit_g = (t_g > 0.1) & (t_g < depth)
    depth = np.where(hit_g, t_g, depth)
    rgb[hit_g] = np.array([0.4, 0.35, 0.3]) * _albedo_mod(t_g, hit_g, 1.9)[:, None]
    seg[hit_g] = 0

    for bi, (center, size, color) in enumerate(boxes):
        lo = np.asarray(center) - np.asarray(size) / 2
        hi = np.asarray(center) + np.asarray(size) / 2
        inv = 1.0 / np.where(np.abs(d) > 1e-9, d, 1e-9)
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        hit = (tmax > tmin) & (tmax > 0.1) & (tmin < depth) & (tmin > 0.1)
        depth = np.where(hit, tmin, depth)
        rgb[hit] = color * _albedo_mod(tmin, hit, 2.6)[:, None]
        seg[hit] = 2 + bi

    rgb = np.clip(rgb, 0.0, 1.0)
    sky = depth > 9e4
    rgb[sky] = np.array([0.6, 0.75, 0.95])
    seg[sky] = 1
    # GT depth valid only within the renderable range, like lidar GT
    # (KITTI velodyne returns top out near ~80 m and has a ~3 m blind
    # radius around the sensor; the reference's depth metrics clamp PRED
    # to 80 and mask gt == 0 — metrics.py:59-60). Near-horizon ground
    # hits run to ~1e5 m here, and the bottom rows of this wide-FOV
    # camera see ground closer than the shipped z_near=3; leaving either
    # in the GT poisons abs_rel with pixels no [z_near, z_far]-bounded
    # field could ever match.
    depth = np.where(sky | (depth > 80.0) | (depth < 3.0), 0.0, depth)
    return rgb.transpose(2, 0, 1), depth, seg


@dataclasses.dataclass
class SyntheticMultiViewDataset:
    """Returns the same dict layout as KITTI360Dataset with V views along a
    forward-moving trajectory + small stereo baseline."""

    length: int = 64
    n_views: int = 8
    image_size: Tuple[int, int] = (48, 96)
    seed: int = 0
    textured: bool = True
    # items are deterministic per index, so long runs (thousands of steps
    # over a length-64 set) re-ray-march identical scenes; memoize them.
    # Copies are returned so a consumer mutating a batch cannot poison the
    # cache. 64 items at 96x192x8 views is ~115 MB — fine on host RAM.
    cache: bool = True

    def __post_init__(self):
        self.K = np.array([[1.1, 0, 0], [0, 1.1 * self.image_size[1] / self.image_size[0] / 2, 0], [0, 0, 1]], np.float32)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return self.length

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        if self.cache:
            item = self._cache.get(index)
            if item is None:
                item = self._render_item(index)
                self._cache[index] = item
            return {k: v.copy() for k, v in item.items()}
        return self._render_item(index)

    def _render_item(self, index) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + index)
        H, W = self.image_size
        boxes = []
        for _ in range(6):
            center = np.array([rng.uniform(-6, 6), rng.uniform(-0.5, 1.0), rng.uniform(6, 30)])
            size = rng.uniform(1.0, 4.0, 3)
            color = rng.uniform(0.1, 0.9, 3).astype(np.float32)
            boxes.append((center, size, color))

        imgs, poses = [], []
        # stereo pairs only: an odd n_views would emit n_views-1 images
        # but n_views intrinsics (silent mispairing downstream)
        if self.n_views % 2:
            raise ValueError(f"n_views must be even (stereo pairs), got {self.n_views}")
        V = self.n_views
        n_t = V // 2
        depth0 = seg0 = None
        for t in range(n_t):
            for lr in range(2):
                pose = np.eye(4, dtype=np.float32)
                pose[0, 3] = lr * 0.54  # stereo baseline
                pose[2, 3] = t * 1.2  # forward motion
                rgb, depth, seg = _render_scene(
                    pose, self.K, H, W, boxes, rng, textured=self.textured
                )
                if t == 0 and lr == 0:
                    depth0, seg0 = depth, seg
                imgs.append(rgb * 2 - 1)
                poses.append(pose)
        # reorder to [left x n_t, right x n_t] to mirror KITTI-360's layout
        order = [2 * t for t in range(n_t)] + [2 * t + 1 for t in range(n_t)]
        imgs = [imgs[i] for i in order]
        poses = [poses[i] for i in order]

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "projs": np.stack([self.K] * V).astype(np.float32),
            # GT of the front view like KITTI-360 (old_kitti_360.py:1067-1078):
            # analytic depth (0 = invalid/sky) + semantic ids (0 ground,
            # 1 sky, 2+k box k)
            "depths": depth0[None].astype(np.float32),
            "segs": seg0[None].astype(np.int32),
            "index": np.array([index]),
        }
