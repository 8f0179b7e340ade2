"""2D panels for TensorBoard image logging (counterpart of
`scenedino_tpu/eval/vis2d.py`; reference
`scenedino/visualization/vis_2d.py`, `tb_visualize` :457).

Host-side numpy: each `get_*` builder gives an (H, W, 3) float array in
[0, 1] from render outputs (input and reconstructed images, depth, DINO
PCA triplets, k-means maps, segmentation colours, weight and alpha
profiles, flows, occlusions); `tb_visualize` picks the builders that the
keys of its input call for. Inputs may be numpy arrays or tensors
(copied to the host). The PCA and the k-means run through the port's
`ops.pca` on the host; k-means++'s draws come from a `torch.Generator`
seeded from `seed` unless they are given.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from scenedino_torch.datasets.labels import TRAIN_CLASS_COLORS
from scenedino_torch.ops.kmeans import KMeansPPDraws, draw_kmeans_pp

# a compact turbo-like colour map (no matplotlib)
_TURBO_ANCHORS = np.array(
    [
        (0.19, 0.07, 0.23), (0.28, 0.26, 0.71), (0.15, 0.58, 0.96),
        (0.05, 0.83, 0.72), (0.45, 0.97, 0.33), (0.85, 0.86, 0.13),
        (0.99, 0.58, 0.16), (0.90, 0.22, 0.08), (0.48, 0.02, 0.01),
    ],
    np.float32,
)


def _np(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def colormap(x) -> np.ndarray:
    """A scalar map in [0, 1] -> RGB through the turbo-like gradient."""
    x = np.clip(_np(x, np.float32), 0.0, 1.0)
    pos = x * (len(_TURBO_ANCHORS) - 1)
    i0 = np.clip(pos.astype(int), 0, len(_TURBO_ANCHORS) - 2)
    t = (pos - i0)[..., None]
    return _TURBO_ANCHORS[i0] * (1 - t) + _TURBO_ANCHORS[i0 + 1] * t


def _norm01(x) -> np.ndarray:
    x = _np(x, np.float32)
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / max(hi - lo, 1e-6)


def get_input_imgs(imgs) -> np.ndarray:
    """(V, 3, H, W) in [-1, 1] -> a horizontal strip (H, V * W, 3)."""
    v = np.concatenate([im.transpose(1, 2, 0) for im in _np(imgs)], axis=1)
    return np.clip(v * 0.5 + 0.5, 0, 1)


def get_depth(depth, z_near=3.0, z_far=80.0) -> np.ndarray:
    """(H, W) depth -> the inverse depth's colour map (vis_2d get_depth)."""
    inv = 1.0 / np.clip(_np(depth), z_near, z_far)
    lo, hi = 1.0 / z_far, 1.0 / z_near
    return colormap((inv - lo) / (hi - lo))


def get_reconstruction(rgb) -> np.ndarray:
    """(H, W, 3) in [0, 1]."""
    return np.clip(_np(rgb), 0, 1)


def get_dino_pca(features, fit_on=None, from_dim: int = 0) -> np.ndarray:
    """(H, W, C) features -> a PCA RGB triplet: the unit-normalized centred
    features (the reference's norm=True, trainer.py:301-303) projected on
    components from_dim .. from_dim + 2, mapped by * 0.5 + 0.5."""
    from scenedino_torch.ops.pca import fit_pca, transform_pca

    features = torch.from_numpy(_np(features, np.float32))
    fit = features if fit_on is None else torch.from_numpy(_np(fit_on, np.float32))
    state = fit_pca(fit.reshape(-1, features.shape[-1]), num_components=from_dim + 3)
    rgb = transform_pca(state, features, norm=True, from_dim=from_dim).numpy()
    return np.clip(rgb * 0.5 + 0.5, 0, 1)


def get_kmeans_map(features, n_clusters: int = 8, seed: int = 0,
                   draws: Optional[KMeansPPDraws] = None) -> np.ndarray:
    """(H, W, C) -> a tab10-coloured cosine k-means label map; k-means++'s
    `draws` are drawn from a generator seeded from `seed` when not given."""
    from scenedino_torch.ops.pca import fit_transform_kmeans

    features = torch.from_numpy(_np(features, np.float32))
    if draws is None:
        n_points = features.reshape(-1, features.shape[-1]).shape[0]
        draws = draw_kmeans_pp(n_points, n_clusters, torch.Generator().manual_seed(seed))
    colors, _ = fit_transform_kmeans(features, n_clusters, draws=draws)
    return colors.numpy()


def get_segmentation(labels) -> np.ndarray:
    """(H, W) train ids (-1: ignore, black) -> class colours
    (SemanticHead.visualize, semantic_head.py:255-257)."""
    lab = _np(labels, np.int64)
    lab = np.where(lab < 0, len(TRAIN_CLASS_COLORS) - 1, lab)
    return TRAIN_CLASS_COLORS[lab]


def get_alpha_profile(weights) -> np.ndarray:
    """(H, W, K) compositing weights -> their normalized entropy's heat map."""
    w = np.clip(_np(weights, np.float64), 1e-8, 1.0)
    w = w / w.sum(-1, keepdims=True)
    ent = -(w * np.log(w)).sum(-1) / np.log(w.shape[-1])
    return colormap(ent)


def get_reconstruction_rmse(rgb, rgb_gt) -> np.ndarray:
    """The per-pixel colour error on the reference's absolute scale
    (vis_2d.py:113: mse / 2 clamped to [0, 1])."""
    err = np.mean((_np(rgb) - _np(rgb_gt)) ** 2, axis=-1) / 2.0
    return colormap(np.clip(err, 0.0, 1.0))


def get_dino_cos_sim(pred, gt) -> np.ndarray:
    """The cosine similarity of rendered and teacher features
    (vis_2d.py:121-131), mapped to [0, 1]."""
    p = _np(pred, np.float64)
    g = _np(gt, np.float64)
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
    return colormap(np.clip((p * g).sum(-1) * 0.5 + 0.5, 0, 1))


def get_invalids(invalid) -> np.ndarray:
    """The mean invalid fraction of each pixel (vis_2d.py:307-316)."""
    inv = _np(invalid, np.float32)
    while inv.ndim > 2:
        inv = inv.mean(-1)
    return colormap(inv)


def get_ray_entropy(weights, z_samps=None) -> np.ndarray:
    """The termination distribution's entropy (vis_2d.py:319-348)."""
    return get_alpha_profile(weights)


def get_ray_entropy_weights(weights) -> np.ndarray:
    """The entropy of the compositing weights (vis_2d.py:335-348)."""
    return get_alpha_profile(weights)


def get_per_patch_weight(weight) -> np.ndarray:
    """The salience downsampler's per-patch weights, min-max normalized
    (vis_2d.py:264-271)."""
    return colormap(_norm01(weight))


def get_alpha_sum(weights) -> np.ndarray:
    """A ray's total opacity, the sum of its weights (vis_2d.py:351-361)."""
    return colormap(np.clip(_np(weights, np.float32).sum(-1), 0, 1))


def get_depth_profile(z_samps, weights, row: Optional[int] = None) -> np.ndarray:
    """The weights along one image row (the middle one by default) as a
    (K, W) heat image (vis_2d.py:289-304)."""
    w = _np(weights, np.float32)  # (H, W, K)
    prof = w[w.shape[0] // 2 if row is None else row].T
    return colormap(prof / max(float(prof.max()), 1e-6))


def compute_profile(sigmas, invalid=None, dim: int = 1) -> np.ndarray:
    """The top-down profile of a dense sigma grid (vis_2d.py:21-59): the
    share of samples along `dim` before the cumulative density crosses 1.
    sigmas (res_x, res_y, res_z); `invalid` voxels count as solid."""
    s = _np(sigmas, np.float32)
    if invalid is not None:
        s = np.where(_np(invalid, bool), 1.0, s)
    return (np.cumsum(s, axis=dim) <= 1.0).astype(np.float32).sum(axis=dim) / s.shape[dim]


def get_profiles(profile) -> np.ndarray:
    """A profile map's heat image, transposed (vis_2d.py:61-70)."""
    return colormap(_norm01(_np(profile).T))


def get_uncertainty(uncert) -> np.ndarray:
    """Per-pixel uncertainty, min-max normalized (vis_2d.py:364-377)."""
    return colormap(_norm01(uncert))


def get_downsampling_weight(weight) -> np.ndarray:
    """The salience downsampler's pixel weights over their max (vis_2d.py:244-251)."""
    w = _np(weight, np.float32)
    return colormap(w / max(float(w.max()), 1e-6))


def get_downsampling_salience(sal) -> np.ndarray:
    """The salience map, min-max normalized (vis_2d.py:254-261)."""
    return colormap(_norm01(sal))


def get_dino_artifacts(art) -> np.ndarray:
    """The artifact field's PCA panel (vis_2d.py:172-178); art (H, W, C)."""
    return get_dino_pca(art)


def flow_to_image(flow) -> np.ndarray:
    """Optical flow (H, W, 2) -> the Middlebury colour wheel (H, W, 3) in
    [0, 1] (vis_2d.py:379-400): hue the direction, saturation the magnitude
    over the image's largest."""
    f = _np(flow, np.float32)
    u, v = f[..., 0], f[..., 1]
    mag = np.sqrt(u * u + v * v)
    mag = mag / max(float(mag.max()), 1e-6)
    hue = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0
    h6 = hue * 6.0
    i = np.floor(h6).astype(np.int32) % 6
    frac = h6 - np.floor(h6)
    p, q, t = 1.0 - mag, 1.0 - mag * frac, 1.0 - mag * (1.0 - frac)
    one = np.ones_like(mag)
    lut = np.stack([np.stack(c, -1) for c in ((one, t, p), (q, one, p), (p, one, t), (p, q, one), (t, p, one),
                                              (one, p, q))], 0)  # (6, H, W, 3)
    return np.take_along_axis(lut, i[None, ..., None], axis=0)[0]


def get_flow(flow_fwd, flow_bwd) -> np.ndarray:
    """Forward and backward flow side by side (vis_2d.py:440-456)."""
    return np.concatenate([flow_to_image(flow_fwd), flow_to_image(flow_bwd)], axis=1)


def get_rendered_flow(flow_ndc, height: int, width: int) -> np.ndarray:
    """Rendered NDC scene flow -> a pixel flow's colour image (vis_2d.py:379-400:
    the NDC deltas times (W / 2, H / 2))."""
    f = _np(flow_ndc, np.float32)
    return flow_to_image(np.stack([f[..., 0] * 0.5 * width, f[..., 1] * 0.5 * height], -1))


def get_occlusions(occ_fwd, occ_bwd) -> np.ndarray:
    """Forward and backward occlusion masks side by side (vis_2d.py:426-438)."""
    return colormap(_norm01(np.concatenate([_np(occ_fwd), _np(occ_bwd)], axis=-1)))


def get_predicted_occlusions(occ) -> np.ndarray:
    """The ray ground truth's predicted occlusion channel (vis_2d.py:404-412)."""
    return colormap(_norm01(occ))


def get_depth_direct(depths) -> np.ndarray:
    """A dataset's depth -> the inverse depth's heat map (vis_2d.py:415-423)."""
    return colormap(_norm01(1.0 / np.maximum(_np(depths, np.float32), 1e-6)))


def tb_visualize(data: Dict, z_near: float = 3.0, z_far: float = 80.0) -> Dict[str, np.ndarray]:
    """The panels that the keys of `data` call for (vis_2d.py:457-515)."""
    out = {}
    if "imgs" in data:
        out["input_imgs"] = get_input_imgs(data["imgs"])
    if "depth" in data:
        out["depth"] = get_depth(data["depth"], z_near, z_far)
    if "rgb" in data:
        out["reconstruction"] = get_reconstruction(data["rgb"])
        if "rgb_gt" in data:
            out["reconstruction_rmse"] = get_reconstruction_rmse(data["rgb"], data["rgb_gt"])
    if "dino_features" in data:
        out["dino_pca"] = get_dino_pca(data["dino_features"])
        out["dino_kmeans"] = get_kmeans_map(data["dino_features"])
        if "dino_gt" in data:
            out["dino_cos_sim"] = get_dino_cos_sim(data["dino_features"], data["dino_gt"])
            out["dino_gt_pca"] = get_dino_pca(data["dino_gt"])
    if "segs_pred" in data:
        out["segmentation"] = get_segmentation(data["segs_pred"])
    if "segs_gt" in data:
        out["segmentation_gt"] = get_segmentation(data["segs_gt"])
    if "invalid" in data:
        out["invalids"] = get_invalids(data["invalid"])
    if "weights" in data:
        out["weight_entropy"] = get_alpha_profile(data["weights"])
        out["alpha_sum"] = get_alpha_sum(data["weights"])
        if "z_samps" in data:
            out["depth_profile"] = get_depth_profile(data["z_samps"], data["weights"])
    if "uncert" in data:
        out["uncertainty"] = get_uncertainty(data["uncert"])
    if "profiles" in data:
        out["profile"] = get_profiles(data["profiles"])
    if "dino_artifacts" in data:
        out["dino_artifacts"] = get_dino_artifacts(data["dino_artifacts"])
    if "downsample_weight" in data:
        out["downsample_weight"] = get_downsampling_weight(data["downsample_weight"])
    if "downsample_salience" in data:
        out["downsample_salience"] = get_downsampling_salience(data["downsample_salience"])
    if "per_patch_weight" in data:
        out["per_patch_weight"] = get_per_patch_weight(data["per_patch_weight"])
    if "flows_fwd" in data and "flows_bwd" in data:
        out["flow"] = get_flow(data["flows_fwd"], data["flows_bwd"])
    if "rendered_flow" in data:
        out["rendered_flow"] = get_rendered_flow(data["rendered_flow"], *data["rendered_flow"].shape[:2])
    if "occs_fwd" in data and "occs_bwd" in data:
        out["occlusions"] = get_occlusions(data["occs_fwd"], data["occs_bwd"])
    if "occ_pred" in data:
        out["predicted_occlusions"] = get_predicted_occlusions(data["occ_pred"])
    if "depths" in data:
        out["depth_direct"] = get_depth_direct(data["depths"])
    return out
