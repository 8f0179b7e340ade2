"""Feature-space PCA and k-means colouring (counterpart of
`scenedino_tpu/ops/pca.py:20-83`; reference
`scenedino/models/backbones/dino/visualization.py`).

`fit_pca` standardizes the features and takes their exact SVD (the
reference's `torch.pca_lowrank` is randomized; the JAX package took the
full SVD, and so does the port), with the reference's sign rule
(`_svd_flip`); `transform_pca` projects onto a triplet of components as
RGB. `fit_transform_kmeans` colours a cosine k-means label map with
matplotlib's tab10 table, over the port's `ops.kmeans` with its draws
explicit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from scenedino_torch.ops.kmeans import KMeansPPDraws, draw_kmeans_pp, kmeans_fit


class PCAState(NamedTuple):
    mean: torch.Tensor  # (1, C)
    components: torch.Tensor  # (C, K), one component a column


def _svd_flip(u: torch.Tensor, v: torch.Tensor):
    """Deterministic signs (visualization.py:66-92): each component's
    largest-|u| entry (the first on a tie) is made positive."""
    max_abs = torch.argmax(u.abs(), dim=-2)
    signs = torch.sign(u[max_abs, torch.arange(u.shape[-1], device=u.device)])
    return u * signs, v * signs[:, None]


def fit_pca(features: torch.Tensor, num_components: int = 9) -> PCAState:
    """Fit PCA on (N, C) features (visualization.py:36-63): rows with a
    non-finite value are left out of the mean and the standard deviation
    (ddof 1), the standardized features' SVD gives the components."""
    finite = torch.isfinite(features).all(-1, keepdim=True)
    f = torch.where(finite, features, 0.0)
    n = torch.clamp_min(finite.sum(), 1)
    mean = f.sum(0, keepdim=True) / n
    centered = torch.where(finite, features - mean, 0.0)
    std = torch.sqrt((centered ** 2).sum(0, keepdim=True) / torch.clamp_min(n - 1, 1))
    u, _, vt = torch.linalg.svd(centered / (std + 1e-8), full_matrices=False)
    _, vt = _svd_flip(u, vt)
    return PCAState(mean=mean, components=vt[:num_components].T)


def transform_pca(state: PCAState, features: torch.Tensor, norm: bool = False, from_dim: int = 0) -> torch.Tensor:
    """Project onto components from_dim .. from_dim + 2 as RGB
    (visualization.py:30-35); `norm` L2-normalizes the centred rows first."""
    f = features - state.mean
    if norm:
        f = f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1, keepdim=True), 1e-12)
    return f @ state.components[:, from_dim:from_dim + 3]


# matplotlib's tab10 colours for k-means label maps (visualization.py:18-19)
TAB10 = torch.tensor([
    (0.1216, 0.4667, 0.7059), (1.0000, 0.4980, 0.0549),
    (0.1725, 0.6275, 0.1725), (0.8392, 0.1529, 0.1569),
    (0.5804, 0.4039, 0.7412), (0.5490, 0.3373, 0.2941),
    (0.8902, 0.4667, 0.7608), (0.4980, 0.4980, 0.4980),
    (0.7373, 0.7412, 0.1333), (0.0902, 0.7451, 0.8118),
])


def fit_transform_kmeans(features: torch.Tensor, n_clusters: int = 8, n_iters: int = 20,
                         draws: Optional[KMeansPPDraws] = None, generator: Optional[torch.Generator] = None):
    """Cosine k-means label map coloured through tab10
    (visualization.py:112-152): features (..., C) -> (rgb (..., 3),
    centers (n_clusters, C)). `draws` are k-means++'s (drawn from
    `generator` when None). The colour of label l is tab10's entry
    clip(floor(l / (n - 1) * 10), 0, 9), matplotlib's ListedColormap."""
    flat = features.reshape(-1, features.shape[-1])
    if draws is None:
        draws = draw_kmeans_pp(flat.shape[0], n_clusters, generator, flat.device)
    centers, labels, _ = kmeans_fit(flat, n_clusters, draws, n_iters)
    frac = labels.float() / max(n_clusters - 1, 1)
    idx = torch.clamp(torch.floor(frac * len(TAB10)).long(), 0, len(TAB10) - 1)
    return TAB10.to(flat.device)[idx].reshape(*features.shape[:-1], 3), centers
