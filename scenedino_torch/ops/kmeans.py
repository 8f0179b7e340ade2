"""Cosine k-means (counterpart of `scenedino_tpu/ops/kmeans.py:24-94`):
k-means++ seeding, nearest-centre assignment and Lloyd updates on the unit
sphere.

The reference's k-means++ draws with `jax.random.categorical`, which is
`argmax(logits + gumbel)`; the port takes that Gumbel noise as an input
(`KMeansPPDraws`), so a caller that must agree with the reference hands
both the same numbers. Ties of an argmax go to the lowest index, as in
`jnp.argmax`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from scenedino_torch.core import safe_normalize


class KMeansPPDraws(NamedTuple):
    """k-means++'s draws: the first centre's index, and one row of Gumbel
    noise over the N points for each later centre."""

    first: int
    gumbel: torch.Tensor  # (n_clusters - 1, N)


def gumbel(shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), as
    `jax.random.gumbel` forms it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def draw_kmeans_pp(n_points: int, n_clusters: int, generator: Optional[torch.Generator] = None,
                   device=None) -> KMeansPPDraws:
    first = int(torch.randint(0, n_points, (), generator=generator, device=device))
    return KMeansPPDraws(first, gumbel((n_clusters - 1, n_points), generator, device))


def kmeans_plus_plus_init(features: torch.Tensor, n_clusters: int, draws: KMeansPPDraws) -> torch.Tensor:
    """Cosine k-means++ seeding (semantic_head.py:329-345): centres drawn
    from the (normalized) data with probability proportional to
    (1 - the largest cosine similarity to a chosen centre)^2.
    features (N, D) -> (n_clusters, D)."""
    feats = safe_normalize(features)
    N, D = feats.shape
    centers = feats.new_zeros(n_clusters, D)
    centers[0] = feats[draws.first]
    rows = torch.arange(n_clusters, device=feats.device)[:, None]
    for count in range(1, n_clusters):
        sim = torch.where(rows < count, centers @ feats.T, torch.full_like(centers[:, :1], -torch.inf))
        probs = (1.0 - sim.max(0).values) ** 2
        probs = probs / probs.sum()
        idx = torch.argmax(torch.log(torch.clamp_min(probs, 1e-30)) + draws.gumbel[count - 1].to(probs))
        centers[count] = feats[idx]
    return centers


def kmeans_cosine_assign(features: torch.Tensor, centers: torch.Tensor):
    """Nearest-centre assignment and per-point loss (semantic_head.py:361-375).
    features (N, D), centers (K, D) -> (labels (N,), loss (N,) = -the best
    cosine, inner products (N, K))."""
    ip = safe_normalize(features) @ safe_normalize(centers).T
    labels = torch.argmax(ip, 1)
    return labels, -ip.gather(1, labels[:, None])[:, 0], ip


def kmeans_cosine_update(features: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor,
                         update_factor: float = 1.0, min_count: int = 0) -> torch.Tensor:
    """One Lloyd step on the sphere (KMeansIterHead, :428-458): a centre
    moves to its members' normalized mean, blended by `update_factor`;
    clusters with at most `min_count` members stay."""
    K = centers.shape[0]
    nf = safe_normalize(features)
    one_hot = torch.nn.functional.one_hot(labels, K).to(nf.dtype)
    counts = one_hot.sum(0)
    f = update_factor * (counts > min_count).to(nf.dtype)[:, None]
    return safe_normalize(safe_normalize(one_hot.T @ nf) * f + centers * (1.0 - f))


def kmeans_fit(features: torch.Tensor, n_clusters: int, draws: KMeansPPDraws, n_iters: int = 10):
    """Lloyd's iterations from a k-means++ seed. Returns (centers, labels, loss)."""
    centers = kmeans_plus_plus_init(features, n_clusters, draws)
    for _ in range(n_iters):
        centers = kmeans_cosine_update(features, kmeans_cosine_assign(features, centers)[0], centers)
    labels, loss, _ = kmeans_cosine_assign(features, centers)
    return centers, labels, loss
