"""Dense-CRF refinement of segmentation scores (the port's
`scenedino_tpu/eval/crf.py:39-122`, plain torch; no TPU kernel).

Mean-field inference with a Potts model over two Gaussian kernels
(reference `scenedino/downstream_head/crf.py`): spatial weight 3, sigma_xy
0.3; bilateral weight 4, sigma_xy 20, sigma_rgb 3 (rgb in 0..255); 10
iterations. The messages are a truncated-window pass (ConvCRF) as in the
JAX package: each pixel gathers from a (2R+1)^2 window of dilated taps
(radius 10 x dilation 4, +/-40 px) and the 1-px ring, each kernel
symmetrically normalized (D^-1/2 K D^-1/2, pydensecrf's default). An
approximation of pydensecrf's permutohedral lattice, not a twin; the
exact lattice is eval/permutohedral.py (`crf_method="exact"`, on the host).

A tap reads a slice of the scores padded once by the window's reach, the
shift of the JAX code without a copy per tap.
"""
from __future__ import annotations

import math

import torch

MAX_ITER = 10
POS_W = 3.0
POS_XY_STD = 0.3
BI_W = 4.0
BI_XY_STD = 20.0
BI_RGB_STD = 3.0


def _offsets(radius: int, dilation: int):
    """The dilated window's taps and the 1-px ring (the spatial kernel's
    support, which dilation would skip), without the pixel itself, sorted."""
    offs = {(dy * dilation, dx * dilation) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1) if (dy, dx) != (0, 0)}
    offs |= {(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)}
    return sorted(offs)


def _shifted(padded: torch.Tensor, reach: int, dy: int, dx: int, H: int, W: int) -> torch.Tensor:
    """x shifted by (dy, dx) with zeros outside: out[y, x] = x[y - dy, x - dx],
    as a view of x padded by `reach` on every side."""
    return padded[reach - dy:reach - dy + H, reach - dx:reach - dx + W]


def dense_crf(image: torch.Tensor, logits: torch.Tensor, n_iter: int = MAX_ITER, radius: int = 10,
              dilation: int = 4) -> torch.Tensor:
    """Mean-field CRF refinement: image (H, W, 3) in [0, 1], logits (H, W, C)
    -> refined probabilities (H, W, C), fp32."""
    img255 = image.float() * 255.0
    unary = torch.log_softmax(logits.float(), -1)
    q = torch.softmax(unary, -1)
    offs = _offsets(radius, dilation)
    reach = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    H, W, _ = image.shape
    pad = torch.nn.functional.pad
    img_p = pad(img255, (0, 0, reach, reach, reach, reach))
    ones_p = pad(torch.ones(H, W, device=image.device), (reach, reach, reach, reach))
    k_bi, k_pos = [], []
    for dy, dx in offs:
        valid = _shifted(ones_p, reach, dy, dx, H, W)
        d_rgb = torch.sum((img255 - _shifted(img_p, reach, dy, dx, H, W)) ** 2, -1)
        d_xy = float(dy * dy + dx * dx)
        k_bi.append(torch.exp(-d_xy / (2 * BI_XY_STD ** 2) - d_rgb / (2 * BI_RGB_STD ** 2)) * valid)
        k_pos.append(math.exp(-d_xy / (2 * POS_XY_STD ** 2)) * valid)
    k_bi = torch.stack(k_bi)  # (K, H, W), unnormalized
    k_pos = torch.stack(k_pos)
    s_bi = (1.0 / torch.sqrt(torch.clamp_min(torch.sum(k_bi, 0), 1e-6)))[..., None]  # (H, W, 1)
    s_pos = (1.0 / torch.sqrt(torch.clamp_min(torch.sum(k_pos, 0), 1e-6)))[..., None]
    k_bi, k_pos = k_bi[..., None], k_pos[..., None]

    for _ in range(n_iter):
        qb = pad(q * s_bi, (0, 0, reach, reach, reach, reach))
        qp = pad(q * s_pos, (0, 0, reach, reach, reach, reach))
        mb = torch.zeros_like(q)
        mp = torch.zeros_like(q)
        for k, (dy, dx) in enumerate(offs):
            mb.addcmul_(k_bi[k], _shifted(qb, reach, dy, dx, H, W))
            mp.addcmul_(k_pos[k], _shifted(qp, reach, dy, dx, H, W))
        # Potts compatibility: agreement with the gathered message is rewarded
        q = torch.softmax(unary + BI_W * mb * s_bi + POS_W * mp * s_pos, -1)
    return q


def refine_segmentation(image: torch.Tensor, logits: torch.Tensor, **kw) -> torch.Tensor:
    """The argmax of the refined probabilities: (H, W) int64. image (H, W, 3)
    in [0, 1], or the package's (3, H, W) in [-1, 1]; logits (H, W, C)."""
    if image.ndim == 3 and image.shape[0] == 3 and image.shape[-1] != 3:
        image = image.permute(1, 2, 0) * 0.5 + 0.5
    return torch.argmax(dense_crf(image, logits, **kw), -1)
