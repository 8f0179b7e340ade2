"""The exact permutohedral-lattice dense CRF, on the host (the port's
counterpart of `scenedino_tpu/eval/permutohedral.py`; reference
`scenedino/downstream_head/crf.py:21-43`, pydensecrf's DenseCRF2D):
mean-field inference whose Gaussian messages are filtered on the
permutohedral lattice of Adams, Baek & Davis (2010), on the CPU as the
reference's pydensecrf call runs. The lattice is built in numpy as the
JAX package builds it; its splat, blurs and slice are sparse matrices
whose products (torch's CSR on the CPU) take the host's threads, and one
pass refines several score maps of an image. `eval/crf.py` is the window
approximation that runs where the tensors lie.

The lattice:
  1. embed the d-dim features in the sum-zero hyperplane of R^{d+1},
     scaled so the blur's variance is a unit Gaussian's,
  2. find each point's enclosing simplex (the remainder-0 point and a rank
     sort) and its barycentric weights,
  3. splat the values onto the simplex's d+1 vertices (keyed by their first
     d coordinates, int64; the last follows from the sum),
  4. blur along each of the d+1 lattice directions with [1, 2, 1] / 4
     (missing neighbours give zero),
  5. slice back with the same weights.

Mean field as pydensecrf (densecrf v2): unary = log(clip(softmax(logits),
1e-5, 1)), Q_0 = softmax(unary), Q_t+1 = softmax(unary + sum_k w_k s_k
L_k(s_k Q_t)), with s_k = 1 / sqrt(L_k 1) (NORMALIZE_SYMMETRIC) and the
Potts weights POS_W and BI_W; the lattice filter includes the point itself.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from scenedino_torch.eval.crf import BI_RGB_STD, BI_W, BI_XY_STD, MAX_ITER, POS_W, POS_XY_STD


def _elevate(feat: np.ndarray) -> np.ndarray:
    """Embed (N, d) features into the sum-zero hyperplane H_d ⊂ R^{d+1},
    scaled so that the lattice blur approximates a unit Gaussian."""
    n, d = feat.shape
    inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
    # scale[j-1] multiplies feature j (1-indexed), j = 1..d
    j = np.arange(1, d + 1, dtype=np.float64)
    scale = inv_std_dev / np.sqrt(j * (j + 1))
    cf = feat.astype(np.float64) * scale  # (N, d)
    elevated = np.empty((n, d + 1), np.float64)
    sm = np.zeros(n, np.float64)
    for jj in range(d, 0, -1):
        elevated[:, jj] = sm - jj * cf[:, jj - 1]
        sm += cf[:, jj - 1]
    elevated[:, 0] = sm
    return elevated


class PermutohedralLattice:
    """Gaussian filtering on the permutohedral lattice.

    Build once from (N, d) features, then `compute(values)` filters any
    (N, C) signal with the (approximate) Gaussian kernel
    K_ij = exp(-|f_i - f_j|² / 2). Features should be pre-divided by
    their standard deviations.
    """

    def __init__(self, features: np.ndarray):
        n, d = features.shape
        self.n, self.d = n, d
        elevated = _elevate(features)  # (N, d+1)

        # nearest remainder-0 lattice point (multiples of d+1 per coord)
        v = elevated / (d + 1)
        rem0 = np.round(v) * (d + 1)  # (N, d+1)
        sum_ = np.rint(rem0.sum(1) / (d + 1)).astype(np.int64)  # (N,)

        # rank[i] = how many coords have a strictly larger differential
        # (ties resolved toward the earlier index, as in the C code's
        # pairwise loop: for i<j equal diffs increment rank[j])
        diff = elevated - rem0
        order = np.argsort(-diff, axis=1, kind="stable")  # (N, d+1)
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.arange(d + 1)[None, :], axis=1)
        rank = rank + sum_[:, None]
        lo = rank < 0
        hi = rank > d
        rank = rank + np.where(lo, d + 1, 0) - np.where(hi, d + 1, 0)
        rem0 = rem0 + np.where(lo, d + 1.0, 0.0) - np.where(hi, d + 1.0, 0.0)

        # barycentric coordinates of each point in its simplex
        vbar = (elevated - rem0) / (d + 1)  # (N, d+1)
        bary = np.zeros((n, d + 2), np.float64)
        rows = np.repeat(np.arange(n), d + 1)
        np.add.at(bary, (rows, (d - rank).ravel()), vbar.ravel())
        np.add.at(bary, (rows, (d - rank + 1).ravel()), -vbar.ravel())
        bary[:, 0] += 1.0 + bary[:, d + 1]
        self.barycentric = bary[:, : d + 1]  # (N, d+1)

        # the d+1 enclosing vertex keys (first d coords; the last is
        # implied by the sum-zero constraint): vertex r adds the
        # canonical simplex offset  (rank < d+1-r ? r : r-(d+1))
        rem0i = np.rint(rem0[:, :d]).astype(np.int64)  # (N, d)
        keys = np.empty((d + 1, n, d), np.int64)
        for r in range(d + 1):
            keys[r] = rem0i + np.where(rank[:, :d] < d + 1 - r, r, r - (d + 1))
        flat_keys = keys.reshape((d + 1) * n, d)
        uniq, inverse = np.unique(flat_keys, axis=0, return_inverse=True)
        self.m = uniq.shape[0]
        # offsets[r, i] = lattice index of vertex r of point i
        self.offsets = inverse.reshape(d + 1, n)

        # neighbor tables for the blur: along axis j, n1 = key + 1
        # everywhere with the j-th coord stepping -d instead (j == d is
        # the implicit sum-zero coordinate: the stored d coords all step
        # +1), n2 the mirror. uniq is numerically-lexicographically
        # sorted (np.unique), so neighbors resolve with a searchsorted
        # over a big-endian byte packing whose byte order matches the
        # numeric order; missing neighbors get index m (a zero slot).
        self._kmin = uniq.min(0) - (d + 2)
        self._uv = self._pack(uniq)
        self.blur_n1 = np.empty((d + 1, self.m), np.int64)
        self.blur_n2 = np.empty((d + 1, self.m), np.int64)
        for ax in range(d + 1):
            off1 = np.ones(d, np.int64)
            if ax < d:
                off1[ax] = -d
            self.blur_n1[ax] = self._lookup(uniq + off1)
            self.blur_n2[ax] = self._lookup(uniq - off1)

    def _pack(self, rows: np.ndarray) -> np.ndarray:
        """Pack int64 key rows into void scalars whose bytewise order
        equals the numeric lexicographic row order (shift non-negative,
        big-endian)."""
        b = np.ascontiguousarray((rows - self._kmin).astype(">u8"))
        return b.view(np.dtype((np.void, b.dtype.itemsize * b.shape[1]))).ravel()

    def _lookup(self, queries: np.ndarray) -> np.ndarray:
        """Indices of query key rows in the sorted unique key table
        (self.m where absent)."""
        qv = self._pack(queries)
        pos = np.searchsorted(self._uv, qv)
        pos_c = np.minimum(pos, self.m - 1)
        found = self._uv[pos_c] == qv
        return np.where(found, pos_c, self.m)

    def _operators(self):
        """The splat (m, N), the slice (N, m) and the d+1 blurs (m, m) as
        sparse CSR matrices of float64 on the CPU (torch's, whose products
        take the host's threads), built on first use: a blur row holds 1/2
        at its vertex and 1/4 at each neighbour along its direction that is
        in the lattice."""
        if getattr(self, "_ops", None) is None:
            import warnings

            from scipy import sparse

            def csr(a):
                with warnings.catch_warnings():  # torch's CSR support is marked beta
                    warnings.simplefilter("ignore", UserWarning)
                    return torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int64)),
                                                   torch.from_numpy(a.indices.astype(np.int64)),
                                                   torch.from_numpy(a.data), size=a.shape, check_invariants=False)

            n, d, m = self.n, self.d, self.m
            cols = np.tile(np.arange(n), d + 1)
            splat = sparse.csr_matrix((self.barycentric.T.ravel(), (self.offsets.ravel(), cols)), shape=(m, n))
            rows = np.arange(m)
            blurs = []
            for ax in range(d + 1):
                r, c, v = [rows], [rows], [np.full(m, 0.5)]
                for nb in (self.blur_n1[ax], self.blur_n2[ax]):
                    keep = nb < m  # a missing neighbour adds nothing
                    r.append(rows[keep])
                    c.append(nb[keep])
                    v.append(np.full(int(keep.sum()), 0.25))
                blurs.append(csr(sparse.csr_matrix((np.concatenate(v), (np.concatenate(r), np.concatenate(c))),
                                                   shape=(m, m))))
            self._ops = csr(splat), csr(splat.T.tocsr()), blurs
        return self._ops

    def compute(self, values: np.ndarray) -> np.ndarray:
        """Filter (N, C) values: splat onto the lattice, the d+1 blurs, slice
        back (times alpha, which offsets the blurs' gain at the centre).
        Returns (N, C) float64."""
        assert values.shape[0] == self.n
        splat, slice_, blurs = self._operators()
        lattice = splat @ torch.from_numpy(np.ascontiguousarray(values, np.float64))
        for blur in blurs:
            lattice = blur @ lattice
        return (slice_ @ lattice).numpy() * (1.0 / (1.0 + 2.0 ** (-self.d)))


def gaussian_filter(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """One-shot normalized Gaussian filtering: weighted average of
    `values` under K_ij = exp(-|f_i-f_j|²/2) (self included)."""
    lat = PermutohedralLattice(features)
    num = lat.compute(values)
    den = lat.compute(np.ones((features.shape[0], 1)))
    return num / np.maximum(den, 1e-20)


class CRFKernels(NamedTuple):
    """An image's two lattices (the spatial and the bilateral kernel) and
    their symmetric normalizations (N, 1); they do not depend on the scores."""

    pos: PermutohedralLattice
    bi: PermutohedralLattice
    s_pos: np.ndarray
    s_bi: np.ndarray


def crf_kernels(image: np.ndarray) -> CRFKernels:
    """The kernels of an (H, W, 3) image in [0, 1]: positions in pixels
    over POS_XY_STD, and over BI_XY_STD beside the colour in 0..255 over
    BI_RGB_STD."""
    H, W = image.shape[:2]
    n = H * W
    img255 = np.asarray(image, np.float64).reshape(n, 3) * 255.0
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pos = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float64)
    lat_pos = PermutohedralLattice(pos / POS_XY_STD)
    lat_bi = PermutohedralLattice(np.concatenate([pos / BI_XY_STD, img255 / BI_RGB_STD], 1))
    ones = np.ones((n, 1))
    return CRFKernels(lat_pos, lat_bi, 1.0 / np.sqrt(np.maximum(lat_pos.compute(ones), 1e-20)),
                      1.0 / np.sqrt(np.maximum(lat_bi.compute(ones), 1e-20)))


def dense_crf_exact(image: np.ndarray, logits: np.ndarray, n_iter: int = MAX_ITER,
                    kernels: Optional[CRFKernels] = None) -> np.ndarray:
    """pydensecrf's mean-field CRF with exact permutohedral filtering, on
    the host: image (H, W, 3) in [0, 1], logits (H, W, C), or (M, H, W, C)
    for M score maps of the image refined independently in one pass over
    the lattices -> the refined probabilities in the logits' shape.
    `kernels` (`crf_kernels` of the image) lets one image's lattices serve
    several calls."""
    *lead, H, W, C = logits.shape
    n, M = H * W, int(np.prod(lead, dtype=np.int64))
    k = crf_kernels(image) if kernels is None else kernels

    lg = np.moveaxis(np.asarray(logits, np.float64).reshape(M, n, C), 0, 1)  # (N, M, C)
    lg = lg - lg.max(-1, keepdims=True)
    p = np.exp(lg)
    p /= p.sum(-1, keepdims=True)
    # unary_from_softmax: U = -log(clip(p, 1e-5, 1)); the engine works
    # with -U throughout
    unary = np.log(np.clip(p, 1e-5, 1.0))

    def filtered(lattice, s, q):  # s_k L_k(s_k Q) for every map at once
        return s[:, :, None] * lattice.compute((s[:, :, None] * q).reshape(n, M * C)).reshape(n, M, C)

    e = unary - unary.max(-1, keepdims=True)
    q = np.exp(e)
    q /= q.sum(-1, keepdims=True)
    for _ in range(n_iter):
        msg = POS_W * filtered(k.pos, k.s_pos, q)
        msg += BI_W * filtered(k.bi, k.s_bi, q)
        e = unary + msg
        e -= e.max(-1, keepdims=True)
        q = np.exp(e)
        q /= q.sum(-1, keepdims=True)
    return np.moveaxis(q, 1, 0).reshape(logits.shape)


def refine_segmentation_exact(image, logits, **kw):
    """The argmax of the exact CRF's probabilities, (H, W) int64; `image`
    (H, W, 3) in [0, 1] or (3, H, W) in [-1, 1] as `eval/crf.py`'s
    refine_segmentation takes it."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[0] == 3 and image.shape[-1] != 3:
        image = np.transpose(image, (1, 2, 0)) * 0.5 + 0.5
    probs = dense_crf_exact(image, np.asarray(logits), **kw)
    return np.argmax(probs, -1).astype(np.int64)
