"""Voxel-grid export (the port's copy of `scenedino_tpu/eval/voxel_io.py`;
reference `sscbench/gen_voxelgrid_npy.py:244` and
`common/io/voxel_grids/semantic_kitti.py`): a cube mesh per occupied
voxel written as a binary little-endian PLY, and the SemanticKITTI
bit-packed occupancy .bin. numpy only; the files are byte for byte the
JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# the 8 corners of a unit cube and its 12 triangles (2 a face)
_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    np.float32,
)
_FACES = np.array(
    [(0, 2, 1), (0, 3, 2),  # bottom
     (4, 5, 6), (4, 6, 7),  # top
     (0, 1, 5), (0, 5, 4),
     (1, 2, 6), (1, 6, 5),
     (2, 3, 7), (2, 7, 6),
     (3, 0, 4), (3, 4, 7)],
    np.int64,
)


def voxel_mesh(occupied: np.ndarray, origin, voxel_size: float, colors: Optional[np.ndarray] = None):
    """occupied (X, Y, Z) bool; colors (X, Y, Z, 3) in [0, 1] or None (grey
    0.7). Returns (verts (8N, 3) float32, faces (12N, 3) int64, vertex
    colours (8N, 3) uint8) for the N occupied voxels in index order."""
    ijk = np.stack(np.nonzero(occupied), -1)
    if len(ijk) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64), np.zeros((0, 3), np.uint8)
    base = np.asarray(origin, np.float32)[None] + ijk.astype(np.float32) * voxel_size
    verts = (base[:, None] + _CORNERS[None] * voxel_size).reshape(-1, 3)
    faces = (_FACES[None] + (np.arange(len(ijk)) * 8)[:, None, None]).reshape(-1, 3)
    c = colors[occupied] if colors is not None else np.full((len(ijk), 3), 0.7, np.float32)
    vcolors = np.repeat((np.clip(c, 0, 1) * 255).astype(np.uint8), 8, axis=0)
    return verts.astype(np.float32), faces, vcolors


def save_as_voxel_ply(path: str, occupied, origin=(0.0, 0.0, 0.0), voxel_size=0.2, colors=None):
    """Write the occupied voxels' cube mesh as a binary little-endian PLY
    (float xyz, uchar rgb a vertex; a uchar count and three int indices a
    face). Returns (vertex count, face count)."""
    verts, faces, vcolors = voxel_mesh(np.asarray(occupied, bool), origin, voxel_size, colors)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    vrec = np.empty(len(verts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vrec["xyz"] = verts
    vrec["rgb"] = vcolors
    frec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
    frec["n"] = 3
    frec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        vrec.tofile(f)
        frec.tofile(f)
    return len(verts), len(faces)


def unpack_voxel_bits(compressed: np.ndarray) -> np.ndarray:
    """Bit-packed uint8 -> flat 0/1 uint8 voxels, the most significant bit
    first (semantic_kitti.py:7-20)."""
    compressed = np.asarray(compressed, np.uint8)
    out = np.zeros(compressed.shape[0] * 8, dtype=np.uint8)
    for bit in range(8):
        out[bit::8] = (compressed >> (7 - bit)) & 1
    return out


def pack_voxel_bits(uncompressed: np.ndarray) -> np.ndarray:
    """Flat 0/1 voxels (a multiple of 8) -> one integer a byte, the most
    significant bit first (semantic_kitti.py:23-29)."""
    u = np.asarray(uncompressed).reshape(-1, 8)
    return u.dot(1 << np.arange(7, -1, -1))


def save_semantic_kitti(voxel_grid: np.ndarray, path: str) -> None:
    """The SemanticKITTI .bin: all three axes flipped, flattened, bit-packed,
    written as uint8 (semantic_kitti.py:32-33)."""
    flat = np.flip(np.asarray(voxel_grid), (0, 1, 2)).reshape(-1)
    pack_voxel_bits(flat).astype(np.uint8).tofile(path)


def save_voxel_grid(voxel_grid: np.ndarray, path: str, format: str = "semantic_kitti") -> None:
    """Save a voxel grid in `format` (voxel_grids/__init__.py:12-21); only
    "semantic_kitti" exists."""
    if format != "semantic_kitti":
        raise NotImplementedError(f"Voxel format {format!r} not implemented.")
    save_semantic_kitti(voxel_grid, path)
