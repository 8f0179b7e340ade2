"""The port's TSDF fusion (`eval/fusion.py`) against the JAX package's on
the CPU: a 32^3 volume and 2 frames of 24x32 depth and colour seeded with
numpy (a slanted wall at 6-10 m with holes of invalid depth, the second
camera moved and turned), with and without `truncation`. The weights equal,
the TSDF values and colours to atol 1e-5, the same surface points and
colours, and the surface PLY written.
"""
import numpy as np
import pytest
import torch

import scenedino_tpu.eval.fusion as J
from scenedino_torch.eval import fusion

FH, FW = 24, 32


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:FH, 0:FW].astype(np.float32)
    depths = np.stack([6.0 + 4.0 * xs / FW + 0.5 * ys / FH + rng.uniform(-0.05, 0.05, (FH, FW)) for _ in range(2)])
    depths[rng.random(depths.shape) < 0.1] = 0.0  # invalid pixels
    intr = np.array([[20.0, 0, FW / 2], [0, 20.0, FH / 2], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    poses[1, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    poses[1, :3, 3] = [0.4, -0.1, 0.3]
    colors = rng.uniform(0, 255, (2, FH, FW, 3)).astype(np.float32)
    return depths.astype(np.float32), np.stack([intr, intr]), poses, colors


@pytest.mark.parametrize("truncation", [None, 0.8], ids=["raw", "truncated"])
def test_fusion_matches_jax(truncation, tmp_path):
    bounds = ((-4.0, 4.0), (-3.0, 3.0), (3.0, 11.0))
    cfg = fusion.TSDFVolumeConfig(bounds, 0.25, truncation=truncation)
    jcfg = J.TSDFVolumeConfig(bounds, 0.25, truncation=truncation)
    assert cfg.vol_dim == jcfg.vol_dim == (32, 24, 32)
    frames = _frames()
    state = fusion.integrate_frames(cfg, *(torch.from_numpy(f) for f in frames))
    ref = J.integrate_frames(jcfg, *frames)
    np.testing.assert_array_equal(state.weight.numpy(), np.asarray(ref.weight))
    assert 0 < (state.weight.numpy() > 0).mean() < 1 and state.weight.max() == 2  # both frames reach voxels
    np.testing.assert_allclose(state.tsdf.numpy(), np.asarray(ref.tsdf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.color.numpy(), np.asarray(ref.color), rtol=0, atol=1e-3)  # 0..255
    pts, cols = fusion.extract_surface_points(state, cfg)
    jpts, jcols = J.extract_surface_points(ref, jcfg)
    assert len(pts) > 0
    np.testing.assert_array_equal(pts, jpts)
    assert np.abs(cols.astype(int) - jcols.astype(int)).max() <= 1
    one = fusion.integrate(fusion.create_volume(cfg), cfg, *(torch.from_numpy(f[0]) for f in frames[:3]))
    jone = J.integrate(J.create_volume(jcfg), jcfg, *(f[0] for f in frames[:3]))
    np.testing.assert_array_equal(one.weight.numpy(), np.asarray(jone.weight))
    np.testing.assert_array_equal(one.color.numpy(), 0.0)  # no colour image: colours stay as they were
    n_vert, n_face = fusion.save_surface_ply(str(tmp_path / "surface.ply"), state, cfg)
    J.save_surface_ply(str(tmp_path / "ref.ply"), ref, jcfg)
    assert n_vert == 8 * len(pts) and n_face == 12 * len(pts)
    assert (tmp_path / "surface.ply").read_bytes().startswith(b"ply\nformat binary_little_endian 1.0\n")
    assert (tmp_path / "surface.ply").stat().st_size == (tmp_path / "ref.ply").stat().st_size
