"""Single-image inference demo (counterpart of `scenedino_tpu/cli/demo.py`;
reference `demo_script.py` + `demo_utils/utils.py`):

    python -m scenedino_torch.cli.demo --image <png or jpeg> [--ckpt <run dir or .pt>] \\
        [--config <run dir or yaml>] [--variant dino|dinov2] [--out demo_out] [--device cpu]

Encodes one image and writes, into `--out`: the full-frame rendered depth
(`depth.npy`) and 768-d features (`dino_features.npy`, fp16) of the
unfolded field through `renderer.nerf.render_rays_chunked`; the input and
three PCA panels of the features (`input_image.png`,
`feat_pca_00_02.png`, `feat_pca_03_05.png`, `feat_pca_06_08.png`); the
densities of a 3D grid query (x in [-10, 10], y in [-5, 5], z in [0, 20]
at 0.2 m: 101 x 51 x 101 points, `grid_sigma.npy`) and its occupied points
(sigma > 0.2) as a PCA-coloured point cloud (`grid_points.ply`).

`--config` rebuilds the trained model from its saved config (its
`with_amp` encodes in bf16, through K1), else the `--variant` preset
(fp32) at 192x640; `--ckpt` is anything `utils.checkpoint.load_eval_state`
reads (without it the weights are seeded random: `cli.evaluate.eval_model`).
Images are read by `datasets.image_io` and resized as cv2's INTER_LINEAR.
Runs on the GPU unless `--device` names another device; without a GPU it
raises. The encode, 2D render, PCA and 3D grid host ms are printed.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from scenedino_torch import resolve_device

GRID_CHUNK = 262144  # points a 3D grid query takes at a time


def build_model(image_size=(192, 640), variant: str = "dino", device=None):
    """The `variant` preset's field (fp32) and the default semantic head,
    their weights seeded random, frozen in eval mode."""
    from scenedino_torch.cli.evaluate import eval_model

    return eval_model({"variant": variant}, None, device, image_size)


def load_image(path, image_size=(192, 640)) -> np.ndarray:
    """A PNG or JPEG as (1, 1, 3, H, W) float32 in [-1, 1] at `image_size`
    (RGB in [0, 1], cv2's INTER_LINEAR resize, then 2x - 1)."""
    from scenedino_torch.datasets.image_io import read_jpeg, read_rgb, resize_bilinear

    if str(path).lower().endswith((".jpg", ".jpeg")):
        img = read_jpeg(path).astype(np.float32) / 255.0
    else:
        img = read_rgb(path)
    img = resize_bilinear(img, tuple(image_size))
    return (img * 2 - 1).transpose(2, 0, 1)[None, None]


def default_camera(image_size=(192, 640)):
    """KITTI-360-like normalized intrinsics (1, 1, 3, 3) and an identity
    pose (1, 1, 4, 4) (demo_utils/utils.py's defaults)."""
    K = np.array([[0.7849, 0, 0.0021], [0, 2.9459, -0.0178], [0, 0, 1]], np.float32)
    return K[None, None], np.eye(4, dtype=np.float32)[None, None]


@torch.no_grad()
def inference_rendered_2d(field, state, image_size=(192, 640), n_coarse: int = 32,
                          u: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
    """Full-frame depth (H, W) and 768-d features (H, W, 768) of the first
    colour view through the unfolded field (demo_utils/utils.py:199-236), in
    chunks of 12,288 rays where they divide the frame. The strata `u` (H*W,
    n_coarse) are an explicit input, drawn from `generator` when None."""
    from scenedino_torch.core.ray_sampler import ImageRaySampler
    from scenedino_torch.renderer.nerf import RenderConfig, render_rays_chunked

    H, W = image_size
    poses_c2w = torch.linalg.inv(state.color_w2c[:, :1].float())
    rays = ImageRaySampler(3.0, 80.0, H, W).sample(poses_c2w, state.color_ks[:, :1].float())
    if u is None:
        u = torch.rand(H * W, n_coarse, generator=generator, device=rays.device)

    def field_fn(xyz, only_density=False):
        return field(state, xyz, only_density=only_density)

    out = render_rays_chunked(field_fn, rays[..., :8], u, RenderConfig(n_coarse=n_coarse),
                              chunk=12288 if (H * W) % 12288 == 0 else H * W)
    depth = out["coarse"]["depth"].reshape(H, W)
    return depth, field.expand_dim(out["coarse"]["dino_features"]).reshape(H, W, -1)


def grid_axes(x_range=(-10, 10), y_range=(-5, 5), z_range=(0, 20), resolution: float = 0.2):
    """The demo grid's axes: endpoint-inclusive, range / resolution + 1
    points each (demo_utils/utils.py:167-174), 101 x 51 x 101 at the
    defaults."""

    def axis(lo, hi):
        return np.linspace(lo, hi, int((hi - lo) / resolution) + 1, dtype=np.float32)

    return axis(*x_range), axis(*y_range), axis(*z_range)


@torch.no_grad()
def inference_3d(field, head, state, x_range=(-10, 10), y_range=(-5, 5), z_range=(0, 20), resolution: float = 0.2,
                 mode: str = "stego_kmeans"):
    """The dense grid query (demo_utils/utils.py:144-186) in chunks of
    `GRID_CHUNK` points: (xyz (N, 3), 768-d features (N, 768), sigma (N,),
    the head's labels (N,) or None without a head), on the host."""
    xs, ys, zs = grid_axes(x_range, y_range, z_range, resolution)
    xyz = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    device = state.feat_grid.device
    sigmas, dinos, segs = [], [], []
    for i in range(0, len(xyz), GRID_CHUNK):
        block = torch.from_numpy(xyz[i:i + GRID_CHUNK]).to(device)[None]
        if head is not None:
            dino768, sigma, seg = field.query_segmentation(state, block, head, mode)
            segs.append(seg[0].cpu().numpy())
        else:
            _, _, sigma, dino = field(state, block, only_density=True)
            dino768 = field.expand_dim(dino)
        sigmas.append(sigma[0].float().cpu().numpy())
        dinos.append(dino768[0].float().cpu().numpy())
    return xyz, np.concatenate(dinos), np.concatenate(sigmas), np.concatenate(segs) if segs else None


def _save_point_ply(path, xyz, rgb) -> None:
    """A binary little-endian point-cloud PLY: float xyz, uchar rgb."""
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {xyz.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    ).encode()
    rec = np.zeros(xyz.shape[0], dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                        ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    with open(path, "wb") as f:
        f.write(header)
        rec.tofile(f)


def _save_png(path, arr) -> None:
    """An image min-max scaled to [0, 255] as uint8 (the reference's panels)."""
    from scenedino_torch.datasets.image_io import write_png

    arr = np.asarray(arr, np.float32)
    arr = arr - arr.min()
    arr = arr / max(arr.max(), 1e-12)
    write_png(path, (arr * 255).astype(np.uint8))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the demo; returns the host ms of its stages and the output directory."""
    ap = argparse.ArgumentParser(description="Single-image inference demo of the PyTorch port.")
    ap.add_argument("--ckpt", default=None, help="a run directory, .pt or .npz (default: seeded random weights)")
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--variant", default="dino", choices=["dino", "dinov2"])
    ap.add_argument("--config", default=None,
                    help="a training run directory or YAML: rebuild the trained model instead of the --variant preset")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.ops.pca import fit_pca, transform_pca
    from scenedino_torch.utils.config import load_run_config

    device = resolve_device(args.device)
    config = load_run_config(args.config) if args.config else {"variant": args.variant}
    image_size = tuple(config.get("dataset", {}).get("image_size", (192, 640)))
    field, head = eval_model(config, args.ckpt, device, image_size)
    img = load_image(args.image, image_size)
    K, pose = default_camera(image_size)
    ms = {}

    def timed(name, fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.no_grad():
        state = timed("encode_ms", lambda: field.encode(*(torch.from_numpy(a).to(device) for a in (img, K, pose)),
                                                        ids_encoder=(0,)))
        depth, dino = timed("render_2d_ms", lambda: inference_rendered_2d(
            field, state, image_size, generator=torch.Generator(device=device).manual_seed(0)))
        flat = dino.reshape(-1, dino.shape[-1]).float()

        def pca_panels():  # fit on the rendered features, three component triplets as RGB (demo_script.py:42-60)
            p = fit_pca(flat)
            return p, [transform_pca(p, flat, from_dim=d).cpu().numpy() for d in (0, 3, 6)]

        pca, panels = timed("pca_ms", pca_panels)
        depth, dino = depth.float().cpu().numpy(), dino.float().cpu().numpy()
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, "depth.npy"), depth)
        np.save(os.path.join(args.out, "dino_features.npy"), dino.astype(np.float16))
        print(f"depth range: [{depth.min():.2f}, {depth.max():.2f}]  features: {dino.shape}", flush=True)
        _save_png(os.path.join(args.out, "input_image.png"), img[0, 0].transpose(1, 2, 0) * 0.5 + 0.5)
        H, W = image_size
        for from_dim, rgb in zip((0, 3, 6), panels):
            _save_png(os.path.join(args.out, f"feat_pca_{from_dim:02d}_{from_dim + 2:02d}.png"), rgb.reshape(H, W, 3))

        xyz, dino3d, sigma, _ = timed("grid_3d_ms", lambda: inference_3d(field, head, state))
        np.save(os.path.join(args.out, "grid_sigma.npy"), sigma)
        print(f"3d grid: {xyz.shape[0]} pts, occupied (sigma>0.2): {(sigma > 0.2).mean():.3f}", flush=True)
        occ = sigma > 0.2
        if occ.any():  # the occupied points coloured by the first PCA triplet (demo_script.py:76-85)
            rgb3d = transform_pca(pca, torch.from_numpy(dino3d[occ]).to(device), from_dim=0).cpu().numpy()
            rgb3d = rgb3d - rgb3d.min(0, keepdims=True)
            rgb3d = rgb3d / np.maximum(rgb3d.max(0, keepdims=True), 1e-12)
            _save_point_ply(os.path.join(args.out, "grid_points.ply"), xyz[occ], (rgb3d * 255).astype(np.uint8))
    print("host ms: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()), flush=True)
    return {**ms, "out": args.out}


if __name__ == "__main__":
    main()
