"""The interactive demo: one image -> a rendered 2D panel and a voxel PLY
(counterpart of `scenedino_tpu/cli/demo_gradio.py`; reference
`demo_gradio.py`).

    python -m scenedino_torch.cli.demo_gradio --ckpt <run dir or .pt> [--config <run dir or yaml>] [--share] [--device cpu]

`demo_run` is the demo without its interface: the image encoded, the 2D
panel of the chosen mode (feature PCA 1-3 / 4-6 / 7-9, the head's SSC
labels unsupervised or linear, else depth), the 3D grid queried over the
chosen ranges at the chosen resolution and its voxels above the density
threshold written as a coloured cube-mesh PLY (classes by the train-class
palette, PCA modes by the features' PCA). A grid of more than
`MAX_VOXEL_COUNT` voxels (counted on the grid's own axes,
`cli.demo.grid_axes`) raises ValueError. It builds on `cli.demo`
(`inference_rendered_2d`, `inference_3d`) and `eval.voxel_io`.
`build_interface` and `main` need gradio, which is not installed here;
`_require_gradio` raises ImportError without it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

MAX_VOXEL_COUNT = 1_000_000  # demo_gradio.py:87

MODES = (
    "Feature PCA 1-3",
    "Feature PCA 4-6",
    "Feature PCA 7-9",
    "SSC (unsup.)",
    "SSC (linear)",
)


def _require_gradio():
    try:
        import gradio as gr

        return gr
    except ImportError as e:
        raise ImportError(
            "the interactive demo needs `pip install gradio`; use "
            "`python -m scenedino_torch.cli.demo` for the batch demo"
        ) from e


@torch.no_grad()
def demo_run(field, head, image_path: str, mode: str = "Feature PCA 1-3", sigma_threshold: float = 0.2,
             resolution: float = 0.2, x_range: float = 10.0, y_range: float = 10.0, z_range: float = 20.0,
             image_size=(192, 640), u: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
    """One demo call (demo_gradio.py:49-193) -> (the 2D panel (H, W, 3)
    uint8, the PLY's path). `head` is the semantic head (None: the SSC
    modes fall back to the depth panel and PCA colours); `u` / `generator`
    the 2D render's strata (`cli.demo.inference_rendered_2d`); the PLY is
    scenedino_demo_voxels.ply in the temporary directory."""
    from scenedino_torch.cli.demo import default_camera, grid_axes, inference_3d, inference_rendered_2d, load_image
    from scenedino_torch.datasets.labels import TRAIN_CLASS_COLORS
    from scenedino_torch.eval import vis2d
    from scenedino_torch.eval.voxel_io import save_as_voxel_ply

    # the grid's shape from the axes inference_3d queries: range / resolution
    # arithmetic disagrees with them for many slider-reachable pairs
    axes = grid_axes((-x_range, x_range), (-y_range, y_range), (0.0, z_range), resolution)
    grid_shape = tuple(len(a) for a in axes)
    n_vox = grid_shape[0] * grid_shape[1] * grid_shape[2]
    if n_vox > MAX_VOXEL_COUNT:
        raise ValueError(f"Too many voxels ({n_vox / 1e6:.1f}M > {MAX_VOXEL_COUNT / 1e6:.1f}M); lower ranges or "
                         "raise resolution")

    device = next(field.parameters()).device
    img = torch.from_numpy(load_image(image_path, image_size)).to(device)
    K, pose = (torch.from_numpy(a).to(device) for a in default_camera(image_size))
    state = field.encode(img, K, pose, ids_encoder=(0,))
    depth, dino768 = inference_rendered_2d(field, state, image_size, u=u, generator=generator)
    want_seg = mode.startswith("SSC")
    seg_mode = "direct_linear" if mode == "SSC (linear)" else "stego_kmeans"
    _, dino3d, sigma, seg = inference_3d(field, head, state, x_range=(-x_range, x_range),
                                         y_range=(-y_range, y_range), z_range=(0.0, z_range),
                                         resolution=resolution, mode=seg_mode)

    if mode.startswith("Feature PCA"):
        start = {"Feature PCA 1-3": 0, "Feature PCA 4-6": 3, "Feature PCA 7-9": 6}[mode]
        panel = vis2d.get_dino_pca(dino768.float().cpu().numpy(), from_dim=start)
    elif want_seg and head is not None:
        # the rendered features are 768-d already: the head takes them as they are
        panel = vis2d.get_segmentation(head(dino768, mode=seg_mode).reshape(dino768.shape[:2]).cpu().numpy())
    else:
        panel = vis2d.get_depth(depth.float().cpu().numpy())
    vis = (np.clip(panel, 0, 1) * 255).astype(np.uint8)

    occ = sigma.reshape(grid_shape) > sigma_threshold
    if want_seg and seg is not None:
        colors = TRAIN_CLASS_COLORS[np.clip(seg.reshape(grid_shape), 0, 18)].astype(np.float32)  # [0, 1] already
    else:
        feats = dino3d.reshape(grid_shape[0], -1, dino3d.shape[-1])
        colors = vis2d.get_dino_pca(feats).reshape(*grid_shape, 3)
    ply_path = os.path.join(tempfile.gettempdir(), "scenedino_demo_voxels.ply")
    save_as_voxel_ply(ply_path, occ, origin=(-x_range, -y_range, 0.0), voxel_size=resolution, colors=colors)
    return vis, ply_path


def build_interface(field, head, image_size=(192, 640)):
    gr = _require_gradio()

    def _run(image, mode, sigma_threshold, resolution, xr, yr, zr):
        try:
            return demo_run(field, head, image, mode, sigma_threshold, resolution, xr, yr, zr, image_size)
        except ValueError as e:
            raise gr.Error(str(e))

    return gr.Interface(
        fn=_run,
        inputs=[
            gr.Image(label="Input image", type="filepath"),
            gr.Radio(label="Mode", choices=list(MODES), value=MODES[0]),
            gr.Slider(label="Density threshold", minimum=0.0, maximum=1.0, step=0.05, value=0.2),
            gr.Slider(label="Resolution [m]", minimum=0.05, maximum=0.5, step=0.05, value=0.2),
            gr.Slider(label="X Range [m]", minimum=1, maximum=50, step=1, value=10),
            gr.Slider(label="Y Range [m]", minimum=1, maximum=50, step=1, value=10),
            gr.Slider(label="Z Range [m]", minimum=1, maximum=100, step=1, value=20),
        ],
        outputs=[
            gr.Image(label="Rendered 2D Visualization"),
            gr.Model3D(label="Voxel Surface 3D Visualization"),
        ],
        title="SceneDINO",
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Interactive demo of the PyTorch port (needs gradio).")
    ap.add_argument("--ckpt", required=True, help="a run directory, .pt or .npz")
    ap.add_argument("--config", default=None, help="a training run directory or YAML (default: the --variant preset)")
    ap.add_argument("--variant", default="dino", choices=("dino", "dinov2"))
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    _require_gradio()

    from scenedino_torch import resolve_device
    from scenedino_torch.cli.evaluate import eval_model
    from scenedino_torch.utils.config import load_run_config

    config = load_run_config(args.config) if args.config else {"variant": args.variant}
    image_size = tuple(config.get("dataset", {}).get("image_size", (192, 640)))
    field, head = eval_model(config, args.ckpt, resolve_device(args.device), image_size)
    build_interface(field, head, image_size).launch(share=args.share)


if __name__ == "__main__":
    main()
