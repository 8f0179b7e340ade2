"""Dataset factory (counterpart of `scenedino_tpu/datasets/__init__.py`):
the synthetic dataset, the only one the port reads so far."""
from __future__ import annotations

from typing import Tuple


def make_datasets(config: dict) -> Tuple:
    """(train, test) datasets from a `dataset:` config block."""
    kind = config.get("type", "old_KITTI_360")
    if kind == "synthetic":
        from scenedino_torch.datasets.synthetic import SyntheticMultiViewDataset

        ds = SyntheticMultiViewDataset(
            length=config.get("length", 64),
            n_views=config.get("n_views", 8),
            image_size=tuple(config.get("image_size", (48, 96))),
            textured=config.get("textured", True),
        )
        return ds, ds
    raise NotImplementedError(f"the port reads the synthetic dataset only, got type {kind!r}")
