"""Frame-selection strategies: which frames a step encodes, which give the
loss and which are rendered (counterpart of
`scenedino_tpu/core/strategies.py`; the reference's
`scenedino/common/sampling_strategies.py`).

Each sampler returns `fn(num_frames, generator=None, draw=None)` -> frame
ids as lists of ints. Its one random draw is `draw` where given (the
permutation or the coins, as the JAX sampler draws them from its key),
else it is drawn from `generator` with the same distribution.

    encoder samplers       draw
    default                none: frame 0
    kitti_360_full         a permutation of 1 .. num_frames - 1
    kitti_360_stereo       a permutation of 1 .. min(num_frames, num_stereo_frames) - 1
    loss/render samplers
    single_view            a permutation of 0 .. num_frames - 1 (shuffle_frames only)
    stereo_view            a coin per pair, 0 or 1 (p = 1/2)
    kitti_360              randint(0, 3) per pair: 0 makes the pair's second frame the loss frame
    alternate              one randint(0, 3): 0 makes the odd frames the loss frames

The training step (`training.trainer.draw_stage1`) draws the kitti_360 and
alternate splits itself, as per-pair coins.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

Ids = List[int]


def _perm(draw: Optional[Sequence[int]], values: Sequence[int], generator: Optional[torch.Generator]) -> Ids:
    if draw is not None:
        if sorted(int(d) for d in draw) != list(values):
            raise ValueError(f"the draw {list(draw)} is not a permutation of {list(values)}")
        return [int(d) for d in draw]
    return [values[int(i)] for i in torch.randperm(len(values), generator=generator)]


def _ints(draw, n: int, high: int, generator: Optional[torch.Generator]) -> Ids:
    if draw is not None:
        if len(draw) != n:
            raise ValueError(f"expected {n} draws, got {len(draw)}")
        return [int(d) for d in draw]
    return torch.randint(0, high, (n,), generator=generator).tolist()


# ------------------------------------------------------------- encoder samplers
def default_encoder_sampler() -> Callable:
    """Always encode frame 0 (sampling_strategies.py:14-18)."""

    def fn(num_frames: int, generator=None, draw=None) -> Ids:
        return [0]

    return fn


def _subset_sampler(num_encoder_frames: int, always_use_base_frame: bool, n_of: Callable[[int], int]) -> Callable:
    def fn(num_frames: int, generator=None, draw=None) -> Ids:
        perm = _perm(draw, range(1, n_of(num_frames)), generator)
        if always_use_base_frame:
            return [0] + perm[:num_encoder_frames - 1]
        return perm[:num_encoder_frames]

    return fn


def kitti_360_full_encoder_sampler(num_encoder_frames: int, always_use_base_frame: bool = True) -> Callable:
    """A random subset of the frames, frame 0 first when
    `always_use_base_frame` (sampling_strategies.py:21-37). As in the
    reference, the permutation is of frames 1 .. n - 1 in either case: without
    the base frame, frame 0 is never drawn."""
    return _subset_sampler(num_encoder_frames, always_use_base_frame, lambda n: n)


def kitti_360_stereo_encoder_sampler(num_encoder_frames: int, num_stereo_frames: int,
                                     always_use_base_frame: bool = True) -> Callable:
    """The full sampler over the first `num_stereo_frames` frames only
    (sampling_strategies.py:40-58)."""
    return _subset_sampler(num_encoder_frames, always_use_base_frame, lambda n: min(n, num_stereo_frames))


def get_encoder_sampling(config: Optional[dict]) -> Callable:
    """(sampling_strategies.py:61-70): kitti_360_full, kitti_360_stereo, else default."""
    name = (config or {}).get("name")
    args = (config or {}).get("args", {}) or {}
    if name == "kitti_360_full":
        return kitti_360_full_encoder_sampler(**args)
    if name == "kitti_360_stereo":
        return kitti_360_stereo_encoder_sampler(**args)
    return default_encoder_sampler()


# --------------------------------------------------------- loss/render samplers
def single_view_loss_sampler(shuffle_frames: bool = False, all_frames: bool = False) -> Callable:
    """The loss on the first frame, the rest rendered (all of them with
    `all_frames`); the order shuffled first with `shuffle_frames`
    (sampling_strategies.py:73-102)."""

    def fn(num_frames: int, generator=None, draw=None) -> Tuple[Ids, Ids]:
        ids = _perm(draw, range(num_frames), generator) if shuffle_frames else list(range(num_frames))
        return ids[:1], ids if all_frames else ids[1:]

    return fn


def _pairs(num_frames: int, coins: Ids) -> Tuple[Ids, Ids]:
    """Per pair (2p, 2p + 1): coin 1 makes the second frame the loss frame."""
    return [2 * p + c for p, c in enumerate(coins)], [2 * p + 1 - c for p, c in enumerate(coins)]


def stereo_view_loss_sampler(shuffle_frames: bool = False) -> Callable:
    """Per stereo pair a fair coin picks the loss frame, the other is
    rendered (sampling_strategies.py:105-119)."""

    def fn(num_frames: int, generator=None, draw=None) -> Tuple[Ids, Ids]:
        return _pairs(num_frames, _ints(draw, num_frames // 2, 2, generator))

    return fn


def kitti_360_loss_sampler() -> Callable:
    """Per stereo pair the first frame is the loss frame with p = 2/3
    (sampling_strategies.py:139-155, `if random.randint(0, 2)`)."""

    def fn(num_frames: int, generator=None, draw=None) -> Tuple[Ids, Ids]:
        return _pairs(num_frames, [int(r == 0) for r in _ints(draw, num_frames // 2, 3, generator)])

    return fn


def alternate_loss_sampler() -> Callable:
    """One coin for the sample: the even frames give the loss and the odd
    ones are rendered with p = 2/3, else the other way round
    (sampling_strategies.py:199-207). The RE10K recipe's split: its samples
    are consecutive mono frames, not stereo pairs."""

    def fn(num_frames: int, generator=None, draw=None) -> Tuple[Ids, Ids]:
        (r,) = _ints(None if draw is None else [draw], 1, 3, generator)
        return _pairs(num_frames, [int(r == 0)] * (num_frames // 2))

    return fn


def get_loss_renderer_sampling(config: Optional[dict]) -> Callable:
    """(sampling_strategies.py:211+): kitti_360, stereo_view,
    single_renderer / single_view, alternate; kitti_360 for anything else."""
    name = (config or {}).get("name")
    args = (config or {}).get("args", {}) or {}
    if name == "stereo_view":
        return stereo_view_loss_sampler(**args)
    if name in ("single_renderer", "single_view"):
        return single_view_loss_sampler(**args)
    if name == "alternate":
        return alternate_loss_sampler()
    return kitti_360_loss_sampler()
