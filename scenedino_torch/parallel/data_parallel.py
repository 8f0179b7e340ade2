"""Data-parallel stage 1 on `torch.distributed` (counterpart of
`scenedino_tpu/parallel/mesh.py`, whose data mesh shards the batch and
replicates the model), NCCL on the card and gloo on the CPU.

The JAX step under its mesh computes the loss of the global batch. Each
rank here reproduces its share of that step:

  * every rank draws the global step's `Stage1Draws` from the same seeded
    generator and keeps its own items' rows (`shard_draws`); the scalar
    draws (split coins, shift, flip) are every rank's;
  * each rank loads its slice of the global batch (`rows`);
  * the gradients, the artifact field's too (it is not a module
    parameter), are averaged over the ranks (`average_`); every rank then
    holds the same gradients, so the non-finite decision is the same on
    every rank and all skip together;
  * the logged losses are averaged (the dbg_* extremes reduced as min or
    max, `reduce_losses`); rank 0 alone writes checkpoints, scalars and
    validations, and gives the others its generator afterwards
    (`sync_generator`), since its validations draw from it.

At equal shard sizes the mean of the ranks' losses is the global loss for
every term: each is a mean over items, patches or rays, and the
edge-aware smoothness normalizes the disparity per patch image, within
one item. The exception is `nanmean` of the DINO loss when some entries
are NaN on one rank and not another: it then weights the ranks by their
finite counts.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place among `world` data-parallel ranks."""

    rank: int
    world: int

    @property
    def main(self) -> bool:
        return self.rank == 0

    @staticmethod
    def init(rank: int, world: int, device: torch.device, init_method: str = "env://") -> "DataParallel":
        """Join the process group: NCCL for a CUDA device, gloo otherwise."""
        backend = "nccl" if device.type == "cuda" else "gloo"
        kw = {}
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(device)
            kw["device_id"] = device
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kw)
        return DataParallel(rank, world)

    def rows(self, n_global: int) -> slice:
        """This rank's items of a global batch of `n_global` (a multiple of world)."""
        if n_global % self.world:
            raise ValueError(f"a global batch of {n_global} does not split over {self.world} ranks")
        b = n_global // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def average_(self, tensors: List[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the ranks, one all-reduce per dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat)
            flat /= self.world
            for t, part in zip(group, torch.split(flat, [t.numel() for t in group])):
                t.copy_(part.view_as(t))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks: a new tensor, outside autograd."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on all) concatenated along the first
        axis in rank order; a bool tensor travels as uint8."""
        x = t.detach().to(torch.uint8 if t.dtype == torch.bool else t.dtype).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts).to(t.dtype)

    def broadcast_(self, tensors: List[torch.Tensor]) -> None:
        """Give every rank rank 0's values of `tensors`."""
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, 0)

    def reduce_losses(self, losses: Dict) -> Dict:
        """The loss dict of the global batch from each rank's: means, the
        dbg_*_min extremes as minima and the other dbg_* as maxima; the
        non-finite counters (equal on every rank) as they are."""
        keys = [k for k in losses if not k.startswith("nonfinite_")]
        if not keys:
            return dict(losses)
        dev = next((v.device for v in losses.values() if isinstance(v, torch.Tensor)), torch.device("cpu"))
        vals = torch.stack([torch.as_tensor(losses[k], dtype=torch.float32, device=dev).reshape(()) for k in keys])
        out = dict(losses)
        lo, hi, mean = vals.clone(), vals.clone(), vals.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(mean)
        for i, k in enumerate(keys):
            if k.startswith("dbg_"):
                out[k] = lo[i] if k.endswith("_min") else hi[i]
            else:
                out[k] = mean[i] / self.world
        return out

    def sync_generator(self, generator: torch.Generator) -> None:
        """Set `generator` to rank 0's state on every rank."""
        state = generator.get_state()
        dev = generator.device if dist.get_backend() == "nccl" else torch.device("cpu")
        t = state.to(dev)
        dist.broadcast(t, 0)
        generator.set_state(t.cpu())

    def shard_draws(self, draws, n_global: int):
        """This rank's rows of a global step's `Stage1Draws` over `n_global` items."""
        sl = self.rows(n_global)

        def item_rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if x is None:
                return None
            return x.reshape(n_global, -1, *x.shape[1:])[sl].reshape(-1, *x.shape[1:])

        cons = draws.consistency
        if cons is not None:
            cons = dataclasses.replace(cons, idx=cons.idx[sl], r0=cons.r0.map(item_rows),
                                       r1=cons.r1.map(item_rows))
        crops = draws.crops
        if crops is not None:
            crops = type(crops)(*(item_rows(getattr(crops, f.name)) for f in dataclasses.fields(crops)))
        return dataclasses.replace(
            draws, pv=draws.pv[sl], py=draws.py[sl], px=draws.px[sl], u=item_rows(draws.u),
            fine=None if draws.fine is None else draws.fine.map(item_rows), crops=crops,
            noise=item_rows(draws.noise), consistency=cons)


def from_environment(device: torch.device) -> Optional[DataParallel]:
    """The ranks `torchrun` describes (RANK, WORLD_SIZE; LOCAL_RANK picks
    the card), joined; None for a single process (no WORLD_SIZE, or 1)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    return DataParallel.init(int(os.environ["RANK"]), world, device)


def local_device(device: torch.device) -> torch.device:
    """The card of this rank under `torchrun` (LOCAL_RANK), else `device`."""
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device

