"""The devices of one process (counterpart of `scenedino_tpu/parallel/mesh.py`).

The reference runs serving and evaluation across chips from one
controller: a mesh of devices goes in, global arrays come out
(`render_novel_view_fused_sharded`, `make_sharded_frame_predictor`,
`Seg2DEvaluator.run_sharded` and `make_sharded_renderer` raise under
several processes). The port keeps that split: those paths take a list of
devices, its "mesh", and run in one process; training runs one process a
card under `torchrun` (`parallel.data_parallel`).

A mesh may name one device several times: a repeated device stands in for
several (the CPU in the tests, one card on a one-card machine). Modules
and state are replicated once per distinct device (`replicate`), never per
share, and no collective is needed. `run_shares` runs each device's shares
from its own thread, as `torch.nn.parallel.parallel_apply` does, so that
host-bound work overlaps on several cards; a device's own shares run in
turn, in order.
"""
from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional, Sequence, TypeVar

import torch

T = TypeVar("T")


def make_mesh(n: Optional[int] = None, device="cuda") -> List[torch.device]:
    """For a CUDA `device`, every visible card (the first `n` where given, as
    the reference's `make_mesh(n)` takes the first `n` devices); for another
    device type, that device once."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device visible")
    return [torch.device("cuda", i) for i in range(count)][:n]


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """The devices of a mesh in first-seen order, each once."""
    out: List[torch.device] = []
    for d in devices:
        d = torch.device(d)
        if d not in out:
            out.append(d)
    return out


def replicate(module: torch.nn.Module, devices: Sequence[torch.device]) -> Dict[torch.device, torch.nn.Module]:
    """One copy of `module` on each distinct device of `devices`: the module
    itself on the device its parameters are on, a deep copy moved to each
    other one."""
    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d) for d in distinct(devices)}


def run_shares(fn: Callable[[int, torch.device], T], devices: Sequence[torch.device]) -> List[T]:
    """[fn(i, devices[i]) for each share i]. With one distinct device the
    shares run in turn in the calling thread; otherwise each distinct device
    runs its shares in turn from a thread of its own, with the caller's grad
    and inference modes, on that card's current stream. The first exception
    of a share is raised here."""
    devices = [torch.device(d) for d in devices]
    groups = {d: [i for i, e in enumerate(devices) if e == d] for d in distinct(devices)}
    results: List[Optional[T]] = [None] * len(devices)
    if len(groups) == 1:
        for i, d in enumerate(devices):
            results[i] = fn(i, d)
        return results
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    errors: List[BaseException] = []

    def worker(d: torch.device, shares: List[int]) -> None:
        try:
            with torch.set_grad_enabled(grad), torch.inference_mode(inference):
                if d.type == "cuda":
                    with torch.cuda.device(d), torch.cuda.stream(torch.cuda.current_stream(d)):
                        for i in shares:
                            results[i] = fn(i, d)
                else:
                    for i in shares:
                        results[i] = fn(i, d)
        except BaseException as e:  # handed to the caller
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(d, shares)) for d, shares in groups.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
