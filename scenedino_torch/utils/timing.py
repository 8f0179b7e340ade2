"""Timing on the card, for the tools and `chip_smoke.py`."""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi failed ({out.returncode})"


def time_ms(fn, reps: int = 10, inner: int = 1, warmup: int = 2) -> float:
    """Median over `reps` of the CUDA-event time of `inner` back-to-back calls, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def _kernel_times(fn):
    """({kernel name: device ms}, wall ms) of one call of `fn` under
    torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    cpu_ops = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    by_name = {}
    for e in events:
        # device-side ranges named after a CPU operator repeat the time of its kernels
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in cpu_ops:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    return by_name, wall


def device_ms(fn, calls: int = 10) -> float:
    """The card's busy time a call of `fn`: its kernels' device time summed
    over `calls` calls (after one unprofiled call) over `calls`. Unlike
    `time_ms`, it leaves out the host's launch overhead."""
    fn()

    def run():
        for _ in range(calls):
            fn()

    return sum(_kernel_times(run)[0].values()) / calls


def profile_device(fn) -> str:
    """Device time of one call of `fn` by kernel (torch.profiler, CUPTI):
    the busy time, the wall time, the idle share and the ten largest
    kernels, as one line."""
    by_name, wall = _kernel_times(fn)
    times = sorted(((n, t) for n, t in by_name.items() if t > 0), key=lambda t: -t[1])
    busy = sum(t for _, t in times)
    if busy == 0:
        return "profiler saw no device time"
    top = "; ".join(f"{name[:70]} {t:.3f} ms" for name, t in times[:10])
    return (f"device busy {busy:.3f} ms of {wall:.3f} ms wall (profiled), idle share "
            f"{max(0.0, 1 - busy / wall):.3f}; top: {top}")
