"""Check and time K1 past head dim 256 (`csrc/attention_wide.cu`) on the card.

    python -m scenedino_torch.tools.bench_attention_wide --check
    python -m scenedino_torch.tools.bench_attention_wide --check --time --other old/attention_wide.cu

It builds `csrc/attention_wide.cu` with the port's flags (and each
`--other` source with the same C functions, say an earlier revision's, its
`hopper.cuh` beside it) and prints what ptxas said of each kernel
(registers at launch, spills) and its notes on serialized wgmma (C75xx).
`--check` holds each build's forward (output and log-sum-exp), dq (with
di), dk and dv against the plain versions at SHAPES, the head dims of
`chip_smoke.py` phase 20a, and at RAGGED token counts around the 64-row
tiles, each twice (two launches bitwise equal).
`--time` times each build's three kernels in turns at SHAPES beside
`scaled_dot_product_attention` (CUDA events, and the device time of the
kernels from the profiler) and beside the bound (the products at the card's
bf16 rate). It needs a card; without one it exits 1.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import attention_bwd_plain, attention_lse_plain, attention_plain

SOURCE = build.CSRC / "attention_wide.cu"
# (B, N, H, D): the widths of the ViTs of wide heads (ViT-B/8 with 2 heads and
# 1, width 1024 with 2, width 1280 with 4 and 1) and D = 264 (five chunks,
# the last one 8 columns wide)
SHAPES = ((2, 1921, 2, 384), (2, 1921, 1, 768), (2, 1921, 2, 512), (2, 1921, 4, 320), (2, 1921, 1, 1280),
          (2, 1921, 2, 264))
RAGGED = ((1, 1, 2, 384), (1, 63, 2, 320), (1, 64, 1, 448), (1, 65, 2, 384), (1, 129, 1, 264),
          (1, 200, 2, 576))
K1_TOL = 2e-2
K1_LSE_TOL = 1e-3
K1_BWD_REL = 2e-2
PEAK_BF16_FLOPS = 989e12
GROUPS = {"fwd": 4, "dq": 4, "dkv": 2}  # output chunks of 64 columns a column group


def wide_report(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas' registers (at launch) and spills of the forward, dq and dkv
    kernels of csrc/attention_wide.cu in nvcc's output `log`."""
    out = {}
    for name, r in build.ptxas_report(log).items():
        m = re.search(r"\d(fwd|dq|dkv)_kernel", name)
        if m:
            out[m.group(1)] = r
    return out


def wgmma_notes(log: str) -> List[str]:
    """ptxas' notes on wgmma in `log` (C75xx: serialized, or an injected warpgroup.arrive)."""
    return [line.strip() for line in log.splitlines() if re.search(r"\bC75\d\d\b", line)]


def spilled(report: Dict[str, Dict[str, int]]) -> bool:
    """A kernel missing from the report, or one that spilled."""
    return sorted(report) != ["dkv", "dq", "fwd"] or any(
        r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in report.values())


def recompute(D: int) -> Dict[str, float]:
    """How many times each kernel runs the products over the head dim (S, and
    dP in the backward) for one output row: its column groups."""
    chunks = -(-D // 64)
    return {k: -(-chunks // g) for k, g in GROUPS.items()}


def bounds_ms(shape) -> Dict[str, float]:
    """The least time of each kernel at `shape`: its products at the card's
    bf16 rate (the forward 4 N^2 D B H FLOP, dq 6, dkv 8; operations bound
    every shape here)."""
    B, N, H, D = shape
    unit = B * H * N * N * D / PEAK_BF16_FLOPS * 1e3
    return {"fwd": 4 * unit, "dq": 6 * unit, "dkv": 8 * unit}


class Build:
    """The three C functions of one build, called as the port's wrappers call them."""

    def __init__(self, lib):
        import ctypes

        self.fns = {}
        for name, ptrs in (("attention_wide_fwd", 5), ("attention_wide_bwd_dq", 8), ("attention_wide_bwd_dkv", 8)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.fns[name] = fn

    def _call(self, name, tensors, shape):
        B, N, H, D = shape
        err = self.fns[name](*(None if t is None else t.data_ptr() for t in tensors), B, N, H, D, D ** -0.5,
                             torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")

    def fwd(self, q, k, v, with_lse=True):
        B, N, H, _ = q.shape
        out = torch.empty_like(q)
        lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32) if with_lse else None
        self._call("attention_wide_fwd", (q, k, v, out, lse), q.shape)
        return out, lse

    def dq(self, q, k, v, o, do, lse):
        B, N, H, _ = q.shape
        dq, di = torch.empty_like(q), torch.empty(B, H, N, device=q.device, dtype=torch.float32)
        self._call("attention_wide_bwd_dq", (q, k, v, o, do, lse, dq, di), q.shape)
        return dq, di

    def dkv(self, q, k, v, do, lse, di):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._call("attention_wide_bwd_dkv", (q, k, v, do, lse, di, dk, dv), q.shape)
        return dk, dv


def inputs(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))


def errors(fwd, dq, dkv, q, k, v, do) -> Dict[str, object]:
    """The three kernels' results at (q, k, v, do) against the plain versions
    (the backward from the kernel's own output and log-sum-exp, as the
    port's autograd hands them), and whether two launches gave the same
    bits: {"out", "lse", "di", "dq", "dk", "dv", "bounds", "bitwise", "ok"}."""
    out, lse = fwd(q, k, v)
    g_dq, di = dq(q, k, v, out, do, lse)
    g_dk, g_dv = dkv(q, k, v, do, lse, di)
    again = (fwd(q, k, v)[0], dq(q, k, v, out, do, lse)[0], *dkv(q, k, v, do, lse, di))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip((out, g_dq, g_dk, g_dv), again))
    e = {"out": (out.float() - attention_plain(q, k, v).float()).abs().max().item(),
         "lse": (lse - attention_lse_plain(q, k)).abs().max().item(),
         "di": (di - (do.float() * out.float()).sum(-1).transpose(1, 2)).abs().max().item()}
    bounds = {}
    for name, got, ref in zip(("dq", "dk", "dv"), (g_dq, g_dk, g_dv), attention_bwd_plain(q, k, v, out, do, lse)):
        e[name] = (got.float() - ref.float()).abs().max().item()
        bounds[name] = K1_BWD_REL * ref.float().abs().max().item() + 1e-3
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, g_dq, g_dk, g_dv))
    ok = (finite and bitwise and e["out"] <= K1_TOL and e["lse"] <= K1_LSE_TOL and e["di"] <= K1_LSE_TOL
          and all(e[n] <= bounds[n] for n in bounds))
    return {**e, "bounds": bounds, "bitwise": bitwise, "ok": ok}


def check(b: Build, shapes: Sequence, seed: int = 0) -> bool:
    ok = True
    for i, shape in enumerate(shapes):
        q, k, v, do = inputs(shape, seed + i)
        e = errors(b.fwd, b.dq, b.dkv, q, k, v, do)
        print(f"  {shape}: out {e['out']:.3e} lse {e['lse']:.3e} di {e['di']:.3e} dq {e['dq']:.3e} dk {e['dk']:.3e} "
              f"dv {e['dv']:.3e} (bounds {K1_TOL} / {K1_LSE_TOL} / {json.dumps({n: round(x, 5) for n, x in e['bounds'].items()})}); "
              f"two launches bitwise equal: {e['bitwise']}{'' if e['ok'] else ', FAIL'}", flush=True)
        ok = ok and e["ok"]
    return ok


def time_sdpa(q, k, v, do):
    """SDPA's forward and backward (CUDA events, device time) at (B, N, H, D)
    inputs, and the backend that ran it (the kernels' names)."""
    from scenedino_torch.utils.timing import _kernel_times, device_ms, time_ms

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_ms = time_ms(lambda: sdpa(qt, kt, vt), inner=3)
    out = sdpa(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), inner=3)
    names, _ = _kernel_times(lambda: sdpa(qt, kt, vt))
    return {"ms": fwd_ms, "device_ms": device_ms(lambda: sdpa(qt, kt, vt), calls=5), "bwd_ms": bwd_ms,
            "backend": backend_of(names)}


def backend_of(kernel_names) -> str:
    """The SDPA backend that the kernels' names show: flash, memory-efficient,
    cuDNN, or the math path (separate matrix products and a softmax); "not
    measured" where the profiler saw no kernel."""
    if not kernel_names:
        return "not measured"
    text = " ".join(kernel_names).lower()
    if "flash" in text:
        return "flash"
    if "fmha" in text or "efficient" in text or ("cutlass" in text and "attention" in text):
        return "memory-efficient"
    if "cudnn" in text:
        return "cuDNN"
    return "math (matrix products and a softmax)"


def time_build(b: Build, shape, seed=0) -> Dict[str, object]:
    from scenedino_torch.utils.timing import device_ms, time_ms

    q, k, v, do = inputs(shape, seed)
    out, lse = b.fwd(q, k, v)
    dq_, di = b.dq(q, k, v, out, do, lse)
    return {"fwd": time_ms(lambda: b.fwd(q, k, v, False), inner=3),
            "fwd_device": device_ms(lambda: b.fwd(q, k, v, False), calls=5),
            "dq": time_ms(lambda: b.dq(q, k, v, out, do, lse), inner=3),
            "dkv": time_ms(lambda: b.dkv(q, k, v, do, lse, di), inner=3),
            "bwd_device": device_ms(lambda: (b.dq(q, k, v, out, do, lse), b.dkv(q, k, v, do, lse, di)), calls=5)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--time", action="store_true")
    parser.add_argument("--other", nargs="*", default=[], type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures the kernels on an NVIDIA GPU", file=sys.stderr)
        return 1
    from scenedino_torch.tools.bench_attention_bwd import compile_sources
    from scenedino_torch.utils.timing import card_line, ms_text

    print(card_line(), flush=True)
    names = ["port"] + [str(p) for p in args.other]
    builds = compile_sources([(p, None) for p in [SOURCE, *args.other]])
    ok = True
    libs = {}
    for name, (lib, log) in zip(names, builds):
        report = wide_report(log)
        notes = wgmma_notes(log)
        print(f"{name}: ptxas {json.dumps(report)}; wgmma notes {len(notes)}" + "".join(f"\n  {n}" for n in notes[:8]),
              flush=True)
        ok = ok and not spilled(report) and not notes
        libs[name] = Build(lib)
    if args.check:
        for name, b in libs.items():
            print(f"{name}: check at {len(SHAPES)} shapes and {len(RAGGED)} ragged ones", flush=True)
            ok = check(b, SHAPES + RAGGED) and ok
    if args.time:
        torch.backends.cuda.matmul.allow_tf32 = False
        for shape in SHAPES:
            q, k, v, do = inputs(shape, 0)
            lib = time_sdpa(q, k, v, do)
            bounds = bounds_ms(shape)
            order = names + names[::-1]
            times = {n: [] for n in names}
            for n in order:
                times[n].append(time_build(libs[n], shape))
            for n in names:
                first = times[n][0]
                print(f"{shape} {n} (column groups {json.dumps(recompute(shape[3]))}): forward "
                      f"{[round(t['fwd'], 4) for t in times[n]]} ms (device "
                      f"{[ms_text(t['fwd_device']) for t in times[n]]}), dq {[round(t['dq'], 4) for t in times[n]]}, "
                      f"dkv {[round(t['dkv'], 4) for t in times[n]]}, dq + dkv device "
                      f"{[ms_text(t['bwd_device']) for t in times[n]]}; bounds {json.dumps(bounds)}; first pass "
                      f"{first['fwd'] / bounds['fwd']:.1f}x the forward's bound", flush=True)
            print(f"{shape} sdpa ({lib['backend']}): forward {lib['ms']:.4f} ms (device {ms_text(lib['device_ms'])}), "
                  f"backward {lib['bwd_ms']:.4f} ms", flush=True)
    print(f"correct={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
