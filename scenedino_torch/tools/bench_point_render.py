"""Check and time the point kernels (K2 `point_render`, K3 `probe_weights`,
K4 `point_query`, all of `csrc/point_render.cu`) at the shapes of the main
paths, in several builds side by side on one card.

    python -m scenedino_torch.tools.bench_point_render --check
    python -m scenedino_torch.tools.bench_point_render --variants 1,3,1 2,2,1 1,3,0 --other old/point_render.cu
    python -m scenedino_torch.tools.bench_point_render --parent parent/scenedino_torch/csrc/point_render.cu

`--check` builds the source as the port loads it, prints what ptxas said
of its kernels (registers, spills) and nvcc's warnings, and holds K2
(expectation and median), K3 and K4 against their plain versions at the
paths' shapes with chip_smoke.py's bounds: K2 over the 192x640 novel
view's rays at 32 and at 12 samples, K3 over the 48x160 probe rays at 16,
K4 over the 2,097,152 SSCBench voxel centres, all on a seeded
384x1280x128 bf16 grid with W_code 39x128 and W2 128x65. A variant
`a,b,c` rebuilds it with warpgroups a block, blocks an SM the registers
are divided for, and corner-load batches issued ahead of the blend (the
PR_WGS, PR_BLOCKS, PR_AHEAD macros); `--other` adds another source with
the same C interface (say an earlier revision's). `--parent` adds a source
from before the normalized depth took jitted XLA's rounding (its entries
take the divisor 1/z_near - 1/z_far, or z_far - z_near, where the port's
take the scale 2 / divisor) and the port's own build beside it, each behind
the same Python call, and first compares the ptxas lines of the parent's kernels with the
port's build's (the same instantiations, by name). Each build is checked as
above, then every build is timed at the four shapes in turns, first to
last and back again, and each pass is printed. Builds are driven through
the port's own wrappers. Every time is the median CUDA-event time of
`utils.timing.time_ms` on the card that the first line names.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scenedino_torch.core import rays as rays_mod
from scenedino_torch.core.sampling import sample_coarse
from scenedino_torch.kernels import build
from scenedino_torch.tools.bench_attention_bwd import compile_sources, print_warnings
from scenedino_torch.utils.timing import card_line, time_ms

pr = importlib.import_module("scenedino_torch.kernels.point_render")  # the package exports the wrapper by this name

H, W = 192, 640
MACROS = ("PR_WGS", "PR_BLOCKS", "PR_AHEAD")
ENTRIES = ("point_render", "probe_weights", "point_query")
# chip_smoke.py's bounds
K2_DEPTH_TOL, K2_FEAT_TOL, K2_RGB_TOL, K2_MEDIAN_FLIPS = 5e-2, 5e-3, 5e-3, 1e-2
K3_TOL, K4_TOL = 5e-3, 1e-2
Z_NEAR, Z_FAR = 3.0, 80.0


def novel_pose(dev):
    c, s = np.cos(0.05), np.sin(0.05)
    m = np.array([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.0], [0, 0, 0, 1]], np.float32)
    return torch.from_numpy(m).to(dev)


def intrinsics(dev):
    return torch.tensor([[0.7, 0.0, 0.0], [0.0, 2.3, 0.0], [0.0, 0.0, 1.0]], device=dev)


def shapes(seed: int) -> Dict[str, tuple]:
    """The four shapes' inputs (chip_smoke.py phases 3, 3b and 3c), seeded."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    D, E, C = 128, 65, 39
    grid = randn(2 * H, 2 * W, D).to(torch.bfloat16)
    w_code = randn(C, D, scale=C ** -0.5).to(torch.bfloat16)
    b1, w2, b2 = randn(D, scale=0.1), randn(D, E, scale=D ** -0.5).to(torch.bfloat16), randn(E, scale=0.1)
    b2[0] += 0.5
    cams = (torch.eye(4, device=dev), intrinsics(dev))
    r, _ = rays_mod.rays_from_k(novel_pose(dev)[None], intrinsics(dev)[None], W, H, Z_NEAR, Z_FAR)
    flat = r.reshape(-1, 8).contiguous()
    colour = torch.rand(H, W, 3, generator=gen, device=dev).to(torch.bfloat16)
    field = (grid, w_code, b1, w2, b2, *cams)
    out = {}
    for K in (32, 12):
        z = sample_coarse(flat, K, generator=gen).contiguous()
        out[f"K2 {K} samples"] = ("point_render", (flat, z, *field, colour, *cams))
    probe = r[0, ::4, ::4].reshape(-1, 8).contiguous()
    zp = sample_coarse(probe, 16, generator=gen).contiguous()
    out["K3 probe"] = ("probe_weights", (probe, zp, grid, w_code, b1, w2[:, :1].contiguous(),
                                         b2[:1].contiguous(), *cams))
    from scenedino_torch.eval.sscbench import generate_point_grid

    pts, _ = generate_point_grid()
    pts = pts.reshape(256, 256, 32, 3).transpose(2, 0, 1, 3).reshape(-1, 3)
    out["K4 voxels"] = ("point_query", (torch.from_numpy(np.ascontiguousarray(pts)).to(dev), *field))
    return out


def through(fn, parent: bool = False):
    """`fn` behind one Python call; for a `parent`'s entry, the normalized
    depth's scale (the third argument from the end, before freq_factor and
    the stream) handed as the divisor the parent takes, 2 / scale."""
    if not parent:
        return lambda *a: fn(*a)
    return lambda *a: fn(*a[:-3], 2.0 / a[-3], *a[-2:])


def entry_name(name: str) -> str:
    """A kernel's mangled name without its anonymous namespace's tag (which
    hashes the file, so that it differs between revisions)."""
    return re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN", name)


def ptxas_entries(log: str) -> Dict[str, List[str]]:
    """ptxas' lines of each kernel in nvcc's output (registers, barriers,
    stack, spills), by `entry_name`."""
    out: Dict[str, List[str]] = {}
    lines = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            lines = out.setdefault(entry_name(m.group(1)), [])
        elif lines is not None and ("bytes stack frame" in line or "Used" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return out


def compare_ptxas(parent_log: str, port_log: str) -> dict:
    """The parent's kernels whose ptxas lines the port's build repeats, and
    the ones it changes or lacks."""
    parent, port = ptxas_entries(parent_log), ptxas_entries(port_log)
    changed = {k: {"parent": v, "port": port.get(k)} for k, v in parent.items() if port.get(k) != v}
    return {"parent_kernels": len(parent), "unchanged": len(parent) - len(changed), "changed": changed,
            "new": sorted(set(port) - set(parent))}


@contextlib.contextmanager
def library(lib):
    """The port's wrappers call `lib`'s functions inside the block (None:
    the port's own build; a dict: entry name -> callable)."""
    saved = {e: build._functions.get(("point_render", e)) for e in ENTRIES}
    try:
        if isinstance(lib, dict):
            for e in ENTRIES:
                build._functions["point_render", e] = lib[e]
        elif lib is not None:
            for e in ENTRIES:
                build._functions["point_render", e] = getattr(lib, e)
                build._functions["point_render", e].restype = ctypes.c_int
        yield
    finally:
        for e, fn in saved.items():
            if fn is None:
                build._functions.pop(("point_render", e), None)
            else:
                build._functions["point_render", e] = fn


def set_argtypes(lib: ctypes.CDLL, buffers: bool = True) -> None:
    """The argument types the wrappers give `build.function` (pointers, ints,
    floats, stream); without `buffers`, a parent's (no wide-walk buffers)."""
    counts = {"point_render": (15, 15, 3), "probe_weights": (10, 11, 3), "point_query": (10, 10, 3)}
    for e, (ptrs, ints, floats) in counts.items():
        getattr(lib, e).argtypes = ([ctypes.c_void_p] * (ptrs + 2 * buffers) + [ctypes.c_int] * ints
                                    + [ctypes.c_float] * floats + [ctypes.c_void_p])
        getattr(lib, e).restype = ctypes.c_int


def check(inputs: Dict[str, tuple], label: str) -> bool:
    """Each shape's kernel output against the plain version, with chip_smoke.py's bounds."""
    cfg = pr.PointRenderConfig()
    ok = True
    for name, (entry, args) in inputs.items():
        if entry == "point_render":
            out = pr.point_render(*args, cfg)
            ref = pr.point_render_plain(*args, cfg)
            errs = [(o - p).abs().max().item() for o, p in zip(out, ref)]
            good = all(bool(torch.isfinite(o).all()) for o in out) and errs[0] <= K2_DEPTH_TOL \
                and errs[1] <= K2_FEAT_TOL and errs[2] <= K2_RGB_TOL
            med = dataclasses.replace(cfg, depth_statistic="median")
            out_m, ref_m = pr.point_render(*args, med), pr.point_render_plain(*args, med)
            z = args[1]
            k_idx = (z - out_m[0][:, None]).abs().argmin(-1)
            p_idx = (z - ref_m[0][:, None]).abs().argmin(-1)
            flips = (k_idx != p_idx).float().mean().item()
            good = good and torch.equal(z.gather(1, k_idx[:, None])[:, 0], out_m[0]) \
                and (k_idx - p_idx).abs().max().item() <= 1 and flips <= K2_MEDIAN_FLIPS
            text = f"depth {errs[0]:.3e}, feature {errs[1]:.3e}, rgb {errs[2]:.3e}; median flips {flips:.3e}"
        elif entry == "probe_weights":
            err = (pr.probe_weights(*args, cfg) - pr.probe_weights_plain(*args, cfg)).abs().max().item()
            good, text = err <= K3_TOL, f"weights {err:.3e}"
        else:
            pts = args[0]
            sigma, feat = pr.point_query(*args, cfg)
            in_range = (pts[:, 2] >= Z_NEAR) & (pts[:, 2] <= Z_FAR)
            err_range, err_scaled, chunk = 0.0, 0.0, 1 << 18
            for p0 in range(0, pts.shape[0], chunk):
                rs, rf = pr.point_query_plain(pts[p0:p0 + chunk], *args[1:], cfg)
                d = torch.maximum((sigma[p0:p0 + chunk] - rs).abs(), (feat[p0:p0 + chunk] - rf).abs().amax(-1))
                scale = torch.clamp_min(torch.maximum(rs, rf.abs().amax(-1)), 1.0)
                err_range = max(err_range, d[in_range[p0:p0 + chunk]].max().item())
                err_scaled = max(err_scaled, (d / scale).max().item())
            good = bool(torch.isfinite(sigma).all() and torch.isfinite(feat).all()) and err_range <= K4_TOL \
                and err_scaled <= K4_TOL
            text = f"in [{Z_NEAR}, {Z_FAR}] m {err_range:.3e}, scaled {err_scaled:.3e}"
        torch.cuda.synchronize()
        print(f"check {label} {name}: {text}{'' if good else ', FAIL'}", flush=True)
        ok = ok and good
    return ok


def run_entry(entry: str, args: tuple, cfg):
    return getattr(pr, entry)(*args, cfg)


def ptxas_lines(log: str) -> str:
    return json.dumps({name: r for name, r in build.ptxas_report(log).items() if "point_kernel" in name})


def parse_variant(text: str) -> Dict[str, int]:
    values = [int(x) for x in text.split(",")]
    if len(values) != len(MACROS):
        raise ValueError(f"a variant is a,b,c, got {text!r}")
    return dict(zip(MACROS, values))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true", help="the port's build: ptxas, then each shape's check")
    parser.add_argument("--variants", nargs="*", default=[], help="a,b,c = PR_WGS, PR_BLOCKS, PR_AHEAD")
    parser.add_argument("--other", nargs="*", default=[], help="other sources with the same C interface")
    parser.add_argument("--parent", help="a source from before the depth rounding, timed against the port's build")
    parser.add_argument("--passes", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_point_render needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    inputs = shapes(args.seed)
    ok = True
    if args.check:
        build.build(["point_render"])
        log = build.build_log("point_render")
        print_warnings(log)
        print(f"ptxas point_render: {ptxas_lines(log)}", flush=True)
        ok = check(inputs, "port") and ok

    jobs: List[Tuple[Path, Optional[Dict[str, int]]]] = [(build.CSRC / "point_render.cu", parse_variant(v))
                                                         for v in args.variants]
    jobs += [(Path(p).resolve(), None) for p in args.other]
    labels = [f"variant {v}" for v in args.variants] + [f"other {p}" for p in args.other]
    if args.parent:
        jobs.append((Path(args.parent).resolve(), None))
    builds = []
    for i, (lib, log) in enumerate(compile_sources(jobs)):
        if i == len(labels):  # the parent
            port = build.load("point_render")
            report = compare_ptxas(log, build.build_log("point_render"))
            print(f"ptxas parent against the port's build: {json.dumps(report)}", flush=True)
            set_argtypes(port)
            set_argtypes(lib)
            builds.append(("port", {e: through(getattr(port, e)) for e in ENTRIES}))
            builds.append(("parent", {e: through(getattr(lib, e), parent=True) for e in ENTRIES}))
            with library(builds[-1][1]):
                ok = check(inputs, "parent") and ok
            continue
        label = labels[i]
        print_warnings(log)
        print(f"ptxas {label}: {ptxas_lines(log)}", flush=True)
        set_argtypes(lib)
        with library(lib):
            ok = check(inputs, label) and ok
        builds.append((label, lib))
    if builds:
        cfg = pr.PointRenderConfig()
        order = list(range(len(builds)))
        for p in range(args.passes):
            seq = order if p % 2 == 0 else order[::-1]
            times = {}
            for i in seq:
                label, lib = builds[i]
                with library(lib):
                    times[label] = {name: round(time_ms(lambda: run_entry(e, a, cfg), inner=5), 4)
                                    for name, (e, a) in inputs.items()}
            print(f"pass {p + 1} ms: {json.dumps(times)}", flush=True)
    if not ok:
        raise SystemExit("bench_point_render: a check failed")
    print("correct=True", flush=True)


if __name__ == "__main__":
    main()
