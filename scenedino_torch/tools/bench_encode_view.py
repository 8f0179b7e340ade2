"""K6, the encode-view kernel, on the card: its registers and spills,
then the kernel against its plain version at the shapes its paths give it,
and the kernel's, the plain version's and the bound's times.

    python -m scenedino_torch.tools.bench_encode_view [--seed N]
    python -m scenedino_torch.tools.bench_encode_view --parent parent/scenedino_torch/csrc/encode_view.cu

The shapes (`SHAPES`), each from a seeded folded grid at twice the render
size through `ops.fast_field.encode_view_inputs` (the render's own
preamble): the flagship's 192x640 rays (W_code 39x128, W2 128x65) as the
bf16 serving state of one frame at 32 samples, as stage 2's fp32 state of 4
frames in one launch at 32 samples, and as the bf16 serving state of one
frame at 48 samples (16 dead rows a ray in the kernel's 64-row tiles); the
96x192 rays of the convergence recipes (W_code 39x64, W2 64x17) as the
stage-2 recipe's fp32 state of 4 frames at 32 samples, and as the bf16
serving state of one frame at configs/train_synthetic_convergence.yaml's
n_coarse of 48. Expectation depth, then the weight-median depth. Then the
serving render stage split into its torch preamble and K6. `--parent`
adds a source from before the normalized depth took jitted XLA's rounding
(its entry takes the divisor where the port's takes the scale 2 / divisor,
`bench_point_render.through`): the ptxas lines of its kernels against the port's
build's, then the serving and stage-2 shapes timed with each build in
turns (parent, port, port, parent), each behind the same Python call.
Every time is
the median CUDA-event time of `utils.timing.time_ms` on the card that the
last lines name. Needs a CUDA card; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import sys

import torch

from scenedino_torch.kernels import build
from scenedino_torch.kernels.encode_view import ARGTYPES, encode_view, encode_view_plain
from scenedino_torch.models.field import FieldConfig
from scenedino_torch.ops.fast_field import FastFieldState, encode_view_inputs, render_encode_view_batched
from scenedino_torch.utils.timing import card_line, profile_device, time_ms

C = 39


@dataclasses.dataclass(frozen=True)
class Shape:
    """One path's K6 launch: `frames` x height x width rays of `samples`
    samples from a folded grid of width d_hidden at twice the render size,
    d_out outputs."""
    path: str
    frames: int
    dtype: torch.dtype
    height: int
    width: int
    d_hidden: int
    d_out: int
    samples: int = 32


# serving (the encode-view request), stage 2 at flagship width (chip_smoke
# phase 7), stage 2's synthetic convergence recipe (phase 7b), serving at
# flagship width and 48 samples, and the encode view of a field of the
# stage-1 convergence recipe (its widths, its 48 samples)
SHAPES = (Shape("serving", 1, torch.bfloat16, 192, 640, 128, 65),
          Shape("stage 2", 4, torch.float32, 192, 640, 128, 65),
          Shape("stage 2 convergence", 4, torch.float32, 96, 192, 64, 17),
          Shape("serving 48 samples", 1, torch.bfloat16, 192, 640, 128, 65, 48),
          Shape("serving convergence 48 samples", 1, torch.bfloat16, 96, 192, 64, 17, 48))
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 on the tensor
# cores, fp32 outside them; HBM3
PEAK_BF16, PEAK_TF32, PEAK_FP32 = 989e12, 495e12, 67e12
PEAK_BYTES = 3.35e12
# the least time of a multiply-add of the state's type at fp32's accuracy on
# the tensor cores: bf16 one pass, fp32 three TF32 passes (3xTF32)
SECONDS_PER_FLOP = {torch.bfloat16: 1 / PEAK_BF16, torch.float32: 3 / PEAK_TF32}
# kernel against plain version. fp32: the same fp32 sums in another order
# (a 141-term dot product a sample, compositing scans) — relative round-off
# of a few 1e-7 through the weights' exponentials; bf16: h rounds to bf16
# before W2, and a sum in another order can flip a rounding (ulp 2^-8 |h|),
# moving a sample's output by about |W2| x ulp and the weights with it
TOL = {torch.float32: {"depth": 1e-3, "feature": 1e-4, "rgb": 1e-4},
       torch.bfloat16: {"depth": 5e-2, "feature": 5e-3, "rgb": 5e-3}}
# the weight-median depth is a sample depth: the plain version's, or its
# neighbour where a near tie of the CDF at 0.5 falls the other way
MEDIAN_FLIPS = 1e-3


def seeded_state(gen: torch.Generator, shape: Shape) -> FastFieldState:
    """A seeded folded state of `shape.frames` encode views at the shape's
    widths, stored in its dtype (bf16 serving, fp32 stage 2)."""
    dev = gen.device
    frames, dtype, H, W, D, E = (shape.frames, shape.dtype, shape.height, shape.width, shape.d_hidden,
                                 shape.d_out)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    ks = torch.tensor([[0.7, 0.0, 0.0], [0.0, 2.3, 0.0], [0.0, 0.0, 1.0]], device=dev)
    ks = ks.expand(frames, 1, 3, 3).contiguous()
    w2c = torch.eye(4, device=dev).expand(frames, 1, 4, 4).contiguous()
    b2 = randn(E, scale=0.1)
    b2[0] += 0.5
    return FastFieldState(
        folded_grid=randn(frames, 1, 2 * H, 2 * W, D).to(dtype), w_code=randn(C, D, scale=C ** -0.5).to(dtype),
        b1=randn(D, scale=0.1), w2=randn(D, E, scale=D ** -0.5).to(dtype), b2=b2, feat_ks=ks, feat_w2c=w2c,
        color_imgs=torch.rand(frames, 1, H, W, 3, generator=gen, device=dev).to(dtype), color_ks=ks,
        color_w2c=w2c)


def flops(args) -> float:
    """The two products' operations: 2 x rays x samples x (Cz D + D E)."""
    n, D = args[0].shape
    k, E = args[1].shape[1], args[4].shape[1]
    return 2.0 * n * k * (args[3].shape[0] * D + D * E)


def bound(args, dtype: torch.dtype):
    """(ms, "bytes" or "operations"): each input read once, each output
    written once; the products at the tensor cores' rate for the state's
    type (fp32: three TF32 passes)."""
    n, E = args[0].shape[0], args[4].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in args) + n * (1 + (E - 1) + 3) * 4
    t_ops, t_bytes = flops(args) * SECONDS_PER_FLOP[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fp32_cores_bound_ms(args) -> float:
    """The products at the 67 TFLOP/s of fp32 outside the tensor cores (the
    fp32 state's bound before it took three TF32 passes), ms."""
    return flops(args) / PEAK_FP32 * 1e3


def check(gen: torch.Generator, shape: Shape, reps: int = 10) -> dict:
    """The kernel against its plain version on one seeded state: errors by
    output (expectation depth), the median depth's sample agreement, two
    launches bitwise equal, and the times."""
    fs = seeded_state(gen, shape)
    args, cfg = encode_view_inputs(fs, FieldConfig(), shape.height, shape.width, generator=gen,
                                   n_coarse=shape.samples)
    out = encode_view(*args, cfg)
    again = encode_view(*args, cfg)
    torch.cuda.synchronize()
    ref = encode_view_plain(*args, cfg)
    errs = {name: (o - p).abs().max().item() for name, o, p in zip(("depth", "feature", "rgb"), out, ref)}
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    bitwise = all(torch.equal(a, b) for a, b in zip(out, again))

    med = dataclasses.replace(cfg, depth_statistic="median")
    z = args[1]
    out_m = encode_view(*args, med)[0]
    torch.cuda.synchronize()
    ref_m = encode_view_plain(*args, med)[0]
    k_idx = (z - out_m[:, None]).abs().argmin(-1)
    p_idx = (z - ref_m[:, None]).abs().argmin(-1)
    on_sample = torch.equal(z.gather(1, k_idx[:, None])[:, 0], out_m)
    flips = (k_idx != p_idx).float().mean().item()
    off = (k_idx - p_idx).abs().max().item()

    ms = time_ms(lambda: encode_view(*args, cfg), reps=reps)
    ms_median = time_ms(lambda: encode_view(*args, med), reps=reps)
    plain_ms = time_ms(lambda: encode_view_plain(*args, cfg), reps=max(3, reps // 3), warmup=1)
    b, by = bound(args, shape.dtype)
    tol = TOL[shape.dtype]
    ok = (finite and bitwise and all(errs[k] <= tol[k] for k in tol) and on_sample and off <= 1
          and flips <= MEDIAN_FLIPS)
    return {"path": shape.path, "frames": shape.frames, "dtype": str(shape.dtype).split(".")[-1],
            "rays": args[0].shape[0], "height": shape.height, "width": shape.width, "d_hidden": shape.d_hidden,
            "d_out": shape.d_out, "samples": shape.samples, "errors": errs,
            "tolerance": tol, "finite": finite, "bitwise": bitwise, "median_on_sample": on_sample,
            "median_flips": flips, "median_off": off, "ms": ms, "median_ms": ms_median, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by,
            "fp32_cores_bound_ms": fp32_cores_bound_ms(args) if shape.dtype == torch.float32 else None, "ok": ok}


def render_stage(gen: torch.Generator, shape: Shape, reps: int = 10) -> dict:
    """The encode-view render stage at `shape` on a seeded state, split into
    its torch preamble (`encode_view_inputs`: the rays, the strata's depths,
    the grid's 2x2 mean, the x/y code's pixel bias, the base rows) and K6,
    each timed alone, beside the whole render
    (`render_encode_view_batched`), and the preamble's device profile."""
    fs = seeded_state(gen, shape)
    fcfg = FieldConfig()
    u = torch.rand(shape.frames, shape.height * shape.width, shape.samples, generator=gen, device=gen.device)

    def pre():
        return encode_view_inputs(fs, fcfg, shape.height, shape.width, u=u, n_coarse=shape.samples)

    args, cfg = pre()
    return {"path": shape.path, "preamble_ms": time_ms(pre, reps=reps),
            "kernel_ms": time_ms(lambda: encode_view(*args, cfg), reps=reps),
            "render_ms": time_ms(lambda: render_encode_view_batched(fs, fcfg, shape.height, shape.width, u=u,
                                                                    n_coarse=shape.samples), reps=reps),
            "preamble_profile": profile_device(pre)}


# kernels of csrc/encode_view.cu: the shipped instantiations, {bf16, TF32} x
# the code's k16 steps {1, 2} x the walk {one tile a ray, several} x hidden
# chunks {1, 2} x output {24, 64 + 8}; the wide walk's (csrc/wide_walk.cuh),
# {bf16, TF32} x the walk; and its weight packing, {bf16, TF32}
INSTANTIATIONS = 32 + 4 + 2
KERNELS = {"encode_view_kernel": "", "encode_wide_kernel": "wide ", "pack_units": "pack "}


def ptxas() -> dict:
    """ptxas' registers and spills of each kernel, by its template arguments:
    "TF32,CS,MULTI,DC,EC,ET" for the shipped instantiations (TF32 1 for the
    fp32 state; the code's k16 steps; MULTI 1 for the multi-tile walk;
    hidden chunks of 64; output chunks of 64; output tail), "wide TF32,MULTI"
    for the wide walk, "pack TF32,0" for its weight packing."""
    build.load("encode_view")
    report = {}
    for name, r in build.ptxas_report(build.build_log("encode_view")).items():
        for kernel, tag in KERNELS.items():
            if kernel in name:
                report[tag + ",".join(re.findall(r"Li(\d+)E", name.split(kernel)[-1]))] = r
    return report


def spilled(report: dict) -> bool:
    """Whether an instantiation is missing or any spilled."""
    return len(report) != INSTANTIATIONS or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                                                for r in report.values())


def against_parent(source: str, gen: torch.Generator, passes: int = 2) -> dict:
    """The parent's ptxas lines against the port's build's, then the serving
    and stage-2 shapes timed with the parent's build and the port's in turns
    (parent, port, port, parent, ...), each entry behind the same Python
    call: {"ptxas": ..., "ms": [{build: {shape: ms}} a pass]}."""
    from pathlib import Path

    from scenedino_torch.tools.bench_attention_bwd import compile_source
    from scenedino_torch.tools.bench_point_render import compare_ptxas, through

    lib, log = compile_source(Path(source).resolve())
    port = build.load("encode_view")
    report = compare_ptxas(log, build.build_log("encode_view"))
    port_fn, parent_fn = port.encode_view, lib.encode_view
    port_fn.argtypes, port_fn.restype = ARGTYPES, ctypes.c_int
    parent_fn.argtypes, parent_fn.restype = ARGTYPES, ctypes.c_int
    builds = {"parent": through(parent_fn, parent=True), "port": through(port_fn)}
    inputs = {}
    for shape in SHAPES[:2]:
        fs = seeded_state(gen, shape)
        inputs[shape.path] = encode_view_inputs(fs, FieldConfig(), shape.height, shape.width, generator=gen,
                                                n_coarse=shape.samples)
    saved = build._functions.get(("encode_view", "encode_view"))
    times = []
    try:
        for p in range(passes):
            order = ("parent", "port") if p % 2 == 0 else ("port", "parent")
            row = {}
            for name in order:
                build._functions["encode_view", "encode_view"] = builds[name]
                row[name] = {path: time_ms(lambda: encode_view(*a, c), reps=10) for path, (a, c) in inputs.items()}
            times.append(row)
    finally:
        build._functions["encode_view", "encode_view"] = saved
    return {"ptxas": report, "ms": times}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", help="a source from before the depth rounding, timed against the port's build")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.parent:
        print(card_line(), flush=True)
        print(f"encode_view against the parent: "
              f"{json.dumps(against_parent(args.parent, torch.Generator(device='cuda').manual_seed(args.seed)))}",
              flush=True)
        print(card_line(), flush=True)
        return 0
    report = ptxas()
    print(f"encode_view ptxas: {report}", flush=True)
    ok = not spilled(report)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for shape in SHAPES:
        res = check(gen, shape)
        print(f"encode_view {res}", flush=True)
        ok = ok and res["ok"]
    print(f"encode_view render stage: {json.dumps(render_stage(gen, SHAPES[0]))}", flush=True)
    print(card_line(), flush=True)
    print(f"correct={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
