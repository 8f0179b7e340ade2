"""Check and time the K1 attention kernels at the shapes of the main
paths: the backward pair, and the forward, each in several builds side by
side on one card.

    python -m scenedino_torch.tools.bench_attention_bwd --check
    python -m scenedino_torch.tools.bench_attention_bwd --variants 2,3,1/2,3,1 1,2,2/1,2,2
    python -m scenedino_torch.tools.bench_attention_bwd --other old/attention_bwd.cu
    python -m scenedino_torch.tools.bench_attention_bwd --fwd-check
    python -m scenedino_torch.tools.bench_attention_bwd --fwd-variants 3,3,1 3,2,1 2,3,1 --fwd-other old/attention.cu
    python -m scenedino_torch.tools.bench_attention_bwd --forward
    python -m scenedino_torch.tools.bench_attention_bwd --wgmma-rate

`--check` builds `csrc/attention_bwd.cu` as the port loads it, prints what
ptxas said of its kernels and holds dq, di, dk, dv against the plain
backward at the training shape (4, 1921, 12, 64) and at ragged token
counts. A variant `a,b,c/d,e,f` rebuilds the source with dq's and dkv's
warpgroups per block, ring slots and blocks per SM set so (the BWD_*
macros); `--other` adds another source with the same C interface (say an
earlier revision's). Builds are timed in turns, first to last and back
again, and each pass is printed, beside one
`scaled_dot_product_attention` backward.
`--fwd-check` does the same for `csrc/attention.cu`: ptxas, then the
output and the log-sum-exp against `attention_plain` and
`attention_lse_plain` at the three shapes the paths give the forward
(serving (1, 1921, 12, 64); the training step's student (4, ...) with the
log-sum-exp and teacher (8, ...) without) and at ragged token counts, and
two launches bitwise equal. A forward variant `a,b,c` rebuilds it with
warpgroups per block, ring slots and blocks per SM (the FWD_* macros);
`--fwd-other` adds another
forward source with the same C interface. Forward builds are timed in
turns at the three shapes beside `scaled_dot_product_attention`.
`--forward` times the port's forward kernel at the three shapes beside
`scaled_dot_product_attention`.
`--wgmma-rate` measures what the kernels' one instruction, wgmma
m64n64k16 with A in registers, reaches on an SM when nothing else runs: 1
to 3 warpgroups start batches of 8 (two accumulators, k-steps alternating,
as the kernels' first products) and wait for each batch, or keep one batch
in flight; cycles per instruction by `clock64`.
Every time is the median CUDA-event time of `utils.timing.time_ms` on the
card that the first line names.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import (
    attention_bwd_plain,
    attention_fwd,
    attention_lse_plain,
    attention_plain,
)
from scenedino_torch.utils.timing import card_line, time_ms

TRAIN_SHAPE = (4, 1921, 12, 64)
# the forward's shapes on the paths: serving, the student (with the
# log-sum-exp), the teacher
FWD_SHAPES = (((1, 1921, 12, 64), False), ((4, 1921, 12, 64), True), ((8, 1921, 12, 64), False))
K1_BWD_REL = 2e-2  # chip_smoke.py's bound: this share of the largest |plain| value plus 1e-3
K1_TOL = 2e-2  # chip_smoke.py's bounds of the forward's output and log-sum-exp
LSE_TOL = 1e-3
MACROS = ("BWD_DQ_WGS", "BWD_DQ_STAGES", "BWD_DQ_BLOCKS", "BWD_DKV_WGS", "BWD_DKV_STAGES", "BWD_DKV_BLOCKS")
FWD_MACROS = ("FWD_WGS", "FWD_STAGES", "FWD_BLOCKS")


def compile_sources(jobs: Sequence[Tuple[Path, Optional[Dict[str, int]]]]) -> List[Tuple[ctypes.CDLL, str]]:
    """nvcc each (source, defines) of `jobs` with the port's flags and `-D`
    for each define into `build/kernels/`, all at once; returns each loaded
    library and nvcc's output, in order."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, defines in jobs:
        flags = [*build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in (defines or {}).items())]
        tag = hashlib.sha1((" ".join(flags) + str(source)).encode() + source.read_bytes()).hexdigest()[:12]
        out = build.BUILD_DIR / f"libbench-{source.stem}-{tag}.so"
        cmd = [build.nvcc_path(), *flags, "-o", str(out), str(source)]
        procs.append((source, defines, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                             text=True)))
    done = []
    for source, defines, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {defines}:\n{log}")
        done.append((ctypes.CDLL(str(out)), log))
    return done


def compile_source(source: Path, defines: Optional[Dict[str, int]] = None) -> Tuple[ctypes.CDLL, str]:
    """`compile_sources` of one source."""
    return compile_sources([(source, defines)])[0]


class Backward:
    """The two C functions of one build, called as the port's wrappers call them."""

    def __init__(self, lib: ctypes.CDLL):
        self.fns = {}
        for name in ("attention_bwd_dq", "attention_bwd_dkv"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.fns[name] = fn

    def _call(self, name, tensors, shape):
        B, N, H, D = shape
        err = self.fns[name](*(t.data_ptr() for t in tensors), B, N, H, D, D ** -0.5,
                             torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")

    def dq(self, q, k, v, o, do, lse):
        B, N, H, _ = q.shape
        dq, di = torch.empty_like(q), torch.empty(B, H, N, device=q.device, dtype=torch.float32)
        self._call("attention_bwd_dq", (q, k, v, o, do, lse, dq, di), q.shape)
        return dq, di

    def dkv(self, q, k, v, do, lse, di):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._call("attention_bwd_dkv", (q, k, v, do, lse, di, dk, dv), q.shape)
        return dk, dv


class Forward:
    """The forward's C function of one build, called as the port's wrapper calls it."""

    def __init__(self, lib: ctypes.CDLL):
        self.fn = lib.attention_fwd
        self.fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, q, k, v, with_lse=False):
        B, N, H, D = q.shape
        out = torch.empty_like(q)
        lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32) if with_lse else None
        err = self.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
                      B, N, H, D, D ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
        return out, lse


def qkv(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))


def check_forward(fwd: Forward, shape, with_lse=True, seed=0) -> bool:
    """The output and (with_lse) the log-sum-exp of `fwd` against the plain versions at `shape`."""
    q, k, v = qkv(shape, seed)
    out, lse = fwd(q, k, v, with_lse)
    torch.cuda.synchronize()
    err = (out.float() - attention_plain(q, k, v).float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= K1_TOL
    text = f"out {err:.3e} (bound {K1_TOL})"
    if with_lse:
        lse_err = (lse - attention_lse_plain(q, k)).abs().max().item()
        ok = ok and lse_err <= LSE_TOL
        text += f", lse {lse_err:.3e} (bound {LSE_TOL})"
    print(f"forward check {tuple(shape)}: max abs err {text}{'' if ok else ', FAIL'}", flush=True)
    return ok


def print_warnings(log: str) -> None:
    """nvcc's warnings, among them ptxas' notes on serialized wgmma (C75xx)."""
    for line in log.splitlines():
        if "warning" in line.lower() or "C75" in line:
            print(f"nvcc: {line}", flush=True)


def forward_lines(log: str) -> str:
    return json.dumps({name: r for name, r in build.ptxas_report(log).items() if "attention_fwd" in name})


def parse_fwd_variant(text: str) -> Dict[str, int]:
    values = [int(x) for x in text.split(",")]
    if len(values) != len(FWD_MACROS):
        raise ValueError(f"a forward variant is a,b,c, got {text!r}")
    return dict(zip(FWD_MACROS, values))


def forward_flops(shape) -> float:
    B, N, H, D = shape
    return 4.0 * B * H * N * N * D


def time_sdpa(q, k, v) -> float:
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=5)


def inputs(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    o, lse = attention_fwd(q, k, v, with_lse=True)
    return q, k, v, o, do, lse


def check(bwd: Backward, shape, seed=0) -> bool:
    """dq, di, dk, dv of `bwd` against the plain backward at `shape`; prints the errors."""
    q, k, v, o, do, lse = inputs(shape, seed)
    dq, di = bwd.dq(q, k, v, o, do, lse)
    dk, dv = bwd.dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    ref = attention_bwd_plain(q, k, v, o, do, lse)
    di_ref = (do.float() * o.float()).sum(-1).transpose(1, 2)
    ok, parts = True, [f"di {(di - di_ref).abs().max().item():.3e}"]
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err = (got.float() - r.float()).abs().max().item()
        bound = K1_BWD_REL * r.float().abs().max().item() + 1e-3
        good = bool(torch.isfinite(got).all()) and err <= bound
        ok = ok and good
        parts.append(f"{name} {err:.3e} (bound {bound:.3e}{'' if good else ', FAIL'})")
    print(f"check {tuple(shape)}: max abs err " + ", ".join(parts), flush=True)
    return ok


def kernel_lines(log: str) -> str:
    report = build.ptxas_report(log)
    return json.dumps({("dq" if "bwd_dq" in name else "dkv"): r for name, r in report.items() if "attention_bwd" in name})


def parse_variant(text: str) -> Dict[str, int]:
    values = [int(x) for part in text.split("/") for x in part.split(",")]
    if len(values) != len(MACROS):
        raise ValueError(f"a variant is a,b,c/d,e,f, got {text!r}")
    return dict(zip(MACROS, values))


def time_sdpa_backward(q, k, v, do) -> float:
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), inner=5)


WGMMA_RATE_SOURCE = r"""
#include "hopper.cuh"
using namespace hopper;
// blockIdx.y: 0 waits for each batch of 8, 1 keeps one batch in flight
template <int TransB>
__global__ void __launch_bounds__(384) rate(unsigned long long* out, int iters, int wgs) {
  __shared__ alignas(1024) unsigned char tile[2][TILE_BYTES];
  for (int i = threadIdx.x; i < 2 * TILE_BYTES / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(tile)[i] = 0;
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg >= wgs) return;
  float acc0[32], acc1[32];
  uint32_t a[16];
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  for (int i = 0; i < 16; ++i) a[i] = 0;
  fence_registers(acc0);
  fence_registers(acc1);
  const uint64_t d0 = wgmma_desc(tile[0]), d1 = wgmma_desc(tile[1]);
  const uint64_t step = TransB ? WGMMA_MN_STEP : WGMMA_K_STEP;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs<TransB>(acc0, &a[4 * kk], d0 + kk * step, 1);
      wgmma_m64n64k16_rs<TransB>(acc1, &a[4 * kk], d1 + kk * step, 1);
    }
    wgmma_commit();
    if (blockIdx.y == 0) wgmma_wait<0>(); else wgmma_wait<1>();
  }
  wgmma_wait<0>();
  const long long t1 = clock64();
  fence_registers(acc0);
  fence_registers(acc1);
  if (threadIdx.x % 128 == 0) out[(blockIdx.y * gridDim.x + blockIdx.x) * 3 + wg] = (t1 - t0) + (acc0[0] + acc1[0] != 0.f);
}
extern "C" int wgmma_rate(unsigned long long* out, int blocks, int iters, int wgs, int trans_b) {
  if (trans_b) rate<1><<<dim3(blocks, 2), 384>>>(out, iters, wgs);
  else rate<0><<<dim3(blocks, 2), 384>>>(out, iters, wgs);
  return (int)cudaGetLastError();
}
"""


def wgmma_rate():
    """Cycles per wgmma m64n64k16 (A in registers) on an SM by itself."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = build.BUILD_DIR / "wgmma_rate.cu"
    source.write_text(WGMMA_RATE_SOURCE.replace('"hopper.cuh"', f'"{build.CSRC / "hopper.cuh"}"'))
    lib, _ = compile_source(source)
    lib.wgmma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.wgmma_rate.restype = ctypes.c_int
    blocks, iters = torch.cuda.get_device_properties(0).multi_processor_count, 2000
    for trans_b in (0, 1):
        for wgs in (1, 2, 3):
            out = torch.zeros(2, blocks, 3, dtype=torch.int64, device="cuda")
            err = lib.wgmma_rate(out.data_ptr(), blocks, iters, wgs, trans_b)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"wgmma_rate launch failed: cudaError {err}")
            cycles = out[:, :, :wgs].max(-1).values.double().median(-1).values / (iters * 8 * wgs)
            print(f"wgmma m64n64k16, A in registers, B {'MN' if trans_b else 'K'}-major, {wgs} warpgroup(s) an SM: "
                  f"{cycles[0].item():.1f} cycles an instruction waiting for each batch of 8, "
                  f"{cycles[1].item():.1f} with one batch in flight (131,072 FLOP each; at the card's 989 TFLOP/s "
                  f"and 1.98 GHz an SM does one in {131072 / (989e12 / blocks / 1.98e9):.1f})", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--variants", nargs="*", default=[])
    parser.add_argument("--other", nargs="*", default=[], type=Path)
    parser.add_argument("--fwd-check", action="store_true")
    parser.add_argument("--fwd-variants", nargs="*", default=[])
    parser.add_argument("--fwd-other", nargs="*", default=[], type=Path)
    parser.add_argument("--forward", action="store_true")
    parser.add_argument("--wgmma-rate", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_bwd needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}; {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    source = build.CSRC / "attention_bwd.cu"
    ok = True

    if args.check:
        lib, log = compile_source(source)
        print(f"ptxas: {kernel_lines(log)}", flush=True)
        print_warnings(log)
        bwd = Backward(lib)
        shapes = [TRAIN_SHAPE, (1, 1921, 12, 64)] + [(2, n, 3, 64) for n in (1, 63, 64, 65, 128, 129, 200)]
        for shape in shapes:
            ok = check(bwd, shape, args.seed) and ok
        q, k, v, o, do, lse = inputs(TRAIN_SHAPE, args.seed)
        first = bwd.dq(q, k, v, o, do, lse)
        again = bwd.dq(q, k, v, o, do, lse)
        same = all(torch.equal(a, b) for a, b in zip(first + bwd.dkv(q, k, v, do, lse, first[1]),
                                                     again + bwd.dkv(q, k, v, do, lse, again[1])))
        print(f"two launches bitwise equal: {same}", flush=True)
        ok = ok and same

    jobs = [(source, parse_variant(text)) for text in args.variants] + [(p, None) for p in args.other]
    names = list(args.variants) + [str(p) for p in args.other]
    builds = [(name, Backward(lib), log) for name, (lib, log) in zip(names, compile_sources(jobs))]
    if builds:
        q, k, v, o, do, lse = inputs(TRAIN_SHAPE, args.seed)
        unit = 2.0 * q.shape[0] * q.shape[2] * q.shape[1] ** 2 * q.shape[3]
        for name, bwd, log in builds:
            print(f"build {name}: ptxas {kernel_lines(log)}", flush=True)
            ok = check(bwd, TRAIN_SHAPE, args.seed) and ok
        for turn, order in enumerate((builds, builds[::-1])):
            for name, bwd, _ in order:
                _, di = bwd.dq(q, k, v, o, do, lse)
                ms_dq = time_ms(lambda: bwd.dq(q, k, v, o, do, lse), inner=5)
                ms_dkv = time_ms(lambda: bwd.dkv(q, k, v, do, lse, di), inner=5)
                print(f"pass {turn + 1} {name}: dq {ms_dq:.4f} ms ({3 * unit / ms_dq / 1e9:.1f} TFLOP/s), dkv "
                      f"{ms_dkv:.4f} ms ({4 * unit / ms_dkv / 1e9:.1f} TFLOP/s), together {ms_dq + ms_dkv:.4f} ms",
                      flush=True)
        print(f"scaled_dot_product_attention backward: {time_sdpa_backward(q, k, v, do):.4f} ms", flush=True)

    fwd_source = build.CSRC / "attention.cu"
    if args.fwd_check:
        lib, log = compile_source(fwd_source)
        print(f"forward ptxas: {forward_lines(log)}", flush=True)
        print_warnings(log)
        fwd = Forward(lib)
        for shape, with_lse in FWD_SHAPES:
            ok = check_forward(fwd, shape, with_lse, args.seed) and ok
        for n in (1, 63, 64, 65, 128, 129, 191, 192, 193, 200, 385):
            ok = check_forward(fwd, (2, n, 3, 64), True, args.seed + n) and ok
        q, k, v = qkv(FWD_SHAPES[1][0], args.seed)
        first, again = fwd(q, k, v, True), fwd(q, k, v, True)
        same = all(torch.equal(a, b) for a, b in zip(first, again)) and torch.equal(first[0], fwd(q, k, v)[0])
        print(f"forward: two launches bitwise equal, and the output the same without the lse: {same}", flush=True)
        ok = ok and same

    jobs = [(fwd_source, parse_fwd_variant(text)) for text in args.fwd_variants] + [(p, None) for p in args.fwd_other]
    names = list(args.fwd_variants) + [str(p) for p in args.fwd_other]
    fwd_builds = [(name, Forward(lib), log) for name, (lib, log) in zip(names, compile_sources(jobs))]
    if fwd_builds:
        for name, fwd, log in fwd_builds:
            print(f"forward build {name}: ptxas {forward_lines(log)}", flush=True)
            print_warnings(log)
            for shape, with_lse in FWD_SHAPES:
                ok = check_forward(fwd, shape, with_lse, args.seed) and ok
        for shape, with_lse in FWD_SHAPES:
            q, k, v = qkv(shape, args.seed)
            for turn, order in enumerate((fwd_builds, fwd_builds[::-1])):
                for name, fwd, _ in order:
                    ms = time_ms(lambda: fwd(q, k, v, with_lse), inner=5)
                    print(f"pass {turn + 1} forward {tuple(shape)}{' with lse' if with_lse else ''} {name}: "
                          f"{ms:.4f} ms ({forward_flops(shape) / ms / 1e9:.1f} TFLOP/s)", flush=True)
            lib_ms = time_sdpa(q, k, v)
            print(f"scaled_dot_product_attention {tuple(shape)}: {lib_ms:.4f} ms "
                  f"({forward_flops(shape) / lib_ms / 1e9:.1f} TFLOP/s)", flush=True)

    if args.forward:
        for shape, with_lse in FWD_SHAPES:
            q, k, v = qkv(shape, args.seed)
            ms = time_ms(lambda: attention_fwd(q, k, v, with_lse=with_lse), inner=5)
            lib_ms = time_sdpa(q, k, v)
            print(f"forward {tuple(shape)} bf16{' with lse' if with_lse else ''}: kernel {ms:.4f} ms "
                  f"({forward_flops(shape) / ms / 1e9:.1f} TFLOP/s), scaled_dot_product_attention {lib_ms:.4f} ms "
                  f"({forward_flops(shape) / lib_ms / 1e9:.1f} TFLOP/s)", flush=True)
    if args.wgmma_rate:
        wgmma_rate()
    if not ok:
        raise SystemExit("bench_attention_bwd: a build disagrees with the plain version")


if __name__ == "__main__":
    main()
