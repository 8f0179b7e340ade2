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
    python -m scenedino_torch.tools.bench_attention_bwd --head-dim 80 --check --variants 2,3,1/2,3,1,32 \
        --other old/attention_d80_bwd.cu
    python -m scenedino_torch.tools.bench_attention_bwd --head-dim 80 --fwd-check --fwd-variants 3,3,1 1,3,2 \
        --fwd-other old/attention_d80.cu
    python -m scenedino_torch.tools.bench_attention_bwd --head-dim 32 --probe --check --fwd-check \
        --other scenedino_torch/csrc/attention_any.cu old/attention_any.cu \
        --fwd-other scenedino_torch/csrc/attention_any.cu scenedino_torch/csrc/attention_any.cu old/attention_any.cu

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
forward source with the same C interface. Forward builds are checked,
compared bit for bit with the first of them, and timed in turns at the
forward's shapes beside `scaled_dot_product_attention` (CUDA events, and
the kernels' device time from the profiler over 20 calls; SDPA's device
time in each pass too).
`--forward` times the port's forward kernel at the forward's shapes beside
`scaled_dot_product_attention`, CUDA events and device time.
`--wgmma-rate` measures what the kernels' one instruction, wgmma
m64n64k16 with A in registers, reaches on an SM when nothing else runs: 1
to 3 warpgroups start batches of 8 (two accumulators, k-steps alternating,
as the kernels' first products) and wait for each batch, or keep one batch
in flight; cycles per instruction by `clock64`.
`--head-dim 80` does the same for the D = 80 kernels,
`csrc/attention_d80_bwd.cu` and `csrc/attention_d80.cu`: `--probe` (also
the first step of `--check` and `--fwd-check`)
runs one wgmma on a 16-column side tile, K-major (m64n64k16 and m64n32k16,
a k-step over its 16 columns) and MN-major (m64n16k16 over its rows, 512
bytes a k-step), loaded by TMA as the kernels load it, against
`torch.matmul` of the same values; `--check` prints ptxas' registers and
spills per kernel with the setmaxnreg split and holds dq, di, dk, dv
against the plain backward at the four D = 80 shapes of `chip_smoke.py`
and at ragged token counts around the tile edges; a variant is
`a,b,c/d,e,f,g` (the BWD80_* macros: dkv's g is the rows of its walked
query tile, 32 or 64); builds and `--other` sources (say an earlier
revision's `attention_d80.cu` with its mma.sync dq and dkv, which has the
same C functions) are timed in turns at the four shapes beside one
`scaled_dot_product_attention` backward; builds of the backward are also
compared bit for bit with the first of them. The forward's options check
`attention_d80.cu` at the four shapes (the student's (2, 1921, 12, 80) with
the log-sum-exp), at ragged token counts and with keys that drift along the
walk (the lazy rescale's jump); its variant is `a,b,c` (the FWD80_*
macros) or `a,b,c/d,e,f` (also FWD80_SMALL_*, the small grids' build), and
`--fwd-other` takes, say, an earlier revision's mma.sync `attention_d80.cu`.
`--head-dim D` at any other multiple of 8 up to 256 works on
`csrc/attention_any.cu`: `--probe` (also the first step of `--check` and
`--fwd-check`) runs one TMA load of a 64-column box over tensors whose inner
dimension is 8 to 56 with a second head beside each row in memory, and
checks that the tile holds the head's columns and zeros past them and that
a TMA store of it writes nothing past D; `--check` and `--fwd-check` print
ptxas' registers and spills by kernel and k-steps and hold the kernels
against the plain versions at `chip_smoke.py` phase 18c's four shapes (head
dims 32, 96, 128, 256) and at ragged token counts at D; the source has no
build macros, so `--other` / `--fwd-other` take the builds to time: the
port's `csrc/attention_any.cu` (twice for two identical builds, built once),
say the parent's `attention_any.cu` (put beside its `hopper.cuh`); builds are
compared bit for bit at the head-dim-32 shape and timed in turns at the
four shapes beside SDPA's forward or backward.
Every time is the median CUDA-event time of `utils.timing.time_ms` on the
card that the first line names; forward builds, and backward builds at the
other head dims, also print the kernels' device time
(`utils.timing.device_ms`), and SDPA's beside them.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
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
from scenedino_torch.utils.timing import card_line, device_ms, ms_text, time_ms

TRAIN_SHAPE = (4, 1921, 12, 64)
# the D = 80 backward's shapes on the paths (chip_smoke.py phase 11a):
# I-JEPA-H/14 at 192x640, four of it, the D = 80 training step's teacher and student
D80_SHAPES = ((1, 585, 16, 80), (4, 585, 16, 80), (4, 1921, 12, 80), (2, 1921, 12, 80))
D80_RAGGED = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 200)
# the forward's shapes on the paths: serving, the student (with the
# log-sum-exp), the teacher
FWD_SHAPES = (((1, 1921, 12, 64), False), ((4, 1921, 12, 64), True), ((8, 1921, 12, 64), False))
# at D = 80: an I-JEPA-H/14 image, four, the D = 80 step's teacher, its student (with the log-sum-exp)
FWD80_SHAPES = tuple((shape, shape == D80_SHAPES[-1]) for shape in D80_SHAPES)
K1_BWD_REL = 2e-2  # chip_smoke.py's bound: this share of the largest |plain| value plus 1e-3
K1_TOL = 2e-2  # chip_smoke.py's bounds of the forward's output and log-sum-exp
LSE_TOL = 1e-3
MACROS = ("BWD_DQ_WGS", "BWD_DQ_STAGES", "BWD_DQ_BLOCKS", "BWD_DKV_WGS", "BWD_DKV_STAGES", "BWD_DKV_BLOCKS")
FWD_MACROS = ("FWD_WGS", "FWD_STAGES", "FWD_BLOCKS")
FWD80_MACROS = ("FWD80_WGS", "FWD80_STAGES", "FWD80_BLOCKS", "FWD80_SMALL_WGS", "FWD80_SMALL_STAGES",
                "FWD80_SMALL_BLOCKS")
MACROS80 = ("BWD80_DQ_WGS", "BWD80_DQ_STAGES", "BWD80_DQ_BLOCKS", "BWD80_DKV_WGS", "BWD80_DKV_STAGES",
            "BWD80_DKV_BLOCKS", "BWD80_DKV_QT")
# every other head dim (csrc/attention_any.cu): chip_smoke.py phase 18c's shapes (the
# smoke recipe's ViT at 192x640, head dim 32; 96, 128 and the widest, 256), the
# forward of the first with the log-sum-exp as its training step runs it
ANY_SHAPES = ((2, 1921, 2, 32), (2, 1921, 4, 96), (2, 1921, 6, 128), (2, 1921, 2, 256))
ANY_RAGGED = (1, 63, 64, 65, 127, 128, 129, 200)


class HeadDim:
    """What the tool does at one head dim: the backward's source, its C
    functions, its macros, the shapes it is checked and timed at; the same
    for the forward."""

    def __init__(self, head_dim: int):
        self.head_dim = head_dim
        if head_dim == 64:
            self.source = build.CSRC / "attention_bwd.cu"
            self.names = ("attention_bwd_dq", "attention_bwd_dkv")
            self.macros = MACROS
            self.time_shapes = (TRAIN_SHAPE,)
            self.check_shapes = [TRAIN_SHAPE, (1, 1921, 12, 64)] + [(2, n, 3, 64) for n in (1, 63, 64, 65, 128, 129,
                                                                                              200)]
            self.fwd_source = build.CSRC / "attention.cu"
            self.fwd_name = "attention_fwd"
            self.fwd_macros = FWD_MACROS
            self.fwd_shapes = FWD_SHAPES
            self.fwd_ragged = [(2, n, 3, 64) for n in (1, 63, 64, 65, 128, 129, 191, 192, 193, 200, 385)]
        elif head_dim == 80:
            self.source = build.CSRC / "attention_d80_bwd.cu"
            self.names = ("attention_d80_bwd_dq", "attention_d80_bwd_dkv")
            self.macros = MACROS80
            self.time_shapes = D80_SHAPES
            self.check_shapes = list(D80_SHAPES) + [(2, n, 3, 80) for n in D80_RAGGED]
            self.fwd_source = build.CSRC / "attention_d80.cu"
            self.fwd_name = "attention_d80_fwd"
            self.fwd_macros = FWD80_MACROS
            self.fwd_shapes = FWD80_SHAPES
            self.fwd_ragged = [(2, n, 3, 80) for n in D80_RAGGED + (191, 192, 193, 385)]
        elif 0 < head_dim <= 256 and head_dim % 8 == 0:
            self.source = build.CSRC / "attention_any.cu"
            self.names = ("attention_any_bwd_dq", "attention_any_bwd_dkv")
            self.macros = ()
            self.time_shapes = ANY_SHAPES
            self.check_shapes = list(ANY_SHAPES) + [(2, n, 3, head_dim) for n in ANY_RAGGED]
            self.fwd_source = self.source
            self.fwd_name = "attention_any_fwd"
            self.fwd_macros = ()
            self.fwd_shapes = tuple((shape, shape == ANY_SHAPES[0]) for shape in ANY_SHAPES)
            self.fwd_ragged = [(2, n, 3, head_dim) for n in ANY_RAGGED + (191, 192, 193, 385)]
        else:
            raise ValueError(f"the attention kernels' C functions take head dim 64, 80 or a multiple of 8 up to "
                             f"256, got {head_dim}")
        # the shape builds are compared at bit for bit: the last, or at the other
        # head dims the main path's (phase 18c's training step)
        self.same_shape = self.time_shapes[-1] if head_dim in (64, 80) else self.time_shapes[0]
        self.fwd_same_shape = self.fwd_shapes[-1][0] if head_dim in (64, 80) else self.fwd_shapes[0][0]


def compile_sources(jobs: Sequence[Tuple[Path, Optional[Dict[str, int]]]]) -> List[Tuple[ctypes.CDLL, str]]:
    """nvcc each (source, defines) of `jobs` with the port's flags and `-D`
    for each define into `build/kernels/`, all at once (a job that repeats
    another is built once); returns each loaded library and nvcc's output,
    in order."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    outs = []
    for source, defines in jobs:
        flags = [*build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in (defines or {}).items())]
        tag = hashlib.sha1((" ".join(flags) + str(source)).encode() + source.read_bytes()).hexdigest()[:12]
        out = build.BUILD_DIR / f"libbench-{source.stem}-{tag}.so"
        outs.append(out)
        if out not in procs:
            cmd = [build.nvcc_path(), *flags, "-o", str(out), str(source)]
            procs[out] = (source, defines, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True))
    logs = {}
    for out, (source, defines, proc) in procs.items():
        logs[out], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {defines}:\n{logs[out]}")
    return [(ctypes.CDLL(str(out)), logs[out]) for out in outs]


def compile_source(source: Path, defines: Optional[Dict[str, int]] = None) -> Tuple[ctypes.CDLL, str]:
    """`compile_sources` of one source."""
    return compile_sources([(source, defines)])[0]


class Backward:
    """The two C functions of one build, called as the port's wrappers call them."""

    def __init__(self, lib: ctypes.CDLL, names=("attention_bwd_dq", "attention_bwd_dkv")):
        self.names = names
        self.fns = {}
        for name in names:
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
        self._call(self.names[0], (q, k, v, o, do, lse, dq, di), q.shape)
        return dq, di

    def dkv(self, q, k, v, do, lse, di):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._call(self.names[1], (q, k, v, do, lse, di, dk, dv), q.shape)
        return dk, dv


class Forward:
    """The forward's C function of one build, called as the port's wrapper calls it."""

    def __init__(self, lib: ctypes.CDLL, name: str = "attention_fwd"):
        self.name = name
        self.fn = getattr(lib, name)
        self.fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, q, k, v, with_lse=False):
        B, N, H, D = q.shape
        out = torch.empty_like(q)
        lse = torch.empty(B, H, N, device=q.device, dtype=torch.float32) if with_lse else None
        err = self.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
                      B, N, H, D, D ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        return out, lse


def qkv(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))


def drifting_keys(shape, seed):
    """q, k, v whose keys drift along the walk (12 n / N added to every
    value of key row n): a row's logits move by 12 n / N times its q's value
    sum over sqrt(D), so where that sum is positive the logits of the last
    tiles exceed the first tile's by more than the lazy rescale's
    threshold and the running max moves during the walk, while the weight
    stays spread over the many keys of the last tiles."""
    q, k, v = qkv(shape, seed)
    drift = 12 * torch.arange(shape[1], device="cuda", dtype=torch.float32) / shape[1]
    return q, (k.float() + drift[None, :, None, None]).to(torch.bfloat16), v


def check_forward(fwd: Forward, shape, with_lse=True, seed=0, drift=False) -> bool:
    """The output and (with_lse) the log-sum-exp of `fwd` against the plain
    versions at `shape`; `drift`: keys that drift along the walk (`drifting_keys`)."""
    q, k, v = drifting_keys(shape, seed) if drift else qkv(shape, seed)
    out, lse = fwd(q, k, v, with_lse)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= K1_TOL
    text = f"out {err:.3e} (bound {K1_TOL}; |plain| <= {ref.abs().max().item():.2f})"
    if with_lse:
        lse_err = (lse - attention_lse_plain(q, k)).abs().max().item()
        ok = ok and lse_err <= LSE_TOL
        text += f", lse {lse_err:.3e} (bound {LSE_TOL})"
    print(f"forward check {tuple(shape)}{', keys drifting' if drift else ''}: max abs err {text}"
          f"{'' if ok else ', FAIL'}", flush=True)
    return ok


def print_warnings(log: str) -> None:
    """nvcc's warnings, among them ptxas' notes on serialized wgmma (C75xx);
    of its notes that it injected a warpgroup.arrive (C7519) only their count."""
    injected = 0
    for line in log.splitlines():
        if "C7519" in line:
            injected += 1
        elif "warning" in line.lower() or "C75" in line:
            print(f"nvcc: {line}", flush=True)
    if injected:
        print(f"nvcc: {injected} notes (C7519) of a warpgroup.arrive injected by ptxas", flush=True)


def forward_lines(log: str) -> str:
    return json.dumps(any_report(log) or forward_report(log))


def parse_fwd_variant(text: str, macros: Sequence[str] = FWD_MACROS) -> Dict[str, int]:
    """`a,b,c` sets the first three macros; at D = 80 `a,b,c/d,e,f` also sets
    the small grids' three (else they keep the source's)."""
    if not macros:
        raise ValueError("csrc/attention_any.cu has no build macros: give its builds with --fwd-other")
    values = [int(x) for part in text.split("/") for x in part.split(",")]
    if len(values) not in (3, len(macros)):
        raise ValueError(f"a forward variant sets 3 or {len(macros)} of {', '.join(macros)}, got {text!r}")
    return dict(zip(macros, values))


def forward_flops(shape) -> float:
    B, N, H, D = shape
    return 4.0 * B * H * N * N * D


def time_sdpa(q, k, v) -> float:
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), inner=5)


def rate_text(ms: Optional[float], flops: float) -> str:
    return ms_text(ms) + ("" if ms is None else f" ({flops / ms / 1e9:.1f} TFLOP/s)")


def device_sdpa(q, k, v) -> Optional[float]:
    """`scaled_dot_product_attention`'s kernels' device time (the profiler):
    at a small shape its CUDA-event time is its host's."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), calls=20, tries=6)


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


def register_split(wgs: int, blocks: int) -> Tuple[int, int]:
    """hopper.cuh's Registers<WGS, BLOCKS>: the producer's and each
    consumer's registers a thread after setmaxnreg."""
    start = min(65536 // (blocks * (wgs + 1) * 128), 255) // 8 * 8
    return 24, min(((wgs + 1) * start - 24) // wgs // 8 * 8, 240)


def _with_split(name: str, r: Dict[str, int]) -> Dict[str, int]:
    """A kernel's ptxas report and, where its name carries template arguments
    (warpgroups, ring slots, blocks per SM, ...), those and the setmaxnreg
    split, `producer` and `consumer` registers a thread."""
    args = [int(x) for x in re.findall(r"Li(\d+)E", name)]
    if len(args) < 3:
        return r
    return {**r, **dict(zip(("wgs", "stages", "blocks", "qt"), args)),
            **dict(zip(("producer", "consumer"), register_split(args[0], args[2])))}


def backward_report(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas' registers (at launch) and spills of each backward kernel in
    nvcc's output `log`, by "dq" and "dkv", with the setmaxnreg split
    (`_with_split`)."""
    return {("dq" if "bwd_dq" in name else "dkv"): _with_split(name, r)
            for name, r in build.ptxas_report(log).items() if "bwd" in name}


def forward_report(log: str) -> Dict[str, Dict[str, int]]:
    """The same for each instantiation of the forward kernel, as "fwd" and,
    where its name carries them, its warpgroups, ring slots and blocks per
    SM ("fwd 3,3,1")."""
    out = {}
    for name, r in build.ptxas_report(log).items():
        if "fwd" in name:
            args = re.findall(r"Li(\d+)E", name)[:3]
            out[" ".join(["fwd"] + [",".join(args)] * bool(args))] = _with_split(name, r)
    return out


def any_report(log: str) -> Dict[str, Dict[str, int]]:
    """ptxas' registers (at launch) and spills of each kernel of
    csrc/attention_any.cu in nvcc's output `log`, by kernel and the head-dim
    columns that its k-steps cover, 16 each ("fwd 16", "fwd 32", "fwd 48",
    "fwd 64" at 64 padded columns, "fwd 128", ..., "dkv 256")."""
    out = {}
    for name, r in build.ptxas_report(log).items():
        m = re.search(r"\d(fwd|dq|dkv)_kernelILi\d+ELi(\d+)E", name)
        if m:
            out[f"{m.group(1)} {16 * int(m.group(2))}"] = r
    return out


def kernel_lines(log: str) -> str:
    """The backward kernels' ptxas report, or at every other head dim all of
    csrc/attention_any.cu's kernels'."""
    return json.dumps(any_report(log) or backward_report(log))


def build_names(variants: Sequence[str], others: Sequence[Path]) -> List[str]:
    """The builds' names as printed: each variant, each other source's path,
    a repeat with its count ("... #2")."""
    names = list(variants) + [str(p) for p in others]
    return [f"{n} #{names[:i + 1].count(n)}" if names[:i].count(n) else n for i, n in enumerate(names)]


def parse_variant(text: str, macros: Sequence[str] = MACROS) -> Dict[str, int]:
    if not macros:
        raise ValueError("csrc/attention_any.cu has no build macros: give its builds with --other")
    values = [int(x) for part in text.split("/") for x in part.split(",")]
    if len(values) != len(macros):
        raise ValueError(f"a variant sets {', '.join(macros)}, got {text!r}")
    return dict(zip(macros, values))


def device_sdpa_backward(q, k, v, do) -> Optional[float]:
    """`scaled_dot_product_attention`'s backward kernels' device time (the
    profiler): a small backward's CUDA-event time is the host's autograd."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    return device_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))


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


SIDE_PROBE_SOURCE = r"""
#include "attention_d80_bwd.cu"
// One warpgroup: TMA loads `rows` rows of a (1, rows, 1, 80) tensor as the
// kernels load a walked tile (main and side boxes), then one product on the
// side tile, A (64 x 16 or 64 x rows, row-major bf16) from registers:
//   mode 0, K-major:  out (64 x rows) = A B_side^T, one k-step over its 16 columns;
//   mode 1, MN-major: out (64 x 16) = A B_side, rows / 16 k-steps down its rows.
namespace {
template <int ROWS>
__global__ void __launch_bounds__(128) side_probe_kernel(const __grid_constant__ MapPair map,
                                                         const __nv_bfloat16* a, float* out, int mode) {
  extern __shared__ unsigned char raw[];
  Rows80<ROWS>& tile = aligned_smem<Rows80<ROWS>>(raw);
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&bar, Rows80<ROWS>::BYTES);
    load_rows(tile, map, &bar, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  const int width = mode == 0 ? 16 : ROWS;  // A's columns
  uint32_t ar[4 * (ROWS / 16)];
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = warp * 16 + hi * 8 + lane / 4, c = 16 * kk + 8 * half + (lane % 4) * 2;
        ar[4 * kk + 2 * half + hi] = c < width ? *reinterpret_cast<const uint32_t*>(a + r * width + c) : 0u;
      }
  const uint64_t side = wgmma_desc_b32(tile.side);
  const int r = warp * 16 + lane / 4, c = (lane % 4) * 2;
  if (mode == 0) {
    constexpr int NA = ROWS / 2;
    float d[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) d[i] = 0.f;
    wgmma_fence();
    mma_nt(d, ar, side, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(d);
#pragma unroll
    for (int i = 0; i < NA; ++i) out[(r + 8 * ((i / 2) % 2)) * ROWS + 8 * (i / 4) + c + i % 2] = d[i];
  } else {
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) wgmma_m64n16k16_rs<1>(d, &ar[4 * kk], side + kk * WGMMA_B32_MN_STEP, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(d);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[(r + 8 * ((i / 2) % 2)) * 16 + 8 * (i / 4) + c + i % 2] = d[i];
  }
}
}  // namespace

extern "C" int side_probe(const void* b, const void* a, float* out, int rows, int mode) {
  hopper::MapPair map;
  const int bad = hopper::encode_pair(&map, b, 1, rows, 1, rows);
  if (bad) return bad;
  const __nv_bfloat16* a16 = (const __nv_bfloat16*)a;
  if (rows == 64) side_probe_kernel<64><<<1, 128, sizeof(hopper::Rows80<64>) + 1024>>>(map, a16, out, mode);
  else if (rows == 32) side_probe_kernel<32><<<1, 128, sizeof(hopper::Rows80<32>) + 1024>>>(map, a16, out, mode);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""


def side_probe(seed: int = 0) -> bool:
    """One wgmma on a side tile of 64 and of 32 rows, each operand order,
    against torch.matmul of the same bf16 values (fp32 sums of at most 64
    products: the bound 1e-3 is far above their rounding)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = build.BUILD_DIR / "side_probe.cu"
    source.write_text(SIDE_PROBE_SOURCE.replace('"attention_d80_bwd.cu"', f'"{build.CSRC / "attention_d80_bwd.cu"}"'))
    lib, _ = compile_source(source)
    lib.side_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.side_probe.restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(seed)
    ok = True
    for mode, rows in ((0, 64), (0, 32), (1, 64), (1, 32)):
        b = torch.randn(1, rows, 1, 80, generator=g, device="cuda").to(torch.bfloat16)
        a = torch.randn(64, 16 if mode == 0 else rows, generator=g, device="cuda").to(torch.bfloat16)
        out = torch.zeros(64, rows if mode == 0 else 16, device="cuda")
        err = lib.side_probe(b.data_ptr(), a.data_ptr(), out.data_ptr(), rows, mode)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"side_probe launch failed: cudaError {err}")
        side = b[0, :, 0, 64:].float()
        ref = a.float() @ (side.T if mode == 0 else side)
        diff = (out - ref).abs().max().item()
        good = diff <= 1e-3
        ok = ok and good
        print(f"side-tile probe, {'K' if mode == 0 else 'MN'}-major B of {rows} rows "
              f"({'m64n%dk16, one k-step' % rows if mode == 0 else 'm64n16k16, %d k-steps' % (rows // 16)}): "
              f"max abs err {diff:.3e} against torch.matmul{'' if good else ', FAIL'}", flush=True)
    return ok


ZERO_FILL_SOURCE = r"""
#include "hopper.cuh"
using namespace hopper;
// One block: TMA loads the 64-row, 64-column box at (0, head 0, row 0) of a
// (1, 64, 2, D) bf16 tensor into a swizzled tile, as csrc/attention_any.cu
// loads a tile of a row of D < 64 columns; copies the tile out unswizzled
// (64 x 64); then stores the tile through the same box of a second tensor.
__global__ void __launch_bounds__(128) zero_fill_kernel(const __grid_constant__ CUtensorMap in,
                                                        const __grid_constant__ CUtensorMap out,
                                                        __nv_bfloat16* tile_out) {
  __shared__ alignas(1024) unsigned char tile[TILE_BYTES];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, TILE_BYTES);
    tma_load_4d(tile, &in, &bar, 0, 0, 0, 0);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int r = i / TILE, c = i % TILE;
    tile_out[i] = *reinterpret_cast<const __nv_bfloat16*>(tile + swizzled_offset(r, c & ~7) + (c & 7) * 2);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store_4d(&out, tile, 0, 0, 0, 0);
    tma_store_commit();
    tma_store_wait_read();
  }
}
extern "C" int zero_fill(const void* in, void* out, void* tile_out, int D) {
  CUtensorMap a, b;
  int bad = encode_head_box_map(&a, in, 1, TILE, 2, D, TILE, TILE, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!bad) bad = encode_head_box_map(&b, out, 1, TILE, 2, D, TILE, TILE, CU_TENSOR_MAP_SWIZZLE_128B);
  if (bad) return bad;
  zero_fill_kernel<<<1, 128>>>(a, b, (__nv_bfloat16*)tile_out);
  return (int)cudaGetLastError();
}
"""


def zero_fill_probe(seed: int = 0) -> bool:
    """One TMA load of a 64-column box over a tensor whose inner dimension is
    D < 64 (32, and 8, 16, 24, 56), with a second head beside it in memory:
    the tile holds the head's D columns and zeros past them (not the next
    head's values), the barrier sees the whole box's bytes, and a TMA store of
    the tile writes the D columns and nothing past them."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = build.BUILD_DIR / "zero_fill_probe.cu"
    source.write_text(ZERO_FILL_SOURCE.replace('"hopper.cuh"', f'"{build.CSRC / "hopper.cuh"}"'))
    lib, _ = compile_source(source)
    lib.zero_fill.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.zero_fill.restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(seed)
    ok = True
    for D in (32, 8, 16, 24, 56):
        x = torch.randn(1, 64, 2, D, generator=g, device="cuda").to(torch.bfloat16)
        out = torch.full_like(x, 7.0)
        tile = torch.full((64, 64), 3.0, device="cuda", dtype=torch.bfloat16)
        err = lib.zero_fill(x.data_ptr(), out.data_ptr(), tile.data_ptr(), D)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"zero_fill launch failed: cudaError {err}")
        loaded = torch.equal(tile[:, :D], x[0, :, 0])
        zeros = bool((tile[:, D:] == 0).all())
        stored = torch.equal(out[0, :, 0], x[0, :, 0]) and bool((out[0, :, 1] == 7.0).all())
        good = loaded and zeros and stored
        ok = ok and good
        print(f"zero-fill probe, a 64-column box over D = {D}: the head's columns loaded {loaded}, columns past D "
              f"zero {zeros}, the store writes the D columns and nothing past them {stored}"
              f"{'' if good else ', FAIL'}", flush=True)
    return ok


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
    parser.add_argument("--head-dim", type=int, default=64,
                        help="the kernels that the backward's and the forward's options work on: 64, 80, or any "
                             "other multiple of 8 up to 256 (csrc/attention_any.cu, checked at that head dim and "
                             "timed at chip_smoke.py phase 18c's shapes)")
    parser.add_argument("--probe", action="store_true",
                        help="the side-tile descriptor probe (D = 80), the zero-fill probe (any other head dim)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_bwd needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}; {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    hd = HeadDim(args.head_dim)
    ok = True

    if args.probe or (hd.head_dim == 80 and (args.check or args.fwd_check)):
        ok = (side_probe() if hd.head_dim == 80 else zero_fill_probe()) and ok
    elif hd.head_dim not in (64, 80) and (args.check or args.fwd_check):
        ok = zero_fill_probe() and ok
    if args.check:
        lib, log = compile_source(hd.source)
        print(f"ptxas: {kernel_lines(log)}", flush=True)
        print_warnings(log)
        bwd = Backward(lib, hd.names)
        for shape in hd.check_shapes:
            ok = check(bwd, shape, args.seed) and ok
        q, k, v, o, do, lse = inputs(hd.same_shape, args.seed)
        first = bwd.dq(q, k, v, o, do, lse)
        again = bwd.dq(q, k, v, o, do, lse)
        same = all(torch.equal(a, b) for a, b in zip(first + bwd.dkv(q, k, v, do, lse, first[1]),
                                                     again + bwd.dkv(q, k, v, do, lse, again[1])))
        print(f"two launches bitwise equal: {same}", flush=True)
        ok = ok and same

    jobs = [(hd.source, parse_variant(text, hd.macros)) for text in args.variants] + [(p, None) for p in args.other]
    names = build_names(args.variants, args.other)
    builds = [(name, Backward(lib, hd.names), log) for name, (lib, log) in zip(names, compile_sources(jobs))]
    for name, bwd, log in builds:
        print(f"build {name}: ptxas {kernel_lines(log)}", flush=True)
        print_warnings(log)
        ok = check(bwd, hd.same_shape, args.seed) and ok
    if builds:
        q, k, v, o, do, lse = inputs(hd.same_shape, args.seed)

        def grads(bwd):
            dq, di = bwd.dq(q, k, v, o, do, lse)
            return (dq, di) + bwd.dkv(q, k, v, do, lse, di)

        first = grads(builds[0][1])
        for name, bwd, _ in builds[1:]:
            same = all(torch.equal(a, b) for a, b in zip(first, grads(bwd)))
            print(f"build {name}: dq, di, dk, dv bitwise equal to build {builds[0][0]}'s at {hd.same_shape}: {same}",
                  flush=True)
    for shape in hd.time_shapes if builds else ():
        q, k, v, o, do, lse = inputs(shape, args.seed)
        unit = 2.0 * q.shape[0] * q.shape[2] * q.shape[1] ** 2 * q.shape[3]
        lib_ms = time_sdpa_backward(q, k, v, do)  # before and after the builds: the yardstick's own spread
        for _, bwd, _ in builds:  # the card's clocks up before the first timed build
            time_ms(lambda: bwd.dkv(q, k, v, do, lse, bwd.dq(q, k, v, o, do, lse)[1]), inner=5)
        for turn, order in enumerate((builds, builds[::-1])):
            for name, bwd, _ in order:
                _, di = bwd.dq(q, k, v, o, do, lse)
                ms_dq = time_ms(lambda: bwd.dq(q, k, v, o, do, lse), inner=5)
                ms_dkv = time_ms(lambda: bwd.dkv(q, k, v, do, lse, di), inner=5)
                dev_dq = device_ms(lambda: bwd.dq(q, k, v, o, do, lse))
                dev_dkv = device_ms(lambda: bwd.dkv(q, k, v, do, lse, di))
                both = ms_dq + ms_dkv
                print(f"pass {turn + 1} {tuple(shape)} {name}: dq {ms_dq:.4f} ms ({3 * unit / ms_dq / 1e9:.1f} "
                      f"TFLOP/s), dkv {ms_dkv:.4f} ms ({4 * unit / ms_dkv / 1e9:.1f} TFLOP/s), together {both:.4f} ms "
                      f"({7 * unit / both / 1e9:.1f} TFLOP/s over the 7 products; {both / lib_ms:.2f} of SDPA's); "
                      f"device time dq {rate_text(dev_dq, 3 * unit)}, dkv {rate_text(dev_dkv, 4 * unit)}", flush=True)
        print(f"scaled_dot_product_attention backward {tuple(shape)}: {lib_ms:.4f} ms before the builds, "
              f"{time_sdpa_backward(q, k, v, do):.4f} ms after, device time "
              f"{rate_text(device_sdpa_backward(q, k, v, do), 7 * unit)}", flush=True)

    if args.fwd_check:
        lib, log = compile_source(hd.fwd_source)
        print(f"forward ptxas: {forward_lines(log)}", flush=True)
        print_warnings(log)
        fwd = Forward(lib, hd.fwd_name)
        for shape, with_lse in hd.fwd_shapes:
            ok = check_forward(fwd, shape, with_lse, args.seed) and ok
        for shape in hd.fwd_ragged:
            ok = check_forward(fwd, shape, True, args.seed + shape[1]) and ok
        ok = check_forward(fwd, hd.fwd_same_shape, True, args.seed, drift=True) and ok
        q, k, v = qkv(hd.fwd_same_shape, args.seed)
        first, again = fwd(q, k, v, True), fwd(q, k, v, True)
        same = all(torch.equal(a, b) for a, b in zip(first, again)) and torch.equal(first[0], fwd(q, k, v)[0])
        print(f"forward: two launches bitwise equal, and the output the same without the lse: {same}", flush=True)
        ok = ok and same

    jobs = [(hd.fwd_source, parse_fwd_variant(text, hd.fwd_macros)) for text in args.fwd_variants]
    jobs += [(p, None) for p in args.fwd_other]
    names = build_names(args.fwd_variants, args.fwd_other)
    fwd_builds = [(name, Forward(lib, hd.fwd_name), log) for name, (lib, log) in zip(names, compile_sources(jobs))]
    if fwd_builds:
        for name, fwd, log in fwd_builds:
            print(f"forward build {name}: ptxas {forward_lines(log)}", flush=True)
            print_warnings(log)
            for shape, with_lse in hd.fwd_shapes:
                ok = check_forward(fwd, shape, with_lse, args.seed) and ok
        q, k, v = qkv(hd.fwd_same_shape, args.seed)
        first = fwd_builds[0][1](q, k, v, True)
        for name, fwd, _ in fwd_builds[1:]:
            same = all(torch.equal(a, b) for a, b in zip(first, fwd(q, k, v, True)))
            print(f"forward build {name}: output and lse bitwise equal to build {fwd_builds[0][0]}'s at "
                  f"{hd.fwd_same_shape}: {same}", flush=True)
        for shape, with_lse in hd.fwd_shapes:
            q, k, v = qkv(shape, args.seed)
            lib_ms = time_sdpa(q, k, v)  # before and after the builds: the yardstick's own spread
            for _, fwd, _ in fwd_builds:  # the card's clocks up before the first timed build
                time_ms(lambda: fwd(q, k, v, with_lse), inner=5)
            for turn, order in enumerate((fwd_builds, fwd_builds[::-1])):
                for name, fwd, _ in order:
                    ms = time_ms(lambda: fwd(q, k, v, with_lse), inner=5)
                    dev = device_ms(lambda: fwd(q, k, v, with_lse), calls=20, tries=6)
                    print(f"pass {turn + 1} forward {tuple(shape)}{' with lse' if with_lse else ''} {name}: "
                          f"{ms:.4f} ms ({forward_flops(shape) / ms / 1e9:.1f} TFLOP/s), device time "
                          f"{rate_text(dev, forward_flops(shape))}", flush=True)
                print(f"pass {turn + 1} scaled_dot_product_attention {tuple(shape)}: device time "
                      f"{rate_text(device_sdpa(q, k, v), forward_flops(shape))}", flush=True)
            print(f"scaled_dot_product_attention {tuple(shape)}: {lib_ms:.4f} ms before the builds, "
                  f"{time_sdpa(q, k, v):.4f} ms after ({forward_flops(shape) / lib_ms / 1e9:.1f} TFLOP/s), device "
                  f"time {rate_text(device_sdpa(q, k, v), forward_flops(shape))}", flush=True)

    if args.forward:
        for shape, with_lse in hd.fwd_shapes:
            q, k, v = qkv(shape, args.seed)
            ms = time_ms(lambda: attention_fwd(q, k, v, with_lse=with_lse), inner=5)
            lib_ms = time_sdpa(q, k, v)
            dev = device_ms(lambda: attention_fwd(q, k, v, with_lse=with_lse), calls=20, tries=6)
            print(f"forward {tuple(shape)} bf16{' with lse' if with_lse else ''}: "
                  f"kernel {ms:.4f} ms ({forward_flops(shape) / ms / 1e9:.1f} TFLOP/s), device time "
                  f"{rate_text(dev, forward_flops(shape))}; scaled_dot_product_attention {lib_ms:.4f} ms "
                  f"({forward_flops(shape) / lib_ms / 1e9:.1f} TFLOP/s), device time "
                  f"{rate_text(device_sdpa(q, k, v), forward_flops(shape))}", flush=True)
    if args.wgmma_rate:
        wgmma_rate()
    if not ok:
        raise SystemExit("bench_attention_bwd: a build disagrees with the plain version")


if __name__ == "__main__":
    main()
