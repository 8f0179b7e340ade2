"""csrc/attention_any.cu's k-steps at 64 columns (M = 1) as a template
parameter against the same k-steps under a predicate known at run time,
with the own rows as wgmma's A operand from registers or from shared
memory: which builds agree with the plain versions and with each other bit
for bit, and what ptxas made of them.

    python -m scenedino_torch.tools.probe_any_registers
    python -m scenedino_torch.tools.probe_any_registers --seeds 8 --sass build/any_registers

Builds `csrc/attention_any.cu` as the port builds it and in variants made
from its text, all at once:

* `predicated`: at M = 1 the products over the head dim issue all four
  k-steps, those past the first under a predicate `kk < ks` whose count
  ptxas cannot fold (KS plus %nsmid / 65536, which is 0: the design before
  the count became a template parameter, which read it from the kernel's
  arguments);
* `dkv K,V from registers`: dkv's own K and V rows as register A operands at
  M = 1, as the forward's Q and dq's Q and dO are (from shared memory in the
  port); `predicated, dkv K,V from registers` both.

Each build runs the forward (with the log-sum-exp), dq and dkv at every
count of k-steps at 64 columns (D = 16, 32, 48, 56, 64), at token counts of
2 to 31 walked tiles, over `--seeds` seeds. Each result is held against the
plain versions at chip_smoke.py's bounds (K1_TOL, K1_LSE_TOL, K1_BWD_REL),
against the port's build bit for bit (a k-step over zero columns adds
products of 0: the same bits), and against a second launch of itself. Each
build's M = 1 kernels are read in their SASS (cuobjdump beside nvcc): the
HGMMA, WARPGROUP.ARRIVE and DEPBAR lines, and the writes inside the walk's
loop to the registers that an HGMMA reads as an A operand loaded before the
loop (the own rows: a write there is a value lost for the next tile). With
`--sass DIR` each build's nvcc output, its SASS and those lines go to DIR.
Exits 1 if the port's build disagrees with anything or writes an own row's
register inside the walk.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import attention_bwd_plain, attention_lse_plain, attention_plain
from scenedino_torch.tools.bench_attention_bwd import K1_BWD_REL, K1_TOL, LSE_TOL, Backward, Forward, compile_sources
from scenedino_torch.utils.timing import card_line

HEAD_DIMS = (16, 32, 48, 56, 64)
TOKENS = (65, 200, 777, 1921)
PRODUCTS = """// acc = A B^T over the head dim's first KS k-steps
template <int KS, int M, bool REG>
__device__ __forceinline__ void product_nt(float (&acc)[32], const OwnA<M, REG>& a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) nt_step(acc, a, desc_b, kk);
}

// acc0 = a0 b0^T and acc1 = a1 b1^T over KS k-steps, alternating
template <int KS, int M, bool REG0, bool REG1>
__device__ __forceinline__ void products_nt(float (&acc0)[32], const OwnA<M, REG0>& a0, uint64_t desc_b0,
                                            float (&acc1)[32], const OwnA<M, REG1>& a1, uint64_t desc_b1) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    nt_step(acc0, a0, desc_b0, kk);
    nt_step(acc1, a1, desc_b1, kk);
  }
}
"""
PREDICATED = r"""__device__ __forceinline__ void wgmma_rs_if(float (&d)[32], const uint32_t* a, uint64_t desc_b, int accumulate,
                                            int run) {
  asm volatile(
      "{\n"
      ".reg .pred p, r;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "setp.ne.b32 r, %38, 0;\n"
      "@r wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "r"(run));
}

__device__ __forceinline__ void wgmma_ss_if(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate,
                                            int run) {
  asm volatile(
      "{\n"
      ".reg .pred p, r;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "setp.ne.b32 r, %35, 0;\n"
      "@r wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "r"(run));
}

template <int M, bool REG>
__device__ __forceinline__ void nt_step_if(float (&acc)[32], const OwnA<M, REG>& a, uint64_t desc_b, int kk,
                                           int ks) {
  if (M == 1 && kk > 0) {
    const uint64_t at = kk * WGMMA_K_STEP;
    if constexpr (REG) {
      wgmma_rs_if(acc, &a.r[0][4 * kk], desc_b + at, 1, kk < ks);
    } else {
      wgmma_ss_if(acc, a.desc + at, desc_b + at, 1, kk < ks);
    }
  } else {
    nt_step(acc, a, desc_b, kk);
  }
}

template <int KS, int M, bool REG>
__device__ __forceinline__ void product_nt(float (&acc)[32], const OwnA<M, REG>& a, uint64_t desc_b) {
  int ks;
  asm volatile("mov.u32 %0, %%nsmid;" : "=r"(ks));
  ks = KS + (ks >> 16);
#pragma unroll
  for (int kk = 0; kk < 4 * M; ++kk) nt_step_if(acc, a, desc_b, kk, ks);
}

template <int KS, int M, bool REG0, bool REG1>
__device__ __forceinline__ void products_nt(float (&acc0)[32], const OwnA<M, REG0>& a0, uint64_t desc_b0,
                                            float (&acc1)[32], const OwnA<M, REG1>& a1, uint64_t desc_b1) {
  int ks;
  asm volatile("mov.u32 %0, %%nsmid;" : "=r"(ks));
  ks = KS + (ks >> 16);
#pragma unroll
  for (int kk = 0; kk < 4 * M; ++kk) {
    nt_step_if(acc0, a0, desc_b0, kk, ks);
    nt_step_if(acc1, a1, desc_b1, kk, ks);
  }
}
"""
DKV_OWN = ("  OwnA<M, false> ak, av;", "  OwnA<M, M == 1> ak, av;")
EDITS = {
    "port": [],
    "predicated": [(PRODUCTS, PREDICATED)],
    "dkv K,V from registers": [DKV_OWN],
    "predicated, dkv K,V from registers": [(PRODUCTS, PREDICATED), DKV_OWN],
}
NAMES = ("out", "lse", "dq", "di", "dk", "dv")


def variant_source(name: str) -> Path:
    """The port's source with `name`'s edits (each must match once), written
    under build/kernels with hopper.cuh included from csrc."""
    text = (build.CSRC / "attention_any.cu").read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is not once in csrc/attention_any.cu")
        text = text.replace(old, new)
    text = text.replace('#include "hopper.cuh"', f'#include "{build.CSRC / "hopper.cuh"}"')
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"attention_any_{re.sub(r'[^a-z]+', '_', name.lower()).strip('_')}.cu"
    path.write_text(text)
    return path


def run(fwd: Forward, bwd: Backward, shape, seed) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    out, lse = fwd(q, k, v, True)
    dq, di = bwd.dq(q, k, v, out, do, lse)
    dk, dv = bwd.dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    return dict(zip(NAMES, (out, lse, dq, di, dk, dv)), q=q, k=k, v=v, do=do)


def errors(r: Dict[str, torch.Tensor]) -> Dict[str, Tuple[float, float]]:
    """Each result's max abs error against the plain versions and its bound."""
    q, k, v, do, out, lse = (r[n] for n in ("q", "k", "v", "do", "out", "lse"))
    errs = {"out": ((out.float() - attention_plain(q, k, v).float()).abs().max().item(), K1_TOL),
            "lse": ((lse - attention_lse_plain(q, k)).abs().max().item(), LSE_TOL),
            "di": ((r["di"] - (do.float() * out.float()).sum(-1).transpose(1, 2)).abs().max().item(), 1e-3)}
    for name, ref in zip(("dq", "dk", "dv"), attention_bwd_plain(q, k, v, out, do, lse)):
        errs[name] = ((r[name].float() - ref.float()).abs().max().item(),
                      K1_BWD_REL * ref.float().abs().max().item() + 1e-3)
    return errs


def sass_of(lib_path: Path) -> Dict[str, str]:
    """The SASS of the M = 1 fwd, dq and dkv kernels in a library, by kernel
    and k-steps ("dq 2"; cuobjdump beside nvcc)."""
    tool = shutil.which("cuobjdump") or str(Path(build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        m = re.match(r"\S*?(fwd|dq|dkv)_kernelILi1ELi(\d)E", block)
        if m:
            out[f"{m.group(1)} {m.group(2)}"] = block
    return out


INSTRUCTION = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Za-z0-9_.]+)\s*(.*?)\s*;")
KEY = ("HGMMA", "WARPGROUP.", "BRA")


def instructions(sass: str) -> List[Tuple[int, str, str]]:
    """(address, opcode, operands) of each instruction, the guard dropped."""
    out = []
    for line in sass.splitlines():
        m = INSTRUCTION.match(line)
        if m:
            out.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def written(op: str, operands: str) -> set:
    """The registers an instruction (not an HGMMA) writes: its first operand
    and, by the width in its opcode, the ones after it."""
    m = re.match(r"R(\d+)\b", operands)
    if not m or op.startswith("HGMMA"):
        return set()
    width = 4 if re.search(r"\.128|\.M88\.4", op) else 2 if re.search(r"\.64|\.WIDE|\.M88\.2", op) else 1
    return set(range(int(m.group(1)), int(m.group(1)) + width))


def own_row_writes(sass: str) -> Tuple[Dict[str, int], List[str]]:
    """Counts of the HGMMA, WARPGROUP.ARRIVE and WARPGROUP.DEPBAR lines of a
    kernel, and the instructions inside its walk (a backward branch over
    HGMMAs) that write a register which an HGMMA reading K-major (a product
    over the head dim: its A the own rows, loaded before the walk) reads as
    its A operand."""
    code = instructions(sass)
    counts = {op: sum(o.startswith(op) for _, o, _ in code) for op in ("HGMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR")}
    hits = []
    for addr, op, operands in code:
        target = re.match(r"0x([0-9a-f]+)", operands)
        if op != "BRA" or not target or int(target.group(1), 16) >= addr:
            continue
        body = [c for c in code if int(target.group(1), 16) <= c[0] <= addr]
        own = set()
        for _, o, args in body:
            a = re.match(r"R\d+, R(\d+), gdesc", args)
            if o.startswith("HGMMA") and a and ".tnspB" not in args:
                own |= set(range(int(a.group(1)), int(a.group(1)) + 4))
        hits += [f"{a:04x} {o} {args}" for a, o, args in body if written(o, args) & own]
    return counts, hits




def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--sass", type=Path, default=None, help="write nvcc's output and the SASS here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_any_registers needs a CUDA card")
    print(f"{torch.cuda.get_device_name(0)}; {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    names = list(EDITS)
    libs = compile_sources([(variant_source(name), None) for name in names])
    builds = {}
    port_ok = True
    for name, (lib, log) in zip(names, libs):
        regs = {f"{m.group(1)} {m.group(2)}": (r.get("registers"), r.get("spill_stores", 0))
                for k, r in build.ptxas_report(log).items()
                for m in [re.search(r"(fwd|dq|dkv)_kernelILi1ELi(\d)E", k)] if m}
        notes = {c: log.count(c) for c in sorted(set(re.findall(r"C75\d\d", log)))}
        print(f"build {name}: M = 1 kernels by k-steps, (registers, spill bytes) {regs}; ptxas notes {notes}",
              flush=True)
        builds[name] = (Forward(lib, "attention_any_fwd"), Backward(lib, ("attention_any_bwd_dq",
                                                                            "attention_any_bwd_dkv")))
        stem = re.sub(r"[^a-z]+", "_", name.lower()).strip("_")
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            (args.sass / f"{stem}.nvcc.log").write_text(log)
        try:
            kernels = sass_of(Path(lib._name))
        except (OSError, subprocess.CalledProcessError) as err:
            print(f"  sass: cuobjdump did not run ({err})", flush=True)
            port_ok = port_ok and name != "port"
            kernels = {}
        for kernel, sass in sorted(kernels.items()):
            counts, hits = own_row_writes(sass)
            print(f"  sass {kernel} k-steps: {counts}; writes to the own rows' registers inside the walk "
                  f"{len(hits)}{': ' + '; '.join(hits[:4]) if hits else ''}", flush=True)
            port_ok = port_ok and not (name == "port" and hits)
            if args.sass is not None:
                file = f"{stem}.{kernel.replace(' ', '_')}"
                (args.sass / f"{file}.sass").write_text(sass)
                (args.sass / f"{file}.keys").write_text("".join(line.strip() + "\n" for line in sass.splitlines()
                                                             if any(k in line for k in KEY)))

    reference = {}
    for name in names:
        fwd, bwd = builds[name]
        worst: Dict[str, Tuple[float, float]] = {}
        failed: List[str] = []
        unequal: Dict[str, int] = {n: 0 for n in NAMES}
        unrepeated = cases = 0
        for D in HEAD_DIMS:
            for N in TOKENS:
                for seed in [1000 * s + N + D for s in range(args.seeds)]:
                    shape = (2, N, 3, D)
                    r, again = run(fwd, bwd, shape, seed), run(fwd, bwd, shape, seed)
                    ref = reference.setdefault((shape, seed), {n: r[n] for n in NAMES})
                    cases += 1
                    unrepeated += not all(torch.equal(r[n], again[n]) for n in NAMES)
                    for n in NAMES:
                        unequal[n] += not torch.equal(r[n], ref[n])
                    for n, (err, bound) in errors(r).items():
                        if n not in worst or err / bound > worst[n][0] / worst[n][1]:
                            worst[n] = (err, bound)
                        if not err <= bound:
                            failed.append(f"{n} at {shape} seed {seed}: {err:.3e} > {bound:.3e}")
        text = ", ".join(f"{n} {e:.3e} (bound {b:.3e})" for n, (e, b) in worst.items())
        print(f"{name}: {cases} cases (D {HEAD_DIMS}, N {TOKENS}, {args.seeds} seeds); worst {text}; "
              f"{len(failed)} results past their bound; cases not bitwise equal to the port's {unequal}; "
              f"cases whose second launch differs {unrepeated}", flush=True)
        for line in failed[:6]:
            print(f"  past its bound: {line}", flush=True)
        if name == "port":
            port_ok = port_ok and not failed and not unrepeated
    print(f"the port's build agrees with the plain versions and with itself, and writes no own row's register "
          f"inside a walk: {port_ok}", flush=True)
    if not port_ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
