"""The K1 forwards' online softmax on keys scaled along the walk: which
build reads one bf16 step more than `scaled_dot_product_attention`.

    python -m scenedino_torch.tools.softmax_sweep
    python -m scenedino_torch.tools.softmax_sweep --rounds 7

Builds `csrc/attention.cu` (D = 64) and `csrc/attention_d80.cu` (D = 80)
two ways, all at once: as the port builds them (the exact rescale: the
running max moves whenever it grows, so the dominant key's P is 1) and
with K1_RESCALE_SLACK=8 (the lazy rescale they shipped with before: the
max moves only on a growth above 8). Each build runs `chip_smoke.py` phase
11a's construction (key row n scaled by 1 + 4 n / N; seeds 200 + N, 1, 2, 3;
shapes (4, 585, 16), (2, 1921, 12), (4, 1921, 12), (4, 2305, 12)) and is
held, as SDPA is, against the fp32 plain version rounded to bf16
(`attention_plain`). A case is "at SDPA's error" when the build's error is
no larger than SDPA's on the same inputs. Then the builds are timed in
turns, D = 64 at the forward's three shapes (phase 2's) and D = 80 at
(2, 1921, 12, 80) with the log-sum-exp and (4, 1921, 12, 80), for
`--rounds` rounds (the median CUDA-event time of each round; the spread of
the rounds is the run-to-run spread), on the card that the first line names.
"""
from __future__ import annotations

import argparse
import json

import torch

from scenedino_torch.kernels import build
from scenedino_torch.kernels.attention import attention_plain
from scenedino_torch.tools.bench_attention_bwd import FWD_SHAPES, Forward, compile_sources
from scenedino_torch.utils.timing import card_line, time_ms

SWEEP = ((4, 585, 16), (2, 1921, 12), (4, 1921, 12), (4, 2305, 12))
SEEDS = (1, 2, 3)
BUILDS = {"as built": {}, "lazy rescale": {"K1_RESCALE_SLACK": 8}}
TIMED = {64: FWD_SHAPES, 80: (((2, 1921, 12, 80), True), ((4, 1921, 12, 80), False))}
SOURCES = {64: ("attention.cu", "attention_fwd"), 80: ("attention_d80.cu", "attention_d80_fwd")}


def scaled_keys(B, N, Hh, D, seed):
    """q, k, v of (B, N, Hh, D) bf16 from `seed`, key row n scaled by 1 + 4 n / N."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, N, Hh, D, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    ramp = torch.arange(N, device="cuda", dtype=torch.float32)[None, :, None, None] / N
    return q, (k.float() * (1 + 4 * ramp)).to(torch.bfloat16), v


def sdpa(q, k, v):
    out = torch.nn.functional.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    return out.transpose(1, 2)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    print(card_line(), flush=True)
    jobs = [(build.CSRC / SOURCES[D][0], defines) for D in SOURCES for defines in BUILDS.values()]
    libs = iter(compile_sources(jobs))
    fwds = {(D, name): Forward(next(libs)[0], SOURCES[D][1]) for D in SOURCES for name in BUILDS}

    table = {}
    for D in SOURCES:
        for b, n, h in SWEEP:
            for seed in (200 + n,) + SEEDS:
                q, k, v = scaled_keys(b, n, h, D, seed)
                ref = attention_plain(q, k, v).float()
                errs = {"SDPA": (sdpa(q, k, v).float() - ref).abs().max().item()}
                for name in BUILDS:
                    errs[name] = (fwds[D, name](q, k, v)[0].float() - ref).abs().max().item()
                table[f"D{D} ({b}, {n}, {h}) seed {seed}"] = errs
    print(f"errors against the plain version rounded to bf16: {json.dumps(table)}", flush=True)
    for D in SOURCES:
        rows = [e for key, e in table.items() if key.startswith(f"D{D} ")]
        summary = {name: {"max": max(e[name] for e in rows), "above SDPA": sum(e[name] > e["SDPA"] for e in rows),
                          "above 1.5625e-2": sum(e[name] > 1.5625e-2 for e in rows)}
                   for name in ("SDPA", *BUILDS)}
        print(f"D = {D}, {len(rows)} cases: {json.dumps(summary)}", flush=True)

    times = {}
    for D, shapes in TIMED.items():
        for shape, with_lse in shapes:
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
            per = {name: [] for name in BUILDS}
            for _ in range(args.rounds):
                for name in BUILDS:
                    per[name].append(time_ms(lambda: fwds[D, name](q, k, v, with_lse), reps=50))
            times[f"{tuple(shape)}{' lse' if with_lse else ''}"] = {
                name: {"median": sorted(t)[len(t) // 2], "min": min(t), "max": max(t)} for name, t in per.items()}
    print(f"forward ms, {args.rounds} rounds in turns (median of 50 CUDA-event times each): "
          f"{json.dumps(times)}", flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
