"""Row-gather throughput on the card: 2^20 rows of a seeded 32768x128 bf16
table (8 MB, it stays in L2) through the row-gather kernel, beside
`torch.index_select` on the same inputs. The port's counterpart of
`tools/bench_pallas_gather.py`.

    python -m scenedino_torch.tools.bench_gather [--seed N]

Checks the kernel's rows equal `index_select`'s exactly, then prints
Mrows/s and ms of each (median of CUDA-event timings) with the card's
name and power limit. Needs a CUDA card; exits 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import sys

import torch

from scenedino_torch import resolve_device
from scenedino_torch.kernels import row_gather
from scenedino_torch.utils.timing import card_line, time_ms

ROWS, C = 32768, 128
P = 1 << 20


def inputs(seed: int = 0, device="cuda"):
    """P2's table (ROWS, C) bf16 and indices (P,) int32, drawn from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(ROWS, C, generator=g, device=device).to(torch.bfloat16)
    idx = torch.randint(0, ROWS, (P,), generator=g, device=device, dtype=torch.int32)
    return table, idx


def measure(seed: int = 0) -> dict:
    """Exact equality with `index_select`, then kernel and `index_select` ms."""
    device = resolve_device(None)
    table, idx = inputs(seed, device)
    equal = torch.equal(row_gather(table, idx), torch.index_select(table, 0, idx))
    return {"equal": equal, "kernel_ms": time_ms(lambda: row_gather(table, idx), reps=20, inner=5),
            "index_select_ms": time_ms(lambda: torch.index_select(table, 0, idx), reps=20, inner=5)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    m = measure(args.seed)
    print(f"row_gather correct (equal to index_select): {m['equal']}", flush=True)
    for name in ("kernel", "index_select"):
        ms = m[f"{name}_ms"]
        print(f"{name} ({ROWS}x{C} bf16 table, {P} rows): {P / ms / 1e3:.1f} Mrows/s ({ms:.4f} ms)", flush=True)
    print(card_line(), flush=True)
    return 0 if m["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
