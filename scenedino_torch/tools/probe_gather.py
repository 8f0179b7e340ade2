"""Gather 256 rows of a 512x128 fp32 table through the row-gather kernel
and check them against numpy: the port's counterpart of
`tools/probe_pallas_gather.py`, which asked whether Mosaic could lower
such a gather on the TPU (it could not).

    python -m scenedino_torch.tools.probe_gather [--device cuda]

Prints `row_gather: RUNS, correct=<exact equality with numpy>` and exits
0 only when the rows are equal. Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from scenedino_torch import resolve_device
from scenedino_torch.kernels import row_gather

ROWS, C, BLK = 512, 128, 256


def run(device=None) -> bool:
    """Gather P1's rows on `device` (CUDA unless "cpu" is asked for); True
    when they equal numpy's `table[idx]` exactly."""
    device = resolve_device(device)
    table = np.arange(ROWS * C, dtype=np.float32).reshape(ROWS, C)
    idx = np.random.RandomState(0).randint(0, ROWS, BLK).astype(np.int32)
    out = row_gather(torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device))
    ok = bool(np.array_equal(out.cpu().numpy(), table[idx]))
    print(f"row_gather: RUNS, correct={ok}", flush=True)
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return 0 if run(args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
