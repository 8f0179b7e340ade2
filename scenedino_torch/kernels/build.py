"""Build the CUDA sources in `scenedino_torch/csrc/` and load them.

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with `ctypes`; nothing includes PyTorch's headers,
so a build takes seconds. Libraries go to `build/kernels/` in the
checkout, named by a hash of their source, the files it includes and the
flags: a changed source or header is rebuilt at its first use, an
unchanged one is loaded as it is. Nothing is built when a module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` and every file it includes with `#include "..."`,
    transitively (paths relative to the including file)."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo.extend((path.parent / inc.decode()).resolve() for inc in _LOCAL_INCLUDE.findall(path.read_bytes()))
    return found


def library_path(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a hash of the flags and of
    every file the source includes, so a changed header is rebuilt too."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def all_names() -> List[str]:
    """The name of every CUDA source in `csrc/`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that has no current library, all nvcc
    processes at once. Returns the seconds each build took (0 for a
    library that was current); `build/kernels/<name>.log` keeps nvcc's
    output (ptxas registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """What `-Xptxas -v` said of each kernel in nvcc's output `log`: by
    (mangled) entry name, its `registers`, `stack`, `spill_stores` and
    `spill_loads` (bytes)."""
    report: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = report.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            entry.update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = _PTXAS_USED.search(line)
        if m:
            entry["registers"] = int(m.group(1))
    return report


def build_log(name: str) -> str:
    """nvcc's output of the last build of `csrc/<name>.cu` in this checkout ('' if none)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text(errors="replace") if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
