"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source under ``csrc/`` has a plain C interface. At first use it
is compiled for Hopper (``sm_90a``) into ``build/`` at the repository root,
under a name keyed by a hash of the flags, the source and the local headers
it includes, and loaded with ``ctypes``. Nothing here runs at import time:
the CPU-only tests import every module of the package and never reach
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from ..trace import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
BUILDS = 0  # nvcc runs of this process (`BatchedStreamEngine.counters()`'s kernel_builds)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path) -> list:
    """``path`` and every local header it includes (``#include "..."``,
    resolved beside the including file), each once, in the order met."""
    seen, todo = [], [path.resolve()]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        todo += [(p.parent / m.decode()).resolve() for m in _LOCAL_INCLUDE.findall(p.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: a hash of the flags, the source
    and the local headers it includes, so that an edited header builds
    anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(CSRC / f"{name}.cu"):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the libraries of ``csrc/<name>.cu`` that are missing, one
    ``nvcc`` per source, all started together (every source when no name
    is given), in the span ``ops.build``; each ``nvcc`` run adds one to
    `BUILDS`.

    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    names = names or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    jobs = []
    for name in names:
        lib_path = library_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, cmd, proc, tmp, lib_path))
    if not jobs:
        return
    global BUILDS
    BUILDS += len(jobs)
    failed = []
    with span("ops.build", sources=",".join(job[0] for job in jobs)):
        for name, cmd, proc, tmp, lib_path in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"building {name}.cu failed ({' '.join(cmd)}):\n{out}")
            else:
                os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it
    (the caller keeps the handle)."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
