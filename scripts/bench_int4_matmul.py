"""Kernel B (the W4A16 product) alone on the card: time it in turns with
other builds of it.

Times `int4_matmul` at the 7B decoder's weight shapes (H, O) and the main
path's row counts (a decode step, a joiner + frame step, the 8- and
32-frame blocks), group 128, beside its roofline bound (`ops/bounds.py`)
and the dense bf16 weight on cuBLAS. A time is device ms: calls captured
in a CUDA graph and replayed back to back, each call on another copy of
the weights so that they come from device memory, as a layer's do. Checks
each build against `int4_matmul_ref` within the kernel's bound; checks
nothing else (`chip_smoke.py` and `tests/test_torch_cuda.py` do). From the
repository root:

    PYTHONPATH=. python scripts/bench_int4_matmul.py [--parent DIR]
        [--variant NAME OLD NEW ...] [--ptxas] [--rows 1,392]

``--parent DIR`` also times the package in DIR (another checkout, e.g. the
parent commit's, unpacked with `git archive`). ``--variant NAME OLD NEW``
also times a build of this tree's `csrc/int4_matmul.cu` with the text OLD
replaced by NEW (it must occur), loaded in place of the kernel's library
for its turns. Each shape is timed in two rounds, the builds in turn and
the second round in reverse order. ``--ptxas`` prints what `nvcc -Xptxas
-v` says of the source (registers, spills). The last line is one JSON
object of each build's mean time over the two rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from mmduet_tpu_torch.models import quant
from mmduet_tpu_torch.ops import _build, bounds, quant_matmul

SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064))


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms of one call of ``fn``, from a CUDA graph of ``iters`` calls."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def build_variant(name: str, old: str, new: str, into: Path) -> ctypes.CDLL:
    """This tree's kernel B source with ``old`` replaced by ``new``, built
    and loaded with the wrapper's argument types."""
    src = (_build.CSRC / "int4_matmul.cu").read_text()
    if old not in src:
        raise SystemExit(f"variant {name}: the text to replace is not in int4_matmul.cu")
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, into / header.name)
    (into / f"{name}.cu").write_text(src.replace(old, new))
    lib_path = into / f"{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(into / f"{name}.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.int4_matmul_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.int4_matmul_bf16.restype = ctypes.c_int
    lib.int4_matmul_error_string.argtypes = [ctypes.c_int]
    lib.int4_matmul_error_string.restype = ctypes.c_char_p
    return lib


def parent_matmul(parent_dir: str):
    """``parent_dir``'s `int4_matmul`, imported beside this package's."""
    for name in [m for m in sys.modules if m.startswith("mmduet_tpu_torch")]:
        del sys.modules[name]  # this package's modules stay alive through `quant_matmul`
    sys.path.insert(0, parent_dir)
    try:
        parent = importlib.import_module("mmduet_tpu_torch.ops.quant_matmul")
    finally:
        sys.path.remove(parent_dir)
    if not Path(parent.__file__).resolve().is_relative_to(Path(parent_dir).resolve()):
        raise RuntimeError(f"{parent_dir} holds no mmduet_tpu_torch")
    return parent.int4_matmul


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, help="a checkout holding the package to compare")
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"), help="a build with OLD replaced by NEW")
    ap.add_argument("--ptxas", action="store_true", help="print the compiler's register report")
    ap.add_argument("--rows", default="1,53,392,1568", help="row counts to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_int4_matmul: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    def log(msg):
        print(f"[{card}] {msg}", flush=True)

    if args.ptxas:
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              "/dev/null", str(_build.CSRC / "int4_matmul.cu")],
                             capture_output=True, text=True)
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line or "warning" in line or "error" in line:
                log(f"int4_matmul: {line.strip()}")
    _build.build("int4_matmul")
    own = quant_matmul._kernel_lib()
    builds = {"change": (quant_matmul.int4_matmul, own)}
    tmp = Path(tempfile.mkdtemp(prefix="int4_variants_"))
    try:
        for name, old, new in args.variant:
            builds[name] = (quant_matmul.int4_matmul, build_variant(name, old, new, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.parent:
        builds["parent"] = (parent_matmul(args.parent), None)
    order = (["parent"] if args.parent else []) + [b for b in builds if b != "parent"]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    result = {}
    for H, O in SHAPES:
        w = torch.randn((H, O), generator=gen, device=dev, dtype=torch.bfloat16) / math.sqrt(H)
        leaf = quant.quantize_weight_int4(w, 0)
        qw4, qs = leaf["qw4"], leaf["qs"]
        n_copies = max(1, min(8, -(-(120 << 20) // qw4.numel())))
        copies = [(qw4.clone(), qs.clone()) for _ in range(n_copies)]
        for R in (int(r) for r in args.rows.split(",")):
            y = torch.randn((R, H), generator=gen, device=dev, dtype=torch.bfloat16)
            want = quant_matmul.int4_matmul_ref(y, qw4, qs)
            mag = bounds.int4_matmul_magnitude(y, qw4, qs)
            times = {b: [] for b in order}
            for rnd in range(2):
                for b in (order if rnd == 0 else order[::-1]):
                    fn, lib = builds[b]
                    if lib is not None:
                        quant_matmul._lib = lib
                    ratio = bounds.int4_matmul_ratio(fn(y, qw4, qs), want, mag)
                    if not ratio <= 1.0:
                        raise AssertionError(f"{b}: R={R} H={H} O={O} misses the bound ({ratio})")
                    turn = iter(range(10 ** 9))

                    def launch(fn=fn):
                        a, s = copies[next(turn) % n_copies]
                        return fn(y, a, s)

                    times[b].append(graph_ms(launch))
            quant_matmul._lib = own
            dense = graph_ms(lambda: quant.matmul_f32(y, w))
            bound_ms, bound_by = bounds.int4_matmul_bound(R, H, O)
            plan = quant_matmul.int4_plan(R, H, O, 128)
            log(f"R={R} H={H} O={O} ({plan.path}, {plan.rows} rows a block, ks {plan.ks}): "
                + ", ".join(f"{b} {' '.join(f'{t:.4f}' for t in times[b])} ms" for b in order)
                + f"; cuBLAS dense {dense:.4f} ms; bound {bound_ms:.5f} ms ({bound_by})")
            result[f"{R}x{H}x{O}"] = {**{b: sum(v) / len(v) for b, v in times.items()},
                                      "cublas_dense": dense, "bound": bound_ms}
            del y, want, mag
        del w, leaf, qw4, qs, copies
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
