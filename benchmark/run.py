"""The benchmark of the PyTorch port (`mmduet_tpu_torch`) on one H100.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` on the machine it is started on and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device`` and, traced, ``breakdown``; the numbers the
check compared come last, under ``checks``, each beside its limit, and are
also the last lines on standard error. It exits with another code and
prints no result where there is no CUDA device, fewer than the cell asks
for, or where a module of JAX or of the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mmduet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``mmduet_tpu_torch`` is not ``mmduet_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness, spec as specs

    spec = specs.load(ROOT)
    cell = specs.cell_of(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, ROOT)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
