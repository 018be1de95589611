"""The program's own account of a cell's traced slice, on the chip (the
benchmark's own runs never run this):

    python benchmark/program_run.py --workload <cell> --seeds <n,n,...> \\
        --seconds <s> [--out FILE]

For each seed: set-up and a window as `run.py --trace 1` makes them
(`harness.serve_window`), with the engine's counters taken at the
window's start, the slice's start and the window's end; then the slice's
trace read once (`program_trace.read`). One JSON line a seed: the slice's
frames scored a second, every per-layer metric of the cell as
`run.py --trace 1` reads it, the readings of `program_trace.READINGS`, and
the ``program`` block (`program_trace.program_block`). The check against
the reference is left to `run.py`.
"""

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class Counts:
    """``serve_window``'s ``faults`` hook that breaks nothing: it keeps the
    engine and takes its counters at the window's start and at the first
    admission or round that runs with the profiler on (the slice's start),
    wrapping `_admit` and `_run_round` inside the harness's own hooks."""

    def __init__(self):
        self.engine = None
        self.start = self.slice = None

    def __call__(self, engine) -> None:
        self.engine = engine
        self.start = engine.counters()
        for name in ("_admit", "_run_round"):
            setattr(engine, name, self._first_traced(getattr(engine, name)))

    def _first_traced(self, inner):
        import torch

        def call(*args):
            if self.slice is None and torch.autograd._profiler_enabled():
                self.slice = self.engine.counters()
            return inner(*args)

        return call


def one_seed(spec, cell, seed: int, seconds: float, device, root=ROOT) -> dict:
    from benchmark import harness, program_trace, spec as specs

    cfg_file = specs.config_of(spec, cell["config"], root)
    mix = specs.traffic_of(cell["traffic"], root)
    counts = Counts()
    t0 = time.perf_counter()
    out = harness.serve_window(cfg_file, mix, seed, seconds, True, device, t0, root,
                               faults=counts)
    end = counts.engine.counters()
    counts.engine = None  # the harness's hooks hold the engine in a cycle
    gc.collect()
    if out["prof"] is None or counts.slice is None:
        raise RuntimeError(f"the window ({out['window_s']:.1f} s) closed before its slice")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        out["prof"].export_chrome_trace(path)
        size = os.path.getsize(path)
        trace, prog = program_trace.read(path)
    read_s = time.perf_counter() - t1
    window = program_trace.delta(end, counts.start)
    in_slice = program_trace.delta(end, counts.slice)
    run = out["run"]
    run.trace = trace
    metrics = {name: specs.reader(name, root)(run)
               for name in specs.metrics_of(spec, cell["name"], "per_layer")}
    metrics.update({name: f(trace, prog, window, in_slice)
                    for name, f in program_trace.READINGS.items()})
    scored = in_slice["frames_fed"] - in_slice["frames_rolled_back"]
    # the harness's clock around the slice's decodes and dispatches, beside
    # `decode_tok_s` and `dispatch_ms_per_frame`, which read the calls before it
    decodes = [c for c in run.sliced() if c.kind in ("prefill", "step")]
    dispatches = [c for c in run.sliced() if c.kind == "dispatch"]
    decode_s = sum(c.seconds for c in decodes)
    dispatch_s = sum(c.seconds for c in dispatches)
    fed = sum(c.scored for c in dispatches)
    return {
        "workload": cell["name"], "seed": seed, "window_s": out["window_s"],
        "setup_s": out["setup_s"], "frames_per_s": run.frames_scored / out["window_s"],
        "slice": {"seconds": trace.window_s(), "frames_scored": scored,
                  "frames_per_s": scored / trace.window_s(), "busy_s": trace.busy_s(),
                  "decode_tok_s": sum(c.lm_rows for c in decodes) / decode_s if decode_s
                  else None,
                  "dispatch_ms_per_frame": 1e3 * dispatch_s / fed if fed else None,
                  "kernels": len(trace.kernels), "program_spans": len(prog.spans),
                  "trace_mib": size / 2 ** 20, "export_and_read_s": read_s},
        "metrics": metrics,
        "program": program_trace.program_block(trace, prog, window, in_slice),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec as specs

    if not torch.cuda.is_available():
        print("program_run.py: no CUDA device", file=sys.stderr)
        return 2
    spec = specs.load(ROOT)
    cell = specs.cell_of(spec, args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        line = json.dumps(one_seed(spec, cell, seed, args.seconds, torch.device("cuda", 0)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
