"""The readings that the check's limits are set from, on the chip, in one
process for many seeds (the benchmark's own runs never run this):

    python benchmark/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--control <k>] [--out FILE]

For each seed: set-up, a window at the cell's own load, and the check's
numbers for the program (the lower reading of each limit is the largest
over the seeds); for the first ``k`` seeds also the control's (the
reference in the nearest lower precision in the program's place: its
smallest reading over those seeds is the upper one), and whether each side
passes the configuration's limits (``correct``, ``control_correct``). One
JSON line a seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, spec as specs

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    spec = specs.load(ROOT)
    cell = specs.cell_of(spec, args.workload)
    cfg_file = specs.config_of(spec, cell["config"], ROOT)
    mix = specs.traffic_of(cell["traffic"], ROOT)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def passes(got):
        return all(c["ok"] for c in harness.judge(got, cfg_file["limits"]).values())

    for k, seed in enumerate(int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        served = harness.serve_window(cfg_file, mix, seed, args.seconds, False, dev, t0, ROOT)
        t1 = time.perf_counter()
        numbers, control = harness.reference_check(served, seed, dev,
                                                   with_control=k < args.control)
        row = dict(workload=args.workload, seed=seed, **numbers, correct=passes(numbers),
                   answers=len(served["answers"]), frames=served["run"].frames_scored,
                   window_s=served["window_s"], setup_s=served["setup_s"],
                   check_s=time.perf_counter() - t1)
        if control is not None:
            row.update(control=control, control_correct=passes(control))
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del served
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
