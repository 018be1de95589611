"""Which tensors are live at the peak of the 7B-width training steps, on one
NVIDIA GPU.

    PYTHONPATH=. python scripts/train_peak_tensors_torch.py [--out FILE]

Runs `chip_smoke.py`'s training phase (`run_training`: the default
`MMDuetConfig` with random bf16 weights from seed 0, LoRA r 16, remat on,
a warm-up and TRAIN_STEPS steps of A = TRAIN_ACCUM micro-batches of one duet
sample in the 2944-token bucket, one `TrainState` and one step's batch on
the card at a time) with the CUDA caching allocator's history on
(`torch.cuda.memory._record_memory_history`). It replays the history to the
moment the most bytes were allocated, sets that beside the phase's own
`torch.cuda.max_memory_allocated()`, and prints every block live then that
the phase allocated, grouped by the port's innermost frames that allocated
it (bytes, blocks, frames; the autograd engine's own allocations have no
Python frame), beside `memory_budget_torch`'s terms of that configuration
and what is left unnamed. Lines go to stdout and, with ``--out``, to FILE.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from chip_smoke import TRAIN_ACCUM, TRAIN_STEPS, budget  # noqa: E402

MIB = 2 ** 20
SHOWN_FRAMES = 3  # the port's innermost frames that name a block's site


def _site(frames) -> tuple:
    """The innermost frames of the port's package (or of the repository)
    that lie under an allocation: the site that names its tensor."""
    ours = [f for f in frames if "mmduet_tpu_torch" in f["filename"]]
    ours = ours or [f for f in frames if f["filename"].startswith(REPO)]
    return tuple(f"{os.path.relpath(f['filename'], REPO)}:{f['line']} {f['name']}"
                 for f in ours[:SHOWN_FRAMES])


def replay_peak(events, start_bytes: int):
    """(peak bytes, the blocks the history allocated and had not freed at the
    peak as {addr: (bytes, frames)}, the bytes allocated before the history
    that were still live): ``events`` in order, ``alloc`` adding a block and
    ``free_requested`` removing it, as `memory_allocated` counts them."""
    live, now, peak, at_peak, pre_freed, pre_at_peak = {}, start_bytes, start_bytes, {}, 0, 0
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
            now += e["size"]
            if now > peak:
                peak, at_peak, pre_at_peak = now, dict(live), pre_freed
        elif e["action"] == "free_requested":
            now -= e["size"]
            if live.pop(e["addr"], None) is None:
                pre_freed += e["size"]
    return peak, at_peak, start_bytes - pre_at_peak


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="also write the lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_peak_tensors_torch: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    log(chip_smoke._card())
    chip_smoke._build.build()
    cfg, tok, params = chip_smoke.full_width_model(log)
    # a small training step first: the libraries' workspaces are resident
    # before the phase, as `chip_smoke.py`'s earlier phases leave them
    chip_smoke.check_small_train(log)
    start = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    _, train_mem = chip_smoke.run_training(cfg, tok, params, log)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    mem = train_mem["mem"]["steps"]
    events = snap["device_traces"][torch.cuda.current_device()]
    peak, blocks, pre = replay_peak(events, start)
    log(f"{len(events)} allocator events over the warm-up and {TRAIN_STEPS} steps; replayed peak "
        f"{peak} bytes, the steps' max_memory_allocated {mem['peak']} (replay less it "
        f"{(peak - mem['peak']) / MIB:+.2f} MiB); at the peak "
        f"{pre / MIB:.1f} MiB allocated before the phase (the weights "
        f"{budget.tree_bytes(params) / MIB:.1f}, resident {mem['resident'] / MIB:.1f}), "
        f"{sum(b for b, _ in blocks.values()) / MIB:.1f} MiB in {len(blocks)} blocks of the phase")

    sites = collections.defaultdict(lambda: [0, 0])
    for size, frames in blocks.values():
        sites[_site(frames)][0] += size
        sites[_site(frames)][1] += 1
    log("blocks live at the peak, by the port's innermost frames (MiB, blocks):")
    for site, (size, n) in sorted(sites.items(), key=lambda kv: -kv[1][0]):
        log(f"  {size / MIB:10.2f} MiB {n:5d}  " + " <- ".join(site or ("(no frame)",)))

    est = budget.training_budget(budget.Training(
        "training", cfg, accum=TRAIN_ACCUM, batch=1, seq=train_mem["seq"],
        frames=train_mem["frames"], params=budget.model_params(cfg)))
    moment, moment_bytes = est.peak_moment
    net = mem["peak"] - mem["resident"]
    log(f"the budget: {est.total_bytes / MIB:.1f} MiB = persistent "
        f"{est.persistent_bytes / MIB:.1f} + '{moment}' {moment_bytes / MIB:.1f}; the steps' "
        f"peak less resident {net / MIB:.1f} MiB, unnamed {(net - est.total_bytes) / MIB:+.1f} MiB")
    for name, b, what in est.persistent + est.moments[moment]:
        log(f"  {b / MIB:10.2f} MiB  {name} ({what})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
