"""Which tensors are resident before, and live at the peak of, a tiny serving
pass on one NVIDIA GPU, beside `memory_budget_torch`'s terms of it.

    PYTHONPATH=. python scripts/serving_peak_tensors_torch.py [--out FILE]

`measure_tiny_serving` is the pass that
`tests/test_torch_cuda.py::test_memory_budget_holds_a_serving_peak_on_the_card`
holds to its budget: `tiny_config(hidden_size=512)` with random bf16
weights from seed 1, a warm-up `LiveInferEngine` in grounding mode on 40
frames (it leaves the libraries' workspaces resident), then a new engine
on 64 frames and a query, measured from a reset of the peak. What the
configuration itself holds is not resident: kernels A's and B's split
scratch, which `ops.attention` / `ops.quant_matmul` keep per device, is
released after the warm-up, so the pass allocates its own, as a new
process would (the budget counts it as the configuration's persistent
term). The measured bytes are the pass's `max_memory_allocated()` less the
resident bytes, plus the bytes of the engine's graph pool that no tensor
holds at the end (`memory_budget_torch.pool_idle_bytes`): the pool keeps
them for the engine's life on the graph route.

With the CUDA caching allocator's history on
(`torch.cuda.memory._record_memory_history`), the script prints the blocks
resident before the pass and those live at its peak, grouped by the port's
innermost frames that allocated them, the graph pool's segments, and the
budget's terms. Lines go to stdout and, with ``--out``, to FILE.
"""

from __future__ import annotations

import argparse
import collections
import gc
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import memory_budget_torch as mb  # noqa: E402
from mmduet_tpu_torch.config import TestArgs, tiny_config  # noqa: E402
from mmduet_tpu_torch.infer import LiveInferEngine  # noqa: E402
from mmduet_tpu_torch.models import init_mmduet_params  # noqa: E402
from mmduet_tpu_torch.stream import CharTokenizer  # noqa: E402

MIB = 2 ** 20
SHOWN_FRAMES = 3


def measure_tiny_serving(history: bool = False) -> dict:
    """The pass, on the current CUDA device: ``est`` (its `Budget`), ``peak``
    and ``resident`` (bytes, the peak with the pool's idle bytes), ``idle``
    (those bytes), ``released`` (the warm-up's split scratch), ``engine``,
    ``start`` (the bytes allocated when the pass begins), and with
    ``history`` (the allocator's history from before the warm-up) its
    ``resident_snapshot`` before the scratch is released, its ``snapshot``
    after the pass and the ``first_event`` of the pass."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(1), dev,
                                torch.bfloat16)
    args = TestArgs(frame_fps=2.0, stream_end_prob_threshold=1.0, grounding_mode=True,
                    max_num_frames=64)
    frames = np.random.RandomState(1).randint(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    query = [{"role": "user", "content": "Q?", "time": 0.0}]
    out = {}
    if history:
        torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
    warm = LiveInferEngine(params, cfg, tok, args)
    warm.input_video_stream(frames[:40])
    warm.input_query_stream(query)
    warm.inference()
    del warm
    gc.collect()
    torch.cuda.synchronize()
    if history:  # what the warm-up leaves, before the split scratch goes
        out["resident_snapshot"] = torch.cuda.memory._snapshot()
    released = mb.release_split_scratch()
    resident = torch.cuda.memory_allocated() - mb.tree_bytes(params)
    engine = LiveInferEngine(params, cfg, tok, args)
    start = torch.cuda.memory_allocated()
    if history:
        out["first_event"] = len(torch.cuda.memory._snapshot()["device_traces"][dev.index])
    torch.cuda.reset_peak_memory_stats()
    engine.input_video_stream(frames)
    engine.input_query_stream(query)
    engine.inference()
    torch.cuda.synchronize()
    if history:
        out["snapshot"] = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
    idle = mb.pool_idle_bytes(engine._graphs)
    est = mb.serving_budget(mb.Serving("tiny serving", cfg, grounding=True, max_num_frames=64,
                                       frames=len(frames)))
    out.update(est=est, peak=torch.cuda.max_memory_allocated() + idle, resident=resident,
               idle=idle, released=released, engine=engine, start=start, params=params)
    return out


def _site(frames) -> tuple:
    ours = [f for f in frames if "mmduet_tpu_torch" in f["filename"]]
    ours = ours or [f for f in frames if f["filename"].startswith(REPO)]
    return tuple(f"{os.path.relpath(f['filename'], REPO)}:{f['line']} {f['name']}"
                 for f in ours[:SHOWN_FRAMES])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="also write the lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serving_peak_tensors_torch: torch.cuda.is_available() is false")
    from train_peak_tensors_torch import replay_peak

    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    m = measure_tiny_serving(history=True)
    est, engine = m["est"], m["engine"]
    log(f"{torch.cuda.get_device_name(0)}; route {engine.decode_route}; graphs "
        f"{engine._graphs.kinds() if engine._graphs is not None else {}}")
    log(f"resident before the pass {m['resident']} bytes (less the weights), the warm-up's "
        f"split scratch released {m['released']} bytes; the pass's peak with the pool's idle "
        f"bytes {m['peak']} (idle {m['idle']})")
    sites = collections.defaultdict(lambda: [0, 0])
    for seg in m["resident_snapshot"]["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                sites[_site(blk.get("frames", []))][0] += blk["size"]
                sites[_site(blk.get("frames", []))][1] += 1
    log("blocks allocated after the warm-up, before the split scratch is released, by the "
        "port's innermost frames (bytes, blocks; the weights included):")
    for site, (size, n) in sorted(sites.items(), key=lambda kv: -kv[1][0]):
        log(f"  {size:12d} {n:5d}  " + " <- ".join(site or ("(no frame)",)))
    events = m["snapshot"]["device_traces"][torch.cuda.current_device()][m["first_event"]:]
    peak, blocks, pre = replay_peak(events, m["start"])
    log(f"{len(events)} allocator events; replayed peak {peak} bytes, of it {pre} allocated "
        f"before the pass and {sum(b for b, _ in blocks.values())} in {len(blocks)} blocks "
        f"of the pass")
    sites = collections.defaultdict(lambda: [0, 0])
    for size, frames in blocks.values():
        sites[_site(frames)][0] += size
        sites[_site(frames)][1] += 1
    log("blocks of the pass live at its peak, by the port's innermost frames (bytes, blocks):")
    for site, (size, n) in sorted(sites.items(), key=lambda kv: -kv[1][0]):
        log(f"  {size:12d} {n:5d}  " + " <- ".join(site or ("(no frame)",)))
    pool = engine._graphs.pool if engine._graphs is not None else None
    for seg in m["snapshot"]["segments"]:
        if pool is not None and tuple(seg.get("segment_pool_id", ())) == tuple(pool):
            log(f"  graph pool segment: {seg['total_size']} bytes, {seg['allocated_size']} "
                f"allocated, {len(seg['blocks'])} blocks")
    ok, line = mb.check(est, m["peak"], m["resident"])
    log(line)
    net = m["peak"] - m["resident"]
    log(f"estimate less measured {est.total_bytes - net:+d} bytes "
        f"({(est.total_bytes - net) / max(net, 1):+.1%}); terms:")
    for name, b, what in est.persistent:
        log(f"  persistent {b:12d}  {name} ({what})")
    for moment, rows in est.moments.items():
        log(f"  moment '{moment}' {sum(b for _, b, _ in rows)}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
