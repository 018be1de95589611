"""The program's spans (``mmduet.*``) in a `torch.profiler` trace, and what
they say of the device's idle time.

`read` parses an exported Chrome trace once. It gives the `benchmark.trace`
`Trace` that `benchmark.trace.kernel_intervals` gives (the same kernels and
``bench.*`` spans, so `idle_pct`, `breakdown` and every reader of it read
the same), and beside it a `ProgramTrace`: each kernel's correlation id,
the CUDA runtime and driver API's launch events by correlation id
(``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaGraphLaunch``: every
kernel of a graph's replay carries its launch's id), the copy engine's
intervals (``gpu_memcpy``, ``gpu_memset``) and the program's host spans.

`program_block` splits the slice's idle time (no kernel running,
`benchmark.trace.idle_gaps`) three ways: **copy**, a copy was running;
**queued**, the launch of the kernel that ends the gap had returned before
the gap began, so the device had the work (the gaps between the kernels
of one graph replay are such once its launch has returned); **host**, the
rest, by the innermost ``mmduet.*`` span at each interval's middle, of
which ``host_in_launch`` is the part where that launch was still running
(a graph's launch submits its kernels as it goes). It also gives the device
seconds by the innermost ``mmduet.*`` span around each kernel's launch,
and the share of kernel time whose launch was found. `READINGS` are the
per-layer metrics read from it and from the engine's counters
(`BatchedStreamEngine.counters()`) over the window and over the slice.

Spans are taken from the host (``cat`` "user_annotation"); the profiler
also copies them onto the device's timeline, where they are not read.
Times are µs on the profiler's clock.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .trace import NAME_CHARS, SPAN_PREFIX, Trace, idle_gaps, union

PROGRAM_PREFIX = "mmduet."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
COPIES = ("gpu_memcpy", "gpu_memset")
NONE = "(no span)"

Interval = Tuple[float, float]


@dataclass
class ProgramTrace:
    """``kernels`` (name, start, end, correlation or None); ``launches``:
    correlation -> (name, start, end); ``copies`` (start, end); ``spans``
    (name without the ``mmduet.`` prefix, start, end)."""

    kernels: List[Tuple[str, float, float, Optional[int]]] = field(default_factory=list)
    launches: Dict[int, Tuple[str, float, float]] = field(default_factory=dict)
    copies: List[Interval] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)


def read(trace_path: str) -> Tuple[Trace, ProgramTrace]:
    """(the `Trace` of `benchmark.trace.kernel_intervals`, the
    `ProgramTrace`) of one exported trace, read once."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out, prog = Trace(), ProgramTrace()
    for e in events:
        if "dur" not in e:
            continue
        name, cat = e.get("name", ""), e.get("cat")
        a = float(e["ts"])
        b = a + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat == "kernel":
            out.kernels.append((name, a, b))
            prog.kernels.append((name, a, b, corr))
        elif name.startswith(SPAN_PREFIX):
            out.spans.append((name, a, b))
        if cat in COPIES:
            prog.copies.append((a, b))
        elif cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
            prog.spans.append((name[len(PROGRAM_PREFIX):], a, b))
        elif cat in ("cuda_runtime", "cuda_driver") and name.startswith(LAUNCHES) \
                and corr is not None:
            prog.launches[corr] = (name, a, b)
    return out, prog


def innermost(spans: Sequence[Tuple[str, float, float]], times: Sequence[float]) -> List[str]:
    """The name of the innermost span that holds each of ``times`` (`NONE`
    where none does), in one sweep; spans that nest, as one thread's do."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    ranked = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [NONE] * len(times)
    stack: List[Tuple[str, float, float]] = []
    k = 0
    for i in order:
        t = times[i]
        while k < len(ranked) and ranked[k][1] <= t:
            while stack and stack[-1][2] < ranked[k][1]:
                stack.pop()
            stack.append(ranked[k])
            k += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][0]
    return out


def _minus(gap: Interval, cover: List[Interval], starts: List[float]) -> Tuple[float, list]:
    """(µs of ``gap`` that the merged, sorted ``cover`` holds, the pieces of
    ``gap`` outside it)."""
    a, b = gap
    covered, pieces, at = 0.0, [], a
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(cover) and cover[i][0] < b:
        c0, c1 = max(cover[i][0], a), min(cover[i][1], b)
        if c1 > c0:
            if c0 > at:
                pieces.append((at, c0))
            covered += c1 - c0
            at = max(at, c1)
        i += 1
    if b > at:
        pieces.append((at, b))
    return covered, pieces


def _add(d: Dict[str, float], key: str, s: float) -> None:
    d[key] = d.get(key, 0.0) + s


def idle_split(t: Trace, p: ProgramTrace) -> dict:
    """The slice's idle seconds as ``copy``, ``queued``, ``host`` (by span)
    and ``host_in_launch`` (a part of ``host``), and the gaps (µs)
    themselves, under ``gaps``."""
    gaps = idle_gaps(t)
    copies = [tuple(c) for c in union(p.copies)]
    cstarts = [c[0] for c in copies]
    # the kernel that ends each gap, and when its launch began
    by_start = sorted(p.kernels, key=lambda k: k[1])
    kstarts = [k[1] for k in by_start]
    copy_s = queued_s = in_launch_s = 0.0
    host_pieces = []
    for a, b in gaps:
        covered, pieces = _minus((a, b), copies, cstarts)
        copy_s += covered
        j = bisect.bisect_left(kstarts, b)
        nxt = by_start[j] if j < len(by_start) else None
        launch = p.launches.get(nxt[3]) if nxt is not None else None
        if launch is not None and launch[2] <= a:
            queued_s += sum(y - x for x, y in pieces)
        else:
            host_pieces += pieces
            if launch is not None and launch[1] <= a:
                in_launch_s += sum(y - x for x, y in pieces)
    labels = innermost(p.spans, [0.5 * (x + y) for x, y in host_pieces])
    host: Dict[str, float] = {}
    for (x, y), label in zip(host_pieces, labels):
        _add(host, label, 1e-6 * (y - x))
    return {"copy": 1e-6 * copy_s, "queued": 1e-6 * queued_s,
            "host": dict(sorted(host.items(), key=lambda kv: -kv[1])),
            "host_in_launch": 1e-6 * in_launch_s, "gaps": gaps}


def device_by_span(t: Trace, p: ProgramTrace, top: int = 5) -> dict:
    """The slice's kernels by the innermost span around their launch:
    ``seconds`` and ``kernels`` (their count) a span, each span's ``top``
    kernels by seconds (``ops``, names cut as in `breakdown`), and the
    share of kernel time whose launch was found (``found``)."""
    w0, w1 = t.window
    clipped = [(n, max(a, w0), min(b, w1), c) for n, a, b, c in p.kernels if b > w0 and a < w1]
    launched = [(n, a, b, p.launches[c]) for n, a, b, c in clipped if c in p.launches]
    labels = innermost(p.spans, [launch[1] for *_, launch in launched])
    seconds: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    ops: Dict[str, Dict[str, float]] = {}
    for (n, a, b, _), label in zip(launched, labels):
        _add(seconds, label, 1e-6 * (b - a))
        _add(kernels, label, 1)
        _add(ops.setdefault(label, {}), n[:NAME_CHARS], 1e-6 * (b - a))
    total = sum(b - a for _, a, b, _ in clipped)
    found = sum(b - a for _, a, b, _ in launched)
    order = sorted(seconds, key=lambda k: -seconds[k])
    return {"seconds": {k: seconds[k] for k in order},
            "kernels": {k: int(kernels[k]) for k in order},
            "ops": {k: [[n, s] for n, s in sorted(ops[k].items(), key=lambda kv: -kv[1])[:top]]
                    for k in order},
            "found": found / total if total else 0.0}


def launches_by_span(t: Trace, p: ProgramTrace) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(the host's seconds inside the slice's launch calls, their count),
    by the innermost span around each call's start."""
    w0, w1 = t.window
    calls = [(a, b) for _, a, b in p.launches.values() if w0 <= a < w1]
    seconds: Dict[str, float] = {}
    count: Dict[str, float] = {}
    for (a, b), label in zip(calls, innermost(p.spans, [a for a, _ in calls])):
        _add(seconds, label, 1e-6 * (b - a))
        _add(count, label, 1)
    order = sorted(seconds, key=lambda k: -seconds[k])
    return {k: seconds[k] for k in order}, {k: int(count[k]) for k in order}


def inside(intervals: List[Interval], spans: List[Interval]) -> float:
    """µs of ``intervals`` (disjoint) that lie inside ``spans``."""
    cover = [tuple(s) for s in union(spans)]
    starts = [c[0] for c in cover]
    return sum(_minus(i, cover, starts)[0] for i in intervals)


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def program_block(t: Trace, p: ProgramTrace, window: Dict[str, int],
                  slice_counts: Dict[str, int]) -> dict:
    """The ``program`` block: the window's counters (``window``, the
    engine's counters' change over it), the slice's idle seconds by class
    and by span, the device seconds, kernels and top kernels by launching
    span, the share of kernel time whose launch was found, the host's
    seconds in launch calls and their count by span, and the slice's
    counters."""
    split = idle_split(t, p)
    dev = device_by_span(t, p)
    launch_s, launches = launches_by_span(t, p)
    idle = sum(b - a for a, b in split["gaps"]) * 1e-6
    return {"counters": window, "slice_counters": slice_counts,
            "idle_s": {"total": idle, "copy": split["copy"], "queued": split["queued"],
                       "host": sum(split["host"].values()), "host_by_span": split["host"],
                       "host_in_launch": split["host_in_launch"]},
            "device_s_by_span": dev["seconds"], "kernels_by_span": dev["kernels"],
            "device_ops_by_span": dev["ops"], "launch_found_pct": 100.0 * dev["found"],
            "launch_s_by_span": launch_s, "launches_by_span": launches}


def _slice_spans(t: Trace, p: ProgramTrace, name: str) -> List[Interval]:
    w0, w1 = t.window
    return [(max(a, w0), min(b, w1)) for n, a, b in p.spans if n == name and b > w0 and a < w1]


def decode_idle_us_per_step(t, p, window, slice_counts) -> Optional[float]:
    """No-kernel µs inside the slice's ``engine.generate`` spans over the
    ``decode.step`` spans inside them."""
    gen = _slice_spans(t, p, "engine.generate")
    steps = [s for s in _slice_spans(t, p, "decode.step")
             if any(a <= s[0] and s[1] <= b for a, b in gen)]
    if not steps:
        return None
    return inside(idle_gaps(t), gen) / len(steps)


def admit_idle_ms_per_frame(t, p, window, slice_counts) -> Optional[float]:
    """No-kernel ms inside the slice's ``engine.admit`` spans over the
    frames that those admissions encoded (the slice's ``frames_admitted``)."""
    admits = _slice_spans(t, p, "engine.admit")
    frames = slice_counts.get("frames_admitted", 0)
    if not admits or not frames:
        return None
    return 1e-3 * inside(idle_gaps(t), admits) / frames


def queued_idle_pct(t, p, window, slice_counts) -> Optional[float]:
    """The queued class over the slice's length: the part of `idle_pct`
    that no change on the host can remove."""
    if not p.spans or not t.window_s():
        return None
    return 100.0 * idle_split(t, p)["queued"] / t.window_s()


def decode_live_rows_pct(t, p, window, slice_counts) -> Optional[float]:
    """The window's ``decode_rows_live`` over ``decode_rows_run``."""
    run = window.get("decode_rows_run", 0)
    return 100.0 * window["decode_rows_live"] / run if run else None


def dispatch_live_rows_pct(t, p, window, slice_counts) -> Optional[float]:
    """The window's ``dispatch_rows_live`` over ``dispatch_rows_run``."""
    run = window.get("dispatch_rows_run", 0)
    return 100.0 * window["dispatch_rows_live"] / run if run else None


READINGS: Dict[str, Callable] = {f.__name__: f for f in (
    decode_idle_us_per_step, admit_idle_ms_per_frame, queued_idle_pct,
    decode_live_rows_pct, dispatch_live_rows_pct)}
