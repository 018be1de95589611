"""Reading a `torch.profiler` trace: the device's kernel intervals, the
harness's spans, busy and idle time, and the breakdown.

`kernel_intervals` and `union` are frozen copies of `chip_smoke.py`'s
`_kernel_intervals` and `_union` at commit 71a961d, kept here so that a
change to the program cannot move the yardstick; `kernel_intervals` keeps
each kernel's name and returns the harness's spans (``bench.*``) beside
the kernels.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.slice"
NAME_CHARS = 120  # a kernel's name in the breakdown: templated names run to thousands


@dataclass
class Trace:
    """Kernels ``(name, start µs, end µs)`` and the harness's spans ``(name,
    start µs, end µs)`` of one profiled slice, on the profiler's clock."""

    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window(self) -> Tuple[float, float]:
        for name, a, b in self.spans:
            if name == WINDOW_SPAN:
                return a, b
        raise ValueError("the trace has no slice span")

    def clipped(self) -> List[Tuple[str, float, float]]:
        """The kernels cut to the slice."""
        w0, w1 = self.window
        return [(n, max(a, w0), min(b, w1)) for n, a, b in self.kernels if b > w0 and a < w1]

    def device_s(self, patterns: Sequence[str]) -> float:
        """Seconds of the slice's kernels whose names hold one of
        ``patterns``."""
        return 1e-6 * sum(b - a for n, a, b in self.clipped() if any(p in n for p in patterns))

    def busy_s(self) -> float:
        """Seconds of the slice in which some kernel ran."""
        return 1e-6 * sum(b - a for a, b in union((a, b) for _, a, b in self.clipped()))

    def window_s(self) -> float:
        w0, w1 = self.window
        return 1e-6 * (w1 - w0)


def kernel_intervals(trace_path: str) -> Trace:
    """The kernels (``cat`` "kernel") and the ``bench.*`` spans of a
    Chrome trace that `torch.profiler` exported."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = Trace()
    for e in events:
        if "dur" not in e:
            continue
        span = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "kernel":
            out.kernels.append(span)
        elif span[0].startswith(SPAN_PREFIX):
            out.spans.append(span)
    return out


def union(spans, gap: float = 0.0) -> list:
    """The intervals merged where they overlap or lie within ``gap`` µs."""
    merged = []
    for a, b, *_ in sorted(spans):
        if merged and a <= merged[-1][1] + gap:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_gaps(t: Trace) -> List[Tuple[float, float]]:
    """The slice's intervals (µs) in which no kernel ran."""
    w0, w1 = t.window
    gaps, at = [], w0
    for a, b in union((a, b) for _, a, b in t.clipped()):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    return gaps


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by what
    the host was doing: the innermost harness span around each idle
    interval's middle ("host" where none is)."""
    by_op: Dict[str, float] = {}
    for name, a, b in t.clipped():
        by_op[name] = by_op.get(name, 0.0) + 1e-6 * (b - a)
    spans = [s for s in t.spans if s[0] != WINDOW_SPAN]
    by_host: Dict[str, float] = {}
    for a, b in idle_gaps(t):
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        label = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "host"
        by_host[label] = by_host.get(label, 0.0) + 1e-6 * (b - a)
    ops = [(n[:NAME_CHARS], s) for n, s in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
