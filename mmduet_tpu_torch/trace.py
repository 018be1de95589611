"""The serving path's spans in `torch.profiler`'s trace.

``with span("engine.dispatch"):`` enters
``torch.profiler.record_function("mmduet.engine.dispatch", args)`` while a
profiler records, and otherwise returns one shared null context and does
nothing else: with no profiler running a span costs one check of the
profiler's state (about 0.1 µs on the CPU), where an unguarded
`record_function` costs about 10 µs. The spans go into the profiler's own
trace, on the clock that it shares with the card's kernels, so that each
gap between kernels can be put down to what the host was doing.

A span wraps a call site on the host, never the inside of a body that a
CUDA graph captures: the graph would record it once, at capture.

Keyword arguments (an admission's session and lane, a decode's lanes)
become the string that `record_function` takes beside the name,
formatted only while a profiler records; torch's Chrome export keeps a
span's name and times, not that string. The spans and the counters
beside them (`BatchedStreamEngine.counters()`) are listed in
``README.md``'s section on tracing.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "mmduet."
_OFF = contextlib.nullcontext()


def span(name: str, **args):
    """The context of the span ``mmduet.<name>``: a `record_function`
    while a profiler records, else a shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    text = " ".join(f"{k}={v}" for k, v in args.items()) if args else None
    return torch.profiler.record_function(PREFIX + name, text)
