"""What one run recorded, as the per-layer metric readers
(``benchmark/metrics/<name>.py``) read it.

The harness keeps it from its own spans around the calls into each layer
of the engine (`benchmark.harness.Recorder`), from the engine's counters
and from the profiler's trace of a slice of the window. Each device call
of the window is one `Call`, with the shapes its work needs, so that a
reader counts operations and bytes from shapes and never from the
launches that carried them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import ModuleType
from typing import List, Optional, Tuple

from .model_shapes import Shapes
from .trace import Trace


@dataclass
class Call:
    """One device call of the window.

    ``kind``: "dispatch" (a batched chunk forward of `_dispatch_sched`),
    "prefill" (a batched decode's prompt) or "step" (one greedy step of it),
    each with ``lanes``, the (cache_len, tokens) of every lane the traffic
    fed, and ``lm_rows``, the rows whose logits are read; or "encode" (the
    tower's work of one admission) with ``frames``. ``seconds``: the
    harness's clock around the call (a batched decode's on its "prefill";
    an admission's ends in a sync only inside the traced slice).
    ``in_slice``: the call ran while the profiler traced."""

    kind: str
    lanes: List[Tuple[int, int]] = field(default_factory=list)
    lm_rows: int = 0
    scored: int = 0
    frames: int = 0
    seconds: float = 0.0
    in_slice: bool = False


@dataclass
class Run:
    """What a run recorded. ``arch``: the configuration's architecture
    (`benchmark.spec.architecture`), whose operation counts read ``shapes``.
    In a traced run the profiler starts ``slice_start_s`` into the window;
    the calls before it ran as in an untraced run, with no sync and no
    profiler."""

    shapes: Shapes
    arch: ModuleType
    window_s: float = 0.0
    frames_scored: int = 0  # frames whose scores the engine returned
    frames_fed: int = 0  # frames fed to the decoder, rolled-back ones each time
    frames_admitted: int = 0
    admissions: int = 0
    rounds: int = 0
    calls: List[Call] = field(default_factory=list)
    slice_start_s: Optional[float] = None
    trace: Optional[Trace] = None

    def sliced(self) -> List[Call]:
        return [c for c in self.calls if c.in_slice]

    def unsliced(self) -> List[Call]:
        return [c for c in self.calls if not c.in_slice]

    def untraced_s(self) -> float:
        """The seconds of the window before the traced slice."""
        return self.window_s if self.slice_start_s is None else self.slice_start_s
