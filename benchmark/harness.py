"""One run of a cell: set-up, the measured window through
`BatchedStreamEngine.serve()`, the check against the reference, the
result line.

Set-up finds the configuration's decoder architecture and its reference
by name (`benchmark.spec.architecture`, `benchmark.spec.reference`), makes
the weights of the architecture's leaves on the device from the
configuration's seed (int4-quantized on the device where the configuration
says so), the traffic's videos, the engine as the serving CLI makes it for
``--batch_streams`` (the graph route), and warms every shape the traffic
uses: `prewarm(vision=True, generate=True)`, and what it leaves
cold (a decode of fewer than all lanes, whose prompt's graph takes a
commit mask; the tower's batch at each session length's remainder). The
window then serves sessions from an endless generator, with continuous
admission, for ``--seconds``; it ends after the round in which that time
passes.

The harness's spans (`Recorder`) wrap the engine's calls into its layers:
each round, each batched dispatch (it ends in the host's read of the
probabilities), each batched decode (it ends in the host's read of the
tokens) and each admission (the tower; inside the traced slice followed by
a sync). With ``--trace 1`` the window's last rounds run under
`torch.profiler`, and the spans are named ``bench.*`` in its trace.

The spans hook the engine's own methods. A hook that is missing or never
fired while frames were scored, and a per-layer metric of the cell that
reads nothing, fail the run (`HookError`), so that a change to the engine
cannot silence the yardstick.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import spec as specs
from . import traffic, weights
from .model_shapes import Shapes
from .record import Call, Run
from .reference import check
from .trace import WINDOW_SPAN, breakdown, kernel_intervals

SLICE_SHARE = 0.25  # the traced slice: the window's last rounds, from this share of it before
# its end; the profiler stops after the window has closed


HOOKED = ("_dispatch_sched", "_generate_batch", "_admit", "_run_round")
STALL_S = 60.0  # past the window by this much with no round ended: the round hook is bypassed


class WindowClosed(Exception):
    pass


class HookError(RuntimeError):
    """The harness's spans did not see the work: the run has no result."""


def serving_args(mix: dict):
    from mmduet_tpu_torch.config import TestArgs

    return TestArgs(
        frame_fps=mix["frame_fps"], max_num_frames=mix["max_num_frames"],
        grounding_mode=mix["mode"] == "grounding",
        stream_end_score_sum_threshold=mix.get("stream_end_score_sum_threshold"),
        stream_end_prob_threshold=mix.get("stream_end_prob_threshold"),
        score_heads=mix["score_heads"], remove_assistant_turns=mix["remove_assistant_turns"],
        repetition_penalty=mix.get("repetition_penalty"), max_new_tokens=mix["max_new_tokens"],
    )


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value that at
    least q % of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


class Recorder:
    """The harness's spans and counts around the engine's calls (instance
    attributes that wrap its bound methods)."""

    def __init__(self, engine, tok, s: Shapes, arch, seconds: float, trace: bool,
                 sync: Callable):
        self.engine, self.tok, self.s = engine, tok, s
        self.seconds, self.trace, self.sync = seconds, trace, sync
        self.run = Run(s, arch)
        self.answers: List[check.Answer] = []
        self.lanes: Dict[int, int] = {}  # session -> lane
        self.profiling = False
        self.prof = None
        self._slice_span = None
        self._decoded: List[List[int]] = []
        self._last_dispatch_end = 0.0
        self.t0 = self.t_end = 0.0

    def span(self, name: str):
        if self.trace:
            return torch.profiler.record_function(f"bench.{name}")
        return contextlib.nullcontext()

    def install(self) -> None:
        e, tok = self.engine, self.tok
        missing = [n for n in HOOKED if not hasattr(type(e), n)]
        if missing or not callable(getattr(tok, "decode", None)):
            raise HookError(f"the engine has no {missing or ['tokenizer.decode']}: the "
                            "harness's spans hook these")
        dispatch, generate = e._dispatch_sched, e._generate_batch
        admit, run_round, decode = e._admit, e._run_round, tok.decode
        ft = self.s.frame_tokens

        def decode_hook(ids, *a, **k):
            self._decoded.append([int(t) for t in ids])
            return decode(ids, *a, **k)

        def dispatch_hook(chunks):
            cur = e._cur.copy()
            t0 = time.perf_counter()
            with self.span("dispatch"):
                out = dispatch(chunks)
            t1 = time.perf_counter()
            if not self.run.rounds and t1 - self.t0 > self.seconds + STALL_S:
                raise HookError("no round ended in the window: _run_round is not called")
            self._last_dispatch_end = t1
            fed = sum(c[2] for c in chunks.values())
            self.run.frames_fed += fed
            lanes = [(int(cur[b]), len(ids) + n * ft) for b, (ids, _, n) in chunks.items()]
            self.run.calls.append(Call("dispatch", lanes, scored=fed, seconds=t1 - t0,
                                       in_slice=self.profiling))
            return out

        def generate_hook(lanes, eos_id=None):
            cur = e._cur.copy()
            frames = {b: len(e.debug_data_lists[b]) - 1 for b in lanes}
            owner = {b: e._lane_sess[b] for b in lanes}
            self._decoded = []
            t0 = time.perf_counter()
            with self.span("generate"):
                out = generate(lanes, eos_id)
            t1 = time.perf_counter()
            if len(self._decoded) != len(lanes):
                raise HookError(f"{len(lanes)} lanes decoded, {len(self._decoded)} answers "
                                "through tokenizer.decode")
            t = len(e._gen_prompt_ids)
            lengths = []
            for b, toks in zip(lanes, self._decoded):
                self.answers.append(check.Answer(owner[b], frames[b], int(cur[b]), toks,
                                                 t1 - self._last_dispatch_end, b))
                lengths.append((b, len(toks)))
            sl = self.profiling
            self.run.calls.append(Call("prefill", [(int(cur[b]), t) for b, _ in lengths],
                                       lm_rows=len(lengths), seconds=t1 - t0, in_slice=sl))
            for k in range(1, max((n for _, n in lengths), default=0)):
                live = [(int(cur[b]) + t + k - 1, 1) for b, n in lengths if n > k]
                self.run.calls.append(Call("step", live, lm_rows=len(live), in_slice=sl))
            return out

        def admit_hook(lane, sess):
            t0 = time.perf_counter()
            with self.span("admit"):
                admit(lane, sess)
                if self.profiling:
                    self.sync()
            T = len(sess["frames"])
            self.run.frames_admitted += T
            self.run.admissions += 1
            self.run.calls.append(Call("encode", frames=T, seconds=time.perf_counter() - t0,
                                       in_slice=self.profiling))

        def round_hook(live):
            before = sum(len(e.debug_data_lists[b]) for b in live)
            for b in live:
                self.lanes[e._lane_sess[b]] = b
            with self.span("round"):
                run_round(live)
            self.run.frames_scored += sum(len(e.debug_data_lists[b]) for b in live) - before
            self.run.rounds += 1
            now = time.perf_counter()
            self._profile_at(now)
            if now - self.t0 >= self.seconds:
                self.t_end = now
                raise WindowClosed

        e._dispatch_sched, e._generate_batch = dispatch_hook, generate_hook
        e._admit, e._run_round = admit_hook, round_hook
        tok.decode = decode_hook

    def check_fired(self, pulled: int, generation: bool) -> None:
        """Raises `HookError` where a hook never fired while the window
        scored frames: every pulled session admitted through `_admit`, every
        frame scored fed through `_dispatch_sched`, and in generation mode
        some answer through `_generate_batch`."""
        run = self.run
        silent = []
        if not run.rounds or not run.frames_scored:
            silent.append("_run_round")
        if run.frames_fed < run.frames_scored:
            silent.append("_dispatch_sched")
        if run.admissions != pulled:
            silent.append("_admit")
        if generation and not self.answers:
            silent.append("_generate_batch")
        if silent:
            raise HookError(f"{silent} did not see the window's work ({run.frames_scored} "
                            f"frames scored, {run.frames_fed} fed, {run.admissions} of "
                            f"{pulled} sessions admitted, {len(self.answers)} answers)")

    def _profile_at(self, now: float) -> None:
        """Starts the profiler at the end of the first round that ends in
        the window's last SLICE_SHARE."""
        if self.trace and self.prof is None and now - self.t0 >= (1 - SLICE_SHARE) * self.seconds:
            from torch.profiler import ProfilerActivity, profile

            self.sync()
            self.run.slice_start_s = time.perf_counter() - self.t0
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self._slice_span = torch.profiler.record_function(WINDOW_SPAN)
            self._slice_span.__enter__()
            self.profiling = True

    def stop_profile(self) -> None:
        if self.profiling:
            self.sync()
            self._slice_span.__exit__(None, None, None)
            self.prof.stop()
            self.profiling = False


def warm_profiler(device) -> None:
    """Pays the profiler's first start (CUPTI's set-up) before the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def warm_cold_shapes(engine, mix: dict, device) -> None:
    """What `prewarm` leaves cold that this traffic uses: in generation
    mode a decode of fewer than all lanes (its prompt's graph takes a
    commit mask), and the tower's batch at each session length's
    remainder."""
    from mmduet_tpu_torch.infer.batch_engine import VISION_BATCH
    from mmduet_tpu_torch.infer.state import staged_visual_encode

    if mix["mode"] == "generation":
        engine._cur[:] = 0
        engine._generate_batch([0], -1)
        engine.reset()
    R = mix["resolution"]
    for n in sorted({n % VISION_BATCH for n in traffic.lengths(mix)} - {0}):
        staged_visual_encode(engine._visual, np.zeros((n, R, R, 3), np.uint8), device,
                             VISION_BATCH)


def build(arch, s: Shapes, device):
    """(port config, served weights, tokenizer) of architecture ``arch``."""
    from mmduet_tpu_torch.models.quant import quantize_params
    from mmduet_tpu_torch.stream import CharTokenizer

    params = weights.make(arch.leaves(s), s.weights_seed, device)
    if s.weight_bits == 4:
        params = quantize_params(params, bits=4, donate=True)
    elif s.weight_bits is not None:
        raise ValueError(f"weight_bits {s.weight_bits}: the benchmark serves bf16 or int4")
    tok = CharTokenizer(frame_num_tokens=s.frame_tokens, vocab_size=s.vocab)
    cfg = arch.port_config(s).replace(v_placeholder_id=tok.v_placeholder_id,
                                      eos_token_id=tok.eos_token_id)
    return cfg, params, tok


def serve_window(cfg_file: dict, mix: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float, root=specs.ROOT,
                 faults: Optional[Callable] = None) -> dict:
    """Set-up and the window. Returns what the check and the result need;
    ``faults`` (tests only) breaks the engine before the window."""
    from mmduet_tpu_torch.infer import BatchedStreamEngine

    check.supported(mix)
    arch = specs.architecture(cfg_file, root)
    ref = specs.reference(cfg_file, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    s = arch.shapes(cfg_file)
    cfg, params, tok = build(arch, s, dev)
    pixels = traffic.pixel_pool(mix, dev)
    sync()
    if cuda:  # the peak from here on: the weights as served, and the engine
        torch.cuda.reset_peak_memory_stats(dev)
    engine = BatchedStreamEngine(
        params, cfg, tok, serving_args(mix), n_streams=mix["lanes"],
        block_frames=mix["block_frames"], gen_coalesce_rounds=mix["gen_coalesce_rounds"],
        kv_cache_quant=s.kv_quant)
    engine.prewarm(vision=True, generate=mix["mode"] == "generation")
    warm_cold_shapes(engine, mix, dev)
    if trace and cuda:
        warm_profiler(dev)
    sync()
    if faults is not None:
        faults(engine)
    graphs_before = len(engine._graphs) if engine._graphs is not None else 0
    rec = Recorder(engine, tok, s, arch, seconds, trace, sync)
    rec.install()
    sessions: Dict[int, traffic.Session] = {}

    def offered():
        for sess in traffic.sessions(mix, seed):
            sessions[sess.index] = sess
            yield {"frames": pixels[sess.video, :sess.frames], "fps": mix["frame_fps"],
                   "conversation": [{"role": "user", "content": sess.query,
                                     "time": mix["query_time"]}]}

    scores: Dict[int, list] = {}
    retired = set()
    rec.t0 = time.perf_counter()
    try:
        for idx, _, debug in engine.serve(offered()):
            scores[idx] = debug
            retired.add(idx)
    except WindowClosed:
        pass
    window_s = rec.t_end - rec.t0
    rec.stop_profile()
    sync()
    rec.check_fired(len(sessions), mix["mode"] == "generation")
    rec.run.window_s = window_s
    for b, idx in enumerate(engine._lane_sess):
        if idx is not None:
            scores[idx] = list(engine.debug_data_lists[b])
    out = dict(
        shapes=s, arch=arch, reference=ref, run=rec.run, answers=rec.answers,
        setup_s=rec.t0 - t_start,
        window_s=window_s, peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
        captures=(len(engine._graphs) - graphs_before) if engine._graphs is not None else 0,
        served=check.Served(sessions={i: sessions[i] for i in scores}, scores=scores,
                            retired=retired, answers=rec.answers, pixels=pixels, mix=mix,
                            eos_id=tok.eos_token_id, frame_tokens=s.frame_tokens,
                            lanes=rec.lanes),
        prof=rec.prof,
    )
    del engine, params, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def reference_check(out: dict, seed: int, device, with_control: bool = False):
    """(the check's numbers, the control's or None) of `serve_window`'s
    ``out``: protocol errors, the program's score and token gaps against the
    configuration's reference; the control's are those of the reference in
    the nearest lower precision put in the program's place, which keeps the
    program's protocol."""
    served, s, ref = out["served"], out["shapes"], out["reference"]
    numbers = {"protocol_errors": float(check.protocol_errors(served))}
    picked = check.pick(served, seed)
    w = weights.make(out["arch"].leaves(s), s.weights_seed, device)
    precisions = [ref.served(s)] + ([ref.control(s)] if with_control else [])
    readings = check.reference_readings(ref, served, s, w, precisions, picked, device)
    del w
    numbers.update(readings[0])
    numbers["sessions_checked"] = float(len(picked))
    numbers["answers_checked"] = float(sum(a.session in picked for a in served.answers))
    numbers["tokens_checked"] = float(sum(len(a.tokens) for a in served.answers
                                          if a.session in picked))
    control = dict(readings[1], protocol_errors=0.0) if with_control else None
    return numbers, control


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number passes at or under
    it."""
    return {k: {"value": numbers[k], "limit": float(lim), "ok": numbers[k] <= lim}
            for k, lim in limits.items()}


def read_trace(prof) -> "object":
    """The profiler's slice through a Chrome trace in a temporary directory
    (under ``TMPDIR``), deleted once read."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        out = kernel_intervals(path)
    print(f"trace: {len(out.kernels)} kernels, {len(out.spans)} spans, {size / 2 ** 20:.1f} MiB, "
          f"read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


def end_to_end(out: dict) -> Dict[str, float]:
    """Every end-to-end metric the harness knows, by name."""
    run = out["run"]
    lat = [1e3 * a.latency_s for a in out["answers"]]
    return {
        "frames_per_s": run.frames_scored / out["window_s"],
        "answer_ms_p95": percentile(lat, 95) if lat else float("nan"),
        "peak_gib": out["peak"] / 2 ** 30,
        "setup_s": out["setup_s"],
    }


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, root=specs.ROOT, faults: Optional[Callable] = None,
             with_control: bool = False) -> dict:
    """The result line of one run (the check's numbers under "checks",
    last). ``with_control`` (not in the benchmark's own runs): the control's
    numbers and whether they pass the same limits, under "window"."""
    cfg_file = specs.config_of(spec, cell["config"], root)
    mix = specs.traffic_of(cell["traffic"], root)
    out = serve_window(cfg_file, mix, seed, seconds, trace, device, t_start, root, faults)
    served = out["served"]
    numbers, control = reference_check(out, seed, device, with_control)
    limits = cfg_file["limits"]
    checks = judge(numbers, limits)
    checked = numbers["sessions_checked"] > 0 and (served.grounding
                                                    or numbers["answers_checked"] > 0)
    requests = list(served.scores) if served.grounding else out["answers"]
    result = {"correct": checked and all(c["ok"] for c in checks.values()),
              "attempted": len(requests),
              "failed": 0 if served.grounding else sum(not a.tokens for a in out["answers"])}
    dev = torch.device(device)
    if trace:
        run = out["run"]
        if out["prof"] is None:
            raise RuntimeError(f"the window ({out['window_s']:.1f} s) closed before its traced "
                               "slice began")
        run.trace = read_trace(out["prof"])
        metrics = {}
        for name in specs.metrics_of(spec, cell["name"], "per_layer"):
            value = specs.reader(name, root)(run)
            if value is None:
                # on the CPU no kernel runs, so a device trace has nothing to read
                if dev.type == "cuda" or specs.source_of(spec, name) != "device_trace":
                    raise HookError(f"{name}, a metric of {cell['name']}, read nothing")
                continue
            metrics[name] = {"value": value, "unit": specs.unit_of(spec, name)}
    else:
        known = end_to_end(out)
        metrics = {name: {"value": known[name], "unit": specs.unit_of(spec, name)}
                   for name in specs.metrics_of(spec, cell["name"], "end_to_end")}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": out["peak"]}
    if trace:
        result["device"]["busy_s"] = out["run"].trace.busy_s()
        result["device"]["window_s"] = out["run"].trace.window_s()
        result["breakdown"] = breakdown(out["run"].trace)
    result["window"] = {"seconds": out["window_s"], "rounds": out["run"].rounds,
                        "frames": out["run"].frames_scored, "answers": len(out["answers"]),
                        "captures_in_window": out["captures"],
                        **{k: v for k, v in numbers.items() if k not in checks}}
    if control is not None:
        result["window"]["control"] = control
        result["window"]["control_correct"] = all(
            c["ok"] for c in judge(control, limits).values())
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result
