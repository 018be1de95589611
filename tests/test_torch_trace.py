"""The serving path's spans (`mmduet_tpu_torch.trace`) and the batched
engine's counters (`BatchedStreamEngine.counters()`), on the tiny model on
the CPU.

Under `torch.profiler` with CPU activity, `serve()` and `prewarm()` leave
every span of the engine, the tower and the decode loop in the exported
Chrome trace, each inside the span that calls it; the span counts equal
the counters, and the counters add up to what `serve()` returned. With
no profiler running no span enters `record_function`. The graph route's
``graphs.capture`` and the kernels' ``ops.build`` run on a card only, as
do the tower's fused passes that ``vision_fused_launches`` counts (the
`cuda`-marked test, which runs on the card with
``python -m pytest --noconftest tests/test_torch_trace.py -m cuda``)."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmduet_tpu_torch.config import TestArgs as ServeArgs, tiny_config
from mmduet_tpu_torch.infer import BatchedStreamEngine
from mmduet_tpu_torch.models.params import init_mmduet_params
from mmduet_tpu_torch.ops import vision_fused
from mmduet_tpu_torch.stream import CharTokenizer

TOK = CharTokenizer(frame_num_tokens=4)
CFG = tiny_config().replace(v_placeholder_id=TOK.v_placeholder_id,
                            eos_token_id=TOK.eos_token_id)
LENGTHS = (9, 14, 6)  # frames of each session; two lanes, so the third is admitted later

# each span's caller: the innermost `mmduet.*` span around it (None: none)
SERVE_PARENTS = {
    "engine.admit": {None},
    "vision.upload": {"engine.admit"},
    "vision.encode": {"engine.admit"},
    "engine.frames_write": {"engine.admit"},
    "engine.round": {None},
    "engine.dispatch": {"engine.round"},
    "engine.assemble": {"engine.dispatch"},
    "model.forward": {"engine.dispatch", "decode.prefill"},
    "engine.scores_read": {"engine.dispatch"},
    "engine.policy": {"engine.round"},
    "engine.generate": {"engine.round"},
    "decode.prefill": {"engine.generate"},
    "decode.start": {"engine.generate"},
    "decode.flag_read": {"engine.generate"},
    "decode.step": {"engine.generate"},
    "decode.commit": {"engine.generate"},
    "engine.tokens_read": {"engine.generate"},
    "engine.detokenize": {"engine.generate"},
}


@pytest.fixture(scope="module")
def engine():
    params = init_mmduet_params(CFG, torch.Generator().manual_seed(0), "cpu")
    args = ServeArgs(system_prompt="sys", frame_fps=1.0, max_num_frames=16, max_new_tokens=4,
                     stream_end_score_sum_threshold=1.2, remove_assistant_turns=True)
    return BatchedStreamEngine(params, CFG, TOK, args, n_streams=2, block_frames=4,
                               kv_cache_size=1024)


def sessions():
    r = np.random.RandomState(0)
    return [{"frames": r.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8), "fps": 1.0,
             "conversation": [{"role": "user", "content": "what?", "time": 0.0}]}
            for n in LENGTHS]


def traced(fn, tmp_path, spy):
    """(fn's result, the trace's `mmduet.*` spans as (name, start, end),
    the ``(name, args)`` each span passed to `record_function`)."""
    calls = []
    real = torch.profiler.record_function

    def record(name, args=None):
        calls.append((name, args))
        return real(name, args)

    spy.setattr(torch.profiler, "record_function", record)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"][len("mmduet."):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("mmduet.")]
    return out, spans, calls


def parents(spans):
    """Each span's name beside the innermost other span that holds it."""
    out = []
    for i, (name, a, b) in enumerate(spans):
        around = [s for j, s in enumerate(spans) if j != i and s[1] <= a and b <= s[2]]
        inner = min(around, key=lambda s: s[2] - s[1]) if around else None
        out.append((name, inner[0] if inner else None))
    return out


def count(spans, name):
    return sum(s[0] == name for s in spans)


def test_serve_spans_nest_and_equal_the_counters(engine, tmp_path, monkeypatch):
    engine.reset()
    served, spans, calls = traced(lambda: list(engine.serve(sessions())), tmp_path, monkeypatch)
    got = {name for name, _, _ in spans}
    assert got == set(SERVE_PARENTS), got ^ set(SERVE_PARENTS)
    for name, parent in parents(spans):
        assert parent in SERVE_PARENTS[name], (name, parent)
    admits = sorted(args for name, args in calls if name == "mmduet.engine.admit")
    assert admits == ["session=0 lane=0", "session=1 lane=1", "session=2 lane=0"], admits

    c = engine.counters()
    assert count(spans, "engine.dispatch") == c["dispatches"] > 0
    assert count(spans, "decode.flag_read") == c["flag_reads"] > 0
    assert count(spans, "decode.step") == c["decode_steps"] > 0
    assert count(spans, "engine.generate") == c["decodes"]
    assert count(spans, "engine.admit") == c["admissions"] == len(LENGTHS)
    assert count(spans, "vision.encode") == c["vision_batches"] == len(LENGTHS)
    assert c["frames_admitted"] == sum(LENGTHS)
    scored = sum(len(debug) for _, _, debug in served)
    assert scored == sum(LENGTHS)
    assert c["frames_rolled_back"] > 0
    assert c["frames_fed"] - c["frames_rolled_back"] == scored
    assert c["decode_rows_live"] == c["tokens_generated"] > 0
    assert c["decode_rows_live"] <= c["decode_rows_run"]
    assert 0 < c["dispatch_rows_live"] <= c["dispatch_rows_run"]
    assert c["graph_replays"] == c["graph_captures"] == 0  # the CPU runs the eager route


def test_prewarm_spans(engine, tmp_path, monkeypatch):
    _, spans, _ = traced(lambda: engine.prewarm(vision=True), tmp_path, monkeypatch)
    under = {name for name, parent in parents(spans) if parent == "engine.prewarm"}
    assert {"model.forward", "engine.generate", "vision.upload", "vision.encode"} <= under
    assert count(spans, "engine.prewarm") == 1
    assert engine.counters()["dispatches"] == 0  # prewarm resets the engine


def test_no_record_function_without_a_profiler(engine, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    engine.reset()
    served = list(engine.serve(sessions()))
    assert len(served) == len(LENGTHS) and engine.counters()["decodes"] > 0


def test_vision_fused_launches_is_zero_on_the_cpu(engine):
    engine.reset()
    before = vision_fused.LAUNCHES
    served = list(engine.serve(sessions()))
    c = engine.counters()
    assert len(served) == len(LENGTHS) and c["vision_batches"] == len(LENGTHS)
    assert c["vision_fused_launches"] == 0 == vision_fused.LAUNCHES - before


@pytest.mark.cuda
def test_vision_fused_launches_counts_every_pass_of_a_served_run_on_the_card():
    """On the card every tower batch of `_admit` runs the fused passes: 4 a
    layer and the first layer's LN1, so the counter is ``vision_batches x
    (4 x layers + 1)`` (a layer that fell back to the eager chain would
    leave it short), counted since the engine's `reset()`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused passes have no CPU mode")
    dev = torch.device("cuda")
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
    args = ServeArgs(frame_fps=1.0, max_num_frames=40, max_new_tokens=4,
                     stream_end_score_sum_threshold=1.2)
    engine = BatchedStreamEngine(params, cfg, CharTokenizer(frame_num_tokens=cfg.frame_num_tokens),
                                 args, n_streams=2, block_frames=4)
    engine.prewarm(vision=True)  # the tower's launches here come before the reset
    engine.reset()
    r = np.random.RandomState(1)
    runs = [{"frames": r.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8), "fps": 1.0,
             "conversation": [{"role": "user", "content": "what?", "time": 0.0}]}
            for n in (9, 40, 33)]  # one batch, two full batches of 32 and a tail
    served = list(engine.serve(runs))
    torch.cuda.synchronize()
    c = engine.counters()
    layers = cfg.vision.num_layers - 1  # features at layer -2
    assert len(served) == len(runs) and c["vision_batches"] == 1 + 2 + 2
    assert c["vision_fused_launches"] == c["vision_batches"] * (4 * layers + 1)
    engine.reset()
    assert engine.counters()["vision_fused_launches"] == 0
