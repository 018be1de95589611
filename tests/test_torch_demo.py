"""The port's demo surface (`mmduet_tpu_torch.demo`): `LiveInferForDemo`'s
single-frame contract against the JAX package's on the same numpy weights,
against the port's own `inference()` loop, and the stdlib demo server's
state loop, `/state` snapshots and pause / resume over a local HTTP server.

f32 on both sides: scores agree to 1e-4 (summation order only); responses,
trigger times and frame indices are equal."""

import dataclasses
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np

from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.demo.live import LiveInferForDemo as JaxDemo
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.demo.app import DemoState, make_handler
from mmduet_tpu_torch.demo.live import LiveInferForDemo
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models.io import config_from_dict

ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
TCFG = config_from_dict(dataclasses.asdict(CFG))
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
JP = jax_init(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")


def _args(**kw):
    base = dict(system_prompt="sys", frame_fps=2.0, stream_end_prob_threshold=0.5,
                max_new_tokens=4, max_num_frames=16)
    base.update(kw)
    return base


def make_demo(**kw):
    return LiveInferForDemo(TP, TCFG, TOK, PortInferArgs(**_args(**kw)),
                            kv_cache_size=512, block_frames=1)


def _frames(seed, n):
    return np.random.RandomState(seed).randint(0, 255, (n, 32, 32, 3), np.uint8)


def _step_all(demo, frames, query_after=None):
    """Every frame through `input_one_frame`, a query injected after frame
    ``query_after``; returns the rows."""
    demo.input_video_stream(frames)
    rows = []
    while True:
        if len(rows) == query_after:
            demo.encode_given_query("what now?")
            assert demo.last_role == "user"
        r = demo.input_one_frame()
        if r is None:
            return rows
        rows.append(r)


def test_frame_loop_with_mid_stream_query_matches_jax():
    frames = _frames(0, 7)
    jd = JaxDemo(JP, CFG, TOK, InferArgs(**_args(stream_end_prob_threshold=0.4)),
                 kv_cache_size=512, block_frames=1)
    td = make_demo(stream_end_prob_threshold=0.4)
    want, got = _step_all(jd, frames, 3), _step_all(td, frames, 3)
    assert [r["frame_idx"] for r in got] == list(range(1, 8))
    assert [(r["frame_idx"], r["time"], r["response"]) for r in got] == [
        (r["frame_idx"], r["time"], r["response"]) for r in want]
    assert any(r["response"] for r in got)
    for key in ("informative_score", "relevance_score"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   atol=ATOL, rtol=0)
    assert td.state.cursor == jd.state.cursor
    assert td.input_one_frame() is None


def test_frame_loop_matches_the_engine_inference_loop():
    """Frame-by-frame stepping gives the scores and trigger times of the
    port's own `inference()` over the same video."""
    frames = _frames(1, 6)
    demo = make_demo(stream_end_prob_threshold=0.4, remove_assistant_turns=True)
    rows = _step_all(demo, frames)
    eng = LiveInferEngine(TP, TCFG, TOK, PortInferArgs(**_args(
        stream_end_prob_threshold=0.4, remove_assistant_turns=True)),
        kv_cache_size=512, block_frames=1)
    eng.input_video_stream(frames)
    responses = eng.inference()
    np.testing.assert_allclose([r["informative_score"] for r in rows],
                               [d["informative_score"] for d in eng.debug_data_list],
                               atol=1e-5, rtol=0)
    assert [(r["time"], r["response"]) for r in rows if r["response"]] == [
        (t["time"], t["content"]) for t in responses if t["role"] == "assistant"]


def _get(port, path):
    return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                             timeout=10).read())


def test_state_snapshot_and_pause_resume_over_http():
    """`DemoState` streams in a thread paused before its first frame; the
    server's /state, /query, /resume and /pause drive it to the end with
    every frame scored once and the query answered into the chat."""
    demo = make_demo(grounding_mode=True, stream_end_prob_threshold=1.0)
    state = DemoState(demo, _frames(2, 6), fps=2.0, realtime=False)
    state.pause_event.clear()
    runner = threading.Thread(target=state.run, daemon=True)
    runner.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        port = srv.server_address[1]
        time.sleep(0.3)
        snap = _get(port, "/state")
        assert snap["paused"] and not snap["done"] and snap["informative"] == []
        assert _get(port, "/query?text=hello") == {} and state.pending_queries == ["hello"]
        _get(port, "/resume")
        runner.join(timeout=60)
        assert not runner.is_alive() and state.done
        snap = _get(port, "/state")
        assert len(snap["informative"]) == snap["total_frames"] == 6
        assert all(0 <= s <= 1 for s in snap["informative"] + snap["relevance"])
        assert snap["chat"] == [{"role": "user", "content": "hello", "time": 0.0}]
        assert not snap["paused"] and snap["done"]
        _get(port, "/pause")
        assert not state.pause_event.is_set()
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
        assert b"<canvas" in page
    finally:
        srv.shutdown()
        srv.server_close()
