"""Live feeding in the port against the JAX engine: chunked feeding
(`append_frame_embeds`, `append_frames`, ``inference(drain=False)``),
`stream_video` (vision ahead of the decode, and ``upload_ahead``),
`prewarm` (single-stream and batched) and ``pipeline_grounding``.

The port counterparts of `tests/test_infer_engine.py::{TestAppendFrames,
TestStreamVideo, TestPrewarm, TestGroundingPipelined}`: each port run is
held against the JAX engine's outputs on the same inputs (f32 on both
sides: scores to atol=1e-4, responses, times and cursors equal), and
where the port's two routes do the same arithmetic, against each other
exactly. On the CPU `stream_video` has no side stream and runs its steps
in order; the card's side is in `tests/test_torch_cuda.py`."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.infer import LiveInferEngine as JaxEngine
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.infer import BatchedStreamEngine, LiveInferEngine
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models.io import config_from_dict

ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
TCFG = config_from_dict(dataclasses.asdict(CFG))
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
JP = jax_init(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")
FT, H = CFG.frame_num_tokens, CFG.text.hidden_size
EMBEDS = (np.random.RandomState(23).randn(11, FT, H) * 0.03).astype(np.float32)
PIXELS = np.random.RandomState(11).randint(0, 255, (11, 32, 32, 3), np.uint8)
QUERY = [{"role": "user", "content": "and now?", "time": 2.5}]


def make_args(**kw) -> InferArgs:
    base = dict(system_prompt="sys", frame_fps=2.0, max_new_tokens=4, max_num_frames=16,
                stream_end_prob_threshold=0.5, stream_end_score_sum_threshold=None,
                threshold_z=None)
    base.update(kw)
    return InferArgs(**base)


_JAX_ENGINES: dict = {}


def jax_engine(grounding: bool = False) -> JaxEngine:
    """One JAX engine per mode for the module (its compiled functions are
    reused across runs), reset for each run."""
    if grounding not in _JAX_ENGINES:
        _JAX_ENGINES[grounding] = JaxEngine(JP, CFG, TOK, make_args(grounding_mode=grounding),
                                            kv_cache_size=2048, block_frames=4)
    eng = _JAX_ENGINES[grounding]
    eng.reset()
    eng.pipeline_grounding = True
    eng.set_fps(2.0)
    return eng


def port_engine(grounding: bool = False, **kw) -> LiveInferEngine:
    eng = LiveInferEngine(TP, TCFG, TOK, PortInferArgs(**dataclasses.asdict(
        make_args(grounding_mode=grounding, **kw))), kv_cache_size=2048, block_frames=4)
    eng.set_fps(2.0)
    return eng


def summary(resp, eng) -> dict:
    rows = eng.debug_data_list
    return dict(
        responses=[(round(x["time"], 6), x["role"], x["content"]) for x in resp],
        times=[round(d["time"], 6) for d in rows],
        scores=np.array([[d["informative_score"], d["relevance_score"]] for d in rows]),
        cursor=eng.state.cursor,
        policy=(list(eng.stream_end_prob_list), eng.stream_end_score_sum),
    )


def assert_same(got: dict, want: dict, atol: float = ATOL) -> None:
    assert got["responses"] == want["responses"]
    assert got["times"] == want["times"]
    assert got["cursor"] == want["cursor"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=atol, rtol=0)
    np.testing.assert_allclose(got["policy"][0], want["policy"][0], atol=atol, rtol=0)
    np.testing.assert_allclose(got["policy"][1], want["policy"][1], atol=atol, rtol=0)


def one_shot_jax(grounding: bool, pixels: bool = False, queries=QUERY) -> dict:
    eng = jax_engine(grounding)
    if pixels:
        eng.input_video_stream(PIXELS)
    else:
        eng.input_frame_embeds(EMBEDS)
    eng.input_query_stream(list(queries))
    return summary(eng.inference(), eng)


def merged(calls) -> list:
    """One response list from several `inference()` calls: user turns are
    re-listed per call, so the first call's listing and every assistant
    turn."""
    out = calls[0] + [x for r in calls[1:] for x in r if x["role"] == "assistant"]
    return sorted(out, key=lambda x: x["time"])


# ---------------------------------------------------------------------------
# chunked feeding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grounding", [False, True], ids=["generation", "grounding"])
def test_chunked_feeding_matches_jax_one_shot(grounding):
    eng = port_engine(grounding)
    eng.input_frame_embeds(EMBEDS[:4])
    eng.input_query_stream(list(QUERY))
    calls = [eng.inference()]
    eng.append_frame_embeds(EMBEDS[4:9])
    calls.append(eng.inference())
    eng.append_frame_embeds(EMBEDS[9:])
    calls.append(eng.inference())
    assert eng.frame_embeds.shape == (16, FT, H)  # one max_num_frames buffer
    assert len(eng.frame_latencies_ms) == 11
    got = summary(merged(calls), eng)
    assert_same(got, one_shot_jax(grounding))
    if not grounding:
        assert any(r[1] == "assistant" for r in got["responses"])


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "sequential"])
def test_drain_false_leaves_the_tail_as_jax_does(pipelined):
    """`inference(drain=False)` stops at the last full block when no query
    is due: frame 0 steps alone (the start-of-dialog joiner), two blocks
    of 4 follow, the 1-frame tail waits; 1 + 2 = 3 frames still wait; the
    final drain runs the rest."""
    emb = EMBEDS[:10]
    counts, engines = [], (jax_engine(True), port_engine(True))
    for eng in engines:
        eng.pipeline_grounding = pipelined
        eng.input_frame_embeds(emb)
        eng.inference(drain=False)
        n = [len(eng.debug_data_list)]
        eng.append_frame_embeds(emb[:2])
        eng.inference(drain=False)
        n.append(len(eng.debug_data_list))
        eng.inference()
        n.append(len(eng.debug_data_list))
        counts.append(n)
    assert counts[1] == counts[0] == [9, 9, 12]
    assert_same(summary([], engines[1]), summary([], engines[0]))


def test_append_frames_matches_jax_input_video_stream():
    eng = port_engine(True)
    eng.input_query_stream(list(QUERY))
    calls = []
    for chunk in (PIXELS[:2], PIXELS[2:7], PIXELS[7:]):
        eng.append_frames(chunk)
        calls.append(eng.inference())
    assert_same(summary(merged(calls), eng), one_shot_jax(True, pixels=True))


def test_append_past_max_num_frames_raises_as_jax_does():
    for eng in (jax_engine(), port_engine()):
        eng.append_frame_embeds(EMBEDS[:10])
        with pytest.raises(ValueError, match="exceeds max_num_frames 16"):
            eng.append_frame_embeds(EMBEDS[:7])


# ---------------------------------------------------------------------------
# stream_video
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("upload_ahead", [False, True], ids=["vision_ahead", "upload_ahead"])
@pytest.mark.parametrize("grounding", [False, True], ids=["generation", "grounding"])
def test_stream_video_matches_jax_sequential(grounding, upload_ahead):
    """`stream_video` equals the JAX engine's `input_video_stream` +
    `inference()` on the same pixels and query."""
    eng = port_engine(grounding)
    assert eng._streams() == (None, None)  # the CPU has no streams
    eng.input_query_stream(list(QUERY))
    got = summary(eng.stream_video(PIXELS, chunk_frames=4, upload_ahead=upload_ahead), eng)
    assert_same(got, one_shot_jax(grounding, pixels=True))


def test_stream_video_without_queries_matches_jax():
    results = []
    for eng in (jax_engine(True), port_engine(True)):
        out = eng.stream_video(PIXELS[:5], chunk_frames=2)
        assert out == [] and len(eng.debug_data_list) == 5
        results.append(summary(out, eng))
    assert_same(results[1], results[0])


def test_upload_ahead_equals_vision_ahead_exactly():
    """The two schedules enqueue the same work in another order: equal
    results, bit for bit."""
    runs = []
    for upload_ahead in (False, True):
        eng = port_engine()
        eng.input_query_stream(list(QUERY))
        runs.append(summary(eng.stream_video(PIXELS, chunk_frames=4,
                                             upload_ahead=upload_ahead), eng))
    assert_same(runs[1], runs[0], atol=0)


# ---------------------------------------------------------------------------
# prewarm
# ---------------------------------------------------------------------------


def _session(eng) -> dict:
    eng.set_fps(2.0)
    eng.input_frame_embeds(EMBEDS[:9])
    eng.input_query_stream([{"role": "user", "content": "what happens?", "time": 0.5}])
    return summary(eng.inference(), eng)


def test_prewarm_then_session_equals_a_cold_engine_and_jax():
    warm = port_engine()
    warm.prewarm(vision=True)
    assert warm.state.cursor == 0 and warm.debug_data_list == [] and warm.frame_embeds is None
    got = _session(warm)
    assert_same(got, _session(port_engine()), atol=0)
    assert_same(got, _session(jax_engine()))


def test_batched_prewarm_then_serve_equals_a_cold_engine():
    def build():
        return BatchedStreamEngine(
            TP, TCFG, TOK, PortInferArgs(**dataclasses.asdict(make_args())), n_streams=2,
            block_frames=4, kv_cache_size=2048)

    sessions = [{"frames": PIXELS[:7], "fps": 2.0, "conversation": list(QUERY)},
                {"frames": PIXELS[3:], "fps": 2.0, "conversation": []}]

    def serve(eng):
        return sorted((i, r, [sorted(d.items()) for d in dbg])
                      for i, r, dbg in eng.serve(iter(sessions)))

    warm = build()
    warm.prewarm(vision=True)
    assert warm.dispatches == 0 and warm.tokens_generated == 0
    assert serve(warm) == serve(build())


# ---------------------------------------------------------------------------
# pipeline_grounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_pipelined_grounding_equals_sequential_and_jax(seed):
    r = np.random.RandomState(3000 + seed)
    n_frames = int(r.randint(4, 12))
    queries = sorted(({"role": "user", "content": f"q{i}?",
                       "time": float(np.round(r.uniform(0, n_frames / 2.0), 3))}
                      for i in range(r.randint(0, 3))), key=lambda q: q["time"])
    runs = {}
    for pipelined in (True, False):
        eng = port_engine(True)
        eng.pipeline_grounding = pipelined
        eng.input_frame_embeds(EMBEDS[:n_frames])
        eng.input_query_stream(list(queries))
        runs[pipelined] = summary(eng.inference(), eng)
    assert_same(runs[True], runs[False], atol=0)
    eng = jax_engine(True)
    eng.input_frame_embeds(EMBEDS[:n_frames])
    eng.input_query_stream(list(queries))
    assert_same(runs[True], summary(eng.inference(), eng))


def test_upload_pixels_and_encode_uploaded_match_jax():
    """`upload_pixels` pads to a multiple of the batch (no pinned copy on
    the CPU) and `encode_uploaded` encodes at the batch shape and drops the
    pad: the JAX functions' shapes and embeddings."""
    import mmduet_tpu.infer.state as jstate
    from mmduet_tpu_torch.infer.state import encode_uploaded, upload_pixels

    up = upload_pixels(PIXELS[:5], "cpu", batch=4)
    jbuf, jn = jstate.upload_pixels(PIXELS[:5], 4)
    assert tuple(up.buf.shape) == tuple(jbuf.shape) == (8, 32, 32, 3)
    assert up.n == jn == 5 and up.host is None
    assert torch.equal(up.buf, torch.tensor(np.asarray(jbuf)))
    got = encode_uploaded(port_engine()._visual, up.buf, up.n, batch=4)
    eng = jax_engine()
    want = np.asarray(jstate.encode_uploaded(eng._visual, JP, jbuf, jn, 4))
    assert tuple(got.shape) == want.shape == (5, FT, H)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="expected"):
        upload_pixels(np.zeros((2, 32, 32)), "cpu")
