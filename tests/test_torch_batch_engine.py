"""The port's batched engines (`BatchedStreamScorer`, `BatchedStreamEngine`,
`serve()`, the CLI's ``--batch_streams``) against the JAX package's, on the
same numpy parameters, frame embeddings, pixels and queries.

f32 on both sides, tiny config. Scores agree to atol 1e-4 (summation order
only; an int8 cache may round a row across one int8 step, which stays
inside that); responses, times, cursors and the order in which `serve()`
retires sessions are equal. A one-device (2, 2) mesh changes nothing of the
port's outputs, bit for bit. The overflow guards raise in both packages at
the same point with the same message."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.infer import BatchedStreamEngine as JaxBatchedEngine
from mmduet_tpu.infer import BatchedStreamScorer as JaxScorer
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import lora as jlora
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.infer import BatchedStreamEngine, BatchedStreamScorer, LiveInferEngine
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models.io import config_from_dict
from mmduet_tpu_torch.parallel import make_mesh

ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
JP = jax_init(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")
H, FT = CFG.text.hidden_size, CFG.frame_num_tokens
MAXF = 12


def make_args(**kw) -> InferArgs:
    base = dict(system_prompt="sys", frame_fps=2.0, max_new_tokens=6,
                repetition_penalty=1.05, max_num_frames=MAXF,
                stream_end_prob_threshold=0.5,
                stream_end_score_sum_threshold=None, threshold_z=None)
    base.update(kw)
    return InferArgs(**base)


def build_pair(n_streams, args=None, j_kw=None, t_kw=None, **kw):
    """(JAX engine, port engine) on the same weights and arguments."""
    args = args or make_args()
    kw = dict(n_streams=n_streams, block_frames=4, kv_cache_size=1024, **kw)
    je = JaxBatchedEngine(JP, CFG, TOK, args, **kw, **(j_kw or {}))
    te = BatchedStreamEngine(TP, PCFG, TOK, PortInferArgs(**dataclasses.asdict(args)),
                             **kw, **(t_kw or {}))
    return je, te


_PAIRS = {}


def shared_pair():
    """One B = 3 pair for the scenarios that differ only in host policy
    (thresholds, turns, rates, coalescing): the JAX engine compiles once."""
    if "b3" not in _PAIRS:
        _PAIRS["b3"] = build_pair(3)
    return _PAIRS["b3"]


def embeds_for(lengths, seed):
    r = np.random.RandomState(seed)
    return [(r.randn(n, FT, H) * 0.05).astype(np.float32) for n in lengths]


def padded(embeds):
    T = max(len(e) for e in embeds)
    out = np.zeros((len(embeds), T, FT, H), np.float32)
    for b, e in enumerate(embeds):
        out[b, : len(e)] = e
    return out


def norm(resp):
    return [(x["time"], x["role"], x["content"]) for x in resp]


def assert_rows_match(got, want, what):
    assert [d["time"] for d in got] == [d["time"] for d in want], what
    for key in ("informative_score", "relevance_score"):
        np.testing.assert_allclose([d[key] for d in got], [d[key] for d in want],
                                   atol=ATOL, rtol=0, err_msg=what)


def set_policy(engines, coalesce=0, **kw):
    """Host-side policy read at run time: thresholds, turns, coalescing."""
    base = dict(stream_end_prob_threshold=None, stream_end_score_sum_threshold=None,
                threshold_z=None, remove_assistant_turns=False)
    base.update(kw)
    for eng in engines:
        for k, v in base.items():
            setattr(eng.args, k, v)
        eng.gen_coalesce_rounds = coalesce
        eng.reset()


def stream_both(je, te, embeds, convs, fps=None):
    lengths = np.array([len(e) for e in embeds])
    out = []
    for eng, arr in ((je, jnp.asarray(padded(embeds))), (te, padded(embeds))):
        if fps is not None:
            eng.set_stream_fps(fps)
        eng.input_frame_embeds(arr, lengths=lengths)
        eng.input_query_streams(convs)
        out.append(eng.stream_all())
    j_resp, t_resp = out
    n_assistant = 0
    for b in range(len(embeds)):
        assert norm(t_resp[b]) == norm(j_resp[b]), f"stream {b}"
        assert_rows_match(te.debug_data_lists[b], je.debug_data_lists[b], f"stream {b}")
        n_assistant += sum(r["role"] == "assistant" for r in t_resp[b])
    assert te._cur.tolist() == je._cur.tolist()
    assert te._next_b.tolist() == je._next_b.tolist() == lengths.tolist()
    return n_assistant


CONVS = [
    [{"role": "user", "content": "what is happening?", "time": 0.0}],
    [{"role": "user", "content": "a much longer question about the video", "time": 1.5}],
    [],
]

# name -> (lengths, conversations, fps, policy)
SCENARIOS = {
    "lockstep": ((8, 8, 8), [CONVS[0]] * 3, None, dict(stream_end_prob_threshold=0.5)),
    "staggered_lengths": ((9, 6, 8), CONVS, None, dict(stream_end_prob_threshold=0.5)),
    "mixed_fps": ((9, 7, 10), CONVS, (1.0, 2.0, 2.5),
                  dict(stream_end_score_sum_threshold=1.5)),
    "remove_assistant_turns": ((9, 6, 8), CONVS, None,
                               dict(stream_end_prob_threshold=0.5, remove_assistant_turns=True)),
    "gen_coalesce_rounds": ((12, 10, 11), CONVS, None,
                            dict(stream_end_score_sum_threshold=2.0, coalesce=2,
                                 remove_assistant_turns=True)),
    "threshold_z": ((10, 8, 9), CONVS, None,
                    dict(threshold_z=0.3, first_n_frames_no_generate=2)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batched_engine_matches_jax(name):
    lengths, convs, fps, policy = SCENARIOS[name]
    je, te = shared_pair()
    set_policy((je, te), **policy)
    n = stream_both(je, te, embeds_for(lengths, seed=len(name)), convs, fps)
    assert n >= 2 or name == "threshold_z", f"too few triggers ({n}) to test"
    if name == "gen_coalesce_rounds":
        assert te.decode_lanes > te.decodes, te.counters()  # triggers did merge
    assert te.tokens_generated > 0 or name == "threshold_z"


def test_batched_engine_int8_cache_matches_jax():
    je, te = build_pair(2, kv_cache_quant="int8")
    n = stream_both(je, te, embeds_for((7, 5), seed=3), CONVS[:2])
    assert n >= 1
    assert isinstance(te._cache.k, dict) and te._cache.k["qw"].dtype == torch.int8


def test_batched_engine_lora_matches_jax():
    """One runtime adapter on all lanes, at scale 1.0 (scale-folded)."""
    lora = jlora.init_lora(jax.random.PRNGKey(3), CFG.text, rank=4)
    r = np.random.RandomState(5)
    lora = {name: {"a": ab["a"], "b": jnp.asarray(r.randn(*ab["b"].shape) * 0.05, jnp.float32)}
            for name, ab in lora.items()}
    folded = jlora.fold_lora_scale(lora, 2.0)
    t_lora = params_from_numpy(jax.tree.map(np.asarray, folded), "cpu")
    je, te = build_pair(2, j_kw=dict(lora=folded), t_kw=dict(lora=t_lora), lora_scale=1.0)
    embeds = embeds_for((7, 5), seed=4)
    stream_both(je, te, embeds, CONVS[:2])
    plain = BatchedStreamEngine(TP, PCFG, TOK, te.args, n_streams=2, block_frames=4,
                                kv_cache_size=1024)
    plain.input_frame_embeds(padded(embeds), lengths=np.array([7, 5]))
    plain.input_query_streams(CONVS[:2])
    plain.stream_all()
    # the adapter changes the scores: it is not silently dropped
    assert abs(plain.debug_data_lists[0][0]["informative_score"]
               - te.debug_data_lists[0][0]["informative_score"]) > 1e-5


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_cache", "int8_cache"])
def test_one_device_mesh_changes_nothing(kv):
    """A (2, 2) mesh on the CPU cuts lanes and heads into four shards of
    the attention; every output equals the engine's without a mesh
    exactly, and so do the committed cache rows."""
    args = PortInferArgs(**dataclasses.asdict(make_args()))
    embeds = embeds_for((9, 6, 8, 7), seed=6)
    convs = CONVS + [CONVS[0]]
    runs = []
    for mesh in (None, make_mesh((2, 2), devices=["cpu"] * 4)):
        te = BatchedStreamEngine(TP, PCFG, TOK, args, n_streams=4, block_frames=4,
                                 kv_cache_size=1024, mesh=mesh, kv_cache_quant=kv)
        assert (te._shard_ctx is None) == (mesh is None)
        te.input_frame_embeds(padded(embeds), lengths=np.array([9, 6, 8, 7]))
        te.input_query_streams(convs)
        runs.append((te.stream_all(), te.debug_data_lists, te._cur.tolist(), te))
    assert runs[1][:3] == runs[0][:3]
    assert any(r["role"] == "assistant" for resp in runs[0][0] for r in resp)
    k0, k1 = (r[3]._cache.k["qw"] if kv else r[3]._cache.k for r in runs)
    for b, n in enumerate(runs[0][2]):
        assert torch.equal(k0[:, b, :, :n], k1[:, b, :, :n])
    # a single stream under a mesh: only its heads are cut
    single = []
    for mesh in (None, make_mesh((1, 2), devices=["cpu"] * 2)):
        eng = LiveInferEngine(TP, PCFG, TOK, args, kv_cache_size=512, block_frames=4, mesh=mesh)
        eng.input_frame_embeds(embeds[0])
        eng.input_query_stream(CONVS[0])
        single.append((eng.inference(), eng.debug_data_list))
    assert single[1] == single[0]
    with pytest.raises(ValueError, match="do not divide"):
        BatchedStreamEngine(TP, PCFG, TOK, args, n_streams=4,
                            mesh=make_mesh((1, 4), devices=["cpu"] * 4))


def _sessions(as_jax: bool):
    lengths = [7, 3, 0, 10, 5, 8]
    fps = [2.0, 1.0, 2.0, 2.0, 2.5, 2.0]
    embeds = embeds_for(lengths, seed=77)
    convs = [[{"role": "user", "content": f"sess{i} q?", "time": 0.5 * i}] if i % 2 == 0 else []
             for i in range(len(lengths))]
    return [{"frame_embeds": jnp.asarray(e) if as_jax else e, "conversation": c, "fps": f}
            for e, c, f in zip(embeds, convs, fps)]


def test_serve_admission_matches_jax(capsys):
    """More sessions than lanes, one of them with zero frames: sessions
    are admitted into lanes as they free up; results and the order of
    retirement equal the JAX engine's."""
    je, te = shared_pair()
    set_policy((je, te), stream_end_prob_threshold=0.5)
    j_out = list(je.serve(iter(_sessions(True))))
    capsys.readouterr()
    t_out = list(te.serve(iter(_sessions(False))))
    assert "zero frames" in capsys.readouterr().err
    assert [i for i, _, _ in t_out] == [i for i, _, _ in j_out]
    assert sorted(i for i, _, _ in t_out) == list(range(6))
    # the zero-frame session retires first, with its query and no scores
    assert t_out[0][0] == 2 and t_out[0][2] == []
    assert [r["role"] for r in t_out[0][1]] == ["user"]
    for (i, t_resp, t_debug), (_, j_resp, j_debug) in zip(t_out, j_out):
        assert norm(t_resp) == norm(j_resp), f"session {i}"
        assert_rows_match(t_debug, j_debug, f"session {i}")
    assert sum(r["role"] == "assistant" for _, resp, _ in t_out for r in resp) >= 2
    # serve() is reusable after reset()
    te.reset()
    again = list(te.serve(_sessions(False)[:1]))
    assert norm(again[0][1]) == norm(next(r for i, r, _ in t_out if i == 0))


def test_scorer_matches_jax():
    """Lockstep scoring from pixels: different lengths and different-length
    queries per stream, one stream without a query."""
    r = np.random.RandomState(0)
    videos = [r.randint(0, 255, (n, 32, 32, 3), np.uint8) for n in (7, 5, 6)]
    queries = ["a dog runs", "the much longer query about a person", None]
    kw = dict(n_streams=3, frame_fps=2.0, system_prompt="sys", block_frames=4,
              kv_cache_size=1024)
    out = []
    for scorer in (JaxScorer(JP, CFG, TOK, **kw), BatchedStreamScorer(TP, PCFG, TOK, **kw)):
        scorer.start_sessions(queries)
        scorer.input_video_streams(videos)
        out.append((scorer.score_all(), scorer._cursor.tolist()))
    (j_rows, j_cur), (t_rows, t_cur) = out
    assert t_cur == j_cur
    for b, video in enumerate(videos):
        assert len(t_rows[b]) == len(video)
        assert_rows_match(t_rows[b], j_rows[b], f"stream {b}")
    # and the batched scorer equals single-stream grounding sessions of the port
    for b, (video, query) in enumerate(zip(videos, queries)):
        eng = LiveInferEngine(
            TP, PCFG, TOK, PortInferArgs(**dataclasses.asdict(make_args(
                stream_end_prob_threshold=1.0, grounding_mode=True, max_num_frames=16))),
            kv_cache_size=1024, block_frames=4)
        eng.input_video_stream(video)
        if query is not None:
            eng.input_query_stream([{"role": "user", "content": query, "time": 0.0}])
        eng.inference()
        assert_rows_match(t_rows[b], eng.debug_data_list, f"stream {b} vs single")


def _guard_engines(**kw):
    args = make_args(stream_end_prob_threshold=1.0, max_num_frames=8, **kw)
    engines = []
    for cls, params, cfg, a in ((JaxBatchedEngine, JP, CFG, args),
                                (BatchedStreamEngine, TP, PCFG,
                                 PortInferArgs(**dataclasses.asdict(args)))):
        be = cls(params, cfg, TOK, a, n_streams=2, kv_cache_size=512)
        be.input_frame_embeds(np.zeros((2, 3, FT, H), np.float32))
        engines.append(be)
    return engines


def _raises_alike(calls) -> str:
    messages = []
    for call in calls:
        with pytest.raises(RuntimeError, match="frozen stream 0") as e:
            call()
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    return messages[0]


def test_frozen_lane_overflow_guard():
    """A dispatch that feeds only lane 1 while lane 0, live, sits within
    the dispatch width of capacity (2048, rounded): both engines raise."""
    engines = _guard_engines()
    for be in engines:
        be._cur[:] = [2044, 10]
    _raises_alike([lambda be=be: be._dispatch_sched({1: ([1, 2, 3], 0, 0)}) for be in engines])


def test_finished_lane_pending_gen_still_guarded():
    """A lane that consumed all its frames is exempt from the guard,
    unless a coalesced generation is still pending on it."""
    for pending in (False, True):
        engines = _guard_engines()
        for be in engines:
            be._cur[:] = [2044, 10]
            be._next_b[0] = be._lengths[0]  # lane 0: all frames consumed
            if pending:
                be._pending_gen[0] = 0
        calls = [lambda be=be: be._dispatch_sched({1: ([1, 2, 3], 0, 0)}) for be in engines]
        if pending:
            _raises_alike(calls)
        else:
            probs = [np.asarray(call()) for call in calls]  # exempt: no raise
            assert probs[0].shape == probs[1].shape == (2, 2, 8)
            assert [be._cur.tolist() for be in engines] == [[2044, 13]] * 2


def test_frozen_lane_generation_commit_guard():
    """The decode commits a (max_new - 1)-wide window: a frozen live lane
    within it of capacity raises before the batched generation, even when
    the prompt itself fits."""
    engines = _guard_engines(max_new_tokens=64)
    for be in engines:
        be._cur[:] = [2040, 10]
    _raises_alike([lambda be=be: be._generate_batch([1]) for be in engines])
    # a fed lane that does not fit raises its own overflow, in both
    for be in engines:
        be._cur[:] = [10, 2040]
        with pytest.raises(RuntimeError, match="overflow on stream 1"):
            be._generate_batch([1])


def test_engine_guards_of_the_inherited_api():
    _, te = shared_pair()
    with pytest.raises(NotImplementedError, match="input_query_streams"):
        te.start_sessions(["q"] * 3)
    with pytest.raises(NotImplementedError, match="stream_all"):
        te.score_all()
    with pytest.raises(ValueError, match="max_num_frames"):
        te.input_frame_embeds(np.zeros((3, MAXF + 1, FT, H), np.float32))
    with pytest.raises(ValueError, match="unknown KV cache quant"):
        BatchedStreamEngine(TP, PCFG, TOK, te.args, n_streams=2, kv_cache_quant="int4")


def test_cli_batched_matches_sequential(tmp_path):
    """`--batch_streams 2 --device cpu` writes per-sample JSONL rows equal
    to the sequential CLI's (scores to 1e-3 after the rows' rounding to 3
    digits, responses equal), three samples through two lanes."""
    import cv2

    from mmduet_tpu_torch.eval.inference import main as torch_main

    vids = tmp_path / "videos"
    vids.mkdir()
    r = np.random.RandomState(0)
    anno = []
    for i, name in enumerate(("a.mp4", "b.mp4", "c.mp4")):
        w = cv2.VideoWriter(str(vids / name), cv2.VideoWriter_fourcc(*"mp4v"), 10, (36, 28))
        for _ in range(30 + 10 * i):  # 3-5 s at 10 fps
            w.write(r.randint(0, 255, (28, 36, 3), np.uint8))
        w.release()
        anno.append({"question_id": f"q{i}", "video": name,
                     "conversation": [{"role": "user", "content": f"query {i}?", "time": 0}]})
    test_f = tmp_path / "eval.json"
    test_f.write_text(json.dumps(anno))
    common = ["--tiny_random", "--no_prefetch", "--device", "cpu",
              "--input_dir", str(vids), "--test_fname", str(test_f),
              "--frame_fps", "0", "--max_num_frames", "6",  # auto: a rate per sample
              "--stream_end_score_sum_threshold", "0.3",
              "--max_new_tokens", "6", "--repetition_penalty", "1.05",
              "--remove_assistant_turns", "true"]
    seq, bat = str(tmp_path / "seq.jsonl"), str(tmp_path / "bat.jsonl")
    torch_main(common + ["--output_fname", seq])
    torch_main(common + ["--output_fname", bat, "--batch_streams", "2",
                         "--gen_coalesce_rounds", "1"])
    seq_rows = {json.loads(line)["question_id"]: json.loads(line) for line in open(seq)}
    bat_rows = {json.loads(line)["question_id"]: json.loads(line) for line in open(bat)}
    assert set(seq_rows) == set(bat_rows) == {"q0", "q1", "q2"}
    n_asst = 0
    for q, s in seq_rows.items():
        b = bat_rows[q]
        assert b["video_duration"] == s["video_duration"]
        assert [d["time"] for d in b["debug_data"]] == [d["time"] for d in s["debug_data"]]
        for ds, db in zip(s["debug_data"], b["debug_data"]):
            assert abs(ds["informative_score"] - db["informative_score"]) <= 1e-3
            assert abs(ds["relevance_score"] - db["relevance_score"]) <= 1e-3
        assert b["model_response_list"] == s["model_response_list"], q
        n_asst += sum(x["role"] == "assistant" for x in s["model_response_list"])
        assert b["latency"].get("aggregate") is True and b["latency"]["frames"] == 6
    assert n_asst >= 1, "the scenario never triggered generation"
