"""Data-parallel batched serving in the port (lanes over ranks): gloo ranks
on the CPU, each holding the device state of its block of lanes, against
the JAX engines on the same (data, model) mesh of the 8 virtual CPU
devices (`tests/test_tp_inference.py::TestDPBatchedServing`'s scenarios)
and against the port's one-process engines.

Two launches of `tests/torch_dp_worker.py`, on (2, 1) and (2, 2) meshes,
run every engine case; each test compares one case. Every lane's scores
agree to 2e-4 and its answers are equal; the rows are the same bits on
every rank; each rank's cache is its (B / D, kh / M) block; admission
churn equals per-session single engines within 3e-5. Then the CLI under
``torch.distributed.run`` with ``--mesh_data`` writes the one-process
CLI's rows, batched and offline (three more launches,
`tests/torch_cli_worker.py`), each sample decoded by one rank, a video
that fails on one rank alone skipped by every rank."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cli_worker as cli_worker

from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.infer import BatchedStreamEngine as JaxBatchedEngine
from mmduet_tpu.infer import BatchedStreamScorer as JaxScorer
from mmduet_tpu.infer import LiveInferEngine as JaxEngine
from mmduet_tpu.models import init_mmduet_params
from mmduet_tpu.parallel import make_mesh, shard_params
from mmduet_tpu.parallel.sharding import kv_cache_sharding as jax_kv_cache_sharding
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortArgs
from mmduet_tpu_torch.config import tiny_config as port_tiny_config
from mmduet_tpu_torch.infer import BatchedStreamEngine, BatchedStreamScorer, LiveInferEngine
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.parallel import (ProcessMesh, kv_cache_sharding, lane_block,
                                       local_cache_dims)
from mmduet_tpu_torch.stream import CharTokenizer as PortTokenizer

REPO = Path(__file__).resolve().parents[1]
ATOL, CHURN_ATOL = 2e-4, 3e-5
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
PCFG = port_tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
PARAMS = init_mmduet_params(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
FT, H = CFG.frame_num_tokens, CFG.text.hidden_size
SHAPES = [(2, 1), (2, 2)]


def _padded(lengths, seed):
    r = np.random.RandomState(seed)
    T = max(lengths)
    return np.stack([np.concatenate([e, np.zeros((T - n, FT, H), np.float32)]) for n, e in
                     ((n, (r.randn(n, FT, H) * 0.05).astype(np.float32)) for n in lengths)])


QUERY = [{"role": "user", "content": "what is happening?", "time": 0.0}]
BATCH_ARGS = dict(system_prompt="sys", frame_fps=2.0, remove_assistant_turns=True,
                  max_new_tokens=8, repetition_penalty=1.05, max_num_frames=16,
                  stream_end_prob_threshold=0.5)
CHURN_ARGS = dict(BATCH_ARGS, max_new_tokens=6, max_num_frames=8)
ENGINE = dict(block_frames=4, kv_cache_size=1024)
INPUTS = {
    "embeds2": _padded((9, 6), 3),  # TestTPBatchedServing._drive's frames
    "embeds4": _padded((9, 6, 8, 7), 4),
    "embeds3": _padded((9, 6, 8), 6),
    "churn": _padded((7, 5, 6, 4), 5),
    "pixels": np.random.RandomState(8).randint(0, 256, (4, 6, 32, 32, 3), np.uint8),
}
CASES = {
    # TestDPBatchedServing.test_dp_lanes_match_unsharded's scenario: one lane a rank
    "two_lanes": dict(kind="stream_all", args=BATCH_ARGS, embeds="embeds2", lengths=[9, 6],
                      engine=dict(ENGINE, n_streams=2), conversations=[QUERY, []]),
    # two lanes a rank, queries on some
    "four_lanes": dict(kind="stream_all", args=BATCH_ARGS, embeds="embeds4", lengths=[9, 6, 8, 7],
                       engine=dict(ENGINE, n_streams=4), conversations=[QUERY, [], [], QUERY]),
    # lockstep scoring, each rank encoding its own lanes' pixels
    "scorer": dict(kind="score_all", pixels="pixels", lengths=[6, 4, 5, 3],
                   queries=["what?", None, "where?", None],
                   engine=dict(n_streams=4, frame_fps=2.0, block_frames=4, kv_cache_size=1024)),
}
CASES_21 = dict(CASES, **{
    # serve() with more sessions than lanes: test_dp_admission_churn_matches_single's
    "churn": dict(kind="serve", args=CHURN_ARGS, embeds="churn", lengths=[7, 5, 6, 4],
                  engine=dict(ENGINE, n_streams=2),
                  conversation=[{"role": "user", "content": "what?", "time": 0.0}]),
    # data 2 does not divide 3 lanes: they are replicated on both ranks
    "three_lanes": dict(kind="stream_all", args=BATCH_ARGS, embeds="embeds3", lengths=[9, 6, 8],
                        engine=dict(ENGINE, n_streams=3), conversations=[QUERY, [], QUERY]),
    # one stream, one lane: run whole on every data replica
    "single": dict(kind="single", args=BATCH_ARGS, embeds="embeds2", lengths=[9],
                   engine=ENGINE, conversations=[QUERY]),
})
MESH_CASES = {(2, 1): CASES_21, (2, 2): CASES}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(n: int, *argv, timeout: int = 240) -> subprocess.CompletedProcess:
    """``n`` ranks of ``argv`` under torch.distributed.run, on 127.0.0.1."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), *argv]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of every case, one launch per mesh shape."""
    d = tmp_path_factory.mktemp("dp")
    torch.save(TP, d / "params.pt")
    np.savez(d / "inputs.npz", **INPUTS)
    out = {}
    for shape, cases in MESH_CASES.items():
        sub = d / f"{shape[0]}x{shape[1]}"
        sub.mkdir()
        for f in ("params.pt", "inputs.npz"):
            os.link(d / f, sub / f)
        (sub / "cases.json").write_text(json.dumps(cases))
        _torchrun(shape[0] * shape[1], "tests/torch_dp_worker.py", str(sub), *map(str, shape))
        out[shape] = [json.loads((sub / f"rank{r}.json").read_text())
                      for r in range(shape[0] * shape[1])]
    return out


def _scores(debug_lists):
    return [[[d["informative_score"], d["relevance_score"]] for d in rows]
            for rows in debug_lists]


def _reference(case, mesh=None, port=False):
    """A stream_all / score_all / single case on one engine: the JAX one
    (on ``mesh``) or, with ``port``, the port's in this process. (responses
    per lane or None, scores per lane)."""
    tok = PortTokenizer(frame_num_tokens=FT) if port else CharTokenizer(frame_num_tokens=FT)
    params = TP if port else (PARAMS if mesh is None
                              else shard_params(PARAMS, mesh, mode="replicate"))
    cfg, as_input = (PCFG, np.asarray) if port else (CFG, jnp.asarray)
    kw = {} if port else dict(mesh=mesh)
    if case["kind"] == "score_all":
        scorer = (BatchedStreamScorer if port else JaxScorer)(params, cfg, tok, **case["engine"],
                                                              **kw)
        pixels = INPUTS[case["pixels"]]
        scorer.input_video_streams([pixels[i, :n] for i, n in enumerate(case["lengths"])])
        scorer.start_sessions(case["queries"])
        return None, _scores(scorer.score_all())
    args = (PortArgs if port else InferArgs)(**case["args"])
    if case["kind"] == "single":
        engine = (LiveInferEngine if port else JaxEngine)(params, cfg, tok, args,
                                                          **case["engine"], **kw)
        engine.input_frame_embeds(as_input(INPUTS[case["embeds"]][0, :case["lengths"][0]]))
        engine.input_query_stream(case["conversations"][0])
        return [engine.inference()], _scores([engine.debug_data_list])
    engine = (BatchedStreamEngine if port else JaxBatchedEngine)(params, cfg, tok, args,
                                                                 **case["engine"], **kw)
    engine.input_frame_embeds(as_input(INPUTS[case["embeds"]]),
                              lengths=np.asarray(case["lengths"]))
    engine.input_query_streams(case["conversations"])
    return engine.stream_all(), _scores(engine.debug_data_lists)


def _texts(responses):
    return [(t["role"], t["content"]) for t in responses]


def _same_rows(results, name):
    first = {k: v for k, v in results[0][name].items() if k in ("responses", "scores",
                                                                 "sessions")}
    for r, x in enumerate(results[1:], 1):
        assert {k: x[name][k] for k in first} == first, f"rank {r}'s rows differ from rank 0's"
    return results[0][name]


STREAM_CASES = [(shape, name) for shape, cases in MESH_CASES.items() for name in cases
                if cases[name]["kind"] != "serve"]


@pytest.mark.parametrize("shape,name", STREAM_CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in STREAM_CASES])
def test_dp_lanes_match_jax_on_the_mesh_and_one_process(ranks, shape, name):
    case = MESH_CASES[shape][name]
    got = _same_rows(ranks[shape], name)
    mesh = make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
    for want_resp, want_scores in (_reference(case, mesh), _reference(case, port=True)):
        for lane, (g, w) in enumerate(zip(got["scores"], want_scores)):
            assert len(g) == len(w) == case["lengths"][lane]
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"lane {lane}")
        if want_resp is not None:
            assert [_texts(r) for r in got["responses"]] == [_texts(r) for r in want_resp]
            for g, w in zip(got["responses"], want_resp):
                np.testing.assert_allclose([t["time"] for t in g], [t["time"] for t in w],
                                           rtol=0, atol=1e-9)
    if name == "two_lanes":
        assert any(t["role"] == "assistant" for r in got["responses"] for t in r), \
            "the scenario must trigger a generation"


def test_dp_admission_churn_matches_single(ranks):
    """serve() with four sessions through two lanes of a (2, 1) mesh (one a
    rank): each session's answers and scores are those of its own
    single-stream engine, the port's within 3e-5 and the JAX one's within
    2e-4."""
    case = CASES_21["churn"]
    got = _same_rows(ranks[(2, 1)], "churn")["sessions"]
    assert sorted(got, key=int) == ["0", "1", "2", "3"]
    for i, n in enumerate(case["lengths"]):
        embeds = INPUTS["churn"][i, :n]
        for cls, params, cfg, args, tok, tol in (
                (LiveInferEngine, TP, PCFG, PortArgs, PortTokenizer, CHURN_ATOL),
                (JaxEngine, PARAMS, CFG, InferArgs, CharTokenizer, ATOL)):
            eng = cls(params, cfg, tok(frame_num_tokens=FT), args(**case["args"]),
                      **ENGINE)
            eng.input_frame_embeds(embeds if cls is LiveInferEngine else jnp.asarray(embeds))
            eng.input_query_stream(case["conversation"])
            want = eng.inference()
            assert _texts(got[str(i)]["responses"]) == _texts(want), f"session {i}"
            np.testing.assert_allclose(got[str(i)]["scores"], _scores([eng.debug_data_list])[0],
                                       atol=tol, rtol=0, err_msg=f"session {i}")


@pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "2x2"])
def test_dp_cache_is_the_ranks_block(ranks, shape):
    """Each rank's cache is (L, B / D, kh / M, S, hd): the block of
    `kv_cache_sharding`'s spec, the JAX package's ((None, "data", "model")
    on (2, 2)); lanes that data does not divide stay whole; each engine
    counts the decoder forwards its process ran."""
    data_n, model_n = shape
    kh, L, hd = CFG.text.num_kv_heads, CFG.text.num_layers, CFG.text.head_dim
    jmesh = make_mesh(shape, devices=jax.devices()[: data_n * model_n])
    for r, res in enumerate(ranks[shape]):
        mesh = ProcessMesh(shape, divmod(r, model_n), torch.device("cpu"))
        for name, case in MESH_CASES[shape].items():
            B = case["engine"].get("n_streams", 1)
            spec = kv_cache_sharding(mesh, kh, lanes=B)
            assert spec == tuple(jax_kv_cache_sharding(jmesh, kh, lanes=B).spec)
            lo, hi = lane_block(mesh, B)
            assert (hi - lo, kh // model_n) == local_cache_dims(mesh, kh, B)
            assert res[name]["cache"] == [L, hi - lo, kh // model_n, 2048, hd], (r, name)
            if "forwards" in res[name]:
                assert res[name]["forwards"] == res[name]["decoder_forwards"], (r, name)
    if shape == (2, 2):
        assert kv_cache_sharding(ProcessMesh(shape, (0, 0), torch.device("cpu")), kh,
                                 lanes=2) == (None, "data", "model")


def test_lane_block_is_the_data_axis_block_of_the_lanes():
    """Rank d of D holds lanes [d B / D, (d + 1) B / D) where D divides B,
    all B otherwise; one-process meshes and no mesh hold all B."""
    for data_n, model_n, B in ((2, 1, 8), (2, 2, 4), (4, 1, 8), (2, 1, 3), (1, 2, 5)):
        for d in range(data_n):
            mesh = ProcessMesh((data_n, model_n), (d, 0), torch.device("cpu"))
            want = (d * B // data_n, (d + 1) * B // data_n) if B % data_n == 0 else (0, B)
            assert lane_block(mesh, B) == want
            assert local_cache_dims(mesh, 4, B) == (want[1] - want[0], 4 // model_n)
    assert lane_block(None, 5) == (0, 5)


def test_ranks_load_nothing_of_jax(ranks):
    assert [r["modules"] for shape in SHAPES for r in ranks[shape]] == [[]] * 6


# ---------------------------------------------------------------------------
# the CLI under torch.distributed.run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("cli")
    (d / "videos").mkdir()
    anno = []
    # sample 1 is a video that fails to decode on one rank only (`torch_cli_worker`)
    for name, seed, n in (("v0", 0, 30), ("flaky", 9, 10), ("v1", 1, 20), ("v2", 2, 25),
                          ("v3", 3, 15)):
        w = cv2.VideoWriter(str(d / "videos" / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            10, (36, 28))
        r = np.random.RandomState(seed)
        for _ in range(n):
            w.write(r.randint(0, 255, (28, 36, 3), np.uint8))
        w.release()
        anno.append({"question_id": f"q{name.lstrip('v')}", "video": f"{name}.mp4",
                     "conversation": [{"role": "user", "content": "query?", "time": 0}]})
    (d / "eval.json").write_text(json.dumps(anno))
    argv = ["--tiny_random", "--no_prefetch", "--device", "cpu", "--input_dir",
            str(d / "videos"), "--test_fname", str(d / "eval.json"), "--frame_fps", "2",
            "--max_num_frames", "6", "--stream_end_prob_threshold", "0.5",
            "--max_new_tokens", "4"]
    return d, argv


def _rows(path):
    rows = [json.loads(line) for line in open(path)]
    for row in rows:
        row.pop("latency", None)  # wall times
    return sorted(rows, key=lambda r: r["question_id"])


CLI_MESHES = [("2", "1", "2", []), ("2", "2", "4", []),
              # the offline baseline, reached with both flags, runs whole on each replica
              ("2", "1", "2", ["--is_online_model", "false"])]


@pytest.mark.parametrize("mesh", CLI_MESHES, ids=["2x1", "2x2", "offline_2x1"])
def test_cli_mesh_data_under_torchrun_writes_the_one_process_rows(cli_inputs, mesh, monkeypatch):
    """The rows of the one process. Sample k of the 5 is decoded by rank
    k mod D*M alone (row-major over (data, model); each rank's count on
    stderr); sample 1's video fails to decode on rank 1 alone
    (`torch_cli_worker`), and in the one process: every rank skips it."""
    from mmduet_tpu_torch.data import eval_dataset
    from mmduet_tpu_torch.eval.inference import main as torch_main

    d, argv = cli_inputs
    data_n, model_n, B, route = mesh
    name = f"{data_n}x{model_n}{'_offline' if route else ''}"
    one, dp = d / f"one_{name}.jsonl", d / f"dp_{name}.jsonl"
    monkeypatch.setattr(eval_dataset, "decode_video", cli_worker.failing(
        eval_dataset.decode_video, "flaky.mp4", lambda: True))
    torch_main(argv + route + ["--batch_streams", B, "--output_fname", str(one)])
    world = int(data_n) * int(model_n)
    out = _torchrun(world, "tests/torch_cli_worker.py", "1", "flaky.mp4", *argv, *route,
                    "--batch_streams", B, "--mesh_data", data_n, "--mesh_model", model_n,
                    "--dist_backend", "gloo", "--output_fname", str(dp))
    assert cli_worker.decoded(out.stderr) == {
        divmod(r, int(model_n)): (len(range(r, 5, world)), 5) for r in range(world)}
    assert out.stderr.count("skipping qflaky:") == world
    got, want = _rows(dp), _rows(one)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g_debug, w_debug = g.pop("debug_data", []), w.pop("debug_data", [])
        assert g == w
        # the scores, rounded to 3 decimals in the rows: an f32 sum in another
        # order may land a value on the other side of a rounding boundary
        assert [x["time"] for x in g_debug] == [x["time"] for x in w_debug]
        for key in ("informative_score", "relevance_score"):
            np.testing.assert_allclose([x[key] for x in g_debug], [x[key] for x in w_debug],
                                       atol=1.001e-3, rtol=0)
