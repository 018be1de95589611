"""Tensor-parallel serving in the port: two gloo ranks on the CPU, each
holding its shard (`parallel.shard_params`) of the JAX package's numpy
weights, against the JAX engines on a (1, 2) mesh of the 8 virtual CPU
devices, driven as `tests/test_tp_inference.py` drives them.

One launch of two ranks (`tests/torch_tp_worker.py`) runs every engine
case; each test compares one case. Per-frame scores agree to 2e-4 and
texts are equal, as the JAX package's own TP tests require; both ranks'
rows are the same; the ranks load nothing of jax or of the JAX package.
Then the CLI under ``torch.distributed.run --nproc_per_node 2
--mesh_model 2`` (single-stream, batched and offline-baseline routes:
three more launches, `tests/torch_cli_worker.py`) writes the rows of the
one-process CLI, each sample decoded by one rank, a video that fails on
one rank alone skipped by both."""

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
from mmduet_tpu.infer import LiveInferEngine as JaxEngine
from mmduet_tpu.models import init_mmduet_params
from mmduet_tpu.models import lora as jlora
from mmduet_tpu.models import quant as jquant
from mmduet_tpu.parallel import make_mesh, shard_params
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.models import params_from_numpy

REPO = Path(__file__).resolve().parents[1]
ATOL = 2e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
PARAMS = init_mmduet_params(jax.random.PRNGKey(0), CFG)
FRAMES = np.random.RandomState(0).randint(0, 255, (12, 32, 32, 3), np.uint8)
QUERY = [{"role": "user", "content": "what?", "time": 1.0}]


def _lora():
    lora = jlora.init_lora(jax.random.PRNGKey(1), CFG.text, rank=4)
    r = np.random.RandomState(2)  # b = 0 at init: give the adapter an effect
    return jax.tree.map(lambda x: jnp.asarray(r.randn(*x.shape) * 0.05, x.dtype), lora)


TREES = {"dense": PARAMS, "int8": jquant.quantize_params(PARAMS, bits=8),
         "int4": jquant.quantize_params(PARAMS, bits=4), "lora": _lora()}
GEN = dict(stream_end_prob_threshold=0.6, max_new_tokens=6)
BATCH_ARGS = dict(system_prompt="sys", frame_fps=2.0, remove_assistant_turns=True,
                  max_new_tokens=8, repetition_penalty=1.05, max_num_frames=16,
                  stream_end_prob_threshold=0.5)
SINGLE = dict(kind="single", conversation=QUERY)
CASES = {
    "generation": dict(SINGLE, tree="dense", args=GEN, engine=dict(block_frames=4)),
    "grounding": dict(SINGLE, tree="dense", engine=dict(block_frames=4),
                      args=dict(GEN, stream_end_prob_threshold=1.0, grounding_mode=True)),
    "int8_weights": dict(SINGLE, tree="int8", args=GEN, engine=dict(block_frames=4)),
    "int4_weights": dict(SINGLE, tree="int4", args=GEN, engine=dict(block_frames=4)),
    "int8_cache": dict(SINGLE, tree="dense", args=GEN,
                       engine=dict(block_frames=4, kv_cache_quant="int8")),
    "lora": dict(SINGLE, tree="dense", args=GEN, engine=dict(block_frames=4), lora=True,
                 lora_scale=2.0),
    # TestTPBatchedServing._drive's scenario
    "batched_2_lanes": dict(kind="batched", tree="dense", args=BATCH_ARGS, lengths=[9, 6],
                            engine=dict(n_streams=2, block_frames=4, kv_cache_size=1024),
                            conversations=[[{"role": "user", "content": "what is happening?",
                                             "time": 0.0}], []]),
}


def _batched_embeds() -> np.ndarray:
    r = np.random.RandomState(3)
    H, ft = CFG.text.hidden_size, CFG.frame_num_tokens
    embeds = [(r.randn(n, ft, H) * 0.05).astype(np.float32) for n in (9, 6)]
    return np.stack([np.concatenate([e, np.zeros((9 - len(e), ft, H), np.float32)])
                     for e in embeds])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(*argv, timeout: int = 240) -> subprocess.CompletedProcess:
    """Two ranks of ``argv`` under torch.distributed.run, on 127.0.0.1."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), *argv]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every case, from one launch."""
    d = tmp_path_factory.mktemp("tp")
    torch.save({name: params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
                for name, tree in TREES.items()}, d / "trees.pt")
    np.savez(d / "inputs.npz", frames=FRAMES, embeds=_batched_embeds())
    (d / "cases.json").write_text(json.dumps(CASES))
    _torchrun("tests/torch_tp_worker.py", str(d))
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


def _jax_run(case):
    """The JAX engine on a (1, 2) mesh: (responses per lane, scores per lane)."""
    mesh = make_mesh((1, 2), devices=jax.devices()[:2])
    params = shard_params(TREES[case["tree"]], mesh, mode="replicate")
    tok = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
    args = InferArgs(**case["args"])
    if case["kind"] == "batched":
        engine = JaxBatchedEngine(params, CFG, tok, args, mesh=mesh, **case["engine"])
        engine.input_frame_embeds(jnp.asarray(_batched_embeds()),
                                  lengths=np.asarray(case["lengths"]))
        engine.input_query_streams(case["conversations"])
        return engine.stream_all(), [[[d["informative_score"], d["relevance_score"]]
                                      for d in rows] for rows in engine.debug_data_lists]
    engine = JaxEngine(params, CFG, tok, args, mesh=mesh,
                       lora=TREES["lora"] if case.get("lora") else None,
                       lora_scale=case.get("lora_scale", 0.0), **case["engine"])
    engine.set_fps(2.0)
    engine.input_video_stream(FRAMES)
    engine.input_query_stream(case["conversation"])
    out = engine.inference()
    return [out], [[[d["informative_score"], d["relevance_score"]]
                    for d in engine.debug_data_list]]


@pytest.mark.parametrize("name", list(CASES))
def test_port_ranks_match_the_jax_tp_engine(ranks, name):
    want_resp, want_scores = _jax_run(CASES[name])
    got = ranks[0][name]
    assert ranks[1][name] == got, "the two ranks' rows differ"
    for lane, (g, w) in enumerate(zip(got["responses"], want_resp)):
        assert [(t["role"], t["content"]) for t in g] == \
            [(t["role"], t["content"]) for t in w], f"lane {lane}"
        np.testing.assert_allclose([t["time"] for t in g], [t["time"] for t in w], rtol=0,
                                   atol=1e-9)
    for lane, (g, w) in enumerate(zip(got["scores"], want_scores)):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"lane {lane}")
    if name == "generation":
        assert any(t["role"] == "assistant" for t in got["responses"][0]), \
            "the scenario must trigger a generation"


def test_ranks_load_nothing_of_jax(ranks):
    assert [r["modules"] for r in ranks] == [[], []]


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
    for name, seed in (("v0", 0), ("flaky", 9), ("v1", 1)):
        w = cv2.VideoWriter(str(d / "videos" / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            10, (36, 28))
        r = np.random.RandomState(seed)
        for _ in range(30):
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


@pytest.mark.parametrize("route", [[], ["--batch_streams", "2"], ["--is_online_model", "false"]],
                         ids=["single", "batched", "offline"])
def test_cli_under_torchrun_writes_the_one_process_rows(cli_inputs, route, monkeypatch):
    """The rows of the one process. Sample k is decoded by rank k mod 2
    alone (each rank's count on stderr); sample 1's video fails to decode
    on rank 1 alone (`torch_cli_worker`), and in the one process: every
    rank skips it."""
    from mmduet_tpu_torch.data import eval_dataset
    from mmduet_tpu_torch.eval.inference import main as torch_main

    d, argv = cli_inputs
    name = route[-1] if route else "single"
    one, tp = d / f"one_{name}.jsonl", d / f"tp_{name}.jsonl"
    monkeypatch.setattr(eval_dataset, "decode_video", cli_worker.failing(
        eval_dataset.decode_video, "flaky.mp4", lambda: True))
    torch_main(argv + route + ["--output_fname", str(one)])
    out = _torchrun("tests/torch_cli_worker.py", "1", "flaky.mp4", *argv, *route,
                    "--mesh_model", "2", "--dist_backend", "gloo", "--output_fname", str(tp))
    assert cli_worker.decoded(out.stderr) == {(0, 0): (2, 3), (0, 1): (1, 3)}
    assert out.stderr.count("skipping qflaky:") == 2
    got, want = _rows(tp), _rows(one)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g_debug, w_debug = g.pop("debug_data", []), w.pop("debug_data", [])
        assert g == w
        # the scores, rounded to 3 decimals in the rows: an f32 sum in another
        # order may land a value on the other side of a rounding boundary
        assert [x["time"] for x in g_debug] == [x["time"] for x in w_debug]
        for key in ("informative_score", "relevance_score"):
            np.testing.assert_allclose([x[key] for x in g_debug], [x[key] for x in w_debug],
                                       atol=1.001e-3, rtol=0)


def test_cli_mesh_model_outside_torchrun_says_how_to_start_it(tmp_path, monkeypatch):
    from mmduet_tpu_torch.eval.inference import main as torch_main

    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run --nproc_per_node 2"):
        torch_main(["--tiny_random", "--test_fname", "x", "--input_dir", "x", "--device",
                    "cpu", "--output_fname", str(tmp_path / "o.jsonl"), "--mesh_model", "2"])
