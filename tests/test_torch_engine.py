"""The slice as a whole: the port's `LiveInferEngine` and CLI against the
JAX package's, on the same numpy parameters, frames and queries.

f32 on both sides: per-frame debug scores agree to atol=1e-4 (summation
order only); response times, texts and cursors are identical. One case
runs at hidden_size=512 (hd=128) with the JAX side's Pallas kernel in
interpret mode. The two packages' config classes are different classes:
the port's engine gets the port's config and arguments, built from the
JAX ones through the shared ``config.json`` dict. Also here: a run of the
port's engine loads neither jax nor the JAX package."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import mmduet_tpu.ops.attention as jattention
from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.infer import LiveInferEngine as JaxEngine
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models.io import config_from_dict

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
JP = jax_init(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")
FRAMES = np.random.RandomState(0).randint(0, 256, (10, 32, 32, 3), dtype=np.uint8)


def make_args(**kw) -> InferArgs:
    base = dict(system_prompt="sys", frame_fps=2.0, max_new_tokens=6,
                max_num_frames=16, stream_end_prob_threshold=None,
                stream_end_score_sum_threshold=None, threshold_z=None)
    base.update(kw)
    return InferArgs(**base)


def port_cfg(cfg):
    """The port's config class from the JAX one, through the config.json dict."""
    return config_from_dict(dataclasses.asdict(cfg))


def port_args(args: InferArgs) -> PortInferArgs:
    return PortInferArgs(**dataclasses.asdict(args))


def run(engine, frames=FRAMES, queries=((1.0, "what now?"),)):
    engine.input_video_stream(frames)
    engine.input_query_stream(
        [{"role": "user", "content": q, "time": t} for t, q in queries])
    return engine.inference()


def assert_same_run(cfg, jp, tp, args, engine_kw=None, **run_kw):
    engine_kw = dict(kv_cache_size=512, **(engine_kw or {}))
    je = JaxEngine(jp, cfg, TOK, args, **engine_kw)
    te = LiveInferEngine(tp, port_cfg(cfg), TOK, port_args(args), **engine_kw)
    j_resp, t_resp = run(je, **run_kw), run(te, **run_kw)
    assert t_resp == j_resp
    assert [d["time"] for d in te.debug_data_list] == [d["time"] for d in je.debug_data_list]
    for key in ("informative_score", "relevance_score"):
        np.testing.assert_allclose(
            [d[key] for d in te.debug_data_list],
            [d[key] for d in je.debug_data_list], atol=ATOL, rtol=0)
    assert te.state.cursor == je.state.cursor
    assert te._next_frame == je._next_frame == len(run_kw.get("frames", FRAMES))
    return t_resp


MODES = {
    "prob": dict(stream_end_prob_threshold=0.5),
    "sum": dict(stream_end_score_sum_threshold=1.5, repetition_penalty=1.2),
    "z": dict(threshold_z=0.3, first_n_frames_no_generate=2),
}


@pytest.mark.parametrize("remove_turns", [False, True], ids=["keep_turns", "remove_turns"])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(mode, remove_turns):
    resp = assert_same_run(
        CFG, JP, TP, make_args(remove_assistant_turns=remove_turns, **MODES[mode]),
        engine_kw=dict(block_frames=4))
    assert any(r["role"] == "assistant" for r in resp) or mode == "z"


def test_engine_grounding_mode_matches_jax():
    resp = assert_same_run(
        CFG, JP, TP, make_args(stream_end_prob_threshold=0.5, grounding_mode=True),
        engine_kw=dict(block_frames=4))
    assert [r["role"] for r in resp] == ["user"]


def test_engine_query_interrupting_a_block_matches_jax():
    # the 4-frame block starting at t=0 would reach t=1.5; a query due at
    # t=1.2 cuts it to single steps, and a second one lands mid-stream
    assert_same_run(
        CFG, JP, TP, make_args(stream_end_score_sum_threshold=1.0),
        engine_kw=dict(block_frames=4), queries=((1.2, "first?"), (3.1, "second?")))


def test_engine_cache_overflow_raises_in_both():
    big = np.random.RandomState(1).randint(0, 256, (600, 32, 32, 3), dtype=np.uint8)
    args = make_args(stream_end_prob_threshold=1.0, grounding_mode=True, max_num_frames=600)
    for engine in (JaxEngine(JP, CFG, TOK, args, kv_cache_size=40),
                   LiveInferEngine(TP, port_cfg(CFG), TOK, port_args(args), kv_cache_size=40)):
        assert engine.state.capacity == 2048  # rounded up to 2048 in both
        with pytest.raises(RuntimeError, match="overflow"):
            run(engine, frames=big, queries=())


def test_engine_hd128_against_pallas_interpret(monkeypatch):
    """head_dim 128: the JAX engine runs its Pallas kernel (interpreted)."""
    monkeypatch.setattr(jattention, "_FORCE_INTERPRET", True)
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    jp = jax_init(jax.random.PRNGKey(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert_same_run(cfg, jp, tp, make_args(stream_end_prob_threshold=0.5),
                    engine_kw=dict(block_frames=4), frames=FRAMES[:6])


def test_engine_input_vision_feats_matches_jax():
    """Raw SigLIP patch features in: projector + pooling run in the engine."""
    feats = np.random.RandomState(2).randn(
        6, CFG.vision.num_patches, CFG.vision.hidden_size).astype(np.float32)
    args = make_args(stream_end_prob_threshold=0.5, grounding_mode=True)
    out = []
    for engine in (JaxEngine(JP, CFG, TOK, args, kv_cache_size=512),
                   LiveInferEngine(TP, port_cfg(CFG), TOK, port_args(args),
                                   kv_cache_size=512)):
        engine.input_vision_feats(feats)
        engine.inference()
        out.append((np.asarray(engine.frame_embeds),
                    [d["relevance_score"] for d in engine.debug_data_list]))
    np.testing.assert_allclose(out[1][0], out[0][0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[1][1], out[0][1], atol=ATOL, rtol=0)


def test_engine_unported_options_raise():
    args = port_args(make_args(stream_end_prob_threshold=0.5))
    with pytest.raises(NotImplementedError, match="mesh"):
        LiveInferEngine(TP, port_cfg(CFG), TOK, args, mesh=object())
    with pytest.raises(ValueError, match="unknown KV cache quant"):
        LiveInferEngine(TP, port_cfg(CFG), TOK, args, kv_cache_quant="int4")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _fixture(tmp_path):
    import cv2

    vids = tmp_path / "videos"
    vids.mkdir()
    w = cv2.VideoWriter(str(vids / "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (36, 28))
    r = np.random.RandomState(0)
    for _ in range(30):
        w.write(r.randint(0, 255, (28, 36, 3), np.uint8))
    w.release()
    anno = [{"question_id": "q0", "video": "a.mp4",
             "conversation": [{"role": "user", "content": "query?", "time": 0}]}]
    test_f = tmp_path / "eval.json"
    test_f.write_text(json.dumps(anno))
    return ["--tiny_random", "--no_prefetch", "--input_dir", str(vids),
            "--test_fname", str(test_f), "--frame_fps", "2",
            "--max_num_frames", "6", "--stream_end_prob_threshold", "0.5",
            "--max_new_tokens", "4"]


def _keys(o):
    """The nested key structure of a JSONL row (values ignored)."""
    if isinstance(o, dict):
        return {k: _keys(v) for k, v in o.items()}
    if isinstance(o, list):
        return sorted({json.dumps(_keys(x), sort_keys=True) for x in o})
    return None


def test_cli_jsonl_has_the_jax_cli_schema(tmp_path):
    from mmduet_tpu.eval.inference import main as jax_main
    from mmduet_tpu_torch.eval.inference import main as torch_main

    common = _fixture(tmp_path)
    jax_main(common + ["--output_fname", str(tmp_path / "jax.jsonl")])
    torch_main(common + ["--output_fname", str(tmp_path / "torch.jsonl"), "--device", "cpu"])
    j_rows = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    t_rows = [json.loads(line) for line in open(tmp_path / "torch.jsonl")]
    assert len(t_rows) == len(j_rows) == 1
    assert _keys(t_rows[0]) == _keys(j_rows[0])
    assert len(t_rows[0]["debug_data"]) == len(j_rows[0]["debug_data"]) == 6


@pytest.mark.parametrize("flag", [
    ["--batch_streams", "2"], ["--mesh_model", "2"], ["--mesh_data", "2"],
    ["--is_online_model", "false"], ["--prewarm"], ["--profile_dir", "prof"],
])
def test_cli_unported_flags_raise(tmp_path, flag):
    from mmduet_tpu_torch.eval.inference import main as torch_main

    argv = ["--tiny_random", "--test_fname", "x", "--input_dir", "x",
            "--output_fname", str(tmp_path / "o.jsonl"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="not yet ported"):
        torch_main(argv + flag)


# ---------------------------------------------------------------------------
# no jax, and nothing of the JAX package, in a run of the port
# ---------------------------------------------------------------------------

JAX_FREE = """
import importlib, pkgutil, sys
import numpy as np, torch
import mmduet_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(mmduet_tpu_torch.__path__, "mmduet_tpu_torch."):
    importlib.import_module(m.name)
from mmduet_tpu_torch.config import TestArgs, tiny_config
from mmduet_tpu_torch.stream import CharTokenizer
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import init_mmduet_params
from mmduet_tpu_torch.models.quant import quantize_params
cfg = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
params = init_mmduet_params(cfg, torch.Generator().manual_seed(0), "cpu")
params = quantize_params(params, bits=4)
eng = LiveInferEngine(params, cfg, CharTokenizer(frame_num_tokens=4), TestArgs(
    system_prompt="s", max_new_tokens=4, max_num_frames=8, stream_end_prob_threshold=0.5),
    kv_cache_quant="int8")
eng.input_video_stream(np.zeros((5, 32, 32, 3), np.uint8))
eng.input_query_stream([{"role": "user", "content": "q", "time": 0.0}])
eng.inference()
assert len(eng.debug_data_list) == 5
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmduet_tpu")))
"""


def test_port_never_imports_jax():
    """A fresh interpreter imports every module of the port and
    `chip_smoke`, runs the quantized engine, and holds neither `jax` nor
    any module of `mmduet_tpu`."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", JAX_FREE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
