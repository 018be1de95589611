"""The port's offline whole-video baseline (`eval/offline_baseline.py`)
against the JAX runner on the same parameters, frames and questions
(answers and cursors equal), and the inference CLI's flags that reach it
and the rest of this slice: ``--is_online_model false`` (the JAX CLI's row
schema), ``--prewarm`` (rows equal a cold run's) and ``--profile_dir`` (a
Chrome trace)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.eval.offline_baseline import OfflineBaselineRunner as JaxRunner
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.eval.offline_baseline import OfflineBaselineRunner
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models.io import config_from_dict

CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
JP = jax_init(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")


def runners(**kw):
    args = InferArgs(max_new_tokens=8, stream_end_prob_threshold=0.5, **kw)
    j = JaxRunner(JP, CFG, TOK, args)
    t = OfflineBaselineRunner(TP, config_from_dict(dataclasses.asdict(CFG)), TOK,
                              PortInferArgs(**dataclasses.asdict(args)))
    for r in (j, t):
        r.set_fps(2.0)
    return j, t


@pytest.mark.parametrize("n_frames,question,rep", [
    (6, "What is happening?", None), (3, "And now?", 1.3), (70, "Long one?", None),
], ids=["six_frames", "repetition_penalty", "several_256_row_chunks"])
def test_answer_equals_the_jax_runners(n_frames, question, rep):
    """The same answer and cursor; 70 frames x 4 tokens go through two
    256-row prefill chunks and a tail. The runner is reused: `answer`
    resets it."""
    j, t = runners(repetition_penalty=rep, max_num_frames=80)
    frames = np.random.RandomState(n_frames).randint(0, 255, (n_frames, 32, 32, 3), np.uint8)
    for runner in (j, t):  # a first video on the same runner
        runner.answer(frames[:2], "warm?")
    want, got = j.answer(frames, question), t.answer(frames, question)
    assert isinstance(got, str) and got == want
    assert t.state.cursor == j.state.cursor


def test_prompt_holds_frames_and_question():
    """The prefill holds the system and user headers, every frame token,
    the question and the assistant header: one untimed pass; the answer's
    tokens stay in the cache after it."""
    _, t = runners()
    frames = np.random.RandomState(1).randint(0, 255, (4, 32, 32, 3), np.uint8)
    t.answer(frames, "Q?")
    prompt_len = (
        len(TOK.encode("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                       "<|im_start|>user\n"))
        + 4 * CFG.frame_num_tokens
        + len(TOK.encode("\nQ?<|im_end|>\n<|im_start|>assistant\n"))
    )
    assert prompt_len + 1 <= t.state.cursor <= prompt_len + 8
    # the last answer token is never fed back, so it has no cache slot
    assert t.state.cursor == prompt_len + t.tokens_generated - 1
    assert t.debug_data_list == []  # no score-threshold policy ran


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _fixture(tmp_path):
    import cv2

    vids = tmp_path / "videos"
    vids.mkdir()
    r = np.random.RandomState(0)
    for name in ("a.mp4", "b.mp4"):
        w = cv2.VideoWriter(str(vids / name), cv2.VideoWriter_fourcc(*"mp4v"), 10, (36, 28))
        for _ in range(30):
            w.write(r.randint(0, 255, (28, 36, 3), np.uint8))
        w.release()
    anno = [{"question_id": f"q{i}", "video": name,
             "conversation": [{"role": "user", "content": "query?", "time": i}]}
            for i, name in enumerate(("a.mp4", "b.mp4"))]
    (tmp_path / "eval.json").write_text(json.dumps(anno))
    return ["--no_prefetch", "--input_dir", str(vids), "--test_fname",
            str(tmp_path / "eval.json"), "--frame_fps", "2", "--max_num_frames", "6",
            "--max_new_tokens", "4"]


def _rows(path) -> list:
    return [json.loads(line) for line in open(path)]


def test_cli_offline_baseline_rows_have_the_jax_schema(tmp_path):
    from mmduet_tpu.eval.inference import main as jax_main
    from mmduet_tpu_torch.eval.inference import main as torch_main

    common = _fixture(tmp_path) + ["--tiny_random", "--is_online_model", "false"]
    jax_main(common + ["--output_fname", str(tmp_path / "jax.jsonl")])
    torch_main(common + ["--output_fname", str(tmp_path / "torch.jsonl"), "--device", "cpu"])
    j_rows, t_rows = _rows(tmp_path / "jax.jsonl"), _rows(tmp_path / "torch.jsonl")
    assert len(t_rows) == len(j_rows) == 2
    for t, j in zip(t_rows, j_rows):
        assert set(t) == set(j) == {"question_id", "model_response", "question", "video_duration"}
        assert (t["question_id"], t["question"], t["video_duration"]) == (
            j["question_id"], j["question"], j["video_duration"])
        assert isinstance(t["model_response"], list) and isinstance(t["model_response"][0], str)


@pytest.mark.parametrize("extra", [
    [], ["--grounding_mode", "true"], ["--batch_streams", "2"],
], ids=["generation", "grounding", "batched"])
def test_cli_prewarm_gives_the_rows_of_a_cold_run(tmp_path, extra, capsys):
    from mmduet_tpu_torch.eval.inference import main as torch_main

    common = _fixture(tmp_path) + ["--tiny_random", "--device", "cpu",
                                   "--stream_end_prob_threshold", "0.5"] + extra
    torch_main(common + ["--output_fname", str(tmp_path / "cold.jsonl")])
    torch_main(common + ["--output_fname", str(tmp_path / "warm.jsonl"), "--prewarm"])
    assert "prewarm:" in capsys.readouterr().err

    def strip(rows):  # wall-clock latencies differ between runs
        return [{k: v for k, v in r.items() if k != "latency"} for r in rows]

    cold, warm = _rows(tmp_path / "cold.jsonl"), _rows(tmp_path / "warm.jsonl")
    assert len(cold) == 2 and strip(warm) == strip(cold)


def test_cli_profile_dir_writes_a_chrome_trace(tmp_path, capsys):
    from mmduet_tpu_torch.eval.inference import main as torch_main

    prof = tmp_path / "prof"
    torch_main(_fixture(tmp_path) + [
        "--tiny_random", "--device", "cpu", "--stream_end_prob_threshold", "0.5",
        "--output_fname", str(tmp_path / "o.jsonl"), "--profile_dir", str(prof)])
    path = prof / "trace.json"
    assert f"profiler trace written to {path}" in capsys.readouterr().err
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len(_rows(tmp_path / "o.jsonl")) == 2 and os.path.getsize(path) > 0
