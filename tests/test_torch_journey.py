"""The user journey through the port, held against the JAX journey at each
hand-off, at tiny scale with real structure (the port's counterpart of
`tests/test_user_journey.py`):

  HF-format checkpoint dir (sharded safetensors + config + BPE tokenizer)
    -> the port's conversion CLI          == the JAX converter's leaves
    -> the port's training CLI (grounding data over real mp4s, pixel path)
                                          == the JAX CLI's first logged loss
    -> the port's eval CLI on the TRAINED output (Charades protocol,
       grounding mode)                    == the JAX CLI's rows on the same
                                             weights
    -> the port's `evaluate`              == the reference `evaluate` on the
                                             same rows.

f32 on both sides. The two training CLIs draw their LoRA A factors from
different generators (torch and `jax.random`), so only the first step's
loss, taken while every B factor is still zero, is compared; the trained
weights cross to the JAX CLI through a JAX checkpoint written here."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("transformers")
cv2 = pytest.importorskip("cv2")

from test_bpe_tokenizer import build_qwen2_style_tokenizer  # noqa: E402
from test_torch_convert import (assert_same_rows, assert_trees_equal, hf_config,  # noqa: E402
                                hf_tensors, jax_leaves, write_hf_dir)

from mmduet_tpu.models import io as jio  # noqa: E402
from mmduet_tpu_torch.models import io as tio  # noqa: E402
from mmduet_tpu_torch.models.convert import TOKENIZER_FILES  # noqa: E402


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    tok = build_qwen2_style_tokenizer()
    vocab = len(tok) + 8  # headroom rows like the real checkpoint
    return write_hf_dir(tmp_path_factory.mktemp("hf"), hf_tensors(vocab),
                        hf_config(vocab, tok.eos_token_id), "index", tokenizer=tok)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Grounding dataset: 2 real mp4s, 4 training annotations, 1 eval sample."""
    d = tmp_path_factory.mktemp("data")
    vids = d / "videos"
    vids.mkdir()
    r = np.random.RandomState(0)
    for name in ("a.mp4", "b.mp4"):
        w = cv2.VideoWriter(str(vids / name), cv2.VideoWriter_fourcc(*"mp4v"), 10, (36, 28))
        for _ in range(40):  # 4 s
            w.write(r.randint(0, 255, (28, 36, 3), np.uint8))
        w.release()
    train_anno = [
        {"video_uid": "a.mp4", "query": "a thing moves", "timestamps": [[1.0, 3.0]]},
        {"video_uid": "b.mp4", "query": "something appears", "timestamps": [[0.0, 2.0]]},
        {"video_uid": "a.mp4", "query": "motion happens", "timestamps": [[2.0, 4.0]]},
        {"video_uid": "b.mp4", "query": "a shape shows up", "timestamps": [[1.0, 3.0]]},
    ]
    (d / "train.json").write_text(json.dumps(train_anno))
    (d / "dataset_config.json").write_text(json.dumps([{
        "dataset_cls": "GroundingStreamDataset",
        "video_root": str(vids),
        "anno_file": str(d / "train.json"),
        "metadata_path": str(d / "videos_metadata.json"),
    }]))
    eval_anno = [
        {"question_id": "q0", "video": "a.mp4",
         "conversation": [{"role": "user", "content": "a thing moves", "time": 0}],
         "timestamps": [[1.0, 3.0]]},
        {"question_id": "q1", "video": "b.mp4",
         "conversation": [{"role": "user", "content": "something appears", "time": 0}],
         "timestamps": [[0.0, 2.0]]},
    ]
    (d / "charades.json").write_text(json.dumps(eval_anno))
    return str(d)


def to_jax_checkpoint(port_dir: str, out: str) -> None:
    """A JAX checkpoint (orbax params, config.json, tokenizer files) of the
    port's checkpoint directory, leaf for leaf."""
    cfg, params, lora = tio.load_checkpoint(port_dir, device="cpu")

    def to_jnp(tree):
        if tree is None or isinstance(tree, dict):
            return tree if tree is None else {k: to_jnp(v) for k, v in tree.items()}
        return jnp.asarray(tree.numpy())

    jio.save_checkpoint(out, jio.load_config(os.path.join(port_dir, "config.json")),
                        to_jnp(params), lora=to_jnp(lora))
    for name in TOKENIZER_FILES:
        if os.path.exists(os.path.join(port_dir, name)):
            shutil.copy(os.path.join(port_dir, name), os.path.join(out, name))


def test_full_journey_matches_the_jax_journey(hf_dir, data_dir, tmp_path):
    from mmduet_tpu.eval.evaluate import main as jax_evaluate
    from mmduet_tpu.eval.inference import main as jax_infer
    from mmduet_tpu.models.convert import main as jax_convert
    from mmduet_tpu.train.loop import main as jax_train
    from mmduet_tpu_torch.eval.evaluate import main as port_evaluate
    from mmduet_tpu_torch.eval.inference import main as port_infer
    from mmduet_tpu_torch.models.convert import main as port_convert
    from mmduet_tpu_torch.train.loop import main as port_train

    # --- conversion: the same leaves
    port_ckpt, jax_ckpt = str(tmp_path / "port_ckpt"), str(tmp_path / "jax_ckpt")
    port_convert(["--hf_dir", hf_dir, "--output", port_ckpt, "--dtype", "float32",
                  "--device", "cpu"])
    jax_convert(["--hf_dir", hf_dir, "--output", jax_ckpt, "--dtype", "float32"])
    for name in ("tokenizer.json", "config.json"):
        assert os.path.exists(os.path.join(port_ckpt, name))
    _, tp, _ = tio.load_checkpoint(port_ckpt, device="cpu")
    _, jp, _ = jio.load_checkpoint(jax_ckpt)
    assert_trees_equal(tp, jax_leaves(jp))

    # --- training: one optimizer step of A=2 over the grounding data
    train_args = [
        "--dataset_config", os.path.join(data_dir, "dataset_config.json"),
        "--per_device_batch_size", "1", "--grad_accum_steps", "2", "--num_epochs", "1",
        "--frame_fps", "1", "--max_num_frames", "6", "--seq_len", "320", "--lora_r", "2",
        "--save_steps", "0", "--logging_steps", "1", "--dataloader_num_workers", "2",
        "--bf16", "false",
    ]
    port_run, jax_run = str(tmp_path / "port_run"), str(tmp_path / "jax_run")
    port_train(train_args + ["--checkpoint", port_ckpt, "--output_dir", port_run,
                             "--device", "cpu"])
    jax_train(train_args + ["--checkpoint", jax_ckpt, "--output_dir", jax_run,
                            "--mesh_data", "1"])
    logs = [[json.loads(line) for line in open(os.path.join(run, "log.jsonl"))]
            for run in (port_run, jax_run)]
    assert len(logs[0]) == len(logs[1]) > 0 and set(logs[0][0]) == set(logs[1][0])
    assert logs[0][0]["step"] == logs[1][0]["step"] == 1
    np.testing.assert_allclose(logs[0][0]["loss"], logs[1][0]["loss"], rtol=1e-4)
    assert all(np.isfinite(row["loss"]) for row in logs[0])
    final = os.path.join(port_run, "final")
    for name in ("config.json", "params.pt", "tokenizer.json"):
        assert os.path.exists(os.path.join(final, name))

    # --- eval on the TRAINED weights: the Charades protocol, grounding mode
    jax_final = str(tmp_path / "jax_final")
    to_jax_checkpoint(final, jax_final)
    eval_args = [
        "--grounding_mode", "true", "--stream_end_prob_threshold", "1",
        "--input_dir", os.path.join(data_dir, "videos"),
        "--test_fname", os.path.join(data_dir, "charades.json"),
        "--frame_fps", "1", "--max_num_frames", "6", "--no_prefetch",
    ]
    port_pred, jax_pred = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_infer(eval_args + ["--checkpoint", final, "--output_fname", port_pred,
                            "--device", "cpu"])
    jax_infer(eval_args + ["--checkpoint", jax_final, "--output_fname", jax_pred])
    rows = [[json.loads(line) for line in open(p)] for p in (port_pred, jax_pred)]
    assert len(rows[0]) == 2 and all(len(r["debug_data"]) >= 4 for r in rows[0])
    assert_same_rows(*rows)

    # --- metrics: the port's evaluate equals the reference's on the same
    # rows: the streaming rows, and the offline baseline's rows of the same
    # trained checkpoint
    base_pred = str(tmp_path / "baseline.jsonl")
    port_infer(eval_args + ["--checkpoint", final, "--output_fname", base_pred,
                            "--device", "cpu", "--is_online_model", "false",
                            "--max_new_tokens", "8"])
    for pred, extra in ((port_pred, []), (base_pred, ["--is_online_model", "0"])):
        outs = []
        for name, evaluate in (("port", port_evaluate), ("jax", jax_evaluate)):
            out = str(tmp_path / f"metrics_{name}.json")
            evaluate(["--func", "grounding", "--pred_file", pred,
                      "--gold_file", os.path.join(data_dir, "charades.json"),
                      "--output_file", out] + extra)
            outs.append(json.load(open(out)))
        assert outs[0] == outs[1], pred
        if pred == port_pred:  # the window and threshold sweep
            assert any(r["threshold"] == "oracle" for r in outs[0])
        else:
            assert len(outs[0]["scores"]) == 4  # mIoU, R@.3, R@.5, R@.7
