"""`scripts/verify_checkpoint_parity_torch.py`, the real-weights gate on the
port (`docs/REAL_CHECKPOINT.md` step 2): the tiny HF directory of
`tests/test_torch_journey.py` converted by the port's converter passes it on
the CPU at the JAX gate's test tolerance (`tests/test_user_journey.py`), and
checkpoints with a mis-mapped projector or swapped score heads fail it."""

import builtins
import os
import shutil
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from test_bpe_tokenizer import build_qwen2_style_tokenizer  # noqa: E402
from test_torch_convert import hf_config, hf_tensors, write_hf_dir  # noqa: E402

from mmduet_tpu_torch.models.convert import main as convert_main  # noqa: E402
from mmduet_tpu_torch.models.io import PARAMS_FILE  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import verify_checkpoint_parity_torch as gate  # noqa: E402

GATE_ARGS = ["--n_prompts", "3", "--seq_len", "24", "--atol", "0.01", "--device", "cpu"]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(hf_dir, the port's f32 conversion of it)."""
    tok = build_qwen2_style_tokenizer()
    vocab = len(tok) + 8  # headroom rows like the real checkpoint
    root = tmp_path_factory.mktemp("gate")
    hf_dir = write_hf_dir(root / "hf", hf_tensors(vocab), hf_config(vocab, tok.eos_token_id),
                          "index", tokenizer=tok)
    ckpt = str(root / "ckpt")
    convert_main(["--hf_dir", hf_dir, "--output", ckpt, "--dtype", "float32", "--device", "cpu"])
    return hf_dir, ckpt


def test_gate_passes_on_the_converted_directory(converted, capsys):
    hf_dir, ckpt = converted
    assert gate.main(["--hf_dir", hf_dir, "--checkpoint", ckpt, *GATE_ARGS]) == 0
    out = capsys.readouterr().out
    assert "PARITY OK" in out and "greedy argmax agreement: 3/3" in out
    for check in ("next-token logits", "informative_prob", "relevance_prob",
                  "vision layer(-2) features", "projector output", "pooled tokens"):
        assert f"ok   prompt0 {check}" in out or f"ok   {check}" in out


def _corrupted(ckpt: str, tmp_path, edit) -> str:
    bad = str(tmp_path / "bad")
    shutil.copytree(ckpt, bad)
    tree = torch.load(os.path.join(bad, PARAMS_FILE), weights_only=True)
    edit(tree["params"])
    torch.save(tree, os.path.join(bad, PARAMS_FILE))
    return bad


def _transpose_fc1(p):
    p["projector"]["fc1"] = p["projector"]["fc1"].T.contiguous()


def _swap_heads(p):
    p["informative_head"], p["relevance_head"] = p["relevance_head"], p["informative_head"]


@pytest.mark.parametrize("edit, failing", [
    (_transpose_fc1, "FAIL projector output"),
    (_swap_heads, "FAIL prompt0 informative_prob"),
])
def test_gate_fails_on_a_mismapped_checkpoint(converted, tmp_path, capsys, edit, failing):
    hf_dir, ckpt = converted
    bad = _corrupted(ckpt, tmp_path, edit)
    assert gate.main(["--hf_dir", hf_dir, "--checkpoint", bad, *GATE_ARGS]) == 1
    out = capsys.readouterr().out
    assert failing in out and "PARITY FAILED" in out


def test_port_outputs_against_themselves_and_the_oracle(converted):
    """`port_outputs` and `hf_outputs` give the same keys; `compare` of the
    port's f32 route with itself passes at zero tolerance, and outputs moved
    by 0.05 (one logit, one probability, one feature) pass at a tolerance
    of 0.06 and fail at 0.04."""
    hf_dir, ckpt = converted
    from mmduet_tpu_torch.models.io import load_config

    cfg = load_config(os.path.join(ckpt, "config.json"))
    prompts, pixels = gate.make_inputs(cfg.text.vocab_size, cfg.vision.image_size, 2, 16)
    f32 = gate.port_outputs(ckpt, "cpu", prompts, pixels)
    hf = gate.hf_outputs(hf_dir, prompts, pixels)
    assert set(hf) <= set(f32)
    assert gate.compare(f32, f32, 0.0, 0.0) == []
    moved = dict(f32)
    logits = np.array(f32["prompt0 next-token logits"])
    logits[np.argmin(logits)] += 0.05  # the argmax stays
    moved["prompt0 next-token logits"] = logits
    moved["prompt1 informative_prob"] = f32["prompt1 informative_prob"] + 0.05
    features = np.array(f32["vision layer(-2) features"])
    features.flat[0] += 0.05
    moved["vision layer(-2) features"] = features
    assert gate.compare(moved, f32, 0.06, 0.06) == []
    assert set(gate.compare(moved, f32, 0.04, 0.06)) == {"prompt1 informative_prob",
                                                         "vision layer(-2) features"}
    assert gate.compare(moved, f32, 0.06, 0.04) == ["prompt0 next-token logits"]


def test_gate_names_the_missing_oracle(converted, monkeypatch):
    """Without ``transformers`` the gate stops at once with an error that
    names it; nothing falls back."""
    real_import = builtins.__import__

    def no_transformers(name, *args, **kwargs):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    hf_dir, ckpt = converted
    with pytest.raises(SystemExit, match="transformers"):
        gate.main(["--hf_dir", hf_dir, "--checkpoint", ckpt, *GATE_ARGS])
