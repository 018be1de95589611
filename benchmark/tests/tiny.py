"""A tiny copy of the benchmark for the CPU tests: the same harness, traffic
generator, architectures, reference and metric readers under a temporary
root, with a configuration and a mix small enough for a test run."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark import spec as specs

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent

CONFIG = {
    "name": "tiny",
    "source": "a tiny MMDuet for the CPU tests",
    "architectures": ["LlavaQwenForCausalLM"],
    "reference": "benchmark/reference/model.py",
    "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 512,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "mm_vision_select_layer": -2,
    "vision_config": {"image_size": 32, "patch_size": 8, "hidden_size": 32,
                      "intermediate_size": 64, "num_hidden_layers": 3,
                      "num_attention_heads": 2, "layer_norm_eps": 1e-06},
    "mmduet": {"frame_num_tokens": 4, "video_pooling_stride": 2},
    "serving": {"weights_seed": 0, "weight_bits": None, "kv_cache_quant": None},
    "limits": {"protocol_errors": 0, "score_gap": 0.02, "token_gap": 0.25},
}

MIX = {
    "mode": "generation", "lanes": 4, "block_frames": 4, "frame_fps": 0.5,
    "max_num_frames": 40, "remove_assistant_turns": True, "gen_coalesce_rounds": 0,
    "score_heads": "informative_score", "stream_end_score_sum_threshold": 1.5,
    "max_new_tokens": 6, "repetition_penalty": None,
    "frames": {"min": 8, "max": 24}, "resolution": 32, "pool_videos": 4, "pool_seed": 0,
    "query_time": 0.0, "queries": ["Describe the steps.", "What happens now?"],
}

# the Charades-STA recipe's protocol at the tiny size: scores only, no answers
GROUNDING = dict(MIX, mode="grounding", block_frames=8, frame_fps=2.0, max_num_frames=40,
                 stream_end_score_sum_threshold=None, stream_end_prob_threshold=1.0)


def make_root(tmp: Path, quant: bool = False, config=None, mix=None, files=None) -> tuple:
    """(root, spec, cell) of a one-cell benchmark under ``tmp``; ``files``:
    {path under the root: text} written there too."""
    bench = tmp / "benchmark"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    (bench / "reference").mkdir()
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    shutil.copytree(BENCH / "arch", bench / "arch")
    shutil.copy(BENCH / "reference" / "model.py", bench / "reference" / "model.py")
    for path, text in (files or {}).items():
        (tmp / path).parent.mkdir(parents=True, exist_ok=True)
        (tmp / path).write_text(text)
    cfg = copy.deepcopy(config or CONFIG)
    if quant:
        cfg["name"] = "tiny-w4kv8"
        cfg["serving"].update(weight_bits=4, group_size=128, kv_cache_quant="int8")
    (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    mix = mix or MIX
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    real = specs.load()
    cell = f"{cfg['name']}.tiny"
    # a metric that lists its cells (answers: generation only) lists the tiny
    # cell where its mode has them; the per-layer ones apply as their `moves`
    answers = [cell] if mix["mode"] == "generation" else []
    spec = {
        "command": real["command"], "paths": ["benchmark"], "run_seconds": 2,
        "configs": [{"name": cfg["name"], "source": cfg["source"], "reduced": [],
                     "file": f"benchmark/configs/{cfg['name']}.json", "why": "tests"}],
        "workloads": [{"name": cell, "config": cfg["name"], "traffic": "tiny", "chips": 1,
                       "why": "tests"}],
        "end_to_end": [dict(m, workloads=answers) if "workloads" in m else m
                       for m in real["end_to_end"]],
        "per_layer": [{k: v for k, v in m.items() if k != "workloads"} for m in real["per_layer"]],
    }
    specs.validate(spec, tmp)
    return tmp, spec, spec["workloads"][0]
