"""One rank of the port's tensor-parallel serving for
`tests/test_torch_tp_serving.py` (not a pytest module itself).

Usage (from the repository root, ``PYTHONPATH`` holding it)::

    python -m torch.distributed.run --nproc_per_node 2 tests/torch_tp_worker.py DIR

``DIR`` holds ``trees.pt`` (the port's parameter trees by name, built by
the test from the JAX package's numpy weights), ``inputs.npz`` (frames and
frame embeddings) and ``cases.json`` (each case: its tree, engine,
arguments and inputs). The rank joins a gloo group, makes the (1, N)
process mesh on the CPU, runs every case on its local tree
(`parallel.shard_params`) and writes ``DIR/rank<r>.json``: per case the
responses and per-frame scores, and the modules of jax or of the JAX
package that the process loaded (none).
"""

import json
import os
import sys

import numpy as np
import torch

from mmduet_tpu_torch.config import TestArgs, tiny_config
from mmduet_tpu_torch.infer import BatchedStreamEngine, LiveInferEngine
from mmduet_tpu_torch.parallel import initialize_distributed, make_mesh, shard_params
from mmduet_tpu_torch.stream import CharTokenizer


def _single(case, params, cfg, mesh, inputs, lora):
    engine = LiveInferEngine(params, cfg, CharTokenizer(frame_num_tokens=cfg.frame_num_tokens),
                             TestArgs(**case["args"]), mesh=mesh, lora=lora,
                             lora_scale=case.get("lora_scale", 0.0), **case["engine"])
    engine.set_fps(2.0)
    engine.input_video_stream(inputs["frames"])
    engine.input_query_stream(case["conversation"])
    out = engine.inference()
    return {"responses": [out],
            "scores": [[[d["informative_score"], d["relevance_score"]]
                        for d in engine.debug_data_list]],
            "cursor": engine.state.cursor}


def _batched(case, params, cfg, mesh, inputs, lora):
    engine = BatchedStreamEngine(params, cfg, CharTokenizer(frame_num_tokens=cfg.frame_num_tokens),
                                 TestArgs(**case["args"]), mesh=mesh, **case["engine"])
    engine.input_frame_embeds(inputs["embeds"], lengths=np.asarray(case["lengths"]))
    engine.input_query_streams(case["conversations"])
    out = engine.stream_all()
    return {"responses": out,
            "scores": [[[d["informative_score"], d["relevance_score"]] for d in rows]
                       for rows in engine.debug_data_lists]}


def main(out_dir: str) -> None:
    initialize_distributed("gloo")
    rank = torch.distributed.get_rank()
    mesh = make_mesh((1, torch.distributed.get_world_size()), device="cpu")
    trees = torch.load(os.path.join(out_dir, "trees.pt"), weights_only=True)
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    with open(os.path.join(out_dir, "cases.json")) as f:
        cases = json.load(f)
    cfg = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
    local = {name: shard_params(tree, mesh) for name, tree in trees.items() if name != "lora"}
    results = {}
    with torch.inference_mode():
        for name, case in cases.items():
            run = _batched if case["kind"] == "batched" else _single
            lora = trees["lora"] if case.get("lora") else None
            results[name] = run(case, local[case["tree"]], cfg, mesh, inputs, lora)
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "mmduet_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    torch.distributed.barrier()  # no rank leaves while another reads its last collective
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
