"""One rank of the port's data-parallel serving (lanes over ranks) for
`tests/test_torch_dp_serving.py` (not a pytest module itself).

Usage (from the repository root, ``PYTHONPATH`` holding it)::

    python -m torch.distributed.run --nproc_per_node D*M tests/torch_dp_worker.py DIR D M

``DIR`` holds ``params.pt`` (the port's parameter tree, built by the test
from the JAX package's numpy weights), ``inputs.npz`` (frame embeddings
and pixels) and ``cases.json`` (each case: its kind, engine, arguments and
inputs). The rank joins a gloo group, makes the (D, M) process mesh on the
CPU, keeps its local tree (`parallel.shard_params(mode="replicate")`), runs
every case and writes ``DIR/rank<r>.json``: per case the responses and
per-frame scores, the local cache's shape, the decoder forwards this
process ran (and the batched engine's own count of them), and the modules
of jax or of the JAX package that the process loaded (none).
"""

import json
import os
import sys

import numpy as np
import torch

from mmduet_tpu_torch.config import TestArgs, tiny_config
from mmduet_tpu_torch.infer import BatchedStreamEngine, BatchedStreamScorer, LiveInferEngine
from mmduet_tpu_torch.models import qwen2
from mmduet_tpu_torch.parallel import initialize_distributed, make_mesh, shard_params
from mmduet_tpu_torch.stream import CharTokenizer

FORWARDS = [0]  # decoder forwards of this process


def _counted(fn):
    def wrapped(*args, **kw):
        FORWARDS[0] += 1
        return fn(*args, **kw)
    return wrapped


def _rows(debug_lists):
    return [[[d["informative_score"], d["relevance_score"]] for d in rows]
            for rows in debug_lists]


def _engine(case, params, cfg, mesh):
    return BatchedStreamEngine(params, cfg, CharTokenizer(frame_num_tokens=cfg.frame_num_tokens),
                               TestArgs(**case["args"]), mesh=mesh, **case["engine"])


def _stream_all(case, params, cfg, mesh, inputs):
    engine = _engine(case, params, cfg, mesh)
    engine.input_frame_embeds(inputs[case["embeds"]], lengths=np.asarray(case["lengths"]))
    engine.input_query_streams(case["conversations"])
    out = engine.stream_all()
    return engine._cache, {"responses": out, "scores": _rows(engine.debug_data_lists),
                           "forwards": engine.forwards}


def _serve(case, params, cfg, mesh, inputs):
    engine = _engine(case, params, cfg, mesh)
    embeds = inputs[case["embeds"]]
    sessions = ({"frame_embeds": embeds[i, :n], "conversation": case["conversation"]}
                for i, n in enumerate(case["lengths"]))
    got = {str(i): {"responses": resp, "scores": _rows([debug])[0]}
           for i, resp, debug in engine.serve(sessions)}
    return engine._cache, {"sessions": got, "forwards": engine.forwards}


def _score_all(case, params, cfg, mesh, inputs):
    scorer = BatchedStreamScorer(params, cfg, CharTokenizer(frame_num_tokens=cfg.frame_num_tokens),
                                 mesh=mesh, **case["engine"])
    pixels = inputs[case["pixels"]]
    scorer.input_video_streams([pixels[i, :n] for i, n in enumerate(case["lengths"])])
    scorer.start_sessions(case["queries"])
    return scorer._cache, {"scores": _rows(scorer.score_all())}


def _single(case, params, cfg, mesh, inputs):
    engine = LiveInferEngine(params, cfg, CharTokenizer(frame_num_tokens=cfg.frame_num_tokens),
                             TestArgs(**case["args"]), mesh=mesh, **case["engine"])
    engine.input_frame_embeds(inputs[case["embeds"]][0, :case["lengths"][0]])
    engine.input_query_stream(case["conversations"][0])
    out = engine.inference()
    return engine.state.kv_cache, {"responses": [out], "scores": _rows([engine.debug_data_list])}


RUNS = {"stream_all": _stream_all, "serve": _serve, "score_all": _score_all, "single": _single}


def main(out_dir: str, data_n: int, model_n: int) -> None:
    initialize_distributed("gloo")
    rank = torch.distributed.get_rank()
    mesh = make_mesh((data_n, model_n), device="cpu")
    qwen2.qwen2_forward = _counted(qwen2.qwen2_forward)
    qwen2.scratch_decode_forward = _counted(qwen2.scratch_decode_forward)  # a decode step
    params = shard_params(torch.load(os.path.join(out_dir, "params.pt"), weights_only=True),
                          mesh, mode="replicate")
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    with open(os.path.join(out_dir, "cases.json")) as f:
        cases = json.load(f)
    cfg = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
    results = {}
    with torch.inference_mode():
        for name, case in cases.items():
            FORWARDS[0] = 0
            cache, out = RUNS[case["kind"]](case, params, cfg, mesh, inputs)
            results[name] = dict(out, cache=list(cache.k.shape), decoder_forwards=FORWARDS[0])
    results["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "mmduet_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    torch.distributed.barrier()  # no rank leaves while another reads its last collective
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
