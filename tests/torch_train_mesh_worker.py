"""One rank of the port's training mesh for `tests/test_torch_train_mesh.py`
(not a pytest module itself).

Usage (from the repository root, ``PYTHONPATH`` holding it)::

    python -m torch.distributed.run --nproc_per_node N tests/torch_train_mesh_worker.py DIR

``DIR`` holds ``inputs.pt`` (the port's parameter tree and whole initial
`TrainState`, built by the test from the JAX package's numpy values, and
the global batches) and ``case.json`` (the mesh shape, the parameter mode,
the training arguments, the step after which to save a checkpoint, a
checkpoint to resume from, whether to take a step with a NaN in data rank
0's features). The rank joins a gloo group, makes its process mesh on the
CPU, cuts the tree and the state (`shard_params`, `shard_train_state`),
stages its share of each batch (`rank_batch`), takes the steps and writes
``DIR/rank<r>.pt``: its share of the first batch, each step's metrics, the
gathered trainable leaves after each step, the first averaged gradients
(gathered over ``model``), the gathered optimizer state after the first
step, the local shapes of its trainable and moment blocks, and the modules
of jax or of the JAX package that the process loaded (none).
"""

import json
import os
import sys

import torch

from mmduet_tpu_torch.config import TrainArgs, tiny_config
from mmduet_tpu_torch.parallel import (initialize_distributed, make_mesh, shard_params,
                                       shard_train_state)
from mmduet_tpu_torch.parallel.sharding import gather_train_state, gather_trainable
from mmduet_tpu_torch.train import checkpoint, make_optimizer
from mmduet_tpu_torch.train.optimizer import tree_leaves
from mmduet_tpu_torch.train.step import TrainState, make_grad_fn, make_train_step, rank_batch


def _shapes(tree):
    return [tuple(t.shape) for t in tree_leaves(tree)]


def main(out_dir: str) -> None:
    initialize_distributed("gloo")
    rank = torch.distributed.get_rank()
    with open(os.path.join(out_dir, "case.json")) as f:
        case = json.load(f)
    mesh = make_mesh(tuple(case["shape"]), device="cpu")
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
    cfg = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
    args = TrainArgs(**case["args"])
    tx, sched = make_optimizer(args, total_steps=case["total_steps"])
    params = shard_params(inputs["params"], mesh, mode=case["mode"])
    state = shard_train_state(TrainState(**inputs["state"]), mesh)
    batches = [rank_batch(b, cfg, mesh) for b in inputs["batches"]]
    out = {"staged": batches[0], "trainable_shapes": _shapes(state.trainable),
           "moment_shapes": _shapes(state.opt_state["mu"]),
           "grads": gather_trainable(make_grad_fn(cfg, args, mesh)(
               state.trainable, params, batches[0])[0], mesh),
           "metrics": [], "trainable": []}
    step = make_train_step(cfg, args, tx, sched, mesh=mesh)
    for i, batch in enumerate(batches):
        state, metrics = step(state, params, batch)
        out["metrics"].append(metrics)
        out["trainable"].append(gather_trainable(state.trainable, mesh))
        if i == 0:
            out["opt_state"] = gather_train_state(state, mesh).opt_state
        if case.get("save_at") == i + 1:
            checkpoint.save_train_state(os.path.join(out_dir, "ckpt"), i + 1, state, mesh=mesh)
    if case.get("nan"):
        before = list(tree_leaves(state.trainable))
        count = state.opt_state["count"]
        state, metrics = step(state, params, rank_batch(inputs["nan_batch"], cfg, mesh))
        out["nan"] = {"metrics": metrics, "step": state.step,
                      "count": state.opt_state["count"], "count_before": count,
                      "kept": all(torch.equal(a, b)
                                  for a, b in zip(before, tree_leaves(state.trainable)))}
    if case.get("resume"):
        resumed = checkpoint.restore_train_state(case["resume"], state, mesh=mesh)
        resumed, metrics = step(resumed, params, batches[resumed.step])
        out["resumed"] = {"step": resumed.step, "metrics": metrics,
                          "trainable": gather_trainable(resumed.trainable, mesh)}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mmduet_tpu"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()  # no rank leaves while another reads its last collective
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
