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
step, the local shapes of its trainable and moment blocks, the steps that
`train.loop.rank_real_batches` read for it from `LoaderData` and the
dataset positions it fetched, and the modules of jax or of the JAX package
that the process loaded (none).

The test imports this module for `LoaderData`, `loader_collator` and
`LOADER_ARGS`, to read the same steps whole in one process.
"""

import json
import os
import sys
import threading

import numpy as np
import torch

from mmduet_tpu_torch.config import TrainArgs, tiny_config
from mmduet_tpu_torch.data.collator import Collator
from mmduet_tpu_torch.eval.inference import mesh_items
from mmduet_tpu_torch.parallel import (initialize_distributed, make_mesh, shard_params,
                                       shard_train_state)
from mmduet_tpu_torch.parallel.collectives import share
from mmduet_tpu_torch.parallel.sharding import gather_train_state, gather_trainable
from mmduet_tpu_torch.stream import CharTokenizer
from mmduet_tpu_torch.train import checkpoint, make_optimizer
from mmduet_tpu_torch.train.duet import duet_sample
from mmduet_tpu_torch.train.loop import rank_real_batches
from mmduet_tpu_torch.train.optimizer import tree_leaves
from mmduet_tpu_torch.train.step import TrainState, make_grad_fn, make_train_step, rank_batch

# the loader's run: a global micro-batch of 4 samples (2 a data rank where
# data is 2), 2 micro-batches a step, 3 epochs of 13 items resumed after
# one step: 31 positions, so 7 micro-batches and a dropped partial tail
LOADER_ARGS = dict(B=4, A=2, epochs=3, seed=11, num_workers=2, skip_batches=1)
# an item's stream turns, by its index modulo 6: text-only samples (a data
# rank whose two samples are both text-only holds no frame), one to four
# frames, and 10 frames in 600 tokens, cut by the collator at 512 tokens
LOADER_TURNS = ((), (2,), (), (1,), (1, 3), (2, 2, 2, 2, 2))
LOADER_BROKEN = 5  # an item that fails, replaced as `StreamDataset` replaces one
LOADER_FLAKY = 8  # an item that the last rank alone fails to read (a transient error), in every epoch


class LoaderData:
    """13 duet samples (frames of 8 pixels a side), each made from its
    index alone; every index asked for is recorded with the epoch it was
    asked in (the fetches run on the loader's threads). An item fails, and
    is replaced as `StreamDataset` replaces one, where it is LOADER_BROKEN
    or its (epoch, index) is in ``fails``."""

    def __init__(self, fails=()):
        self.tok = CharTokenizer(frame_num_tokens=4)
        self.epoch, self.fetched, self._lock = 0, [], threading.Lock()
        self.fails = set(fails)

    def __len__(self):
        return 13

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, index, _depth=0):
        if _depth == 0:
            with self._lock:
                self.fetched.append((self.epoch, index))
        if index == LOADER_BROKEN or (self.epoch, index) in self.fails:
            # a deterministic alternative, as on a decode failure
            return self.__getitem__((7 * index + 3) % len(self), _depth + 1)
        return duet_sample(self.tok, np.random.RandomState(index), index,
                           LOADER_TURNS[index % len(LOADER_TURNS)], 8)


def loader_collator(data: LoaderData) -> Collator:
    """The CLI's collator at this scale: 12 frames a sample (48 a global
    micro-batch, frame buckets 16 / 24 / 48) and length buckets 256 / 384
    / 512."""
    return Collator(data.tok, seq_len=512, max_frames=48, frame_size=8,
                    buckets=(256, 384, 512), frame_buckets=(16, 24, 48))


def _shapes(tree):
    return [tuple(t.shape) for t in tree_leaves(tree)]


def _read_share(mesh, fails=()) -> dict:
    """This rank's steps from `rank_real_batches` over `LoaderData(fails)`
    (as tensors), the (epoch, index) of every item it fetched and the
    bytes it sent and received."""
    data, stats = LoaderData(fails), {}
    steps = rank_real_batches(data, loader_collator(data), **LOADER_ARGS, mesh=mesh, stats=stats)
    steps = [{k: tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
              else torch.from_numpy(v) for k, v in step.items()} for step in steps]
    return {"steps": steps, "fetched": data.fetched, "stats": stats}


def share_value(owner: int) -> dict:
    """What owner index ``owner`` of an axis shares: bf16 and f32 values
    with -0.0 and NaN payloads, bool, uint8 frames, an empty frame array,
    0-d and int32 arrays, and JSON values."""
    r = np.random.RandomState(owner)
    bf16 = torch.tensor([1.5, -0.0, 0.0, -2.0, 3.0], dtype=torch.bfloat16)
    bf16.view(torch.int16)[2:4] = torch.tensor([0x7F81, -0x3B], dtype=torch.int16)  # NaNs
    f32 = np.array([0.0, -0.0, 1.0, 0.0, 0.0], np.float32)
    f32.view(np.uint32)[3:] = [0x7FC00001 + owner, 0xFF812345]  # NaNs with payloads
    return {"conversation": [{"role": "user", "content": f"\u00fc{owner}?", "time": 0.1}],
            "bf16": bf16, "f32": f32, "mask": r.rand(3, 4) > 0.5,
            "frames": r.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8),
            "empty": np.zeros((0, 8, 8, 3), np.uint8), "count": np.asarray(owner + 7, np.int64),
            "ids": r.randint(-9, 9, (2, 5)).astype(np.int32), "fps": 2.0, "error": None}


def _as_record(value: dict) -> dict:
    """A shared value as `torch.save` keeps it: each array as (its kind,
    dtype, shape, bytes), every other value as its JSON."""
    out = {}
    for k, v in value.items():
        if isinstance(v, np.ndarray):
            out[k] = ("numpy", v.dtype.str, tuple(v.shape),
                      torch.from_numpy(np.ascontiguousarray(v).reshape(-1).view(np.uint8).copy()))
        elif torch.is_tensor(v):
            out[k] = ("torch", str(v.dtype), tuple(v.shape),
                      v.contiguous().reshape(-1).view(torch.uint8).clone())
        else:
            out[k] = json.dumps(v)
    return out


def _share_cases(mesh) -> dict:
    """`collectives.share` over each axis of the mesh from each owner
    index: what arrived here (`_as_record`), whether the owner got its own
    value back, and what each rank raised when the owner's value was an
    error; then `eval.inference.mesh_items` over both axes of three items
    whose second fails to fetch on its owner: what arrived, what was
    raised."""
    out = {}
    for axis in ("data", "model"):
        mine = mesh.index(axis)
        for owner in range(mesh.shape[axis]):
            value = share_value(owner) if owner == mine else None
            got = share(axis, owner, value, mesh.device)
            try:
                share(axis, owner, ValueError("no sample") if owner == mine else None,
                      mesh.device)
                raised = None
            except Exception as e:
                raised = type(e).__name__
            out[f"{axis}{owner}"] = {"got": _as_record(got), "kept": got is value,
                                     "raised": raised}

    def fetch(k):
        if k == 1:
            raise ValueError("no sample")
        return share_value(k)

    got, raised = [], None
    try:  # item 1's owner (rank 1) fails: every rank raises, none waits
        for item in mesh_items(3, fetch, mesh, 0):
            got.append(_as_record(item))
    except Exception as e:
        raised = type(e).__name__
    out["items"] = {"got": got, "raised": raised}
    return out


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
    out["loader"] = _read_share(mesh)
    last = rank == torch.distributed.get_world_size() - 1
    out["flaky_loader"] = _read_share(
        mesh, [(e, LOADER_FLAKY) for e in range(LOADER_ARGS["epochs"])] if last else ())
    out["share"] = _share_cases(mesh)
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mmduet_tpu"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()  # no rank leaves while another reads its last collective
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
