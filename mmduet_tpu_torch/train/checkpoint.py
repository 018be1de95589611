"""Train-state checkpointing: step-numbered saves with rotation and resume.

Port of `mmduet_tpu/train/checkpoint.py` with the port's own format:
``<output_dir>/checkpoint-<step>/state.pt`` holds the `TrainState` as one
`torch.save` file (step, trainable tree, optimizer state). The file is
written under a temporary name and renamed into place, so a directory
without ``state.pt`` is an interrupted save, and resume skips it.

Under a process mesh the file is the same whole state: every rank gathers
it (`parallel.sharding.gather_train_state`), rank 0 alone writes it (and
rotates), and every rank waits at a barrier; a restore loads the whole
state and cuts it again for the rank (`shard_train_state`). So a
checkpoint resumes on any mesh shape and on one device, as the JAX
package's orbax save of global arrays does.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.sharding import gather_train_state, shard_train_state
from .optimizer import tree_leaves
from .step import TrainState

STATE_FILE = "state.pt"


def _ckpt_dirs(output_dir: str) -> List[Tuple[int, str]]:
    out = []
    if not os.path.isdir(output_dir):
        return out
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(out)


def save_train_state(
    output_dir: str, step: int, state: TrainState, save_total_limit: Optional[int] = None,
    mesh=None,
) -> str:
    """Save ``state`` as ``checkpoint-<step>`` (replacing one of that name)
    and keep only the newest ``save_total_limit`` checkpoints. With
    ``mesh`` (this rank's `parallel.ProcessMesh`; every rank calls it) the
    whole state is gathered and written by rank 0."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    writer = True
    if mesh is not None:
        state = gather_train_state(state, mesh, to="cpu")
        writer = mesh.coords == (0, 0)
    if writer:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
        torch.save(state._asdict(), tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        if save_total_limit:
            for _, old in _ckpt_dirs(output_dir)[:-save_total_limit]:
                shutil.rmtree(old, ignore_errors=True)
    if mesh is not None:
        dist.barrier()  # no rank reads or resumes before the file is in place
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest complete checkpoint: a ``checkpoint-N`` whose state file
    was renamed into place. A save killed before that rename is skipped."""
    for _, path in reversed(_ckpt_dirs(output_dir)):
        if os.path.isfile(os.path.join(path, STATE_FILE)):
            return path
    return None


def restore_train_state(ckpt_path: str, template: Any, mesh=None) -> TrainState:
    """Load a checkpoint onto the device of ``template`` (a `TrainState` of
    the same structure); with ``mesh``, the rank's local state of it
    (`shard_train_state`; ``template`` is a local state)."""
    device = next(tree_leaves(template.trainable)).device
    saved = torch.load(os.path.join(ckpt_path, STATE_FILE),
                       map_location="cpu" if mesh is not None else device, weights_only=True)
    state = TrainState(**saved)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    if ([t.shape for t in tree_leaves(state.trainable)]
            != [t.shape for t in tree_leaves(template.trainable)]):
        raise ValueError(f"{ckpt_path}: trainable tree does not match the model")
    return state
