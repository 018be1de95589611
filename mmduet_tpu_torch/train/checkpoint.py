"""Train-state checkpointing: step-numbered saves with rotation and resume.

Port of `mmduet_tpu/train/checkpoint.py` with the port's own format:
``<output_dir>/checkpoint-<step>/state.pt`` holds the `TrainState` as one
`torch.save` file (step, trainable tree, optimizer state). The file is
written under a temporary name and renamed into place, so a directory
without ``state.pt`` is an interrupted save, and resume skips it.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import torch

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
    output_dir: str, step: int, state: TrainState, save_total_limit: Optional[int] = None
) -> str:
    """Save ``state`` as ``checkpoint-<step>`` (replacing one of that name)
    and keep only the newest ``save_total_limit`` checkpoints."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(state._asdict(), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if save_total_limit:
        for _, old in _ckpt_dirs(output_dir)[:-save_total_limit]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest complete checkpoint: a ``checkpoint-N`` whose state file
    was renamed into place. A save killed before that rename is skipped."""
    for _, path in reversed(_ckpt_dirs(output_dir)):
        if os.path.isfile(os.path.join(path, STATE_FILE)):
            return path
    return None


def restore_train_state(ckpt_path: str, template: Any) -> TrainState:
    """Load a checkpoint onto the device of ``template`` (a `TrainState` of
    the same structure)."""
    device = next(tree_leaves(template.trainable)).device
    saved = torch.load(os.path.join(ckpt_path, STATE_FILE), map_location=device,
                       weights_only=True)
    state = TrainState(**saved)
    if ([t.shape for t in tree_leaves(state.trainable)]
            != [t.shape for t in tree_leaves(template.trainable)]):
        raise ValueError(f"{ckpt_path}: trainable tree does not match the model")
    return state
