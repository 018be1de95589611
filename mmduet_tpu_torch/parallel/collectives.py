"""The collectives of tensor-parallel serving, over the model axis of a
`mesh.ProcessMesh`.

The JAX package gets these from XLA, which inserts them where shardings
meet; the port calls them itself. Megatron's layout needs two:

- `reduce_model`: the f32 partial products of the row-cut projections
  (attention out, MLP down, the towers' out and fc2, the projector's fc2)
  and of the vocabulary-cut embedding lookup, summed over the model
  group before the one rounding to the activation dtype;
- `gather_vocab`: whole vocabulary rows from each rank's slice of the
  LM head's logits, for the repetition penalty and the greedy choice.

Both are sums (the gather adds zero-filled full-width rows), so that the
one collective works on CPU and CUDA tensors under either backend (gloo
takes ``all_reduce`` of CUDA tensors), and every rank ends with the same
bits: every host decision of the engines (scores, triggers, tokens) is
taken from these outputs, never from a rank's partial.

The model axis is bound once per process, by `mesh.make_mesh` when it
builds a process mesh: one process is one rank, and every forward it runs
is on its shard. Without a bound axis (size 1) both are the identity, and
`cut` says whether a dim holds a whole axis or this rank's part of it.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

_group: Optional[Any] = None
_rank, _size = 0, 1


def bind_model_axis(group: Any, rank: int, size: int) -> None:
    """Make ``group`` this process's model axis, with this rank at index
    ``rank`` of ``size``. A process binds one axis for its life."""
    global _group, _rank, _size
    if _size > 1 and (_group, _rank, _size) != (group, rank, size):
        raise RuntimeError("collectives: this process's model axis is already bound")
    _group, _rank, _size = group, rank, size


def model_axis() -> Tuple[int, int]:
    """(this rank's index, the model axis's size); (0, 1) unbound."""
    return _rank, _size


def cut(local: int, full: int, what: str) -> bool:
    """Whether a dim that holds ``full`` values when whole holds this
    rank's ``full / size`` of them (True) or all (False); any other size
    raises."""
    if _size == 1 or local == full:
        return False
    if local * _size == full:
        return True
    raise ValueError(f"{what}: {local} of {full} values on a model axis of {_size}")


def reduce_model(partial: torch.Tensor) -> torch.Tensor:
    """The sum of ``partial`` over the model axis, in f32 (in place when
    ``partial`` is an f32 contiguous tensor); the identity when no axis is
    bound. Callers reduce what `cut` says is a partial product."""
    if _size == 1:
        return partial
    out = partial.float().contiguous()
    dist.all_reduce(out, group=_group)
    return out


def gather_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Whole (..., V) f32 rows from this rank's (..., V / size) slice of
    the vocabulary; the identity when the slice is the whole vocabulary."""
    local = logits.shape[-1]
    if not cut(local, vocab_size, "gather_vocab"):
        return logits
    full = torch.zeros((*logits.shape[:-1], vocab_size), dtype=torch.float32,
                       device=logits.device)
    full[..., _rank * local:(_rank + 1) * local] = logits
    dist.all_reduce(full, group=_group)
    return full
