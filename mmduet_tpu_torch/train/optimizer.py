"""Optimizer: AdamW with global-norm clipping and the learning-rate
schedules, written out as optax computes them, and the MMDuet
trainable-set split.

Port of `mmduet_tpu/train/optimizer.py`. The trainable tree is
``{"lora", "projector", "informative_head", "relevance_head"}``; the frozen
base never enters optimizer state. The update is optax's
``chain(clip_by_global_norm(1.0), adamw(sched, 0.9, 0.999, 1e-8,
weight_decay=0.0))``:

- clip: ``g * max_norm / norm`` when ``norm >= max_norm`` (no epsilon);
- Adam: ``mu = 0.1 g + 0.9 mu``, ``nu = 0.001 g^2 + 0.999 nu``, bias
  corrections at the incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``;
- the schedule is read at the optimizer's count *before* the update (so
  the first update of a warmup runs at ``sched(0) = 0``);
- ``(p + u)`` rounded to the leaf's dtype.

Gradients arrive in f32 (the step averages them in f32), so the moments
are f32 for every leaf: optax initializes them in the leaf's dtype, but
its first update promotes them to f32 and zeros are exact in any dtype.
Weight decay 0 adds nothing and is left out.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ..config import TrainArgs

FINETUNE_KEYS = ("projector", "informative_head", "relevance_head")
MAX_GRAD_NORM = 1.0
B1, B2, EPS = 0.9, 0.999, 1e-8

Schedule = Callable[[int], float]


def trainable_params(params: Dict, lora) -> Dict:
    """Assemble the trainable tree from full params + adapters."""
    t = {"lora": lora}
    for k in FINETUNE_KEYS:
        t[k] = params[k]
    return t


def merge_trainable(params: Dict, trainable: Dict) -> Dict:
    """Full param tree with the trainable leaves swapped in."""
    out = dict(params)
    for k in FINETUNE_KEYS:
        out[k] = trainable[k]
    return out


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (transition_begin 0)."""
    if steps <= 0:
        return lambda count: init

    def sched(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _cosine(init: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0, exponent 1."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def sched(count: int) -> float:
        count = min(count, decay_steps)
        return init * 0.5 * (1 + math.cos(math.pi * count / decay_steps))

    return sched


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(args: TrainArgs, total_steps: int) -> Schedule:
    """``sched(count) -> lr`` as a host float (optax computes it in f32;
    the two agree to f32 rounding)."""
    warmup = max(1, int(args.warmup_ratio * total_steps))
    lr = args.learning_rate
    if args.lr_schedule == "cosine":
        decay = max(total_steps, warmup + 1)
        return _join(_linear(0.0, lr, warmup), _cosine(lr, decay - warmup), warmup)
    if args.lr_schedule == "linear":
        return _join(_linear(0.0, lr, warmup),
                     _linear(lr, 0.0, max(total_steps - warmup, 1)), warmup)
    if args.lr_schedule == "constant":
        return lambda count: lr
    raise ValueError(f"unknown lr_schedule: {args.lr_schedule}")


def tree_leaves(tree):
    """The leaves of nested dicts, in key order (`tree_map`'s order)."""
    for v in tree.values():
        yield from tree_leaves(v) if isinstance(v, dict) else (v,)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, f32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in tree_leaves(tree)))


class AdamW(NamedTuple):
    """The optimizer: ``init(trainable) -> state`` and ``update(grads,
    state, trainable, norm) -> (new_trainable, new_state)``; ``grads`` are
    f32 and ``norm`` is their `global_norm`. New tensors are returned; the
    inputs are not modified."""

    sched: Schedule

    def init(self, trainable: Dict) -> Dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"count": 0, "mu": tree_map(zeros, trainable),
                "nu": tree_map(zeros, trainable)}

    def update(self, grads: Dict, state: Dict, trainable: Dict,
               norm: torch.Tensor) -> Tuple[Dict, Dict]:
        # jax.lax.select(norm < max_norm, g, g / norm * max_norm), on device
        factor = torch.where(norm < MAX_GRAD_NORM, torch.ones_like(norm),
                             MAX_GRAD_NORM / norm)
        count = state["count"] + 1
        bc1 = 1 - B1 ** count
        bc2 = 1 - B2 ** count
        lr = self.sched(state["count"])
        mu = tree_map(lambda g, m: (1 - B1) * (g * factor) + B1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - B2) * (g * factor) ** 2 + B2 * v, grads, state["nu"])

        def apply(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            return (p.float() - lr * u).to(p.dtype)

        new = tree_map(apply, trainable, mu, nu)
        return new, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(args: TrainArgs, total_steps: int) -> Tuple[AdamW, Schedule]:
    sched = make_lr_schedule(args, total_steps)
    return AdamW(sched), sched
