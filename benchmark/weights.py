"""Seeded random weights, made by the benchmark and handed to both sides.

The tree has the layout the port takes (`mmduet_tpu_torch.models.params`:
layer-stacked leaves, matmul weights as (in, out)); its leaves are the
architecture's (``leaves(s)`` of ``benchmark/arch/<architecture>.py``),
which ends with the `shared` ones. Its numbers are the benchmark's own: two
`torch.randn` calls from one generator on the device, in the served dtype,
each filling one flat buffer whose views are the leaves, then scaled in
place. The first buffer holds what quantization replaces (the decoder's
projections, the embedding, the LM head), so that it is freed once those
are quantized; the second holds the rest. The same seed gives the same
bits, so the reference makes them again after the window instead of
reading anything from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .model_shapes import Shapes

# (path, shape, init): init is "dense" (N(0, 1/fan_in), fan_in = shape[-2]),
# "small" (N(0, 0.02^2): embeddings, biases) or "norm" (1 + N(0, 0.05^2))
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def shared(s: Shapes) -> List[Leaf]:
    """The leaves that every architecture shares, in a fixed order: the
    score heads, the projector, the tower. An architecture's ``leaves(s)``
    ends its second group with them."""
    h, vl, vh, vi, P = s.hidden, s.v_layers, s.v_hidden, s.v_intermediate, s.v_patches
    out = [
        (("informative_head",), (h, 2), "dense"),
        (("relevance_head",), (h, 2), "dense"),
        (("projector", "fc1"), (vh, h), "dense"),
        (("projector", "fc1_bias"), (h,), "small"),
        (("projector", "fc2"), (h, h), "dense"),
        (("projector", "fc2_bias"), (h,), "small"),
        (("vision", "patch_embed"), (3 * s.patch ** 2, vh), "dense"),
        (("vision", "patch_bias"), (vh,), "small"),
        (("vision", "pos_embed"), (P, vh), "small"),
    ]
    for name, shape, init in (
            ("ln1_scale", (vl, vh), "norm"), ("ln1_bias", (vl, vh), "small"),
            ("ln2_scale", (vl, vh), "norm"), ("ln2_bias", (vl, vh), "small"),
            ("q_proj", (vl, vh, vh), "dense"), ("q_bias", (vl, vh), "small"),
            ("k_proj", (vl, vh, vh), "dense"), ("k_bias", (vl, vh), "small"),
            ("v_proj", (vl, vh, vh), "dense"), ("v_bias", (vl, vh), "small"),
            ("o_proj", (vl, vh, vh), "dense"), ("o_bias", (vl, vh), "small"),
            ("fc1", (vl, vh, vi), "dense"), ("fc1_bias", (vl, vi), "small"),
            ("fc2", (vl, vi, vh), "dense"), ("fc2_bias", (vl, vh), "small")):
        out.append((("vision", "layers", name), shape, init))
    return out


def _fill(tree: Dict, group: List[Leaf], gen: torch.Generator, device,
          dtype: torch.dtype) -> None:
    n = sum(math.prod(shape) for _, shape, _ in group)
    buf = torch.randn(n, generator=gen, device=device, dtype=dtype)
    at = 0
    for path, shape, init in group:
        view = buf[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        if init == "dense":
            view.mul_(1.0 / math.sqrt(shape[-2]))
        elif init == "small":
            view.mul_(0.02)
        else:
            view.mul_(0.05).add_(1.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = view


def make(groups: Sequence[List[Leaf]], seed: int, device,
         dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The weight tree of ``groups`` (an architecture's ``leaves(s)``: what
    quantization replaces, the rest) from ``seed``, on ``device`` in
    ``dtype``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed % (1 << 63))
    tree: Dict = {}
    for group in groups:
        _fill(tree, group, gen, device, dtype)
    return tree
