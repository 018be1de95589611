"""Seeded random weights, made by the benchmark and handed to both sides.

The tree has the layout the port takes (`mmduet_tpu_torch.models.params`:
layer-stacked leaves, matmul weights as (in, out)). Its numbers are the
benchmark's own: two `torch.randn` calls from one generator on the device,
in the served dtype, each filling one flat buffer whose views are the
leaves, then scaled in place. The first buffer holds what quantization
replaces (the decoder's projections, the embedding, the LM head), so that
it is freed once those are quantized; the second holds the rest. The same
seed gives the same bits, so the reference makes them again after the
window instead of reading anything from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .model_shapes import Shapes

# (path, shape, init): init is "dense" (N(0, 1/fan_in), fan_in = shape[-2]),
# "small" (N(0, 0.02^2): embeddings, biases) or "norm" (1 + N(0, 0.05^2))
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def leaves(s: Shapes) -> Tuple[List[Leaf], List[Leaf]]:
    """(what quantization replaces, the rest), each in a fixed order."""
    L, h, q, kv, mi, V = s.layers, s.hidden, s.q_dim, s.kv_dim, s.intermediate, s.vocab
    quantized = [
        (("decoder", "layers", "q_proj"), (L, h, q), "dense"),
        (("decoder", "layers", "k_proj"), (L, h, kv), "dense"),
        (("decoder", "layers", "v_proj"), (L, h, kv), "dense"),
        (("decoder", "layers", "o_proj"), (L, q, h), "dense"),
        (("decoder", "layers", "gate_proj"), (L, h, mi), "dense"),
        (("decoder", "layers", "up_proj"), (L, h, mi), "dense"),
        (("decoder", "layers", "down_proj"), (L, mi, h), "dense"),
        (("decoder", "embed"), (V, h), "small"),
        (("lm_head",), (h, V), "dense"),
    ]
    vl, vh, vi, P = s.v_layers, s.v_hidden, s.v_intermediate, s.v_patches
    rest = [
        (("decoder", "layers", "input_norm"), (L, h), "norm"),
        (("decoder", "layers", "post_attn_norm"), (L, h), "norm"),
        (("decoder", "layers", "q_bias"), (L, q), "small"),
        (("decoder", "layers", "k_bias"), (L, kv), "small"),
        (("decoder", "layers", "v_bias"), (L, kv), "small"),
        (("decoder", "final_norm"), (h,), "norm"),
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
        rest.append((("vision", "layers", name), shape, init))
    return quantized, rest


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


def make(s: Shapes, seed: int, device, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The weight tree of ``s`` from ``seed``, on ``device`` in ``dtype``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed % (1 << 63))
    tree: Dict = {}
    for group in leaves(s):
        _fill(tree, group, gen, device, dtype)
    return tree
