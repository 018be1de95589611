"""LoRA adapters for the Qwen2 decoder, layer-stacked like the base weights.

Port of `mmduet_tpu/models/lora.py`. Adapters live in a separate tree
``{proj_name: {"a": (L, in, r), "b": (L, r, out)}}`` that the decoder's
layer loop slices per layer (`qwen2.qwen2_forward`), so a LoRA forward
adds two thin matmuls to each projection. ``merge_lora`` folds adapters
into the base weights (PEFT's merge_and_unload).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from ..config import Qwen2Config

DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"
)


def _proj_dims(cfg: Qwen2Config) -> Dict[str, tuple]:
    """(in_dim, out_dim) of each projection."""
    h, nh, kh, hd, mi = (
        cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.intermediate_size,
    )
    return {
        "q_proj": (h, nh * hd),
        "k_proj": (h, kh * hd),
        "v_proj": (h, kh * hd),
        "o_proj": (nh * hd, h),
        "gate_proj": (h, mi),
        "up_proj": (h, mi),
        "down_proj": (mi, h),
    }


def init_lora(
    generator: torch.Generator,
    cfg: Qwen2Config,
    rank: int = 16,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Dict:
    """A ~ N(0, 1/in_dim), B = 0 (the standard LoRA init: the adapter starts
    as a no-op). ``generator`` must live on ``device``; its numbers differ
    from `jax.random`'s."""
    dims = _proj_dims(cfg)
    L = cfg.num_layers
    out = {}
    for name in targets:
        din, dout = dims[name]
        a = torch.randn((L, din, rank), generator=generator, device=device,
                        dtype=torch.float32) / math.sqrt(din)
        out[name] = {
            "a": a.to(dtype),
            "b": torch.zeros((L, rank, dout), dtype=dtype, device=device),
        }
    return out


def lora_scale(rank: int, alpha: float) -> float:
    return alpha / rank


def fold_lora_scale(lora: Dict, scale: float) -> Dict:
    """Pre-multiply the ``b`` factors by ``scale``: the stored adapter's
    delta is then exactly ``a @ b`` and serves at ``lora_scale=1.0``."""
    return {name: {"a": ab["a"], "b": ab["b"] * scale} for name, ab in lora.items()}


def merge_lora(decoder_params: Dict, lora: Dict, scale: float) -> Dict:
    """Fold adapters into base weights: W' = W + scale * A @ B, the product
    in f32, the sum rounded once to W's dtype."""
    layers = dict(decoder_params["layers"])
    for name, ab in lora.items():
        delta = torch.matmul(ab["a"].float(), ab["b"].float()) * scale
        layers[name] = (layers[name].float() + delta).to(layers[name].dtype)
    return dict(decoder_params, layers=layers)
