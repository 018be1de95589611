"""Parameter trees of the port: converted from the JAX package's tree, or
random at any width.

The tree has the JAX package's structure and names (`decoder`,
`lm_head`, `informative_head`, `relevance_head`, `projector`, `vision`),
per-layer weights stacked on a leading axis and matmul weights in the
(in, out) layout, so ``y @ W`` equals the JAX ``einsum``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmduet_tpu.config import MMDuetConfig, Qwen2Config, SiglipConfig

Params = Dict[str, Any]


def params_from_numpy(tree: Params, device, dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX param tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``) as tensors on ``device``, cast to ``dtype`` (None keeps
    each leaf's dtype). A LoRA tree (``{proj: {"a", "b"}}``) converts the
    same way. Quantized leaves raise `NotImplementedError`."""
    out: Params = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            if {"qw", "qs"} <= set(leaf) or "qw4" in leaf:
                raise NotImplementedError(
                    f"{name}: quantized (int8/int4) leaves are not ported yet"
                )
            out[name] = params_from_numpy(leaf, device, dtype)
            continue
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it
            arr = arr.astype(np.float32)
        out[name] = torch.tensor(arr, device=device, dtype=dtype)
    return out


class _Init:
    """Draws the leaves of one tree from one generator, in the target
    dtype directly (no f32 staging copy of a multi-GB weight)."""

    def __init__(self, generator: torch.Generator, device, dtype: torch.dtype):
        self.gen, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale: float) -> torch.Tensor:
        w = torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)
        return w.mul_(scale)

    def dense(self, shape) -> torch.Tensor:  # N(0, 1/fan_in), fan_in = shape[-2]
        return self.normal(shape, 1.0 / math.sqrt(shape[-2]))

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)


def _decoder(ini: _Init, cfg: Qwen2Config) -> Params:
    h, nh, kh, hd, mi, L = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, cfg.intermediate_size, cfg.num_layers)
    layers = {
        "input_norm": ini.ones((L, h)),
        "post_attn_norm": ini.ones((L, h)),
        "q_proj": ini.dense((L, h, nh * hd)),
        "k_proj": ini.dense((L, h, kh * hd)),
        "v_proj": ini.dense((L, h, kh * hd)),
        "o_proj": ini.dense((L, nh * hd, h)),
        "gate_proj": ini.dense((L, h, mi)),
        "up_proj": ini.dense((L, h, mi)),
        "down_proj": ini.dense((L, mi, h)),
    }
    if cfg.qkv_bias:
        layers["q_bias"] = ini.zeros((L, nh * hd))
        layers["k_bias"] = ini.zeros((L, kh * hd))
        layers["v_bias"] = ini.zeros((L, kh * hd))
    return {
        "embed": ini.normal((cfg.vocab_size, h), 0.02),
        "layers": layers,
        "final_norm": ini.ones((h,)),
    }


def _siglip(ini: _Init, cfg: SiglipConfig) -> Params:
    h, mi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    layers = {
        "ln1_scale": ini.ones((L, h)),
        "ln1_bias": ini.zeros((L, h)),
        "ln2_scale": ini.ones((L, h)),
        "ln2_bias": ini.zeros((L, h)),
        "q_proj": ini.dense((L, h, h)),
        "q_bias": ini.zeros((L, h)),
        "k_proj": ini.dense((L, h, h)),
        "k_bias": ini.zeros((L, h)),
        "v_proj": ini.dense((L, h, h)),
        "v_bias": ini.zeros((L, h)),
        "o_proj": ini.dense((L, h, h)),
        "o_bias": ini.zeros((L, h)),
        "fc1": ini.dense((L, h, mi)),
        "fc1_bias": ini.zeros((L, mi)),
        "fc2": ini.dense((L, mi, h)),
        "fc2_bias": ini.zeros((L, h)),
    }
    return {
        "patch_embed": ini.dense((3 * cfg.patch_size ** 2, h)),
        "patch_bias": ini.zeros((h,)),
        "pos_embed": ini.normal((cfg.num_patches, h), 0.02),
        "layers": layers,
    }


def init_mmduet_params(cfg: MMDuetConfig, generator: torch.Generator, device,
                       dtype: torch.dtype = torch.float32) -> Params:
    """Random weights at the shapes and scales of the JAX package's
    `init_mmduet_params` (its random numbers differ: `jax.random` is not
    `torch.Generator`). ``generator`` must live on ``device``."""
    if cfg.vision_arch != "siglip":
        raise NotImplementedError("the CLIP tower is not ported yet")
    ini = _Init(generator, device, dtype)
    h, vh = cfg.text.hidden_size, cfg.vision.hidden_size
    return {
        "decoder": _decoder(ini, cfg.text),
        "lm_head": ini.dense((h, cfg.text.vocab_size)),
        "informative_head": ini.dense((h, cfg.num_score_classes)),
        "relevance_head": ini.dense((h, cfg.num_score_classes)),
        "projector": {
            "fc1": ini.dense((vh, h)),
            "fc1_bias": ini.zeros((h,)),
            "fc2": ini.dense((h, h)),
            "fc2_bias": ini.zeros((h,)),
        },
        "vision": _siglip(ini, cfg.vision),
    }


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside a chain state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_numpy(state, device, dtype: Optional[torch.dtype] = None):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as the port's `train.step.TrainState` on ``device``: the
    trainable tree cast to ``dtype`` (None keeps each leaf's), and optax's
    Adam count and moments (f32, as the port keeps them)."""
    from ..train.step import TrainState

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    return TrainState(
        step=int(state.step),
        trainable=params_from_numpy(state.trainable, device, dtype),
        opt_state={"count": int(adam.count),
                   "mu": params_from_numpy(adam.mu, device, torch.float32),
                   "nu": params_from_numpy(adam.nu, device, torch.float32)},
    )
