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

from ..config import ClipConfig, MMDuetConfig, Qwen2Config, SiglipConfig

Params = Dict[str, Any]


def params_from_numpy(tree: Params, device, dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX param tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``) as tensors on ``device``, cast to ``dtype`` (None keeps
    each leaf's dtype). A LoRA tree (``{proj: {"a", "b"}}``) converts the
    same way. Quantized leaves (``{"qw" | "qw4", "qs"}``, weights or an
    int8 KV cache) cross as they are: int8 stays int8 and ``qs`` keeps
    its own dtype (bf16 for weights, f32 for a cache), whatever ``dtype``
    says."""
    out: Params = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            if "qs" in leaf and ("qw" in leaf or "qw4" in leaf):
                out[name] = {k: _as_is(v, device) for k, v in leaf.items()}
            else:
                out[name] = params_from_numpy(leaf, device, dtype)
            continue
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it
            arr = arr.astype(np.float32)
        out[name] = torch.tensor(arr, device=device, dtype=dtype)
    return out


def _as_is(leaf, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (bf16 through f32: torch
    cannot read the ml_dtypes array)."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device, dtype=torch.bfloat16)
    return torch.tensor(arr, device=device)


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


def _vit_layers(ini: _Init, cfg) -> Params:
    """The layer-stacked encoder layers the SigLIP and CLIP towers share."""
    h, mi, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    return {
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


def _siglip(ini: _Init, cfg: SiglipConfig) -> Params:
    h = cfg.hidden_size
    layers = _vit_layers(ini, cfg)  # drawn first: the order fixes a seed's weights
    return {
        "patch_embed": ini.dense((3 * cfg.patch_size ** 2, h)),
        "patch_bias": ini.zeros((h,)),
        "pos_embed": ini.normal((cfg.num_patches, h), 0.02),
        "layers": layers,
    }


def _clip(ini: _Init, cfg: ClipConfig) -> Params:
    h = cfg.hidden_size
    layers = _vit_layers(ini, cfg)
    return {
        "class_embed": ini.normal((h,), 0.02),
        "patch_embed": ini.dense((3 * cfg.patch_size ** 2, h)),  # HF's conv has no bias
        "pos_embed": ini.normal((1 + cfg.num_patches, h), 0.02),
        "pre_ln_scale": ini.ones((h,)),
        "pre_ln_bias": ini.zeros((h,)),
        "post_ln_scale": ini.ones((h,)),
        "post_ln_bias": ini.zeros((h,)),
        "layers": layers,
    }


def init_clip_params(cfg: ClipConfig, generator: torch.Generator, device,
                     dtype: torch.dtype = torch.float32) -> Params:
    """A random CLIP tower (`models.clip`) at the shapes and scales of the
    JAX package's `clip.init_clip_params`."""
    return _clip(_Init(generator, device, dtype), cfg)


def init_mmduet_params(cfg: MMDuetConfig, generator: torch.Generator, device,
                       dtype: torch.dtype = torch.float32) -> Params:
    """Random weights at the shapes and scales of the JAX package's
    `init_mmduet_params` (its random numbers differ: `jax.random` is not
    `torch.Generator`). ``generator`` must live on ``device``.

    ``vision_arch="clip"`` builds a CLIP tower (`init_clip_params`' tree),
    where the JAX function builds a SigLIP-shaped tower whatever the arch
    (its own CLIP `visual_embed` cannot run that tree)."""
    ini = _Init(generator, device, dtype)
    h, vh = cfg.text.hidden_size, cfg.vision.hidden_size
    tower = _clip if cfg.vision_arch == "clip" else _siglip
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
        "vision": tower(ini, cfg.vision),
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
