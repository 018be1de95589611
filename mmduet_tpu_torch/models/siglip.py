"""SigLIP vision tower (so400m-patch14-384) in PyTorch.

Port of `mmduet_tpu/models/siglip.py`: patch embedding as crop + reshape +
one matmul (no conv), per-layer weights stacked on a leading axis and run
as a loop, features taken at layer -2 by running only the first
``num_layers - 1`` layers. Vision attention is the plain matmul + softmax
+ matmul of the JAX package's default branch.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..config import SiglipConfig
from .quant import is_quantized, layer_view, quantized_matmul

Params = Dict[str, Any]


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def _linear(y: torch.Tensor, w: Any, bias: torch.Tensor) -> torch.Tensor:
    """``y @ w + bias`` in the activation dtype (f32 accumulation, one
    rounding, then the bias), as the JAX einsum + astype + bias. An int8
    leaf ``{"qw", "qs"}`` (`quant.quantize_vision`) is the product with
    the int8 values cast to the activation dtype, scaled per output
    channel in f32 before the rounding."""
    if is_quantized(w):
        return quantized_matmul(y, w).to(y.dtype) + bias.to(y.dtype)
    return torch.matmul(y, w) + bias.to(y.dtype)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, H, W, 3) -> (N, num_patches, 3*p*p), row-major patch order,
    features laid out (C, ph, pw) as HF SigLIP's Conv2d weight flattens.
    Non-divisible sizes are cropped to the patch grid (384 px -> 27x27
    patches of 14, the last 6 px dropped), as a stride-p valid conv."""
    N, H, W, C = images.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = images[:, : gh * p, : gw * p].reshape(N, gh, p, gw, p, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # N, gh, gw, C, ph, pw
    return x.reshape(N, gh * gw, C * p * p)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hd: int) -> torch.Tensor:
    """(N, T, nh, hd) non-causal MHA: f32 scores and softmax, the value
    product accumulated in f32 from probabilities in the value dtype."""
    scores = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", probs, v).to(q.dtype)


def encoder_layer(h: torch.Tensor, p: Params, cfg: SiglipConfig) -> torch.Tensor:
    """One pre-LN ViT encoder layer with the tanh-GELU MLP: LN -> MHA ->
    residual -> LN -> MLP -> residual."""
    N = h.shape[0]
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh

    y = _layer_norm(h, p["ln1_scale"], p["ln1_bias"], cfg.layer_norm_eps)
    q = _linear(y, p["q_proj"], p["q_bias"]).reshape(N, -1, nh, hd)
    k = _linear(y, p["k_proj"], p["k_bias"]).reshape(N, -1, nh, hd)
    v = _linear(y, p["v_proj"], p["v_bias"]).reshape(N, -1, nh, hd)
    attn = _attend(q, k, v, hd).reshape(N, -1, nh * hd)
    h = h + _linear(attn, p["o_proj"], p["o_bias"])

    y = _layer_norm(h, p["ln2_scale"], p["ln2_bias"], cfg.layer_norm_eps)
    y = _linear(y, p["fc1"], p["fc1_bias"])
    y = F.gelu(y.float(), approximate="tanh").to(h.dtype)
    return h + _linear(y, p["fc2"], p["fc2_bias"])


def siglip_encode(
    params: Params,
    cfg: SiglipConfig,
    images: torch.Tensor,  # (N, H, W, 3) already normalized to [-1, 1]
    feature_layer: int = -2,
) -> torch.Tensor:
    """Encode frames -> patch features (N, num_patches, hidden)."""
    x = _linear(patchify(images, cfg.patch_size), params["patch_embed"],
                params["patch_bias"])
    x = x + params["pos_embed"].to(x.dtype)[None]
    num_layers = (
        cfg.num_layers + feature_layer + 1 if feature_layer < 0
        else feature_layer + 1
    )
    layers = params["layers"]
    for i in range(num_layers):
        x = encoder_layer(x, layer_view(layers, i), cfg)
    return x


def normalize_pixels(frames_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (N, H, W, 3) -> SigLIP-normalized f32 (mean/std 0.5,
    rescale 1/255)."""
    return (frames_uint8.float() / 255.0 - 0.5) / 0.5
