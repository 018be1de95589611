"""SigLIP vision tower (so400m-patch14-384) in PyTorch.

Port of `mmduet_tpu/models/siglip.py`: patch embedding as crop + reshape +
one matmul (no conv), per-layer weights stacked on a leading axis and run
as a loop, features taken at layer -2 by running only the first
``num_layers - 1`` layers. Vision attention is
`ops.attention.flash_vision_attention` (kernel D on CUDA tensors); the
matmul + softmax + matmul route is its plain version, for CPU tensors
(`_attend`).

On a rank of a process mesh the layers are the rank's local leaves
(`parallel.sharding.shard_params`): its heads and its part of the MLP's
intermediate dim. The f32 products of ``o_proj`` and ``fc2`` are then
summed over the model axis before their rounding, and the whole
``o_bias`` / ``fc2_bias`` is added once, after the sum; under autograd
the normed inputs of q/k/v and fc1 pass through
`collectives.copy_to_model`. Leaves cut over the data axis (``--param_mode
fsdp``: the frozen tower in training) are gathered right before their
layer runs (`collectives.data_gatherer`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import SiglipConfig
from ..ops.attention import (KernelRefused, flash_vision_attention,
                             flash_vision_attention_ref)
from ..parallel.collectives import (copy_to_model, cut, data_gatherer, reduce_model,
                                    whole_over_data)
from .quant import is_quantized, layer_view, out_width, quantized_matmul

Params = Dict[str, Any]


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def _linear(y: torch.Tensor, w: Any, bias: Optional[torch.Tensor],
            partial: bool = False) -> torch.Tensor:
    """``y @ w + bias`` in the activation dtype (f32 accumulation, one
    rounding, then the bias, if any), as the JAX einsum + astype + bias. An
    int8 leaf ``{"qw", "qs"}`` (`quant.quantize_vision`) is the product
    with the int8 values cast to the activation dtype, scaled per output
    channel in f32 before the rounding. ``partial``: ``y`` and ``w`` are a
    rank's slice of the input dim; the f32 product is summed over the model
    axis before the rounding and the bias."""
    if partial:
        out = reduce_model(quantized_matmul(y, w)).to(y.dtype)
    else:
        out = quantized_matmul(y, w).to(y.dtype) if is_quantized(w) else torch.matmul(y, w)
    return out if bias is None else out + bias.to(y.dtype)


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


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hd: int,
            use_flash: Optional[bool] = None) -> torch.Tensor:
    """(N, T, nh, hd) non-causal MHA. ``use_flash`` True:
    `flash_vision_attention` (on CUDA tensors kernel D or an error, on
    CPU tensors its plain version). False: the matmul route
    (`flash_vision_attention_ref`: f32 scores and softmax, the value
    product accumulated in f32), which is for CPU tensors; on CUDA tensors
    it raises `KernelRefused`, as `qwen2_forward` does for kernel C. None
    (auto): kernel D for CUDA tensors, the matmul route for CPU tensors.
    (The JAX package's auto takes its jnp route everywhere, on a timing of
    its TPU kernel that says nothing about this card.)"""
    if q.is_cuda and use_flash is False:
        raise KernelRefused("siglip: attention on CUDA tensors runs kernel D (use_flash "
                            "None or True); the matmul route is for CPU tensors")
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        return flash_vision_attention(q, k, v)
    return flash_vision_attention_ref(q, k, v)


def encoder_layer(h: torch.Tensor, p: Params, cfg,
                  act: Callable[[torch.Tensor], torch.Tensor],
                  use_flash: Optional[bool] = None) -> torch.Tensor:
    """One pre-LN ViT encoder layer: LN -> MHA -> residual -> LN -> MLP ->
    residual. Shared by the SigLIP and CLIP towers, which differ only in
    the MLP activation ``act`` (tanh-GELU vs quick_gelu), applied in f32
    and cast back. ``cfg`` needs num_heads / hidden_size /
    intermediate_size / layer_norm_eps; the leaves' head count may be a
    rank's own (their products then partial, summed over the model axis)."""
    N, T, C = h.shape
    hd = cfg.hidden_size // cfg.num_heads

    heads_cut = cut(out_width(p["q_proj"]), C, "vision q_proj")
    y = _layer_norm(h, p["ln1_scale"], p["ln1_bias"], cfg.layer_norm_eps)
    y = copy_to_model(y) if heads_cut else y
    q = _linear(y, p["q_proj"], p["q_bias"]).reshape(N, T, -1, hd)
    k = _linear(y, p["k_proj"], p["k_bias"]).reshape(N, T, -1, hd)
    v = _linear(y, p["v_proj"], p["v_bias"]).reshape(N, T, -1, hd)
    attn = _attend(q, k, v, hd, use_flash).reshape(N, T, -1)
    h = h + _linear(attn, p["o_proj"], p["o_bias"],
                    partial=cut(attn.shape[-1], C, "vision o_proj"))

    y = _layer_norm(h, p["ln2_scale"], p["ln2_bias"], cfg.layer_norm_eps)
    if cut(out_width(p["fc1"]), cfg.intermediate_size, "vision fc1"):
        y = copy_to_model(y)
    y = _linear(y, p["fc1"], p["fc1_bias"])
    y = act(y.float()).to(h.dtype)
    return h + _linear(y, p["fc2"], p["fc2_bias"],
                       partial=cut(y.shape[-1], cfg.intermediate_size, "vision fc2"))


def siglip_encode(
    params: Params,
    cfg: SiglipConfig,
    images: torch.Tensor,  # (N, H, W, 3) already normalized to [-1, 1]
    feature_layer: int = -2,
    use_flash: Optional[bool] = None,  # None = auto (kernel D on CUDA tensors)
) -> torch.Tensor:
    """Encode frames -> patch features (N, num_patches, hidden)."""
    x = _linear(patchify(images, cfg.patch_size), whole_over_data(params["patch_embed"]),
                params["patch_bias"])
    x = x + whole_over_data(params["pos_embed"]).to(x.dtype)[None]
    num_layers = (
        cfg.num_layers + feature_layer + 1 if feature_layer < 0
        else feature_layer + 1
    )
    layers = params["layers"]
    whole = data_gatherer(layers)
    for i in range(num_layers):
        x = encoder_layer(x, whole(layer_view(layers, i)), cfg, _tanh_gelu, use_flash)
    return x


def _tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def normalize_pixels(frames_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (N, H, W, 3) -> SigLIP-normalized f32 (mean/std 0.5,
    rescale 1/255)."""
    return (frames_uint8.float() / 255.0 - 0.5) / 0.5
