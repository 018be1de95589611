"""SigLIP vision tower (so400m-patch14-384) in PyTorch.

Port of `mmduet_tpu/models/siglip.py`: patch embedding as crop + reshape +
one matmul (no conv), per-layer weights stacked on a leading axis and run
as a loop, features taken at layer -2 by running only the first
``num_layers - 1`` layers. Vision attention is
`ops.attention.flash_vision_attention` (kernel D on CUDA tensors); the
matmul + softmax + matmul route is its plain version, for CPU tensors
(`_attend`). The elementwise chains between a layer's products (biases,
residuals, LayerNorms, the MLP's activation) are the passes of
`ops.vision_fused`: fused kernels on CUDA tensors, the eager chains on CPU
tensors. A layer hands the next one its residual stream and the next LN1's
output (`encoder_layers`).

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

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import SiglipConfig
from ..ops.attention import (KernelRefused, flash_vision_attention,
                             flash_vision_attention_ref)
from ..ops.vision_fused import bias_act, bias_add3, bias_residual_layernorm, gelu_tanh
from ..parallel.collectives import (copy_to_model, cut, data_gatherer, reduce_model,
                                    whole_over_data)
from .quant import is_quantized, layer_view, out_width, quantized_matmul

Params = Dict[str, Any]


def _product(y: torch.Tensor, w: Any, partial: bool = False) -> torch.Tensor:
    """``y @ w`` in the activation dtype: f32 accumulation, one rounding, as
    the JAX einsum + astype. An int8 leaf ``{"qw", "qs"}``
    (`quant.quantize_vision`) is the product with the int8 values cast to
    the activation dtype, scaled per output channel in f32 before the
    rounding. ``partial``: ``y`` and ``w`` are a rank's slice of the input
    dim; the f32 product is summed over the model axis before the
    rounding."""
    if partial:
        return reduce_model(quantized_matmul(y, w)).to(y.dtype)
    return quantized_matmul(y, w).to(y.dtype) if is_quantized(w) else torch.matmul(y, w)


def _linear(y: torch.Tensor, w: Any, bias: Optional[torch.Tensor],
            partial: bool = False) -> torch.Tensor:
    """`_product`, then the bias, if any, added in the activation dtype
    (after the sum over the model axis when ``partial``)."""
    out = _product(y, w, partial)
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


def encoder_layer(h: torch.Tensor, y: torch.Tensor, p: Params, cfg,
                  act: Callable[[torch.Tensor], torch.Tensor],
                  use_flash: Optional[bool] = None,
                  next_p: Optional[Params] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-LN ViT encoder layer, MHA -> residual -> LN -> MLP ->
    residual, on the residual stream ``h`` and its LN1 output ``y``.
    Returns (the new h, the next layer's LN1 output of it, from the
    ``ln1_*`` leaves of ``next_p``; None when ``next_p`` is None).

    Shared by the SigLIP and CLIP towers, which differ only in the MLP
    activation ``act`` (`vision_fused.gelu_tanh` vs `quick_gelu`), applied
    in f32 and cast back. The elementwise steps between the products are
    the passes of `ops.vision_fused` (kernels on CUDA tensors, the eager
    chains on CPU tensors): q/k/v biases; o bias, residual and LN2; fc1
    bias and ``act``; fc2 bias, residual and the next LN1. ``cfg`` needs
    num_heads / hidden_size / intermediate_size / layer_norm_eps; the
    leaves' head count may be a rank's own (their products then partial,
    summed over the model axis before the bias)."""
    N, T, C = h.shape
    hd = cfg.hidden_size // cfg.num_heads
    eps = cfg.layer_norm_eps

    if cut(out_width(p["q_proj"]), C, "vision q_proj"):
        y = copy_to_model(y)
    q, k, v = bias_add3(_product(y, p["q_proj"]), _product(y, p["k_proj"]),
                        _product(y, p["v_proj"]), p["q_bias"], p["k_bias"], p["v_bias"])
    attn = _attend(q.reshape(N, T, -1, hd), k.reshape(N, T, -1, hd), v.reshape(N, T, -1, hd),
                   hd, use_flash).reshape(N, T, -1)
    o = _product(attn, p["o_proj"], partial=cut(attn.shape[-1], C, "vision o_proj"))
    h, y = bias_residual_layernorm(o, p["o_bias"], h, p["ln2_scale"], p["ln2_bias"], eps)

    if cut(out_width(p["fc1"]), cfg.intermediate_size, "vision fc1"):
        y = copy_to_model(y)
    y = bias_act(_product(y, p["fc1"]), p["fc1_bias"], act)
    out = _product(y, p["fc2"], partial=cut(y.shape[-1], cfg.intermediate_size, "vision fc2"))
    ln = (None, None) if next_p is None else (next_p["ln1_scale"], next_p["ln1_bias"])
    return bias_residual_layernorm(out, p["fc2_bias"], h, *ln, eps)


def encoder_layers(x: torch.Tensor, layers: Params, num_layers: int, cfg,
                   act: Callable[[torch.Tensor], torch.Tensor],
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """The first ``num_layers`` layers of a stack on ``x``: the first
    layer's LN1 as a pass of its own (`vision_fused.bias_residual_layernorm`
    with no bias and no residual), then each `encoder_layer`, which hands
    the next one its residual stream and LN1 output; the last one returns
    the stream alone. Leaves cut over the data axis are gathered one layer
    ahead (`collectives.data_gatherer`), as the layer before needs the next
    one's LN1."""
    if num_layers == 0:
        return x
    whole = data_gatherer(layers)
    p = whole(layer_view(layers, 0))
    _, y = bias_residual_layernorm(x, None, None, p["ln1_scale"], p["ln1_bias"],
                                   cfg.layer_norm_eps)
    for i in range(num_layers):
        next_p = whole(layer_view(layers, i + 1)) if i + 1 < num_layers else None
        x, y = encoder_layer(x, y, p, cfg, act, use_flash, next_p)
        p = next_p
    return x


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
    return encoder_layers(x, params["layers"], num_layers, cfg, gelu_tanh, use_flash)


def normalize_pixels(frames_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (N, H, W, 3) -> SigLIP-normalized f32 (mean/std 0.5,
    rescale 1/255)."""
    return (frames_uint8.float() / 255.0 - 0.5) / 0.5
