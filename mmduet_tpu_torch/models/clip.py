"""CLIP vision tower (ViT-L/14 family) in PyTorch.

Port of `mmduet_tpu/models/clip.py`, the reference's standalone CLIP
vision path (`models/vision_live.py:34-64`: `_clip_vision_encode` over an
HF `CLIPVisionModel`, checkpoints `openai/clip-vit-large-patch14-336` and
`laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90k`). What differs from the SigLIP
tower:

- a learned class token prepended to the patches, positions over
  ``1 + num_patches``;
- a ``pre_layrnorm`` on the embeddings (HF's name) and no LayerNorm after
  the last layer (``post_layernorm`` is kept in the tree but unused: HF
  applies it to the pooled CLS only, which the reference does not read);
- quick_gelu in the MLP (x * sigmoid(1.702 x));
- the OpenAI CLIP pixel normalization;
- spatial tokens pooled at the tower with torch's adaptive average pooling,
  before the projector (no post-projector `spatial_pool`).

The layers are `siglip.encoder_layers` with `quick_gelu`, the
``pre_layrnorm`` the LayerNorm pass of `ops.vision_fused`; the attention is
`siglip._attend`, i.e. kernel D (`ops.attention.flash_vision_attention`)
on CUDA tensors, at CLIP-L's 16 heads of 64 over 1 + 576 tokens (336 px).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.vision_fused import bias_residual_layernorm, quick_gelu
from .siglip import _linear, encoder_layers, patchify

Params = Dict[str, Any]

# transformers.utils.constants.OPENAI_CLIP_MEAN / OPENAI_CLIP_STD (the
# reference's `_clip_vision_encode` normalization, `vision_live.py:35-37`)
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _channels(values: Sequence[float], device: torch.device) -> torch.Tensor:
    """A per-channel f32 constant on ``device``; through pinned memory on a
    CUDA device (a pageable copy would wait for the stream's whole queue,
    the vision stream's encode included)."""
    t = torch.tensor(values, dtype=torch.float32)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def normalize_pixels(frames_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (N, H, W, 3) -> CLIP-normalized f32."""
    mean = _channels(OPENAI_CLIP_MEAN, frames_uint8.device)
    std = _channels(OPENAI_CLIP_STD, frames_uint8.device)
    return (frames_uint8.float() / 255.0 - mean) / std


def clip_encode(params: Params, cfg, images: torch.Tensor,
                use_flash: Optional[bool] = None) -> torch.Tensor:
    """Images (N, H, W, 3), already CLIP-normalized -> last_hidden_state
    (N, 1 + num_patches, hidden): CLS at position 0, no final LayerNorm.
    ``use_flash``: the attention route of `siglip._attend` (None = kernel D
    on CUDA tensors)."""
    N = images.shape[0]
    x = _linear(patchify(images, cfg.patch_size), params["patch_embed"], None)  # no bias
    cls = params["class_embed"].to(x.dtype)[None, None].expand(N, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)[None]
    _, x = bias_residual_layernorm(x, None, None, params["pre_ln_scale"], params["pre_ln_bias"],
                                   cfg.layer_norm_eps)
    return encoder_layers(x, params["layers"], cfg.num_layers, cfg, quick_gelu, use_flash)


def adaptive_avg_pool_grid(grid: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """torch's `adaptive_avg_pool2d` over a (N, S, S, C) grid -> (N, oh, ow,
    C), in f32 and cast back to the grid's dtype: output cell (i, j)
    averages rows floor(i S / oh) .. ceil((i + 1) S / oh) (and the same for
    columns)."""
    pooled = F.adaptive_avg_pool2d(grid.float().permute(0, 3, 1, 2), tuple(out_hw))
    return pooled.permute(0, 2, 3, 1).to(grid.dtype)


def standalone_encode(params: Params, cfg, images: torch.Tensor, frame_token_cls: bool,
                      frame_token_pooled: Optional[Sequence[int]],
                      use_flash: Optional[bool] = None) -> torch.Tensor:
    """The reference `_clip_vision_encode` contract (`vision_live.py:34-54`):
    the CLS token ``last_hidden_state[:, 0]`` (no post-LN) and/or the patch
    grid of ``last_hidden_state[:, 1:]`` adaptive-average-pooled to
    ``frame_token_pooled`` (a tuple, or the list `config.json` gives back),
    concatenated [cls, spatial]. Returns (N, tokens, hidden)."""
    last = clip_encode(params, cfg, images, use_flash=use_flash)
    outs = []
    if frame_token_cls:
        outs.append(last[:, :1])
    if frame_token_pooled:
        s = cfg.num_patches_per_side
        grid = last[:, 1:].reshape(last.shape[0], s, s, -1)
        pooled = adaptive_avg_pool_grid(grid, tuple(frame_token_pooled))
        outs.append(pooled.reshape(last.shape[0], -1, last.shape[-1]))
    if not outs:
        raise ValueError("standalone_encode needs frame_token_cls and/or frame_token_pooled")
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
