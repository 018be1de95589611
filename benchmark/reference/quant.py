"""Quantization arithmetic as the reference works it out again from the
bf16 weights, and the lower precisions of the controls.

`int4_round_trip` and `int8_kv_round_trip` follow the arithmetic of
`mmduet_tpu_torch/models/quant.py` (`quantize_weight_int4`) and
`mmduet_tpu_torch/models/qwen2.py` (`quantize_kv_rows`) at commit
71a961d, frozen here: symmetric, round half to even, the int4 scale kept
in bf16 as the program stores it. The controls' precisions (`fp8_*`,
`int4_kv_round_trip`) are the benchmark's own. Every function returns f32
values.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def int4_round_trip(w: torch.Tensor, reduce_axis: int, group: int = 128) -> torch.Tensor:
    """Group-wise symmetric int4 (values in [-7, 7]) along ``reduce_axis``,
    one bf16 scale a (group, output) pair, dequantized."""
    w = w.float()
    reduce_axis %= w.ndim
    dim = w.shape[reduce_axis]
    if dim % group:
        raise ValueError(f"int4: reduce dim {dim} is not a multiple of the group {group}")
    shape = w.shape
    g = w.reshape(shape[:reduce_axis] + (dim // group, group) + shape[reduce_axis + 1:])
    scale = g.abs().amax(dim=reduce_axis + 1, keepdim=True).clamp(min=1e-8) / 7.0
    q = torch.round(g / scale).clamp(-7, 7)
    return (q * scale.to(torch.bfloat16).float()).reshape(shape)


def int8_kv_round_trip(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-token int8 over the trailing head dim, dequantized."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-20) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


def int4_kv_round_trip(x: torch.Tensor) -> torch.Tensor:
    """The int8 cache's control: symmetric per-token int4 over the head dim."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-20) / 7.0
    return torch.round(x / scale).clamp(-7, 7) * scale


def fp8_weight_round_trip(w: torch.Tensor, reduce_axis: int) -> torch.Tensor:
    """float8 e4m3 with one f32 scale an output channel (the amax over the
    reduce axis maps to 448), dequantized."""
    w = w.float()
    scale = w.abs().amax(dim=reduce_axis, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_act_round_trip(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one f32 scale a row (token), dequantized."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
