"""Qwen2 decoder in PyTorch: full (training), streaming and scratch-decode
modes, with runtime LoRA.

Port of `mmduet_tpu/models/qwen2.py` for bf16 and f32 parameter leaves.
Parameters are the JAX package's tree as tensors (`models.params`):
per-layer weights stacked on a leading layer axis, matmul weights in the
(in, out) layout, so ``y @ W`` is the JAX einsum. The layer stack runs as
a Python loop over per-layer views of the stacked weights.

Streaming contract: attention runs over [the lane's committed cache
history] + [the chunk itself, causal] with the cache read-only
(`ops.attention.flash_decode_attention`, a CUDA kernel for CUDA tensors);
the chunk's K/V are written into the cache after the layer loop, in
place (`commit_lanes`). Padded tail tokens of a bucket produce outputs
that are never read, and their cache slots are overwritten by the next
chunk.

Full mode (``kv_cache=None``): causal attention over the chunk with
``attn_mask`` for padding, through `ops.attention.flash_full_attention`
(kernel C on CUDA, forward and backward) or the masked plain attention.

Not ported yet: int8/int4 leaves and the int8 KV cache; each raises
`NotImplementedError`.
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmduet_tpu.config import Qwen2Config

from ..ops.attention import (KernelRefused, attend, flash_decode_attention,
                             flash_full_attention)

Params = Dict[str, Any]
Lanes = Union[int, Sequence[int], torch.Tensor]


class KVCache(NamedTuple):
    """Preallocated KV cache: k/v of shape (L, B, kv_heads, S_max, head_dim),
    head-major so each head's (S, hd) slab is contiguous."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_kv_cache(
    cfg: Qwen2Config, batch: int, max_len: int,
    dtype: torch.dtype = torch.bfloat16, device=None,
    quant: Optional[str] = None,
) -> KVCache:
    if quant is not None:
        raise NotImplementedError(f"KV cache quant {quant!r} is not ported yet")
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def lane_list(x: Lanes, batch: int) -> List[int]:
    """Per-lane host integers from a scalar, a sequence or a tensor."""
    if torch.is_tensor(x):
        x = x.tolist()
    if isinstance(x, numbers.Integral):
        return [int(x)] * batch
    out = [int(v) for v in x]
    if len(out) == 1 and batch > 1:
        out = out * batch
    if len(out) != batch:
        raise ValueError(f"{len(out)} per-lane values for {batch} lanes")
    return out


def ints_to(values: Sequence[int], device) -> torch.Tensor:
    """Host integers as an int32 tensor on ``device``. A copy to a CUDA
    device goes through pinned memory and does not wait for the device's
    queue, so the host can keep enqueueing work ahead of the card."""
    t = torch.tensor(values, dtype=torch.int32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


class _MatmulF32(torch.autograd.Function):
    """bf16 ``(N, H) @ (H, O)`` on cuBLAS with an f32 output (f32
    accumulation, no f32 copy of either operand). The backward rounds the
    f32 cotangent to bf16 for its two products; the gradients come out in
    the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(..., H) @ (H, O)`` accumulated and returned in f32, as the JAX
    einsum with ``preferred_element_type=float32``. Two bf16 operands on
    CUDA go to cuBLAS as they are (`_MatmulF32`); otherwise both are
    upcast to f32."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def _rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (B, T) -> cos/sin of shape (B, T, head_dim//2), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, heads, head_dim); HF 'half-rotation' layout."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)


def _proj(y: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
          lora_ab: Optional[Params] = None, lora_scale: float = 0.0) -> torch.Tensor:
    """``y @ w`` in the activation dtype (f32 accumulation, one rounding,
    as the JAX einsum + astype), plus the bias in that dtype.

    With an adapter ``{"a": (in, r), "b": (r, out)}`` the low-rank term
    ``lora_scale * (y @ a) @ b`` is added to the f32 base product before
    the rounding, as the JAX projection does."""
    if lora_ab is None:
        out = torch.matmul(y, w)
    else:
        delta = torch.matmul(torch.matmul(y.float(), lora_ab["a"].float()),
                             lora_ab["b"].float())
        out = (matmul_f32(y, w) + lora_scale * delta).to(y.dtype)
    if bias is not None:
        out = out + bias.to(y.dtype)
    return out


def _check_dense(tree: Params, where: str) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            raise NotImplementedError(
                f"{where}.{name}: quantized (int8/int4) leaves are not ported yet"
            )


def _layer_lora(lora: Optional[Params], i: int) -> Params:
    """Layer ``i`` of the stacked adapter tree ({} without adapters)."""
    return {name: {"a": ab["a"][i], "b": ab["b"][i]} for name, ab in (lora or {}).items()}


def _qkv(x: torch.Tensor, p: Params, lo: Params, lora_scale: float,
         cfg: Qwen2Config, cos: torch.Tensor, sin: torch.Tensor):
    """Input norm, the q/k/v projections (with their adapters) and RoPE:
    q (B, T, nh, hd), k and v (B, T, kh, hd)."""
    B, T, _ = x.shape
    nh, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    y = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
    q = _proj(y, p["q_proj"], p.get("q_bias"), lo.get("q_proj"), lora_scale)
    k = _proj(y, p["k_proj"], p.get("k_bias"), lo.get("k_proj"), lora_scale)
    v = _proj(y, p["v_proj"], p.get("v_bias"), lo.get("v_proj"), lora_scale)
    q = apply_rope(q.reshape(B, T, nh, hd), cos, sin)
    k = apply_rope(k.reshape(B, T, kh, hd), cos, sin)
    return q, k, v.reshape(B, T, kh, hd)


def _out_mlp(x: torch.Tensor, attn: torch.Tensor, p: Params, lo: Params,
             lora_scale: float, cfg: Qwen2Config) -> torch.Tensor:
    """The attention output projection and the MLP block, with residuals."""
    B, T, _ = x.shape
    x = x + _proj(attn.reshape(B, T, -1), p["o_proj"], None, lo.get("o_proj"), lora_scale)
    y = rms_norm(x, p["post_attn_norm"], cfg.rms_norm_eps)
    gate = _proj(y, p["gate_proj"], None, lo.get("gate_proj"), lora_scale)
    up = _proj(y, p["up_proj"], None, lo.get("up_proj"), lora_scale)
    act = F.silu(gate.float()).to(x.dtype) * up
    return x + _proj(act, p["down_proj"], None, lo.get("down_proj"), lora_scale)


# ---------------------------------------------------------------------------
# Decoder forward
# ---------------------------------------------------------------------------


def qwen2_forward(
    params: Params,
    cfg: Qwen2Config,
    embeds: torch.Tensor,  # (B, T, H) input embeddings (already joint-embedded)
    positions: torch.Tensor,  # (B, T) global positions (RoPE; masking in full mode)
    kv_cache: Optional[KVCache] = None,
    cache_len: Optional[Lanes] = None,  # per-lane tokens already in cache
    attn_mask: Optional[torch.Tensor] = None,  # (B, T) bool, full mode only
    lora: Optional[Params] = None,  # {proj: {"a": (L,in,r), "b": (L,r,out)}}
    lora_scale: float = 0.0,
    remat: bool = False,  # full mode: recompute each layer in the backward
    t_real: Optional[Lanes] = None,  # per-lane real tokens in the chunk
    use_flash: Optional[bool] = None,  # full mode: None = auto (kernel C on CUDA)
    scratch: Optional[KVCache] = None,  # (L, B, kh, M, hd) decode scratch
    scratch_len: Optional[int] = None,  # tokens already in the scratch
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder. Three modes:

    - **full** (``kv_cache`` None): causal self-attention over the chunk,
      ``attn_mask`` masking padding; the training forward. CUDA tensors
      take `flash_full_attention`, kernel C (``use_flash`` None or True;
      False raises, and so does the kernel for what it refuses, e.g. a
      ``head_dim`` other than 128). CPU tensors take the masked plain
      attention (position-causal) for False and None, and kernel C's plain
      version for True. Under None (auto) on CUDA the hidden states turn
      to NaN if real positions do not strictly increase along the
      sequence (the index-causal kernel would silently differ from
      position-causality). ``remat`` checkpoints
      each layer (`torch.utils.checkpoint`, non-reentrant): its forward,
      kernel C's included, runs again inside the backward.
    - **streaming** (``kv_cache`` given): split attention over [committed
      cache history] + [the chunk, causal], then the chunk's K/V
      committed into ``kv_cache`` in place at each lane's ``cache_len``.
    - **scratch decode** (streaming + ``scratch``): the big cache is
      read-only; the chunk's K/V go into ``scratch`` at ``scratch_len``
      (in place) and attention runs over [cache slots < cache_len] +
      [scratch tokens + the chunk, causal at chunk position
      ``scratch_len`` + t]. Returns the scratch; the caller commits it
      into the big cache once, after the decode loop
      (`mmduet.decode_loop`).

    LoRA (every mode): ``lora_scale * (y @ a) @ b`` added to each adapted
    projection. Returns (hidden_states (B, T, H), the updated cache, the
    scratch, or None in full mode)."""
    layers = params["layers"]
    _check_dense(layers, "decoder.layers")
    cos, sin = _rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if kv_cache is None:
        return _full_forward(params, cfg, embeds, positions, cos, sin, attn_mask,
                             lora, lora_scale, remat, use_flash), None
    if attn_mask is not None:
        # Streaming handles right-padding via t_real only; a mask with
        # interior holes would be silently dropped here. Fail loudly.
        raise ValueError(
            "attn_mask is a full-mode (training) argument; streaming "
            "masks padding via t_real (right-padded chunks only)"
        )
    B, T, _ = embeds.shape
    dev = embeds.device

    cache_len_b = lane_list(cache_len, B)
    t_real_b = lane_list(T if t_real is None else t_real, B)
    if scratch is not None:
        s_len = int(scratch_len)
        t_att, q_off = [s_len + t for t in t_real_b], [s_len] * B
    else:
        t_att, q_off = t_real_b, [0] * B
    # per-lane cursors cross to the device once per forward
    cl_dev, tr_dev, qo_dev = (ints_to(v, dev) for v in (cache_len_b, t_att, q_off))

    x = embeds
    new_k: List[torch.Tensor] = []
    new_v: List[torch.Tensor] = []
    for i in range(kv_cache.k.shape[0]):
        p = {name: w[i] for name, w in layers.items()}
        lo = _layer_lora(lora, i)
        q, k, v = _qkv(x, p, lo, lora_scale, cfg, cos, sin)
        # chunk (B, T, kh, hd) -> head-major (B, kh, T, hd)
        k_hm = k.transpose(1, 2).to(kv_cache.k.dtype).contiguous()
        v_hm = v.transpose(1, 2).to(kv_cache.v.dtype).contiguous()
        if scratch is not None:
            # the chunk operand is this layer's scratch [generated tokens'
            # K/V ++ this chunk], written in place at s_len (the JAX code
            # returns an updated scratch instead)
            scratch.k[i, :, :, s_len:s_len + T] = k_hm
            scratch.v[i, :, :, s_len:s_len + T] = v_hm
            ck, cv = scratch.k[i], scratch.v[i]
        else:
            ck, cv = k_hm, v_hm
            new_k.append(k_hm)
            new_v.append(v_hm)
        attn = flash_decode_attention(
            q, kv_cache.k, kv_cache.v, ck.to(q.dtype), cv.to(q.dtype),
            cl_dev, tr_dev, i, q_offset=qo_dev,
        )
        x = _out_mlp(x, attn, p, lo, lora_scale, cfg)

    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if scratch is not None:
        return hidden, scratch
    # every layer's chunk K/V into the cache, in place; padded tail slots
    # hold garbage that the next chunk overwrites
    return hidden, commit_lanes(
        kv_cache, torch.stack(new_k), torch.stack(new_v), cache_len_b
    )


def _full_forward(params: Params, cfg: Qwen2Config, embeds: torch.Tensor,
                  positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  attn_mask: Optional[torch.Tensor], lora: Optional[Params],
                  lora_scale: float, remat: bool,
                  use_flash: Optional[bool]) -> torch.Tensor:
    """Full mode of `qwen2_forward`: the final-normed hidden states."""
    B, T, _ = embeds.shape
    if embeds.is_cuda and use_flash is False:
        raise KernelRefused("qwen2_forward: full mode on CUDA tensors runs kernel C "
                             "(use_flash None or True); the plain attention is for CPU tensors")
    auto = use_flash is None
    use_flash = embeds.is_cuda or bool(use_flash)
    mono_ok = None
    if auto and use_flash:
        # the kernel is index-causal; it equals the position-causal mask
        # only while real positions strictly increase
        real = (attn_mask if attn_mask is not None
                else torch.ones((B, T), dtype=torch.bool, device=embeds.device))
        both = real[:, :-1] & real[:, 1:]
        mono_ok = torch.where(both, positions[:, 1:] > positions[:, :-1], True).all()
    mask = None
    if not use_flash:
        mask = positions[:, :, None] >= positions[:, None, :]
        if attn_mask is not None:  # padding neither attends nor is attended
            mask = mask & attn_mask[:, None, :] & attn_mask[:, :, None]

    def layer(x, p, lo):
        q, k, v = _qkv(x, p, lo, lora_scale, cfg, cos, sin)
        if use_flash:
            attn = flash_full_attention(q, k, v, attn_mask)
        else:
            attn = attend(q, k, v, mask)
        return _out_mlp(x, attn, p, lo, lora_scale, cfg)

    x = embeds
    layers = params["layers"]
    for i in range(layers["q_proj"].shape[0]):
        p = {name: w[i] for name, w in layers.items()}
        lo = _layer_lora(lora, i)
        x = checkpoint(layer, x, p, lo, use_reentrant=False) if remat else layer(x, p, lo)
    if mono_ok is not None:
        x = torch.where(mono_ok, x, torch.full_like(x, float("nan")))
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def commit_lanes(cache: KVCache, new_k: torch.Tensor, new_v: torch.Tensor,
                 starts: Lanes) -> KVCache:
    """Write (L, B, kh, t, hd) K/V rows into the (L, B, kh, S, hd) cache
    at per-lane slot ``starts[b]``, in place, one slice write per lane
    (the JAX code chains per-lane `dynamic_update_slice` on a donated
    buffer). A write past the cache's end raises instead of clamping."""
    B, t = new_k.shape[1], new_k.shape[3]
    for b, s in enumerate(lane_list(starts, B)):
        if s < 0 or s + t > cache.max_len:
            raise RuntimeError(
                f"commit_lanes: lane {b} rows [{s}, {s + t}) outside the "
                f"cache of {cache.max_len} slots"
            )
        cache.k[:, b, :, s:s + t] = new_k[:, b]
        cache.v[:, b, :, s:s + t] = new_v[:, b]
    return cache


def embed_tokens(params: Params, input_ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Token embedding with the reference's clamp trick: the `<image>`
    placeholder id may be >= the embedding rows and gets clamped; its
    embedding is always overwritten by visual features."""
    emb = params["embed"]
    if isinstance(emb, dict):
        raise NotImplementedError("quantized embedding is not ported yet")
    return emb[input_ids.clamp(0, vocab_size - 1)]


def lm_logits(lm_head: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """(B, T, H) @ (H, V) -> f32 logits."""
    if isinstance(lm_head, dict):
        raise NotImplementedError("quantized lm_head is not ported yet")
    return matmul_f32(hidden, lm_head)
