"""Qwen2 decoder in PyTorch: full (training), streaming and scratch-decode
modes, with runtime LoRA.

Port of `mmduet_tpu/models/qwen2.py`. Matmul weights, the embedding and
the LM head may be dense tensors or the quantized leaves of
`models.quant` (int8 per channel, group-wise int4); every projection goes
through `quant.quantized_matmul`, which dispatches on the leaf. Parameters are the JAX package's tree as tensors (`models.params`):
per-layer weights stacked on a leading layer axis, matmul weights in the
(in, out) layout, so ``y @ W`` is the JAX einsum. The layer stack runs as
a Python loop over per-layer views of the stacked weights.

Streaming contract: attention runs over [the lane's committed cache
history] + [the chunk itself, causal] with the cache read-only
(`ops.attention.flash_decode_attention`, a CUDA kernel for CUDA tensors);
the chunk's K/V are written into the cache after the layer loop, in
place (`commit_lanes`). With an int8 cache (`init_kv_cache(quant="int8")`)
the chunk and the decode scratch stay in the activation dtype, the rows
are quantized at the commit, and attention reads the int8 cache with its
per-token scales. Padded tail tokens of a bucket produce outputs
that are never read, and their cache slots are overwritten by the next
chunk.

Full mode (``kv_cache=None``): causal attention over the chunk with
``attn_mask`` for padding, through `ops.attention.flash_full_attention`
(kernel C on CUDA, forward and backward) or the masked plain attention.
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import Qwen2Config

from ..ops.attention import (KernelRefused, attend, flash_decode_attention,
                             flash_full_attention)
from .quant import is_quantized, layer_view, quantized_matmul, unpack_int4

Params = Dict[str, Any]
Lanes = Union[int, Sequence[int], torch.Tensor]


class KVCache(NamedTuple):
    """Preallocated KV cache: k/v of shape (L, B, kv_heads, S_max, head_dim),
    head-major so each head's (S, hd) slab is contiguous.

    int8 cache (``init_kv_cache(quant="int8")``): each of k/v is a
    ``{"qw": int8 (L, B, kh, S, hd), "qs": f32 (L, B, kh, S)}`` dict, the
    leaf convention of the int8 weights. Rows are quantized symmetrically
    per (layer, lane, head, slot) at commit time (`commit_lanes`); the
    attention kernel applies the scales as column scalings."""

    k: Any
    v: Any

    @property
    def max_len(self) -> int:
        return kv_arr(self.k).shape[3]


def kv_arr(leaf) -> torch.Tensor:
    """The cache's value tensor for either layout (a tensor, or the int8
    ``{"qw", "qs"}`` dict)."""
    return leaf["qw"] if isinstance(leaf, dict) else leaf


def kv_quantized(cache: KVCache) -> bool:
    return isinstance(cache.k, dict)


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 over the trailing head_dim: (..., hd) ->
    ((..., hd) int8, (...) f32 scale)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-20) / 127.0
    qw = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return qw, scale


def dequantize_kv(leaf, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """{"qw", "qs"} -> dense (..., hd) values (tests)."""
    if not isinstance(leaf, dict):
        return leaf.to(dtype)
    return (leaf["qw"].float() * leaf["qs"].float()[..., None]).to(dtype)


def init_kv_cache(
    cfg: Qwen2Config, batch: int, max_len: int,
    dtype: torch.dtype = torch.bfloat16, device=None,
    quant: Optional[str] = None,
) -> KVCache:
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if quant == "int8":
        def leaf():
            return {"qw": torch.zeros(shape, dtype=torch.int8, device=device),
                    "qs": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}

        return KVCache(k=leaf(), v=leaf())
    if quant is not None:
        raise ValueError(f"unknown KV cache quant: {quant!r} (use 'int8')")
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


def _proj(y: torch.Tensor, w: Any, bias: Optional[torch.Tensor] = None,
          lora_ab: Optional[Params] = None, lora_scale: float = 0.0) -> torch.Tensor:
    """``y @ w`` in the activation dtype (f32 accumulation, one rounding,
    as the JAX einsum + astype), plus the bias in that dtype; ``w`` is a
    dense tensor or a quantized leaf (`quant.quantized_matmul`).

    With an adapter ``{"a": (in, r), "b": (r, out)}`` the low-rank term
    ``lora_scale * (y @ a) @ b`` is added to the f32 base product before
    the rounding, as the JAX projection does."""
    if lora_ab is None and not is_quantized(w):
        out = torch.matmul(y, w)
    else:
        out = quantized_matmul(y, w)
        if lora_ab is not None:
            delta = torch.matmul(torch.matmul(y.float(), lora_ab["a"].float()),
                                 lora_ab["b"].float())
            out = out + lora_scale * delta
        out = out.to(y.dtype)
    if bias is not None:
        out = out + bias.to(y.dtype)
    return out


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
    kc_arr, vc_arr = kv_arr(kv_cache.k), kv_arr(kv_cache.v)
    kv_q = kv_quantized(kv_cache)
    scales = (dict(k_scale=kv_cache.k["qs"], v_scale=kv_cache.v["qs"]) if kv_q else {})
    # the chunk stays in the activation dtype under an int8 cache
    # (quantization happens at the commit)
    el_dtype = embeds.dtype if kv_q else kc_arr.dtype
    for i in range(kc_arr.shape[0]):
        p = layer_view(layers, i)
        lo = _layer_lora(lora, i)
        q, k, v = _qkv(x, p, lo, lora_scale, cfg, cos, sin)
        # chunk (B, T, kh, hd) -> head-major (B, kh, T, hd)
        k_hm = k.transpose(1, 2).to(el_dtype).contiguous()
        v_hm = v.transpose(1, 2).to(el_dtype).contiguous()
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
            q, kc_arr, vc_arr, ck.to(q.dtype), cv.to(q.dtype),
            cl_dev, tr_dev, i, q_offset=qo_dev, **scales,
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
    for i in range(layers["input_norm"].shape[0]):
        p = layer_view(layers, i)
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
    buffer). A write past the cache's end raises instead of clamping.

    int8 cache: the rows are quantized here (per-token symmetric,
    `quantize_kv_rows`) and both the int8 values and the f32 scales are
    written in place."""
    B, t = new_k.shape[1], new_k.shape[3]
    if kv_quantized(cache):
        new_k, k_s = quantize_kv_rows(new_k)
        new_v, v_s = quantize_kv_rows(new_v)
    for b, s in enumerate(lane_list(starts, B)):
        if s < 0 or s + t > cache.max_len:
            raise RuntimeError(
                f"commit_lanes: lane {b} rows [{s}, {s + t}) outside the "
                f"cache of {cache.max_len} slots"
            )
        kv_arr(cache.k)[:, b, :, s:s + t] = new_k[:, b]
        kv_arr(cache.v)[:, b, :, s:s + t] = new_v[:, b]
        if kv_quantized(cache):
            cache.k["qs"][:, b, :, s:s + t] = k_s[:, b]
            cache.v["qs"][:, b, :, s:s + t] = v_s[:, b]
    return cache


def embed_tokens(params: Params, input_ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Token embedding with the reference's clamp trick: the `<image>`
    placeholder id may be >= the embedding rows and gets clamped; its
    embedding is always overwritten by visual features."""
    ids = input_ids.clamp(0, vocab_size - 1)
    emb = params["embed"]
    if isinstance(emb, dict) and "qw4" in emb:
        # int4 per row group: qw4 packed (V, G, g/2), qs (V, G, 1). Gather
        # the packed rows, then unpack the nibbles of the gathered rows only.
        rows = unpack_int4(emb["qw4"][ids], -1).float()  # (..., G, g)
        out = rows * emb["qs"][ids].float()
        return out.reshape(*out.shape[:-2], -1).to(emb["qs"].dtype)
    if isinstance(emb, dict):  # int8 per row: gather rows, then scale
        rows = emb["qw"][ids].float()
        return (rows * emb["qs"][:, 0][ids].float()[..., None]).to(emb["qs"].dtype)
    return emb[ids]


def lm_logits(lm_head: Any, hidden: torch.Tensor) -> torch.Tensor:
    """(B, T, H) @ (H, V) -> f32 logits, for a dense, int8 or grouped int4
    LM head (`quant.quantized_matmul`)."""
    return quantized_matmul(hidden, lm_head)
