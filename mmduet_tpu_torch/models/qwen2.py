"""Qwen2 decoder in PyTorch: full (training) and streaming modes, and the
scratch-decode step, with runtime LoRA.

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
place, at each lane's device cursor (`commit_rows`). With an int8 cache
(`init_kv_cache(quant="int8")`) the chunk and the decode scratch stay in
the activation dtype, the rows
are quantized at the commit, and attention reads the int8 cache with its
per-token scales. Padded tail tokens of a bucket produce outputs
that are never read, and their cache slots are overwritten by the next
chunk.

Scratch decode (`scratch_decode_forward`): one token a lane against the
read-only cache and a small scratch of the tokens generated so far, on
device integers only, so that a CUDA graph can capture it.

Full mode (``kv_cache=None``): causal attention over the chunk with
``attn_mask`` for padding, through `ops.attention.flash_full_attention`
(kernel C on CUDA, forward and backward) or the masked plain attention.

Tensor parallelism: on a rank of a process mesh ``params`` is the rank's
local tree (`parallel.sharding.shard_params`). Head counts come from the
leaves' shapes; the f32 partial products of a row-cut ``o_proj`` /
``down_proj`` and of a vocabulary-cut embedding are summed over the model
axis (`parallel.collectives.reduce_model`) before their one rounding, so a
rank's hidden states differ from one device's only by the order of that
sum, and are the same bits on every rank. `lm_logits` gives the rank's
vocabulary slice (`collectives.gather_vocab` makes whole rows). Under
autograd the normed inputs of q/k/v and of gate/up pass through
`collectives.copy_to_model` (the sum of their cotangents over the model
axis), and the reduces are differentiable; a whole adapter's gradient is
then the rank's part of it (the columns or rows it used, or a partial sum),
which the training step sums over the model axis. In full mode, leaves cut
over the data axis (``--param_mode fsdp``) are gathered one layer at a time
inside the layer (`collectives.data_gatherer`), so under remat they are
gathered again in its recompute.
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import Qwen2Config

from ..ops.attention import (KernelRefused, ShardCtx, attend, flash_decode_attention,
                             flash_decode_attention_sharded, flash_full_attention)
from ..parallel.collectives import (copy_to_model, cut, data_gatherer, model_axis,
                                    reduce_model)
from .quant import is_quantized, layer_view, out_width, quantized_matmul, unpack_int4

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
    quant: Optional[str] = None, num_kv_heads: Optional[int] = None,
) -> KVCache:
    """A zero cache; ``num_kv_heads`` (default ``cfg.num_kv_heads``) is a
    rank's local count under tensor parallelism."""
    kh = cfg.num_kv_heads if num_kv_heads is None else num_kv_heads
    shape = (cfg.num_layers, batch, kh, max_len, cfg.head_dim)
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


def zero_kv_cache(cache: KVCache) -> KVCache:
    """Zeros every tensor of ``cache`` in place (the values of a fresh
    `init_kv_cache`), keeping its memory: what holds its address, as a
    captured decode step does, stays valid."""
    for leaf in (cache.k, cache.v):
        for t in leaf.values() if isinstance(leaf, dict) else (leaf,):
            t.zero_()
    return cache


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
          lora_ab: Optional[Params] = None, lora_scale: float = 0.0,
          partial: bool = False) -> torch.Tensor:
    """``y @ w`` in the activation dtype (f32 accumulation, one rounding,
    as the JAX einsum + astype), plus the bias in that dtype; ``w`` is a
    dense tensor or a quantized leaf (`quant.quantized_matmul`).

    With an adapter ``{"a": (in, r), "b": (r, out)}`` the low-rank term
    ``lora_scale * (y @ a) @ b`` is added to the f32 base product before
    the rounding, as the JAX projection does; on a cut projection the rank
    takes its part of the whole adapter (`_local_adapter`). ``partial``:
    ``y`` and ``w`` are this rank's slice of the input dim, and the f32
    product (with the adapter's partial term) is summed over the model axis
    before the rounding."""
    if lora_ab is None and not is_quantized(w) and not partial:
        out = torch.matmul(y, w)
    else:
        out = quantized_matmul(y, w)
        if lora_ab is not None:
            a, b = _local_adapter(lora_ab, y.shape[-1], out.shape[-1])
            delta = torch.matmul(torch.matmul(y.float(), a.float()), b.float())
            out = out + lora_scale * delta
        if partial:
            out = reduce_model(out)
        out = out.to(y.dtype)
    if bias is not None:
        out = out + bias.to(y.dtype)
    return out


def _local_adapter(ab: Params, n_in: int, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of a whole adapter on a projection with ``n_in``
    inputs and ``n_out`` outputs: the columns of ``b`` of an output-cut
    projection (q/k/v/gate/up), the rows of ``a`` of an input-cut one
    (o/down)."""
    a, b = ab["a"], ab["b"]
    rank, _ = model_axis()
    if cut(n_in, a.shape[0], "LoRA a"):
        a = a[rank * n_in:(rank + 1) * n_in]
    if cut(n_out, b.shape[-1], "LoRA b"):
        b = b[:, rank * n_out:(rank + 1) * n_out]
    return a, b


def _layer_lora(lora: Optional[Params], i: int) -> Params:
    """Layer ``i`` of the stacked adapter tree ({} without adapters)."""
    return {name: {"a": ab["a"][i], "b": ab["b"][i]} for name, ab in (lora or {}).items()}


def _qkv(x: torch.Tensor, p: Params, lo: Params, lora_scale: float,
         cfg: Qwen2Config, cos: torch.Tensor, sin: torch.Tensor):
    """Input norm, the q/k/v projections (with their adapters) and RoPE:
    q (B, T, nh, hd), k and v (B, T, kh, hd), with the head counts of the
    leaves (a rank's own under tensor parallelism)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    y = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
    if cut(out_width(p["q_proj"]), cfg.num_heads * hd, "q_proj"):
        y = copy_to_model(y)
    q = _proj(y, p["q_proj"], p.get("q_bias"), lo.get("q_proj"), lora_scale)
    k = _proj(y, p["k_proj"], p.get("k_bias"), lo.get("k_proj"), lora_scale)
    v = _proj(y, p["v_proj"], p.get("v_bias"), lo.get("v_proj"), lora_scale)
    q = apply_rope(q.reshape(B, T, -1, hd), cos, sin)
    k = apply_rope(k.reshape(B, T, -1, hd), cos, sin)
    return q, k, v.reshape(B, T, -1, hd)


def _out_mlp(x: torch.Tensor, attn: torch.Tensor, p: Params, lo: Params,
             lora_scale: float, cfg: Qwen2Config) -> torch.Tensor:
    """The attention output projection and the MLP block, with residuals;
    a rank's slice of the heads (of the intermediate dim) makes o_proj's
    (down_proj's) product partial, summed over the model axis."""
    B, T, _ = x.shape
    attn = attn.reshape(B, T, -1)
    x = x + _proj(attn, p["o_proj"], None, lo.get("o_proj"), lora_scale,
                  partial=cut(attn.shape[-1], cfg.num_heads * cfg.head_dim, "o_proj"))
    y = rms_norm(x, p["post_attn_norm"], cfg.rms_norm_eps)
    if cut(out_width(p["gate_proj"]), cfg.intermediate_size, "gate_proj"):
        y = copy_to_model(y)
    gate = _proj(y, p["gate_proj"], None, lo.get("gate_proj"), lora_scale)
    up = _proj(y, p["up_proj"], None, lo.get("up_proj"), lora_scale)
    act = F.silu(gate.float()).to(x.dtype) * up
    return x + _proj(act, p["down_proj"], None, lo.get("down_proj"), lora_scale,
                     partial=cut(act.shape[-1], cfg.intermediate_size, "down_proj"))


# ---------------------------------------------------------------------------
# Decoder forward
# ---------------------------------------------------------------------------


def qwen2_forward(
    params: Params,
    cfg: Qwen2Config,
    embeds: torch.Tensor,  # (B, T, H) input embeddings (already joint-embedded)
    positions: torch.Tensor,  # (B, T) global positions (RoPE; masking in full mode)
    kv_cache: Optional[KVCache] = None,
    cache_len: Optional[Lanes] = None,  # per-lane tokens already in cache: host
    # values or a (B,) int32 tensor on the device
    attn_mask: Optional[torch.Tensor] = None,  # (B, T) bool, full mode only
    lora: Optional[Params] = None,  # {proj: {"a": (L,in,r), "b": (L,r,out)}}
    lora_scale: float = 0.0,
    remat: bool = False,  # full mode: recompute each layer in the backward
    t_real: Optional[Lanes] = None,  # per-lane real tokens in the chunk, the same
    use_flash: Optional[bool] = None,  # full mode: None = auto (kernel C on CUDA)
    shard_ctx: Optional[ShardCtx] = None,  # streaming: attention per shard of
    # a mesh (`flash_decode_attention_sharded`); the caller has checked
    # `shard_ctx_ok`
    commit=None,  # streaming: the lanes whose chunk K/V are committed, host
    # bools or a (B,) bool tensor on the device (None = all)
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder. Two modes:

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
      A lane that ``commit`` leaves out keeps its cache untouched: the
      batched engines leave out the lanes they do not feed, whose rows
      the JAX package writes past the lane's cursor, where nothing reads
      them. With ``shard_ctx`` the attention runs per (lane shard, head
      shard) of the mesh, bit-equal to the unsharded call. Host cursors
      cross to the device once, at the entry (`stream_cursors`, which
      checks that a committed lane's rows fit the cache); device tensors
      pass through, and the body (`_stream_forward`) reads no host value,
      so a CUDA graph can capture the call. The decode step's route
      through the layers is `scratch_decode_forward`.

    LoRA (both modes): ``lora_scale * (y @ a) @ b`` added to each adapted
    projection. Returns (hidden_states (B, T, H), the updated cache, or
    None in full mode)."""
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
    cl, tr, cm = stream_cursors(kv_cache, B, T, embeds.device, cache_len,
                                T if t_real is None else t_real, commit)
    return _stream_forward(params, cfg, embeds, cos, sin, kv_cache, cl, tr, cm, lora,
                           lora_scale, shard_ctx), kv_cache


def stream_cursors(kv_cache: KVCache, B: int, T: int, device, cache_len, t_real,
                   commit=None) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """A streaming forward's per-lane operands on ``device``, made once at
    its entry: ``cache_len`` and ``t_real`` (None stays None) as (B,)
    int32 tensors and ``commit`` as a (B,) bool tensor (None = every
    lane). A device tensor passes as it is; host values (a scalar, a
    sequence) cross in one copy each, and host cursors are checked first,
    as `commit_lanes` checks them: a committed lane's T rows must fit the
    cache."""
    if not torch.is_tensor(cache_len):
        cache_len = lane_list(cache_len, B)
        fits = lane_list(True if commit is None else commit, B)
        check_rows_fit(kv_cache, cache_len, T, fits)
    if commit is not None and not torch.is_tensor(commit):
        commit = ints_to(lane_list(commit, B), device).bool()
    return (_on_device(cache_len, B, device),
            None if t_real is None else _on_device(t_real, B, device), commit)


def _on_device(x: Lanes, B: int, device) -> torch.Tensor:
    return x if torch.is_tensor(x) and x.device == torch.device(device) \
        else ints_to(lane_list(x, B), device)


def check_rows_fit(cache: KVCache, starts: Sequence[int], t: int,
                   lanes: Optional[Sequence[bool]] = None) -> None:
    """Raises for a lane (of those ``lanes`` marks) whose ``t`` rows from
    its host cursor ``starts[b]`` leave the cache: the host's guard before
    a write, which itself never clamps."""
    for b, s in enumerate(starts):
        if (lanes is None or lanes[b]) and (s < 0 or s + t > cache.max_len):
            raise RuntimeError(
                f"commit_lanes: lane {b} rows [{s}, {s + t}) outside the "
                f"cache of {cache.max_len} slots"
            )


def _stream_forward(params: Params, cfg: Qwen2Config, embeds: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, kv_cache: KVCache,
                    cache_len: torch.Tensor, t_real: torch.Tensor,
                    commit: Optional[torch.Tensor], lora: Optional[Params], lora_scale: float,
                    shard_ctx: Optional[ShardCtx]) -> torch.Tensor:
    """The streaming mode's body on device operands only: it reads nothing
    back to the host and copies nothing to the device, so a CUDA graph can
    capture it (`mmduet.EngineGraphs`). Returns the final-normed hidden
    states; the chunk's K/V are committed in place."""
    B, T, _ = embeds.shape
    kc_arr, vc_arr = kv_arr(kv_cache.k), kv_arr(kv_cache.v)
    L, _, kh, _, hd = kc_arr.shape
    scales = _cache_scales(kv_cache)
    # the chunk stays in the activation dtype under an int8 cache
    # (quantization happens at the commit)
    el_dtype = embeds.dtype if kv_quantized(kv_cache) else kc_arr.dtype
    # every layer's chunk K/V, head-major, for the commit after the loop
    new_k = torch.empty((L, B, kh, T, hd), dtype=el_dtype, device=embeds.device)
    new_v = torch.empty_like(new_k)
    x = embeds
    for i in range(L):
        p = layer_view(params["layers"], i)
        lo = _layer_lora(lora, i)
        q, k, v = _qkv(x, p, lo, lora_scale, cfg, cos, sin)
        # chunk (B, T, kh, hd) -> head-major (B, kh, T, hd)
        new_k[i] = k.transpose(1, 2)
        new_v[i] = v.transpose(1, 2)
        attn = _attend_cache(q, kc_arr, vc_arr, new_k[i].to(q.dtype), new_v[i].to(q.dtype),
                             cache_len, t_real, i, None, scales, shard_ctx)
        x = _out_mlp(x, attn, p, lo, lora_scale, cfg)

    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    # every layer's chunk K/V into the cache, in place; padded tail slots
    # hold garbage that the next chunk overwrites
    commit_rows(kv_cache, new_k, new_v, cache_len, commit)
    return hidden


def _cache_scales(kv_cache: KVCache) -> Dict[str, torch.Tensor]:
    """The per-token scales of an int8 cache as kernel A's keywords ({} for
    a cache in the activation dtype)."""
    if not kv_quantized(kv_cache):
        return {}
    return dict(k_scale=kv_cache.k["qs"], v_scale=kv_cache.v["qs"])


def _attend_cache(q, kc, vc, ck, cv, cache_len, t_real, layer: int, q_offset,
                  scales: Dict[str, torch.Tensor], shard_ctx: Optional[ShardCtx]):
    """Kernel A (its plain version for CPU tensors) over layer ``layer`` of
    the cache and the chunk operand, per mesh shard under ``shard_ctx``."""
    if shard_ctx is not None:
        return flash_decode_attention_sharded(q, kc, vc, ck, cv, cache_len, t_real, layer,
                                              shard_ctx, q_offset=q_offset, **scales)
    return flash_decode_attention(q, kc, vc, ck, cv, cache_len, t_real, layer,
                                  q_offset=q_offset, **scales)


def scratch_decode_forward(
    params: Params,
    cfg: Qwen2Config,
    embeds: torch.Tensor,  # (B, 1, H) each lane's last sampled token
    positions: torch.Tensor,  # (B,) int32 each lane's cursor: its token's RoPE position
    kv_cache: KVCache,  # read-only
    cache_len: torch.Tensor,  # (B,) int32 the committed cache slots each lane attends
    step: torch.Tensor,  # () int32 the decode step i >= 1: the scratch holds i - 1 tokens
    scratch: KVCache,  # (L, B, kh, W, hd) the generated tokens' K/V, W >= i
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    shard_ctx: Optional[ShardCtx] = None,
) -> torch.Tensor:
    """One greedy decode step through the decoder: the scratch mode of the
    JAX package's `qwen2_forward`. Each lane's token attends [its cache
    slots < ``cache_len``] + [the scratch's first i - 1 tokens and itself]
    (kernel A with ``t_real`` i and query offset i - 1), and each layer's
    K/V of it go into the scratch at slot i - 1, in place, by
    `index_copy_` at that device position. The big cache is not written:
    the caller commits the scratch once, after the loop
    (`mmduet.decode_loop`).

    The cursors, the step and the positions are device tensors and stay
    there: the call reads nothing back to the host and copies nothing to
    the device, so a CUDA graph can capture it and replay it after the
    values in those tensors changed. Returns the final-normed hidden
    states (B, 1, H)."""
    B = embeds.shape[0]
    cos, sin = _rope_angles(positions[:, None], cfg.head_dim, cfg.rope_theta)
    attended = step.repeat(B)  # the scratch's tokens and this one
    q_offset = attended - 1
    slot = (step - 1).long().reshape(1)
    kc_arr, vc_arr = kv_arr(kv_cache.k), kv_arr(kv_cache.v)
    scales = _cache_scales(kv_cache)
    x = embeds
    for i in range(kc_arr.shape[0]):
        p = layer_view(params["layers"], i)
        lo = _layer_lora(lora, i)
        q, k, v = _qkv(x, p, lo, lora_scale, cfg, cos, sin)
        sk, sv = scratch.k[i], scratch.v[i]
        sk.index_copy_(2, slot, k.transpose(1, 2).to(sk.dtype))
        sv.index_copy_(2, slot, v.transpose(1, 2).to(sv.dtype))
        attn = _attend_cache(q, kc_arr, vc_arr, sk, sv, cache_len, attended, i, q_offset,
                             scales, shard_ctx)
        x = _out_mlp(x, attn, p, lo, lora_scale, cfg)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


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

    layers = params["layers"]
    whole = data_gatherer(layers)  # the identity unless leaves are cut over data

    def layer(x, p, lo):
        p = whole(p)
        q, k, v = _qkv(x, p, lo, lora_scale, cfg, cos, sin)
        if use_flash:
            attn = flash_full_attention(q, k, v, attn_mask)
        else:
            attn = attend(q, k, v, mask)
        return _out_mlp(x, attn, p, lo, lora_scale, cfg)

    x = embeds
    for i in range(layers["input_norm"].shape[0]):
        p = layer_view(layers, i)
        lo = _layer_lora(lora, i)
        x = checkpoint(layer, x, p, lo, use_reentrant=False) if remat else layer(x, p, lo)
    if mono_ok is not None:
        x = torch.where(mono_ok, x, torch.full_like(x, float("nan")))
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def commit_lanes(cache: KVCache, new_k: torch.Tensor, new_v: torch.Tensor,
                 starts: Lanes, lanes: Optional[Sequence[bool]] = None) -> KVCache:
    """Write (L, B, kh, t, hd) K/V rows into the (L, B, kh, S, hd) cache
    at per-lane slot ``starts[b]`` (host integers), in place (the JAX code
    chains per-lane `dynamic_update_slice` on a donated buffer). A write
    past the cache's end raises instead of clamping. ``lanes``: only the
    lanes marked True are written (None = all). The host's check, then
    `commit_rows` at those cursors on the device."""
    B, t = new_k.shape[1], new_k.shape[3]
    starts = lane_list(starts, B)
    check_rows_fit(cache, starts, t, lanes)
    dev = kv_arr(cache.k).device
    mask = None if lanes is None else ints_to([bool(x) for x in lanes], dev).bool()
    return commit_rows(cache, new_k, new_v, ints_to(starts, dev), mask)


def commit_rows(cache: KVCache, new_k: torch.Tensor, new_v: torch.Tensor,
                starts: torch.Tensor, lanes: Optional[torch.Tensor] = None) -> KVCache:
    """Write (L, B, kh, t, hd) K/V rows into the cache at each lane's
    device cursor ``starts`` ((B,) int32): lane b's rows go to slots
    ``starts[b] + arange(t)``, all lanes in one `index_put_` a tensor. The
    caller has checked that they fit. ``lanes`` ((B,) bool, None = all):
    a lane it leaves out keeps every byte, since its slots (clamped into
    the cache) are written with what they hold.

    int8 cache: the rows are quantized here (per-token symmetric,
    `quantize_kv_rows`) and both the int8 values and the f32 scales are
    written in place."""
    B, t = new_k.shape[1], new_k.shape[3]
    dev = new_k.device
    pos = starts.long()[:, None] + torch.arange(t, device=dev)[None, :]  # (B, t)
    if lanes is not None:
        pos = pos.clamp(max=cache.max_len - 1)
    lane = torch.arange(B, device=dev)[:, None]
    for leaf, new in ((cache.k, new_k), (cache.v, new_v)):
        if kv_quantized(cache):
            qw, qs = quantize_kv_rows(new)
            _put_rows(leaf["qw"], lane, pos, qw, lanes)
            _put_rows(leaf["qs"], lane, pos, qs, lanes)
        else:
            _put_rows(leaf, lane, pos, new, lanes)
    return cache


def _put_rows(dst: torch.Tensor, lane: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
              lanes: Optional[torch.Tensor]) -> None:
    """``dst[:, b, :, pos[b, j]] = rows[:, b, :, j]`` for every lane b of
    ``lanes`` (all if None) and chunk row j; dst is (L, B, kh, S, ...)."""
    vals = rows.movedim(1, 0).movedim(3, 1).to(dst.dtype)  # (B, t, L, kh, ...)
    if lanes is not None:
        keep = lanes.reshape(-1, *([1] * (vals.ndim - 1)))
        vals = torch.where(keep, vals, dst[:, lane, :, pos])
    dst[:, lane, :, pos] = vals


def embed_tokens(params: Params, input_ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Token embedding with the reference's clamp trick: the `<image>`
    placeholder id may be >= the embedding rows and gets clamped; its
    embedding is always overwritten by visual features.

    A rank's vocabulary slice of the table (tensor parallelism): the ids
    of its rows are looked up, the others give zeros, and the sum over the
    model axis (exact: one row is not zero) makes every rank's rows."""
    ids = input_ids.clamp(0, vocab_size - 1)
    emb = params["embed"]
    rows = (emb["qw4"] if "qw4" in emb else emb["qw"]) if isinstance(emb, dict) else emb
    n_rows = rows.shape[0]
    if not cut(n_rows, vocab_size, "embed"):
        return _lookup(emb, ids)
    local = ids - model_axis()[0] * n_rows
    hit = (local >= 0) & (local < n_rows)
    out = _lookup(emb, local.clamp(0, n_rows - 1))
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return reduce_model(out).to(out.dtype)


def _lookup(emb: Any, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``ids`` of a dense, int8 or int4 embedding table."""
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
    LM head (`quant.quantized_matmul`); on a rank of a vocabulary-cut head,
    its (B, T, V / n) slice."""
    return quantized_matmul(hidden, lm_head)
