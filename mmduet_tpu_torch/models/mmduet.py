"""The MMDuet model assembly in PyTorch: tower + projector + pooling +
decoder + score heads.

Port of `mmduet_tpu/models/mmduet.py`:

- ``visual_embed``  — SigLIP patches -> projector MLP -> bilinear 27->7
  spatial pooling -> 49 tokens per frame; or, with ``vision_arch="clip"``,
  the CLIP tower's CLS and adaptive-pooled patches -> projector;
- ``joint_embed``   — text embeddings with ``<image>`` positions replaced
  by frame tokens through a cumsum gather;
- ``step_forward`` / ``chunk_scores_forward`` / ``frames_block_forward`` —
  streaming forwards (one lane or a batch of lanes with a cursor each) against
  the preallocated KV cache, returning the score-head probabilities (and
  last-position LM logits); host cursors cross to the device at the entry,
  and the bodies (`step_body`, `chunk_scores_body`, `frames_block_body`)
  run on device operands only;
- ``decode_loop``   — prompt prefill + greedy decode into a scratch cache,
  then one commit into the big cache; the loop state stays on the device
  (`DecodeState`, `decode_step`);
- `EngineGraphs` — on a CUDA device, an engine's forwards and decode steps
  each replay a graph captured once a shape (`Captured`), in one memory
  pool;
- ``train_forward``  — the full-sequence training forward with the LM and
  video (score-head) losses.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MMDuetConfig

from ..parallel.collectives import (copy_to_model, cut, gather_vocab, max_model, model_axis,
                                    reduce_model, sum_data, whole_over_data)
from ..ops import attention as attention_ops
from ..ops import quant_matmul
from ..trace import span
from . import clip, qwen2, siglip
from .quant import matmul_f32, out_width
from .qwen2 import KVCache, Lanes, ints_to, kv_arr, lane_list

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Vision path
# ---------------------------------------------------------------------------


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of `jax.image.resize(method="bilinear",
    antialias=False)` along one axis: a triangle kernel at half-pixel
    sample positions, normalized per output sample, zero for samples
    outside the input (`jax._src.image.scale.compute_weight_mat`), in f32
    as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def spatial_pool(features: torch.Tensor, cfg: MMDuetConfig) -> torch.Tensor:
    """(N, P, C) patch grid -> pooled (N, frame_num_tokens, C).

    ``bilinear`` (the LLaVA-OV default) resizes the side x side grid to
    ceil(side / stride) exactly as `jax.image.resize(..., antialias=False)`;
    ``average`` / ``max`` floor the output side and drop trailing rows and
    columns, as torch's pooling with ceil_mode=False."""
    N, P, C = features.shape
    side = int(round(np.sqrt(P)))
    stride = cfg.video_pooling_stride
    out_side = -(-side // stride)  # ceil
    grid = features.reshape(N, side, side, C)
    mode = cfg.spatial_pool_mode
    if mode == "bilinear":
        # through pinned memory: a copy from pageable memory would wait for
        # the whole queue of the current stream (the vision stream's encode)
        w = torch.from_numpy(_bilinear_weights(side, out_side))
        w = (w.pin_memory().to(features.device, non_blocking=True) if features.is_cuda
             else w.to(features.device))
        pooled = torch.einsum(
            "nhwc,hi,wj->nijc", grid.float(), w, w
        ).to(features.dtype)
    elif mode in ("average", "max"):
        out_side = side // stride
        if out_side == 0:
            raise ValueError(
                f"video_pooling_stride {stride} exceeds patch grid side {side}"
            )
        grid = grid[:, : out_side * stride, : out_side * stride]
        blocks = grid.reshape(N, out_side, stride, out_side, stride, C)
        if mode == "average":
            pooled = blocks.mean(dim=(2, 4))
        else:
            pooled = blocks.amax(dim=(2, 4))
    else:
        raise ValueError(f"unknown spatial_pool_mode: {mode}")
    if out_side * out_side != cfg.frame_num_tokens:
        # a mismatch would desync the engine cursor (which advances by
        # frame_num_tokens) and the template's <image> placeholder count
        raise ValueError(
            f"spatial_pool ({mode}, stride {stride}) yields "
            f"{out_side * out_side} tokens/frame but cfg.frame_num_tokens="
            f"{cfg.frame_num_tokens}; set frame_num_tokens to match"
        )
    return pooled.reshape(N, out_side * out_side, C)


def project(params: Params, features: torch.Tensor) -> torch.Tensor:
    """2-layer MLP projector (LLaVA mm_projector) with exact GELU, in the
    features' dtype (f32 features over bf16 weights compute in f32, as the
    JAX einsum promotes them). Under tensor parallelism ``fc1`` is cut on
    its outputs and the square (H, H) ``fc2`` on its inputs: its partial
    product is summed over the model axis, then ``fc2_bias`` is added."""
    p = params["projector"]
    dt = features.dtype
    fc2 = p["fc2"]
    if cut(fc2.shape[0], fc2.shape[1], "projector fc2"):
        features = copy_to_model(features)
    x = siglip._linear(features, p["fc1"].to(dt), p["fc1_bias"])
    x = F.gelu(x.float(), approximate="none").to(dt)
    return siglip._linear(x, fc2.to(dt), p["fc2_bias"],
                          partial=cut(fc2.shape[0], fc2.shape[1], "projector fc2"))


def normalize_pixels(cfg: MMDuetConfig, frames_uint8: torch.Tensor) -> torch.Tensor:
    """Pixel normalization of the model's tower: SigLIP's mean/std 0.5, or
    the OpenAI CLIP constants."""
    if cfg.vision_arch == "clip":
        return clip.normalize_pixels(frames_uint8)
    return siglip.normalize_pixels(frames_uint8)


def visual_embed(params: Params, cfg: MMDuetConfig, pixels: torch.Tensor,
                 vision_use_flash: Optional[bool] = None) -> torch.Tensor:
    """Normalized pixels (N, H, W, 3) -> frame token embeddings
    (N, frame_num_tokens, hidden).

    - ``siglip`` arch: SigLIP -> projector -> bilinear spatial pooling;
    - ``clip`` arch (the reference's standalone path): the tower's CLS and
      adaptive-pooled patches (`clip.standalone_encode`), then the
      projector; the pooling runs before it, so no `spatial_pool`.

    ``vision_use_flash``: the tower's attention route (`siglip._attend`;
    None = kernel D on CUDA tensors)."""
    if cfg.vision_arch == "clip":
        feats = clip.standalone_encode(
            params["vision"], cfg.vision, pixels, cfg.frame_token_cls,
            cfg.frame_token_pooled, use_flash=vision_use_flash)
        if feats.shape[1] != cfg.frame_num_tokens:
            raise ValueError(
                f"clip tower yields {feats.shape[1]} tokens/frame but "
                f"cfg.frame_num_tokens={cfg.frame_num_tokens}"
            )
        return project(params, feats)
    feats = siglip.siglip_encode(params["vision"], cfg.vision, pixels,
                                 use_flash=vision_use_flash)
    return spatial_pool(project(params, feats), cfg)


# ---------------------------------------------------------------------------
# Joint embedding (text + frames)
# ---------------------------------------------------------------------------


def joint_embed(
    params: Params,
    cfg: MMDuetConfig,
    input_ids: torch.Tensor,  # (B, T)
    frame_embeds: Optional[torch.Tensor],  # (N_frames, frame_num_tokens, H)
) -> torch.Tensor:
    """Text embeddings with ``<image>`` positions replaced by frame tokens:
    the k-th placeholder (flattened batch-major order) takes the k-th
    frame token via a cumsum gather."""
    text = qwen2.embed_tokens(params["decoder"], input_ids, cfg.text.vocab_size)
    if frame_embeds is None:
        return text
    B, T, H = text.shape
    flat_frames = frame_embeds.reshape(-1, H)
    v_mask = (input_ids == cfg.v_placeholder_id).reshape(-1)
    idx = (torch.cumsum(v_mask.long(), dim=0) - 1).clamp(0, flat_frames.shape[0] - 1)
    out = torch.where(
        v_mask[:, None], flat_frames[idx].to(text.dtype), text.reshape(-1, H)
    )
    return out.reshape(B, T, H)


# ---------------------------------------------------------------------------
# Heads and streaming forwards
# ---------------------------------------------------------------------------


def _head(w: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    return matmul_f32(hidden, w)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              vocab_size: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over labels != -100. Returns (loss, count); the
    loss is 0 when no label counts.

    On a rank of a process mesh the mean is the global batch's: the count
    is summed over the data axis (`collectives.sum_data`), so each rank's
    loss is its share, the sum of its nll over the global count (the sum
    of the shares over ``data`` is the loss of the whole batch), and
    ``count`` is the global count. Logits that are a rank's slice of
    ``vocab_size`` (a vocabulary-cut LM head) take the vocabulary-parallel
    cross-entropy (`_vocab_parallel_nll`)."""
    mask = labels != -100
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    if vocab_size is not None and cut(logits.shape[-1], vocab_size, "LM logits"):
        nll = _vocab_parallel_nll(logits, safe)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count = sum_data(mask.sum())
    loss = (nll * mask).sum() / count.clamp(min=1)
    return torch.where(count > 0, loss, torch.zeros_like(loss)), count


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position ``logsumexp(row) - row[target]`` of whole-vocabulary rows
    from this rank's (..., V / n) slice of them, as Megatron's
    vocabulary-parallel cross-entropy: the row maximum, the sum of the
    exponentials and the target's logit are each a sum over the model axis
    (the maximum is a constant of the gradient; the two sums are
    differentiable, `reduce_model`), so no rank holds a whole row."""
    x = logits.float()
    n = x.shape[-1]
    shifted = x - max_model(x.detach().amax(dim=-1))[..., None]
    sum_exp = reduce_model(torch.exp(shifted).sum(dim=-1))
    local = targets - model_axis()[0] * n
    hit = (local >= 0) & (local < n)
    picked = torch.gather(shifted, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = reduce_model(torch.where(hit, picked, torch.zeros_like(picked)))
    return torch.log(sum_exp) - target


class TrainOutput(NamedTuple):
    loss: torch.Tensor
    lm_loss: torch.Tensor
    video_loss: torch.Tensor
    lm_logits: torch.Tensor
    informative_logits: torch.Tensor
    relevance_logits: torch.Tensor


def train_forward(
    params: Params,
    cfg: MMDuetConfig,
    input_ids: torch.Tensor,  # (B, T)
    attn_mask: torch.Tensor,  # (B, T) bool
    frame_embeds: Optional[torch.Tensor],  # (N, frame_tokens, H) pre-computed
    labels: torch.Tensor,  # (B, T) pre-shifted LM labels
    informative_labels: torch.Tensor,  # (B, T)
    relevance_labels: torch.Tensor,  # (B, T)
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    remat: bool = True,
    use_flash: Optional[bool] = None,  # None = auto (kernel C on CUDA)
) -> TrainOutput:
    """Full-sequence training forward. Labels are pre-shifted by the
    collator; positions are ``cumsum(attn_mask) - 1``. The loss is
    ``lm_loss_weight * lm_loss + video_loss_weight * video_loss``, the
    video loss one cross-entropy over both score heads' labels.

    On a rank of a process mesh: each loss is the rank's share of the
    global batch's (`masked_ce`); a vocabulary-cut LM head gives the rank's
    slice of ``lm_logits`` (its input through `copy_to_model`); the frozen
    embedding and LM head, where cut over the data axis, are gathered right
    before they are used."""
    dec = dict(params["decoder"], embed=whole_over_data(params["decoder"]["embed"]))
    embeds = joint_embed(dict(params, decoder=dec), cfg, input_ids, frame_embeds)
    del dec
    positions = torch.cumsum(attn_mask.int(), dim=1) - 1
    hidden, _ = qwen2.qwen2_forward(
        params["decoder"], cfg.text, embeds, positions,
        attn_mask=attn_mask, lora=lora, lora_scale=lora_scale, remat=remat,
        use_flash=use_flash,
    )
    head_hidden = hidden.detach() if cfg.video_head_stop_grad else hidden
    lm_head = whole_over_data(params["lm_head"])
    if cut(out_width(lm_head), cfg.text.vocab_size, "lm_head"):
        hidden = copy_to_model(hidden)
    lm = qwen2.lm_logits(lm_head, hidden)
    del lm_head
    inf = _head(params["informative_head"], head_hidden)
    rel = _head(params["relevance_head"], head_hidden)

    lm_loss, _ = masked_ce(lm, labels, cfg.text.vocab_size)
    video_loss, _ = masked_ce(
        torch.cat([inf, rel], dim=0),
        torch.cat([informative_labels, relevance_labels], dim=0),
    )
    loss = cfg.lm_loss_weight * lm_loss + cfg.video_loss_weight * video_loss
    return TrainOutput(loss, lm_loss, video_loss, lm, inf, rel)


class StepOutput(NamedTuple):
    last_logits: Optional[torch.Tensor]  # (B, V) f32, None in score-only steps
    informative_prob: torch.Tensor  # (B,) P(informative)
    relevance_prob: torch.Tensor  # (B,)
    kv_cache: KVCache


def _score_output(params: Params, cfg: MMDuetConfig, last: torch.Tensor,
                  compute_lm_logits: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                                    torch.Tensor]:
    """The score heads (whole on every rank) and, if asked, the whole
    vocabulary's logits (`gather_vocab` from a rank's slice)."""
    inf = torch.softmax(_head(params["informative_head"], last)[:, 0], dim=-1)[:, 1]
    rel = torch.softmax(_head(params["relevance_head"], last)[:, 0], dim=-1)[:, 1]
    logits = None
    if compute_lm_logits:
        logits = gather_vocab(qwen2.lm_logits(params["lm_head"], last)[:, 0],
                              cfg.text.vocab_size)
    return logits, inf, rel


def _stream_hidden(params: Params, cfg: MMDuetConfig, embeds: torch.Tensor, kv_cache: KVCache,
                   cache_len: torch.Tensor, t_real: torch.Tensor,
                   commit: Optional[torch.Tensor], lora: Optional[Params], lora_scale: float,
                   shard_ctx) -> torch.Tensor:
    """The decoder's streaming mode on device cursors (`qwen2.qwen2_forward`,
    which passes them through): positions ``cache_len[b] + arange(T)``, the
    chunk committed in place."""
    T = embeds.shape[1]
    positions = cache_len[:, None] + torch.arange(T, device=embeds.device)[None, :]
    hidden, _ = qwen2.qwen2_forward(params["decoder"], cfg.text, embeds, positions,
                                    kv_cache=kv_cache, cache_len=cache_len, lora=lora,
                                    lora_scale=lora_scale, t_real=t_real, shard_ctx=shard_ctx,
                                    commit=commit)
    return hidden


def step_body(params: Params, cfg: MMDuetConfig, kv_cache: KVCache, x: Dict[str, torch.Tensor],
              lora: Optional[Params] = None, lora_scale: float = 0.0,
              compute_lm_logits: bool = True, shard_ctx=None):
    """`step_forward`'s body on its device operands ``x`` (``embeds``,
    ``cache_len``, ``t_real``, optionally ``commit``): each lane's last real
    row taken by a gather at ``t_real - 1``. Returns (logits or None,
    informative, relevance)."""
    embeds = x["embeds"]
    hidden = _stream_hidden(params, cfg, embeds, kv_cache, x["cache_len"], x["t_real"],
                            x.get("commit"), lora, lora_scale, shard_ctx)
    row = (x["t_real"].long() - 1)[:, None, None].expand(-1, 1, hidden.shape[-1])
    return _score_output(params, cfg, torch.gather(hidden, 1, row), compute_lm_logits)


def chunk_scores_body(params: Params, cfg: MMDuetConfig, kv_cache: KVCache,
                      x: Dict[str, torch.Tensor], lora: Optional[Params] = None,
                      lora_scale: float = 0.0, shard_ctx=None) -> torch.Tensor:
    """`chunk_scores_forward`'s body on its device operands ``x``
    (``embeds``, ``cache_len``, ``t_real``, ``score_pos`` (B, K), optionally
    ``commit``): (B, 2, K) probabilities."""
    hidden = _stream_hidden(params, cfg, x["embeds"], kv_cache, x["cache_len"], x["t_real"],
                            x.get("commit"), lora, lora_scale, shard_ctx)
    sp = x["score_pos"].long()
    sel = torch.gather(hidden, 1, sp[..., None].expand(-1, -1, hidden.shape[-1]))  # (B, K, H)
    inf = torch.softmax(_head(params["informative_head"], sel), dim=-1)[..., 1]
    rel = torch.softmax(_head(params["relevance_head"], sel), dim=-1)[..., 1]
    return torch.stack([inf, rel], dim=1)


def frames_block_body(params: Params, cfg: MMDuetConfig, kv_cache: KVCache,
                      x: Dict[str, torch.Tensor], lora: Optional[Params] = None,
                      lora_scale: float = 0.0, shard_ctx=None):
    """`frames_block_forward`'s body on its device operands ``x``
    (``frames`` (K, ft, H), ``cache_len`` (1,)): (informative (K,),
    relevance (K,))."""
    K, ft, H = x["frames"].shape
    embeds = x["frames"].reshape(1, K * ft, H)
    t_real = torch.full((1,), K * ft, dtype=torch.int32, device=embeds.device)
    hidden = _stream_hidden(params, cfg, embeds, kv_cache, x["cache_len"], t_real, None, lora,
                            lora_scale, shard_ctx)
    last = hidden.reshape(K, ft, H)[None, :, ft - 1, :]  # (1, K, H)
    inf = torch.softmax(_head(params["informative_head"], last)[0], dim=-1)[:, 1]
    rel = torch.softmax(_head(params["relevance_head"], last)[0], dim=-1)[:, 1]
    return inf, rel


def _run_entry(graphs: Optional["EngineGraphs"], name: str, body, params: Params,
               cfg: MMDuetConfig, kv_cache: KVCache, x: Dict[str, torch.Tensor],
               lora: Optional[Params], lora_scale: float, shard_ctx, *baked):
    """``body(params, cfg, kv_cache, x, lora, lora_scale, *baked, shard_ctx)``
    eagerly, or through ``graphs``' captured graph of this entry's shapes,
    in the span ``model.forward``."""
    def run(inputs):
        return body(params, cfg, kv_cache, inputs, lora, lora_scale, *baked, shard_ctx=shard_ctx)

    with span("model.forward", entry=name):
        if graphs is None:
            return run(x)
        return graphs.run(graphs.key(name, params, cfg, kv_cache, lora, lora_scale, shard_ctx,
                                     x, *baked), x, run)


def step_forward(
    params: Params,
    cfg: MMDuetConfig,
    embeds: torch.Tensor,  # (B, T, H) chunk embeddings (text and/or frame)
    kv_cache: KVCache,
    cache_len: Lanes,  # per-lane cursors (or one for all), host or (B,) int32 device
    t_real: Lanes,  # real (unpadded) tokens in each lane's chunk, the same
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    compute_lm_logits: bool = True,
    shard_ctx=None,  # ops.attention.ShardCtx: attention per mesh shard
    commit=None,  # lanes to commit: host bools or (B,) bool device (None = all)
    graphs: Optional["EngineGraphs"] = None,  # the graph route (CUDA tensors)
) -> StepOutput:
    """One streaming step: write the chunk into the cache (in place) and
    read the scores at each lane's last real position. Host operands
    cross to the device here, once (`qwen2.stream_cursors`, which checks
    host cursors against the cache); the body (`step_body`) reads no host
    value, and with ``graphs`` it replays a captured graph."""
    B, T, _ = embeds.shape
    cl, tr, cm = qwen2.stream_cursors(kv_cache, B, T, embeds.device, cache_len, t_real, commit)
    x = dict(embeds=embeds, cache_len=cl, t_real=tr, **({} if cm is None else {"commit": cm}))
    logits, inf, rel = _run_entry(graphs, "step", step_body, params, cfg, kv_cache, x, lora,
                                  lora_scale, shard_ctx, compute_lm_logits)
    return StepOutput(logits, inf, rel, kv_cache)


def chunk_scores_forward(
    params: Params,
    cfg: MMDuetConfig,
    embeds: torch.Tensor,  # (B, T, H) per-lane (padded) chunks
    kv_cache: KVCache,
    cache_len: Lanes,  # per-lane cursors (or one for all), host or (B,) int32 device
    t_real: Lanes,  # per-lane real lengths (or one for all), the same
    score_pos,  # (B, K) or (K,) chunk-local positions to score, host or device
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    shard_ctx=None,
    commit=None,  # lanes to commit: host bools or (B,) bool device (None = all)
    graphs: Optional["EngineGraphs"] = None,  # the graph route (CUDA tensors)
) -> Tuple[torch.Tensor, KVCache]:
    """One batched streaming chunk -> score probabilities at several
    per-lane chunk positions. Generalizes `step_forward` (scores at the
    last real token) and `frames_block_forward` (scores at fixed frame
    boundaries): the batched engine feeds ``[joiner or query ids + n <= K
    frames]`` chunks whose frame boundaries differ per lane and reads each
    frame's score at its own position. Entries of ``score_pos`` beyond a
    lane's real frame count may point anywhere inside the chunk; the host
    never reads their probabilities. The lanes run in one forward with a
    cursor each (one kernel launch per layer, the weights read once).

    Returns ((B, 2, K) stacked informative / relevance probabilities,
    cache)."""
    B, T, _ = embeds.shape
    dev = embeds.device
    cl, tr, cm = qwen2.stream_cursors(kv_cache, B, T, dev, cache_len, t_real, commit)
    if not torch.is_tensor(score_pos):
        sp = np.asarray(score_pos, dtype=np.int64)
        sp = np.broadcast_to(sp[None] if sp.ndim == 1 else sp, (B, sp.shape[-1]))
        score_pos = ints_to(sp.reshape(-1).tolist(), dev).reshape(B, -1)
    elif score_pos.ndim == 1:
        score_pos = score_pos[None].expand(B, -1)
    x = dict(embeds=embeds, cache_len=cl, t_real=tr, score_pos=score_pos,
             **({} if cm is None else {"commit": cm}))
    probs = _run_entry(graphs, "chunk_scores", chunk_scores_body, params, cfg, kv_cache, x,
                       lora, lora_scale, shard_ctx)
    return probs, kv_cache


def frames_block_forward(
    params: Params,
    cfg: MMDuetConfig,
    frames: torch.Tensor,  # (K, frame_num_tokens, H) — K whole frames
    kv_cache: KVCache,
    cache_len,  # the cursor: a host int or a (1,) int32 device tensor
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    shard_ctx=None,
    graphs: Optional["EngineGraphs"] = None,  # the graph route (CUDA tensors)
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Score K consecutive frames in ONE chunk forward: attention is
    causal, so the heads read at each frame's last position (ft-1,
    2*ft-1, ...) equal K sequential `step_forward` calls, with the
    weights read once per block.

    Returns (informative_probs (K,), relevance_probs (K,), cache)."""
    K, ft, _ = frames.shape
    cl, _, _ = qwen2.stream_cursors(kv_cache, 1, K * ft, frames.device, cache_len, None)
    inf, rel = _run_entry(graphs, "frames_block", frames_block_body, params, cfg, kv_cache,
                          dict(frames=frames, cache_len=cl), lora, lora_scale, shard_ctx)
    return inf, rel, kv_cache


class DecodeState(NamedTuple):
    """`decode_loop`'s loop state, on the device: B lanes, up to ``max_new``
    tokens, a W-wide scratch. `start_decode` sets it after the prompt's
    prefill and `decode_step` updates it in place, as the JAX package's
    `lax.while_loop` carries it."""

    buf: torch.Tensor  # (B, max_new) int32 sampled tokens (0 where none)
    n: torch.Tensor  # (B,) int32 tokens a lane produced
    cursor: torch.Tensor  # (B,) int32 a lane's cursor after its tokens fed so far
    last_tok: torch.Tensor  # (B,) int32 the token a lane feeds next
    done: torch.Tensor  # (B,) bool: ended (EOS) or frozen
    active: torch.Tensor  # (B,) bool; False = frozen lane
    base: torch.Tensor  # (B,) int32 a lane's cursor after its prompt
    i: torch.Tensor  # () int32 the step
    eos: torch.Tensor  # () int32 the end-of-sequence id (-1: none ends a lane)
    pen_mask: torch.Tensor  # (B, V) bool repetition-penalty token set
    scratch: KVCache  # (L, B, kh, W, hd) the generated tokens' K/V
    top_v: torch.Tensor  # (max_new, B, 2) f32: each step's two largest logits
    top_i: torch.Tensor  # (max_new, B, 2) int64: their tokens


def decode_state(B: int, max_new: int, vocab_size: int, scratch_shape: Tuple[int, int, int],
                 dtype: torch.dtype, device) -> DecodeState:
    """A zero `DecodeState`; ``scratch_shape`` is (L, kh, hd) and the
    scratch ``W = max(max_new - 1, 1)`` wide, in ``dtype``."""
    L, kh, hd = scratch_shape
    W = max(max_new - 1, 1)

    def zeros(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=device)

    return DecodeState(
        buf=zeros(B, max_new), n=zeros(B), cursor=zeros(B), last_tok=zeros(B),
        done=zeros(B, dt=torch.bool), active=zeros(B, dt=torch.bool), base=zeros(B),
        i=zeros(), eos=zeros(), pen_mask=zeros(B, vocab_size, dt=torch.bool),
        scratch=KVCache(zeros(L, B, kh, W, hd, dt=dtype), zeros(L, B, kh, W, hd, dt=dtype)),
        top_v=zeros(max_new, B, 2, dt=torch.float32), top_i=zeros(max_new, B, 2, dt=torch.int64),
    )


def _penalized(logits: torch.Tensor, mask: torch.Tensor, rep: Optional[float]) -> torch.Tensor:
    if rep is None:
        return logits
    pen = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(mask, pen, logits)


def _mark(mask: torch.Tensor, tok: torch.Tensor, where: torch.Tensor) -> None:
    """``mask[b, tok[b]] = True`` for the lanes ``where`` holds, in place."""
    idx = tok.long()[:, None]
    mask.scatter_(1, idx, mask.gather(1, idx) | where[:, None])


def _keep_top2(s: DecodeState, logits: torch.Tensor, row: torch.Tensor) -> None:
    """The two largest logits of each lane and their tokens into row ``row``
    (a one-element int64 tensor) of ``s.top_v`` / ``s.top_i``."""
    top = torch.topk(logits, 2, dim=-1)
    s.top_v.index_copy_(0, row, top.values[None].float())
    s.top_i.index_copy_(0, row, top.indices[None])


def start_decode(s: DecodeState, logits: torch.Tensor, rep: Optional[float]) -> None:
    """The first token of every lane from the prompt's last logits (B, V),
    and the state the loop starts from, in place. ``s.active``,
    ``s.base``, ``s.eos`` and ``s.pen_mask`` hold the response's inputs."""
    tok0 = torch.argmax(_penalized(logits, s.pen_mask, rep), dim=-1).int()
    s.buf.zero_()
    s.buf[:, 0] = torch.where(s.active, tok0, 0)
    if rep is not None:  # the mask is read only by _penalized
        _mark(s.pen_mask, tok0, s.active & (tok0 != s.eos))
    s.done.copy_((tok0 == s.eos) | ~s.active)
    s.n.copy_(s.active.int())
    s.cursor.copy_(s.base)
    s.last_tok.copy_(tok0)
    s.i.fill_(1)
    _keep_top2(s, logits, torch.zeros(1, dtype=torch.int64, device=logits.device))
    s.scratch.k.zero_()
    s.scratch.v.zero_()


def decode_step(s: DecodeState, params: Params, cfg: MMDuetConfig, kv_cache: KVCache, *,
                rep: Optional[float] = None, lora: Optional[Params] = None,
                lora_scale: float = 0.0, shard_ctx=None) -> None:
    """One greedy step of every lane, in place: the body of the JAX
    package's `lax.while_loop`. Each lane feeds its last token at its
    cursor (`qwen2.scratch_decode_forward`, the cache read-only), takes the
    argmax of its penalized logits and, unless it is done, writes it to
    ``buf[:, i]``, marks it in the penalty set (not an EOS), sets ``n`` to
    i + 1 and moves its cursor and last token on; a token equal to
    ``s.eos`` ends it; ``i`` grows by one. Every value stays on the device:
    the step reads nothing back to the host and copies nothing to the
    device, so `EngineGraphs.decode_step` can replay it from a CUDA graph."""
    V = cfg.text.vocab_size
    dec = params["decoder"]
    emb = qwen2.embed_tokens(dec, s.last_tok[:, None], V).to(s.scratch.k.dtype)
    hidden = qwen2.scratch_decode_forward(
        dec, cfg.text, emb, s.cursor, kv_cache, s.base, s.i, s.scratch,
        lora=lora, lora_scale=lora_scale, shard_ctx=shard_ctx)
    logits = gather_vocab(qwen2.lm_logits(params["lm_head"], hidden)[:, 0], V)
    tok = torch.argmax(_penalized(logits, s.pen_mask, rep), dim=-1).int()
    row = s.i.long().reshape(1)
    _keep_top2(s, logits, row)
    live = ~s.done
    # a done lane keeps buf[:, i] at the zero it starts from
    s.buf.index_copy_(1, row, torch.where(live, tok, 0)[:, None])
    if rep is not None:
        _mark(s.pen_mask, tok, live & (tok != s.eos))
    s.n.copy_(torch.where(live, s.i + 1, s.n))
    s.cursor.add_(live.int())
    s.last_tok.copy_(torch.where(live, tok, s.last_tok))
    s.done.logical_or_(tok == s.eos)
    s.i.add_(1)


# The launch counts a captured forward adds to: kernels A (A-int8, A') and B.
_STEP_COUNTS = ((attention_ops, "LAUNCHES"), (attention_ops, "INT8_LAUNCHES"),
                (attention_ops, "SHARDED_LAUNCHES"), (quant_matmul, "B_LAUNCHES"))


def _tree_clone(out):
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, tuple):
        return type(out)(*(_tree_clone(x) for x in out)) if hasattr(out, "_fields") \
            else tuple(_tree_clone(x) for x in out)
    return out


class Captured:
    """One entry's body on static device tensors, captured in a CUDA graph:
    the port's counterpart of one program the JAX package compiles for a
    shape.

    ``run(inputs)`` is the body on a dict of input tensors (None for a body
    that updates its own ``state`` in place, as `decode_step` does). The
    first call runs it eagerly on the caller's inputs (a real call, which
    also allocates what the kernels keep between calls: kernel A's and B's
    split scratch, cuBLAS's workspace) and returns its outputs; it then
    captures it into the engine's memory pool on static inputs allocated
    there. Every later call copies the caller's inputs into the static
    ones, replays the graph on the current stream and returns a copy of
    the static outputs made on that stream after the replay, so a caller
    that enqueues the next call before it reads this one's (one-deep
    pipelining) reads its own. The graph holds the addresses of the static
    tensors, the cache, the parameters and the kernels' split scratch; it
    keeps the scratch tensors it captured alive, so a later launch that
    grows the scratch (and drops the old tensors from `ops.attention` /
    `ops.quant_matmul`) leaves them valid. The capture launches nothing,
    so the launch counts it added are taken back, and each replay adds
    them, and to ``replays``. A capture that fails raises."""

    def __init__(self, run: Callable, pool, state=None):
        self.state = state
        self.replays = 0
        self._run, self._pool = run, pool
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._out = None
        self._launches: Tuple[int, ...] = ()
        self._held: tuple = ()

    def __call__(self, inputs: Optional[Dict[str, torch.Tensor]] = None):
        if self._graph is None:
            out = self._run(inputs)
            self._capture(inputs)
            return out
        for name, x in (inputs or {}).items():
            self._static[name].copy_(x)
        self._graph.replay()
        self.replays += 1
        for (module, name), n in zip(_STEP_COUNTS, self._launches):
            setattr(module, name, getattr(module, name) + n)
        return _tree_clone(self._out)

    def _capture(self, inputs) -> None:
        before = [getattr(module, name) for module, name in _STEP_COUNTS]
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's allocations (a demo's server) do
        # not break this capture
        with span("graphs.capture"), torch.cuda.graph(
                graph, pool=self._pool, capture_error_mode="thread_local"):
            # allocated in the pool; filled before each replay
            self._static = (None if inputs is None
                            else {name: torch.empty_like(x) for name, x in inputs.items()})
            self._out = self._run(self._static)
        self._launches = tuple(getattr(module, name) - b
                               for (module, name), b in zip(_STEP_COUNTS, before))
        for (module, name), b in zip(_STEP_COUNTS, before):
            setattr(module, name, b)
        dev = torch.cuda.current_device()
        self._held = tuple(s.get(torch.device("cuda", dev)) for s in
                           (attention_ops._split_scratch, quant_matmul._split_scratch))
        self._graph = graph


class EngineGraphs:
    """An engine's captured forwards (`Captured`), all in one CUDA memory
    pool, one per entry and what its graph bakes in: the entry, the shapes
    and dtypes of its inputs (lanes, chunk width or frames), its own
    options (``compute_lm_logits``; the decode step's ``max_new`` and
    ``rep``), the parameters, config, LoRA and its scale, the mesh context
    and the cache's tensors. There is one graph a shape, as the JAX package
    compiles one program a shape. An entry keeps the objects of its key
    alive, so their identities and addresses stay its own. An engine keeps
    one cache for its life (its ``reset`` zeros it in place). The graphs
    replay one at a time, on one stream at a time (`ops.attention`'s
    one-stream rule), so they share the pool's memory."""

    def __init__(self):
        self._entries: Dict[tuple, Captured] = {}
        self._keep: Dict[tuple, tuple] = {}
        self.pool = None  # made at the first capture

    def __len__(self) -> int:
        return len(self._entries)

    def kinds(self) -> Dict[str, int]:
        """Captured graphs by entry name."""
        out: Dict[str, int] = {}
        for key in self._entries:
            out[key[0]] = out.get(key[0], 0) + 1
        return out

    def counts(self) -> Dict[str, int]:
        """``graph_replays``, over every graph, and ``graph_captures``,
        since the graphs were made."""
        got = self._entries.values()
        return {"graph_replays": sum(c.replays for c in got),
                "graph_captures": sum(c._graph is not None for c in got)}

    def key(self, name: str, params: Params, cfg: MMDuetConfig, kv_cache: KVCache,
            lora: Optional[Params], lora_scale: float, shard_ctx,
            inputs: Optional[Dict[str, torch.Tensor]] = None, *extra) -> tuple:
        """The key of an entry's graph; raises ValueError off a CUDA device."""
        leaves = [t for leaf in kv_cache for t in
                  (leaf.values() if isinstance(leaf, dict) else (leaf,))]
        if leaves[0].device.type != "cuda":
            raise ValueError(f"{name}: the graph route runs on a CUDA device, not "
                             f"{leaves[0].device}")
        shapes = tuple((n, tuple(x.shape), x.dtype) for n, x in (inputs or {}).items())
        key = (name, shapes, extra, lora_scale, id(params), id(cfg), id(lora), shard_ctx,
               tuple(t.data_ptr() for t in leaves))
        self._keep.setdefault(key, (params, cfg, lora, kv_cache))
        return key

    def entry(self, key: tuple, run: Callable, state=None) -> Captured:
        got = self._entries.get(key)
        if got is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            got = self._entries[key] = Captured(run, self.pool, state)
        return got

    def run(self, key: tuple, inputs: Dict[str, torch.Tensor], run: Callable):
        """``run(inputs)`` through the graph of ``key`` (`Captured`)."""
        return self.entry(key, run)(inputs)

    def decode_step(self, params: Params, cfg: MMDuetConfig, kv_cache: KVCache, B: int,
                    max_new: int, dtype: torch.dtype, rep: Optional[float],
                    lora: Optional[Params], lora_scale: float, shard_ctx) -> Captured:
        """The captured `decode_step` of (lanes, ``max_new``, ``rep``, dtype)
        on its static `DecodeState` (the entry's ``state``)."""
        key = self.key("decode_step", params, cfg, kv_cache, lora, lora_scale, shard_ctx, None,
                       B, max_new, rep, dtype)
        got = self._entries.get(key)
        if got is None:
            L, _, kh, _, hd = kv_arr(kv_cache.k).shape
            state = decode_state(B, max_new, cfg.text.vocab_size, (L, kh, hd), dtype,
                                 kv_arr(kv_cache.k).device)

            def run(_):
                decode_step(state, params, cfg, kv_cache, rep=rep, lora=lora,
                            lora_scale=lora_scale, shard_ctx=shard_ctx)

            got = self.entry(key, run, state)
        return got


def decode_outputs(s: DecodeState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(packed (B, max_new + 2) int32 [tokens | n | final cursor],
    pen_mask)`` of a finished loop, new tensors made on the device. Rows
    ``< s.i`` of ``s.top_v`` / ``s.top_i`` are the prefill's and the
    steps' top-2 logits."""
    return torch.cat([s.buf, s.n[:, None], s.cursor[:, None]], dim=1), s.pen_mask.clone()


def decode_loop(
    params: Params,
    cfg: MMDuetConfig,
    embeds: torch.Tensor,  # (B, t, H) generation-prompt chunk (padded)
    kv_cache: KVCache,
    cache_len: Lanes,  # per-lane cursors
    t_real: Lanes,  # real prompt tokens per lane
    pen_mask: torch.Tensor,  # (B, V) bool repetition-penalty token set
    active: Optional[Sequence[bool]] = None,  # False = frozen lane
    *,
    max_new: int,
    eos_id: int,
    rep: Optional[float] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    shard_ctx=None,
    graphs: Optional[EngineGraphs] = None,  # the graph route (CUDA tensors)
    counts: Optional[Dict[str, int]] = None,
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Prompt prefill + greedy decode (with the repetition penalty as a
    token bitmask), with the loop state on the device as the JAX package's
    `lax.while_loop` keeps it (`DecodeState`), and the same condition:
    ``any(~done) and i < max_new``. The host counts ``i`` itself and reads
    one flag a step (``done.all()``); each step is `decode_step`, which
    makes no host read and no copy to the device.

    Two routes, chosen by the caller: without ``graphs`` every step runs
    eagerly on a state made for the call (CPU tensors, and the ranks of a
    process mesh, whose collectives a graph cannot hold); with ``graphs``
    (CUDA tensors only) the prompt's prefill replays its captured
    `step_forward`, the state is the static one of the graph that
    ``graphs`` keeps for these operands, the call copies its inputs into
    it, and each step replays the captured `decode_step` (`Captured`; the
    first call of a new graph runs eagerly and captures it). Both give the
    same bits.

    The big cache is written twice, in place: by the prompt prefill and
    by one commit after the loop. Inside the loop it is read-only; each
    step attends [cache] + [scratch + current token] and writes its K/V
    into a (L, B, kh, W, hd) scratch, ``W = max(max_new - 1, 1)`` wide
    (the last sampled token is never fed back). Frozen (``active=False``)
    lanes run the forwards but commit nothing: neither their prompt rows
    nor their scratch rows are written (the JAX package writes both past
    the frozen cursor, where nothing reads them). The scratch is in the
    activation dtype also under an int8 cache: the one commit after the
    loop quantizes its rows. Capacity: for every active
    lane ``cache_len[b] + t + W <= S`` (`commit_lanes` raises otherwise);
    the batched engine also holds a frozen lane to the JAX package's
    ``cache_len[b] + max(t, W) <= S``, so both raise at the same point.

    ``counts``: a dict to which the call adds the steps it ran
    (``decode_steps``) and the flag reads it made (``flag_reads``), which
    the host knows without reading the device. The spans ``decode.prefill``,
    ``decode.start``, ``decode.flag_read`` and ``decode.step`` (each read
    and step) and ``decode.commit`` time its parts.

    Returns ``(packed (B, max_new+2) int32 [tokens | n | final cursor],
    cache, updated pen_mask)``, new tensors (not the graph's state)."""
    B, _, _ = embeds.shape
    dev = embeds.device
    act = [True] * B if active is None else [bool(a) for a in active]
    cl = lane_list(cache_len, B)
    tr = lane_list(t_real, B)

    # the prompt's prefill, on the same route as the steps
    with span("decode.prefill"):
        out = step_forward(params, cfg, embeds, kv_cache, cl, tr, lora=lora,
                           lora_scale=lora_scale, compute_lm_logits=True,
                           shard_ctx=shard_ctx, commit=None if all(act) else act, graphs=graphs)
    cache = out.kv_cache  # prompt committed; read-only until the commit
    base = [c + t if a else c for c, t, a in zip(cl, tr, act)]

    if graphs is None:
        L, _, kh, _, hd = kv_arr(cache.k).shape
        state = decode_state(B, max_new, cfg.text.vocab_size, (L, kh, hd), embeds.dtype, dev)

        def step():
            decode_step(state, params, cfg, cache, rep=rep, lora=lora,
                        lora_scale=lora_scale, shard_ctx=shard_ctx)
    else:
        step = graphs.decode_step(params, cfg, cache, B, max_new, embeds.dtype, rep, lora,
                                  lora_scale, shard_ctx)
        state = step.state
    with span("decode.start"):
        # the response's inputs, the only host-to-device copies of the call
        state.base.copy_(ints_to(base, dev))
        state.active.copy_(ints_to(act, dev))
        state.eos.fill_(eos_id)
        state.pen_mask.copy_(pen_mask)
        start_decode(state, out.last_logits, rep)

    i, reads = 1, 0
    while i < max_new:
        reads += 1
        with span("decode.flag_read"):
            done = bool(state.done.all())
        if done:
            break
        with span("decode.step", step=i):
            step()
        i += 1
    if counts is not None:
        counts["decode_steps"] = counts.get("decode_steps", 0) + i - 1
        counts["flag_reads"] = counts.get("flag_reads", 0) + reads
    with span("decode.commit"):
        # ONE commit of the scratch at each active lane's post-prompt cursor;
        # rows past a lane's fed count land in its garbage zone
        cache = qwen2.commit_lanes(cache, state.scratch.k, state.scratch.v, base, act)
        packed, pen_mask = decode_outputs(state)
    return packed, cache, pen_mask
