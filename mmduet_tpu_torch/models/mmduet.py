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
  last-position LM logits);
- ``decode_loop``   — prompt prefill + greedy decode into a scratch cache,
  then one commit into the big cache;
- ``train_forward``  — the full-sequence training forward with the LM and
  video (score-head) losses.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MMDuetConfig

from ..parallel.collectives import (copy_to_model, cut, gather_vocab, max_model, model_axis,
                                    reduce_model, sum_data, whole_over_data)
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


def _positions(cache_len: Sequence[int], T: int, device) -> torch.Tensor:
    return (ints_to(cache_len, device)[:, None]
            + torch.arange(T, device=device)[None, :])


def _score_output(params: Params, cfg: MMDuetConfig, last: torch.Tensor, kv_cache: KVCache,
                  compute_lm_logits: bool) -> StepOutput:
    """The score heads (whole on every rank) and, if asked, the whole
    vocabulary's logits (`gather_vocab` from a rank's slice)."""
    inf = torch.softmax(_head(params["informative_head"], last)[:, 0], dim=-1)[:, 1]
    rel = torch.softmax(_head(params["relevance_head"], last)[:, 0], dim=-1)[:, 1]
    logits = None
    if compute_lm_logits:
        logits = gather_vocab(qwen2.lm_logits(params["lm_head"], last)[:, 0],
                              cfg.text.vocab_size)
    return StepOutput(logits, inf, rel, kv_cache)


def step_forward(
    params: Params,
    cfg: MMDuetConfig,
    embeds: torch.Tensor,  # (B, T, H) chunk embeddings (text and/or frame)
    kv_cache: KVCache,
    cache_len: Lanes,  # per-lane cursors (or one for all)
    t_real: Lanes,  # real (unpadded) tokens in each lane's chunk
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    compute_lm_logits: bool = True,
    shard_ctx=None,  # ops.attention.ShardCtx: attention per mesh shard
    commit: Optional[Sequence[bool]] = None,  # lanes to commit (None = all)
) -> StepOutput:
    """One streaming step: write the chunk into the cache (in place) and
    read the scores at each lane's last real position."""
    B, T, _ = embeds.shape
    cl = lane_list(cache_len, B)
    tr = lane_list(t_real, B)
    hidden, kv_cache = qwen2.qwen2_forward(
        params["decoder"], cfg.text, embeds, _positions(cl, T, embeds.device),
        kv_cache=kv_cache, cache_len=cl, lora=lora, lora_scale=lora_scale, t_real=tr,
        shard_ctx=shard_ctx, commit=commit,
    )
    last = torch.stack([hidden[b, t - 1] for b, t in enumerate(tr)])[:, None]
    return _score_output(params, cfg, last, kv_cache, compute_lm_logits)


def chunk_scores_forward(
    params: Params,
    cfg: MMDuetConfig,
    embeds: torch.Tensor,  # (B, T, H) per-lane (padded) chunks
    kv_cache: KVCache,
    cache_len: Lanes,  # per-lane cursors (or one for all)
    t_real: Lanes,  # per-lane real lengths (or one for all)
    score_pos,  # (B, K) or (K,) chunk-local positions to score
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    shard_ctx=None,
    commit: Optional[Sequence[bool]] = None,  # lanes to commit (None = all)
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
    cl = lane_list(cache_len, B)
    tr = lane_list(t_real, B)
    hidden, kv_cache = qwen2.qwen2_forward(
        params["decoder"], cfg.text, embeds, _positions(cl, T, dev),
        kv_cache=kv_cache, cache_len=cl, lora=lora, lora_scale=lora_scale, t_real=tr,
        shard_ctx=shard_ctx, commit=commit,
    )
    sp = torch.as_tensor(np.asarray(score_pos), dtype=torch.int64)
    if sp.ndim == 1:
        sp = sp[None].expand(B, -1)
    sp = sp.to(dev)
    sel = torch.gather(hidden, 1, sp[..., None].expand(-1, -1, hidden.shape[-1]))  # (B, K, H)
    inf = torch.softmax(_head(params["informative_head"], sel), dim=-1)[..., 1]
    rel = torch.softmax(_head(params["relevance_head"], sel), dim=-1)[..., 1]
    return torch.stack([inf, rel], dim=1), kv_cache


def frames_block_forward(
    params: Params,
    cfg: MMDuetConfig,
    frames: torch.Tensor,  # (K, frame_num_tokens, H) — K whole frames
    kv_cache: KVCache,
    cache_len: int,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    shard_ctx=None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Score K consecutive frames in ONE chunk forward: attention is
    causal, so the heads read at each frame's last position (ft-1,
    2*ft-1, ...) equal K sequential `step_forward` calls, with the
    weights read once per block.

    Returns (informative_probs (K,), relevance_probs (K,), cache)."""
    K, ft, H = frames.shape
    embeds = frames.reshape(1, K * ft, H)
    hidden, kv_cache = qwen2.qwen2_forward(
        params["decoder"], cfg.text, embeds,
        _positions([cache_len], K * ft, frames.device),
        kv_cache=kv_cache, cache_len=cache_len, lora=lora, lora_scale=lora_scale,
        t_real=K * ft, shard_ctx=shard_ctx,
    )
    last = hidden.reshape(K, ft, H)[None, :, ft - 1, :]  # (1, K, H)
    inf = torch.softmax(_head(params["informative_head"], last)[0], dim=-1)[:, 1]
    rel = torch.softmax(_head(params["relevance_head"], last)[0], dim=-1)[:, 1]
    return inf, rel, kv_cache


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
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Prompt prefill + greedy decode (with the repetition penalty as a
    token bitmask), the port of the JAX device-side `lax.while_loop` as a
    host loop with the same condition: ``any(~done) and i < max_new``.

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

    Returns ``(packed (B, max_new+2) int32 [tokens | n | final cursor],
    cache, updated pen_mask)``."""
    B, _, _ = embeds.shape
    dev = embeds.device
    V = cfg.text.vocab_size
    act = [True] * B if active is None else [bool(a) for a in active]
    cl = lane_list(cache_len, B)
    tr = lane_list(t_real, B)
    pen_mask = pen_mask.clone()

    def penalized(logits: torch.Tensor) -> torch.Tensor:
        if rep is None:
            return logits
        pen = torch.where(logits > 0, logits / rep, logits * rep)
        return torch.where(pen_mask, pen, logits)

    def mark(b: int, tok: int) -> None:
        if rep is not None:  # the mask is read only by penalized()
            pen_mask[b, tok] = True

    out = step_forward(params, cfg, embeds, kv_cache, cl, tr, lora=lora,
                       lora_scale=lora_scale, compute_lm_logits=True,
                       shard_ctx=shard_ctx, commit=act)
    cache = out.kv_cache  # prompt committed; read-only until the commit
    base = [c + t if a else c for c, t, a in zip(cl, tr, act)]

    tok0 = torch.argmax(penalized(out.last_logits), dim=-1).tolist()
    buf = [[0] * max_new for _ in range(B)]
    done, n = [], []
    for b in range(B):
        buf[b][0] = tok0[b] if act[b] else 0
        if act[b] and tok0[b] != eos_id:
            mark(b, tok0[b])
        done.append(tok0[b] == eos_id or not act[b])
        n.append(1 if act[b] else 0)

    W = max(max_new - 1, 1)
    L, _, kh, _, hd = kv_arr(cache.k).shape
    scratch = KVCache(
        torch.zeros((L, B, kh, W, hd), dtype=embeds.dtype, device=dev),
        torch.zeros((L, B, kh, W, hd), dtype=embeds.dtype, device=dev),
    )
    dec = params["decoder"]
    cursor = list(base)
    last_tok = list(tok0)
    i = 1
    while not all(done) and i < max_new:
        emb = qwen2.embed_tokens(
            dec, ints_to(last_tok, dev)[:, None], V
        ).to(embeds.dtype)
        hidden, scratch = qwen2.qwen2_forward(
            dec, cfg.text, emb, ints_to(cursor, dev)[:, None],
            kv_cache=cache, cache_len=base, lora=lora, lora_scale=lora_scale,
            t_real=1, scratch=scratch, scratch_len=i - 1, shard_ctx=shard_ctx,
        )
        logits = gather_vocab(qwen2.lm_logits(params["lm_head"], hidden[:, :1])[:, 0], V)
        tok = torch.argmax(penalized(logits), dim=-1).tolist()
        for b in range(B):
            if not done[b]:
                buf[b][i] = tok[b]
                if tok[b] != eos_id:
                    mark(b, tok[b])
                n[b] = i + 1
                cursor[b] += 1
                last_tok[b] = tok[b]
            done[b] = done[b] or tok[b] == eos_id
        i += 1
    # ONE commit of the scratch at each active lane's post-prompt cursor;
    # rows past a lane's fed count land in its garbage zone
    cache = qwen2.commit_lanes(cache, scratch.k, scratch.v, base, act)
    packed = torch.tensor(
        [buf[b] + [n[b], cursor[b]] for b in range(B)],
        dtype=torch.int32, device=dev,
    )
    return packed, cache, pen_mask
