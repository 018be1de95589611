"""The MMDuet model assembly in PyTorch: tower + projector + pooling +
decoder + score heads.

Port of `mmduet_tpu/models/mmduet.py`:

- ``visual_embed``  — SigLIP patches -> projector MLP -> bilinear 27->7
  spatial pooling -> 49 tokens per frame;
- ``joint_embed``   — text embeddings with ``<image>`` positions replaced
  by frame tokens through a cumsum gather;
- ``step_forward`` / ``frames_block_forward`` — streaming forwards against
  the preallocated KV cache, returning the score-head probabilities (and
  last-position LM logits);
- ``decode_loop``   — prompt prefill + greedy decode into a scratch cache,
  then one commit into the big cache;
- ``train_forward``  — the full-sequence training forward with the LM and
  video (score-head) losses.

The CLIP tower is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MMDuetConfig

from . import qwen2, siglip
from .quant import matmul_f32
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
        w = torch.from_numpy(_bilinear_weights(side, out_side)).to(features.device)
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
    JAX einsum promotes them)."""
    p = params["projector"]
    dt = features.dtype
    x = siglip._linear(features, p["fc1"].to(dt), p["fc1_bias"])
    x = F.gelu(x.float(), approximate="none").to(dt)
    return siglip._linear(x, p["fc2"].to(dt), p["fc2_bias"])


def normalize_pixels(cfg: MMDuetConfig, frames_uint8: torch.Tensor) -> torch.Tensor:
    """Pixel normalization of the model's tower (SigLIP: mean/std 0.5)."""
    if cfg.vision_arch == "clip":
        raise NotImplementedError("the CLIP tower is not ported yet")
    return siglip.normalize_pixels(frames_uint8)


def visual_embed(params: Params, cfg: MMDuetConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Normalized pixels (N, H, W, 3) -> frame token embeddings
    (N, frame_num_tokens, hidden): SigLIP -> projector -> pooling."""
    if cfg.vision_arch == "clip":
        raise NotImplementedError("the CLIP tower is not ported yet")
    feats = siglip.siglip_encode(params["vision"], cfg.vision, pixels)
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


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over labels != -100. Returns (loss, count); the
    loss is 0 when no label counts."""
    mask = labels != -100
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count = mask.sum()
    loss = (nll * mask).sum() / count.clamp(min=1)
    return torch.where(count > 0, loss, torch.zeros_like(loss)), count


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
    video loss one cross-entropy over both score heads' labels."""
    embeds = joint_embed(params, cfg, input_ids, frame_embeds)
    positions = torch.cumsum(attn_mask.int(), dim=1) - 1
    hidden, _ = qwen2.qwen2_forward(
        params["decoder"], cfg.text, embeds, positions,
        attn_mask=attn_mask, lora=lora, lora_scale=lora_scale, remat=remat,
        use_flash=use_flash,
    )
    head_hidden = hidden.detach() if cfg.video_head_stop_grad else hidden
    lm = qwen2.lm_logits(params["lm_head"], hidden)
    inf = _head(params["informative_head"], head_hidden)
    rel = _head(params["relevance_head"], head_hidden)

    lm_loss, _ = masked_ce(lm, labels)
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


def _score_output(params: Params, last: torch.Tensor, kv_cache: KVCache,
                  compute_lm_logits: bool) -> StepOutput:
    inf = torch.softmax(_head(params["informative_head"], last)[:, 0], dim=-1)[:, 1]
    rel = torch.softmax(_head(params["relevance_head"], last)[:, 0], dim=-1)[:, 1]
    logits = None
    if compute_lm_logits:
        logits = qwen2.lm_logits(params["lm_head"], last)[:, 0]
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
) -> StepOutput:
    """One streaming step: write the chunk into the cache (in place) and
    read the scores at each lane's last real position."""
    B, T, _ = embeds.shape
    cl = lane_list(cache_len, B)
    tr = lane_list(t_real, B)
    hidden, kv_cache = qwen2.qwen2_forward(
        params["decoder"], cfg.text, embeds, _positions(cl, T, embeds.device),
        kv_cache=kv_cache, cache_len=cl, lora=lora, lora_scale=lora_scale, t_real=tr,
    )
    last = torch.stack([hidden[b, t - 1] for b, t in enumerate(tr)])[:, None]
    return _score_output(params, last, kv_cache, compute_lm_logits)


def frames_block_forward(
    params: Params,
    cfg: MMDuetConfig,
    frames: torch.Tensor,  # (K, frame_num_tokens, H) — K whole frames
    kv_cache: KVCache,
    cache_len: int,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
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
        t_real=K * ft,
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
) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Prompt prefill + greedy decode (with the repetition penalty as a
    token bitmask), the port of the JAX device-side `lax.while_loop` as a
    host loop with the same condition: ``any(~done) and i < max_new``.

    The big cache is written twice, in place: by the prompt prefill and
    by one commit after the loop. Inside the loop it is read-only; each
    step attends [cache] + [scratch + current token] and writes its K/V
    into a (L, B, kh, W, hd) scratch, ``W = max(max_new - 1, 1)`` wide
    (the last sampled token is never fed back). Frozen (``active=False``)
    lanes run the forwards but commit nothing of their own: their
    scratch rows land at their frozen cursor. The scratch is in the
    activation dtype also under an int8 cache: the one commit after the
    loop quantizes its rows. Capacity: for every active
    lane ``cache_len[b] + t + W <= S``; for a frozen one
    ``cache_len[b] + max(t, W) <= S`` (`commit_lanes` raises otherwise).

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
                       lora_scale=lora_scale, compute_lm_logits=True)
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
            t_real=1, scratch=scratch, scratch_len=i - 1,
        )
        logits = qwen2.lm_logits(params["lm_head"], hidden[:, :1])[:, 0]
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
    # ONE commit of the scratch at each lane's post-prompt cursor; rows
    # past a lane's fed count land in its garbage zone
    cache = qwen2.commit_lanes(cache, scratch.k, scratch.v, base)
    packed = torch.tensor(
        [buf[b] + [n[b], cursor[b]] for b in range(B)],
        dtype=torch.int32, device=dev,
    )
    return packed, cache, pen_mask
