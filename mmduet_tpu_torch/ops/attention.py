"""The port's attention kernels, each beside its plain PyTorch version.

**Kernel A**, streaming split attention over the stacked KV cache: port of
`mmduet_tpu/ops/attention.py::flash_decode_attention`. Per lane,
one softmax over [that lane's committed cache history (slots <
cache_len[b]) of layer ``layer``] + [the chunk itself, causal at chunk
position q_offset[b] + t, masked to columns < t_real[b]]. The cache is
read-only: the caller commits the chunk's K/V afterwards
(`models.qwen2.commit_lanes`).

`flash_decode_attention` chooses by device: tensors on the CPU take the
plain version (`flash_decode_attention_ref`); tensors on a CUDA device
launch the kernel in ``csrc/flash_decode.cu`` or raise. The kernel runs
on the tensor cores for both cache types, split over the cache when the
rows are few (`decode_split`); it rounds the softmax numerators to
bf16 for the value product, as the Pallas kernel does.

**Kernel A, int8 cache** (``k_scale`` / ``v_scale`` given; the Pallas
kernel's ``quantized=True``): the cache holds int8 rows with one f32
scale per (layer, lane, head, slot). The K scale multiplies the scores
as a column scaling, the V scale is folded into the softmax numerators,
and the denominator sums the unscaled numerators; the chunk stays in the
activation dtype. The kernel widens the int8 tiles to bf16 (exactly) and
rounds the scaled numerators p * v_scale to bf16, as the Pallas kernel
does; the plain version does the column scalings in f32 on the int8
values and keeps p in f32. (The JAX package's jnp fallback instead
dequantizes the cache to the activation dtype first, which rounds
differently in bf16; in f32 the two agree to rounding.)

**Kernel C**, causal GQA attention over a padded batch, forward and
backward (the decoder's training attention): port of
`mmduet_tpu/ops/attention.py::flash_full_attention`. `flash_full_attention`
runs the plain version (`flash_full_attention_ref`, differentiable through
autograd) for CPU tensors and the kernels of ``csrc/flash_full.cu``
(forward; backward preprocess, dK/dV and dQ) for CUDA tensors.

**Kernel A'**, kernel A per shard of a (data, model) mesh: port of
`mmduet_tpu/ops/attention.py::flash_decode_attention_sharded`.
`flash_decode_attention_sharded` launches kernel A once per (lane shard,
head shard) on strided views of the operands; the result is bit-equal to
one unsharded launch.

**Kernel D**, non-causal multi-head attention for the ViT tower, forward
only: port of `mmduet_tpu/ops/attention.py::flash_vision_attention`.
`flash_vision_attention` runs the plain version
(`flash_vision_attention_ref`) for CPU tensors and the kernel of
``csrc/flash_vision.cu`` for CUDA tensors.

There is no fallback from a kernel to its plain version. Kernel C's
refusals and failed launches raise a `KernelError` (a `KernelRefused`
ValueError or a `KernelLaunchFailed` RuntimeError), which the training
loop's skip-a-bad-batch guard lets through.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30

# Kernel A launches since the last reset to 0. Only `_decode_launch` adds to
# it, once per launch.
LAUNCHES = 0
# Those of them that went to the int8-cache variant.
INT8_LAUNCHES = 0
# Those of them that `flash_decode_attention_sharded` made (one per shard).
SHARDED_LAUNCHES = 0
# Kernel C: forward launches, and backward launches (a backward launches
# the preprocess, dK/dV and dQ kernels, one count each). Only the CUDA
# branch adds to them.
FULL_FWD_LAUNCHES = 0
FULL_BWD_LAUNCHES = 0
# Kernel D launches. Only the CUDA branch of `flash_vision_attention` adds
# to it.
VISION_LAUNCHES = 0


class KernelError(Exception):
    """A kernel refused its operands or failed to launch: a fault of the
    run, never of one batch."""


class KernelRefused(KernelError, ValueError):
    pass


class KernelLaunchFailed(KernelError, RuntimeError):
    pass

_lib: Optional[ctypes.CDLL] = None
_full_lib: Optional[ctypes.CDLL] = None
_vision_lib: Optional[ctypes.CDLL] = None


def _lanes(x: Optional[torch.Tensor], name: str, batch: int, device) -> torch.Tensor:
    """Checks a per-lane cursor: a (B,) int32 tensor on ``device``; None
    (``q_offset`` only) is all zeros."""
    if x is None:
        return torch.zeros(batch, dtype=torch.int32, device=device)
    if (not torch.is_tensor(x) or x.dtype != torch.int32
            or tuple(x.shape) != (batch,) or x.device != device):
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}" if torch.is_tensor(x)
               else type(x).__name__)
        raise ValueError(f"{name}: want a ({batch},) int32 tensor on {device}, got {got}")
    return x.contiguous()


def attend_split(
    q: torch.Tensor,  # (B, T, nh, hd)
    kc: torch.Tensor,  # (B, kh, S, hd) one layer of the cache, read-only
    vc: torch.Tensor,  # (B, kh, S, hd)
    ck: torch.Tensor,  # (B, kh, Tc, hd) the chunk's K (Tc >= T)
    cv: torch.Tensor,  # (B, kh, Tc, hd)
    cache_len: torch.Tensor,  # (B,) int32 committed cache tokens per lane
    t_real: torch.Tensor,  # (B,) int32 real tokens in each lane's chunk
    q_offset: Optional[torch.Tensor] = None,  # (B,) int32 chunk position of
    # query row 0; None = 0
    k_scale: Optional[torch.Tensor] = None,  # (B, kh, S) f32: kc / vc are int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Port of `qwen2._attend_split`: per lane, one f32 softmax over
    [cache slots < cache_len[b]] + [the chunk, causal: query row t sees
    chunk cols <= q_offset[b] + t and < t_real[b]]. Scores and both
    value products accumulate in f32 from the stored dtype's values, as
    the JAX einsums with ``preferred_element_type=float32`` do.

    With scales the cache is int8: the cache scores are multiplied by
    ``k_scale`` per column, the cache numerators by ``v_scale`` before the
    value product (in f32, not rounded), and the softmax denominator
    keeps the unscaled numerators."""
    B, T, nh, hd = q.shape
    kh, S = kc.shape[1], kc.shape[2]
    Tc = ck.shape[2]
    dev = q.device
    cl = _lanes(cache_len, "cache_len", B, dev)
    tr = _lanes(t_real, "t_real", B, dev)
    qo = _lanes(q_offset, "q_offset", B, dev)
    qr = q.reshape(B, T, kh, nh // kh, hd).float()
    scale = math.sqrt(hd)
    s_cache = torch.einsum("btkgh,bksh->bkgts", qr, kc.float()) / scale
    s_chunk = torch.einsum("btkgh,bkch->bkgtc", qr, ck.float()) / scale
    if k_scale is not None:
        s_cache = s_cache * k_scale.float()[:, :, None, None, :]
    slot = torch.arange(S, device=dev)
    s_cache.masked_fill_(
        (slot[None, :] >= cl[:, None])[:, None, None, None, :], NEG_INF
    )
    col = torch.arange(Tc, device=dev)[None, None, :]
    row = torch.arange(T, device=dev)[None, :, None]
    cmask = (col <= qo[:, None, None] + row) & (col < tr[:, None, None])
    s_chunk.masked_fill_(~cmask[:, None, None], NEG_INF)
    probs = torch.softmax(torch.cat([s_cache, s_chunk], dim=-1), dim=-1)
    p_cache, p_chunk = probs[..., :S], probs[..., S:]
    if v_scale is not None:
        p_cache = p_cache * v_scale.float()[:, :, None, None, :]
    else:
        p_cache = p_cache.to(vc.dtype).float()
    out = torch.einsum("bkgts,bksh->btkgh", p_cache, vc.float()) + torch.einsum(
        "bkgtc,bkch->btkgh", p_chunk.to(cv.dtype).float(), cv.float()
    )
    return out.reshape(B, T, nh, hd).to(q.dtype)


def flash_decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    cache_len: torch.Tensor,
    t_real: torch.Tensor,
    layer: int,
    q_offset: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of `flash_decode_attention`: layer
    ``layer`` of the stacked cache (and of its scales, for an int8 cache)
    through `attend_split`."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode_attention: k_scale and v_scale go together")
    return attend_split(
        q, k_cache[layer], v_cache[layer], chunk_k, chunk_v,
        cache_len, t_real, q_offset,
        None if k_scale is None else k_scale[layer],
        None if v_scale is None else v_scale[layer],
    )


# Kernel A runs on 64-row query tiles of one (lane, kv head), for either
# cache type, and cuts a lane's cache into spans of whole 64-slot key tiles,
# one block a (row tile, span). The rule has two inputs, the rows of a (lane,
# kv head) (T times the GQA group) and the capacity S, and the kernel adds
# the lane's cursor: nothing that a shard changes, so that a shard's launch
# splits each (lane, head) as one launch does. For each regime, (most row
# tiles, slots a span aims at, most spans): a decode step (one tile) takes a
# span for every 128 live slots, up to 128; a frame or joiner step (up to 16
# tiles) one for every 256, up to 16; an 8-frame block (up to 64) one for
# every 4096, up to 2 (only a long cursor splits: its 43 tiles a head fill
# the card at the whole model's heads); above that one span (a 32-frame
# block's 172 tiles a head are work enough).
SPLIT_TILE_ROWS = 64
SPLIT_KEY_TILE = 64
SPLIT_RULE = ((1, 128, 128), (16, 256, 16), (64, 4096, 2))
SPLIT_MAX = 128  # spans of a (lane, head) at most: the kernel's MAX_SPLIT
# Spans combined together: more live spans combine in two levels, each group
# of SPLIT_GROUP, then the groups; a (lane, head, row tile) has a counter for
# the last level and one a group (the kernel's GROUP and COUNTERS).
SPLIT_GROUP = 16


def decode_split(rows: int, S: int) -> Tuple[int, int]:
    """(span_min, nsplit) of kernel A for ``rows`` GQA rows a (lane, kv
    head) and a cache of S slots: a lane takes one span for every span_min
    slots of its cursor, at most nsplit, the spans of the grid (sized from
    S, since the wrapper never reads a cursor)."""
    tiles = -(-rows // SPLIT_TILE_ROWS)
    for most_tiles, span_min, most in SPLIT_RULE:
        if tiles <= most_tiles:
            return span_min, max(1, min(most, SPLIT_MAX, -(-S // span_min)))
    return max(1, S), 1


def lane_spans(cache_len: int, span_min: int, nsplit: int) -> Tuple[int, int]:
    """(slots a span, live spans) of a lane with ``cache_len`` live slots, as
    the kernel computes them: ceil(cache_len / span_min) spans, at most
    nsplit and at least one, of equal whole key tiles."""
    want = min(nsplit, max(1, -(-cache_len // span_min)))
    per = -(-cache_len // want)  # slots a span, before whole key tiles
    span = max(SPLIT_KEY_TILE, -(-per // SPLIT_KEY_TILE) * SPLIT_KEY_TILE)
    return span, max(1, -(-cache_len // span))


def decode_scratch_numel(B: int, kh: int, rows: int, S: int, hd: int) -> Tuple[int, int]:
    """(f32 partials, int32 counters) of kernel A's split scratch for a
    launch of B lanes x kh kv heads x ``rows`` GQA rows over S slots: the
    partials (acc, m, l) of every (lane, head, span, row), 1 + SPLIT_MAX /
    SPLIT_GROUP counters a (lane, head, row tile); nothing when the grid has
    one span."""
    _, nsplit = decode_split(rows, S)
    if nsplit == 1:
        return 0, 0
    return (B * kh * nsplit * rows * (hd + 2),
            B * kh * -(-rows // SPLIT_TILE_ROWS) * (1 + SPLIT_MAX // SPLIT_GROUP))


# The split's scratch per device: f32 partials and int32 counters (zeros,
# and left zero by every launch), grown when a launch needs more. Launches
# that share it run one after another on one stream. `_split_memo` keeps
# each launch shape's (span_min, nsplit, partials, counters) for the host's
# sake, and is emptied whenever the scratch is reallocated.
# The one-stream rule: kernel A runs on one stream at a time, the decoder's
# (the caller's current stream; inside `LiveInferEngine.stream_video` the
# engine's decoder stream, which starts after the caller's stream and which
# the caller's stream waits for at the end), never beside another launch of
# A. `stream_video` puts the vision tower (kernel D, which has no scratch)
# on a side stream of its own.
_split_scratch: dict = {}
_split_memo: dict = {}


def _split_args(device, B: int, kh: int, rows: int, S: int, hd: int) -> Tuple[int, int, Any, Any]:
    """Kernel A's (span_min, nsplit, partials pointer, counters pointer)
    for a launch of B lanes x kh kv heads x ``rows`` GQA rows over S cache
    slots (pointers None when the grid has one span)."""
    key = (device, B, kh, rows, S)
    got = _split_memo.get(key)
    if got is None:
        span_min, nsplit = decode_split(rows, S)
        got = (span_min, nsplit, None, None)
        n_part, n_counters = decode_scratch_numel(B, kh, rows, S, hd)
        if n_part:
            part, counters = reserve_split_scratch(device, n_part, n_counters)
            got = (span_min, nsplit, part.data_ptr(), counters.data_ptr())
        _split_memo[key] = got
    return got


def reserve_split_scratch(device, n_part: int, n_counters: int) -> Tuple[Any, Any]:
    """Kernel A's split scratch of ``device``, grown to at least ``n_part``
    f32 partials and ``n_counters`` int32 counters (zeros): the tensors are
    made anew when they grow, and the memo goes with the old ones. An engine
    that replays CUDA graphs reserves its largest launch's before it
    captures any, so that one scratch serves all its graphs."""
    part, counters = _split_scratch.get(device, (None, None))
    if part is None or part.numel() < n_part or counters.numel() < n_counters:
        part = torch.empty(max(n_part, 0 if part is None else part.numel()),
                           dtype=torch.float32, device=device)
        counters = torch.zeros(max(n_counters, 0 if counters is None else counters.numel()),
                               dtype=torch.int32, device=device)
        _split_scratch[device] = (part, counters)
        _split_memo.clear()
    return part, counters


def bind_decode_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Gives a build of ``csrc/flash_decode.cu`` its functions' argument
    types."""
    ptr, num = ctypes.c_void_p, ctypes.c_int
    tail = [num] * 9 + [ctypes.c_float, ptr]
    lib.flash_decode_bf16.argtypes = [ptr] * 12 + tail
    lib.flash_decode_bf16.restype = ctypes.c_int
    lib.flash_decode_int8.argtypes = [ptr] * 14 + tail
    lib.flash_decode_int8.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind_decode_lib(_build.load("flash_decode"))
    return _lib


def _decode_check(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real, layer,
                  q_offset, k_scale, v_scale):
    """What kernel A takes, for whole operands or strided views of them:
    bf16 queries and chunk, a bf16 or int8 cache, hd = 128, rows of hd
    values contiguous and 16-byte aligned on one CUDA device, K and V of a
    pair laid out alike. Returns the three per-lane cursors."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: no kernel for device {q.device}")
    B, T, nh, hd = q.shape
    L, Bc, kh, S, hd_c = k_cache.shape
    Tc = chunk_k.shape[2]
    if hd != 128:
        raise ValueError(f"flash_decode_attention: head_dim {hd} (the kernel takes 128)")
    if (
        Bc != B or hd_c != hd or nh % kh
        or tuple(v_cache.shape) != tuple(k_cache.shape)
        or tuple(chunk_k.shape) != (B, kh, Tc, hd)
        or tuple(chunk_v.shape) != (B, kh, Tc, hd)
    ):
        raise ValueError(
            "flash_decode_attention: inconsistent shapes q "
            f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}/"
            f"{tuple(v_cache.shape)}, chunk {tuple(chunk_k.shape)}/"
            f"{tuple(chunk_v.shape)}"
        )
    if not 0 <= int(layer) < L:
        raise ValueError(f"flash_decode_attention: layer {layer} of {L}")
    if (k_scale is None) != (v_scale is None):
        raise KernelRefused("flash_decode_attention: k_scale and v_scale go together")
    quantized = k_scale is not None
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("chunk_k", chunk_k), ("chunk_v", chunk_v)):
        if t.device != dev:
            raise ValueError(f"flash_decode_attention: {name} on {t.device}, q on {dev}")
        dtype, cache = t.dtype, name[-6:] == "_cache"
        if quantized and cache:
            if dtype != torch.int8:
                raise KernelRefused(
                    f"flash_decode_attention: {name} is {dtype}; with scales the "
                    "kernel takes an int8 cache")
        elif dtype != torch.bfloat16:
            if dtype == torch.int8 and cache:
                raise KernelRefused(
                    f"flash_decode_attention: {name} is int8 and no scales were given")
            raise TypeError(f"flash_decode_attention: {name} is {dtype}, the kernel takes bfloat16")
        # 16-byte vector loads: rows of hd values back to back, every other
        # stride and the base a multiple of 16 bytes
        step = 16 if dtype == torch.int8 else 8
        st = t.stride()
        if (st[-1] != 1 or st[-2] != hd or t.data_ptr() % 16
                or any(x % step for x in st[:-2])):
            raise ValueError(
                f"flash_decode_attention: {name} must have contiguous, 16-byte aligned rows "
                f"(strides {st})")
    for a, b in ((k_cache, v_cache), (chunk_k, chunk_v)):
        if a.stride() != b.stride():
            raise ValueError("flash_decode_attention: K and V must be laid out alike, got "
                             f"strides {a.stride()} and {b.stride()}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)) if quantized else ():
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (L, B, kh, S) or t.stride(-1) != 1
                or t.stride() != k_scale.stride()):
            raise KernelRefused(
                f"flash_decode_attention: {name} must be an f32 ({L}, {B}, {kh}, {S}) tensor "
                f"with contiguous rows on {q.device}, got {t.dtype} {tuple(t.shape)} "
                f"(strides {t.stride()}) on {t.device}")
    return (_lanes(cache_len, "cache_len", B, q.device),
            _lanes(t_real, "t_real", B, q.device),
            _lanes(q_offset, "q_offset", B, q.device))


# The ctypes arrays of the strides already met (a serving run meets a few).
_strides_memo: dict = {}


def _decode_launch(q, k_cache, v_cache, chunk_k, chunk_v, cl, tr, qo, out, layer,
                   k_scale, v_scale) -> None:
    """One launch of kernel A on operands that `_decode_check` passed, or
    on a shard's views of them, writing ``out`` (laid out like ``q``).
    Counts the launch."""
    global LAUNCHES, INT8_LAUNCHES
    B, T, nh, hd = q.shape
    kh, S = k_cache.shape[2], k_cache.shape[3]
    quantized = k_scale is not None
    sq, so, c, ck = q.stride(), out.stride(), k_cache.stride(), chunk_k.stride()
    sc = k_scale.stride() if quantized else (0, 0, 0)
    key = (sq[0], sq[1], so[0], so[1], c[0], c[1], c[2], ck[0], ck[1], sc[0], sc[1], sc[2])
    strides = _strides_memo.get(key)
    if strides is None:
        strides = _strides_memo[key] = (ctypes.c_longlong * 12)(*key)
    lib = _kernel_lib()
    Tc, scale = chunk_k.shape[2], 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    span_min, nsplit, part, counters = _split_args(q.device, B, kh, (nh // kh) * T, S, hd)
    pointers = (chunk_k.data_ptr(), chunk_v.data_ptr(), cl.data_ptr(), tr.data_ptr(),
                qo.data_ptr(), out.data_ptr(), part, counters, strides,
                B, T, nh, kh, S, Tc, int(layer), span_min, nsplit, scale, stream)
    if quantized:
        err = lib.flash_decode_int8(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                    k_scale.data_ptr(), v_scale.data_ptr(), *pointers)
    else:
        err = lib.flash_decode_bf16(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                    *pointers)
    if err:
        raise KernelLaunchFailed(
            "flash_decode_attention: kernel launch failed: "
            + lib.flash_decode_error_string(err).decode()
        )
    LAUNCHES += 1
    INT8_LAUNCHES += quantized


def flash_decode_attention(
    q: torch.Tensor,  # (B, T, nh, hd)
    k_cache: torch.Tensor,  # (L, B, kh, S, hd) head-major, read-only
    v_cache: torch.Tensor,  # same layout
    chunk_k: torch.Tensor,  # (B, kh, Tc, hd) this chunk's K
    chunk_v: torch.Tensor,  # (B, kh, Tc, hd)
    cache_len: torch.Tensor,  # (B,) int32 committed tokens per lane
    t_real: torch.Tensor,  # (B,) int32 real tokens in each lane's chunk
    layer: int,  # layer into the stacked cache
    q_offset: Optional[torch.Tensor] = None,  # (B,) int32 chunk position of
    # query row 0 (scratch decode: generated tokens' K/V fill chunk slots
    # 0..q_offset-1 and the queries sit after them); None = 0
    k_scale: Optional[torch.Tensor] = None,  # (L, B, kh, S) f32 per-token
    # scales of an int8 cache; None = the cache is in the activation dtype
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns the attention output (B, T, nh, hd). Rows t >= t_real[b]
    hold values that are never read.

    CPU tensors: the plain version. CUDA tensors: the kernel (its int8
    variant when the scales are given), which takes bf16 queries and
    chunk, a bf16 or int8 cache, hd = 128 and operands on one device whose
    rows of hd values are contiguous and 16-byte aligned (a whole tensor,
    or a view cut along lanes and heads); anything else raises
    (`KernelRefused` for what concerns the int8 variant), as does a
    refused launch."""
    if q.device.type == "cpu":
        return flash_decode_attention_ref(
            q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real, layer,
            q_offset, k_scale, v_scale,
        )
    cl, tr, qo = _decode_check(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real,
                               layer, q_offset, k_scale, v_scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _decode_launch(q, k_cache, v_cache, chunk_k, chunk_v, cl, tr, qo, out, layer,
                   k_scale, v_scale)
    return out


# ---------------------------------------------------------------------------
# Kernel A': kernel A on each shard of a (data, model) mesh
# ---------------------------------------------------------------------------


class ShardCtx(NamedTuple):
    """How the serving tensors are laid out over a mesh
    (`parallel.make_mesh`), for running kernel A per shard:

    - ``head_axis`` ('model' or None): nh and kh are cut over it, each
      shard owning a contiguous run of kv heads and their query heads;
    - ``lane_axis`` ('data' or None): the lane (batch) dim is cut over it.

    Attention mixes neither lanes nor heads, so a shard needs nothing of
    another."""

    mesh: Any
    lane_axis: Optional[str] = None
    head_axis: Optional[str] = None


def shard_ctx_ok(ctx: ShardCtx, num_heads: int, num_kv_heads: int, lanes: int) -> bool:
    """Every sharded dim must divide evenly into local shards."""
    if ctx.head_axis is not None:
        n = ctx.mesh.shape[ctx.head_axis]
        if num_heads % n or num_kv_heads % n:
            return False
    if ctx.lane_axis is not None:
        if lanes % ctx.mesh.shape[ctx.lane_axis]:
            return False
    return True


def flash_decode_attention_sharded(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    cache_len: torch.Tensor,  # (B,)
    t_real: torch.Tensor,  # (B,)
    layer: int,
    ctx: ShardCtx,
    q_offset: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,  # int8 KV cache scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`flash_decode_attention` over a (data, model) mesh: port of
    `mmduet_tpu/ops/attention.py::flash_decode_attention_sharded`. For each
    (lane shard, head shard) of ``ctx`` the kernel runs on that shard's
    (B / data_n) lanes x (kh / model_n) kv heads, with the nh / model_n
    query heads of the same shard, and writes the shard's part of the
    output. The shards are strided views: no cache operand is copied, and
    the per-lane cursors are sliced per lane shard. Each (lane, head)
    program computes exactly what it computes in one unsharded launch, so
    the result is bit-equal to `flash_decode_attention`.

    The mesh lies on one device (`parallel.make_mesh`), so the shards run
    one after another on the operands' device. CPU tensors take the plain
    version per shard. A ``ctx`` that `shard_ctx_ok` refuses raises."""
    global SHARDED_LAUNCHES
    B, T, nh, hd = q.shape
    kh = k_cache.shape[2]
    if not shard_ctx_ok(ctx, nh, kh, B):
        raise ValueError(
            f"flash_decode_attention_sharded: {nh} heads / {kh} kv heads / {B} lanes do not "
            f"divide the mesh {dict(ctx.mesh.shape)} (lane_axis {ctx.lane_axis}, head_axis "
            f"{ctx.head_axis})")
    data_n = ctx.mesh.shape[ctx.lane_axis] if ctx.lane_axis is not None else 1
    model_n = ctx.mesh.shape[ctx.head_axis] if ctx.head_axis is not None else 1
    quantized = k_scale is not None
    if q.device.type == "cpu":
        if (k_scale is None) != (v_scale is None):
            raise ValueError("flash_decode_attention: k_scale and v_scale go together")
        cl = _lanes(cache_len, "cache_len", B, q.device)
        tr = _lanes(t_real, "t_real", B, q.device)
        qo = _lanes(q_offset, "q_offset", B, q.device)
    else:
        cl, tr, qo = _decode_check(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real,
                                   layer, q_offset, k_scale, v_scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lb, hq, hk = B // data_n, nh // model_n, kh // model_n
    for i in range(data_n):
        lanes = slice(i * lb, (i + 1) * lb)
        for j in range(model_n):
            qh, kvh = slice(j * hq, (j + 1) * hq), slice(j * hk, (j + 1) * hk)
            scales = ((k_scale[:, lanes, kvh], v_scale[:, lanes, kvh]) if quantized
                      else (None, None))
            shard = (q[lanes, :, qh], k_cache[:, lanes, kvh], v_cache[:, lanes, kvh],
                     chunk_k[lanes, kvh], chunk_v[lanes, kvh], cl[lanes], tr[lanes])
            if q.device.type == "cpu":
                out[lanes, :, qh] = flash_decode_attention_ref(
                    *shard, layer, qo[lanes], *scales)
            else:
                _decode_launch(*shard, qo[lanes], out[lanes, :, qh], layer, *scales)
                SHARDED_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Kernel C: full-sequence (training) attention, forward and backward
# ---------------------------------------------------------------------------


def _segments(attn_mask: Optional[torch.Tensor], B: int, T: int, device) -> torch.Tensor:
    """(B, T) int32 segment ids: 1 for real tokens, 0 for pads (all real
    when ``attn_mask`` is None)."""
    if attn_mask is None:
        return torch.ones((B, T), dtype=torch.int32, device=device)
    if tuple(attn_mask.shape) != (B, T):
        raise ValueError(f"attn_mask: want ({B}, {T}), got {tuple(attn_mask.shape)}")
    return attn_mask.to(device=device, dtype=torch.int32).contiguous()


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Port of `qwen2._attend`: grouped-query attention with an f32 softmax
    over a (B, T, S) mask (True = may attend); q (B, T, nh, hd), k/v (B, S,
    kh, hd). Scores are f32 products of the stored values (the (B, kh, g,
    T, S) tensor is materialized); the probabilities are rounded to the
    value dtype and the value product accumulates in f32, as the JAX
    einsums with ``preferred_element_type=float32`` do."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    qr = q.reshape(B, T, kh, nh // kh, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qr, k.float()) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, nh, hd).to(q.dtype)


def flash_full_attention_ref(
    q: torch.Tensor,  # (B, T, nh, hd)
    k: torch.Tensor,  # (B, T, kh, hd)
    v: torch.Tensor,  # (B, T, kh, hd)
    attn_mask: Optional[torch.Tensor] = None,  # (B, T) bool; None = no padding
) -> torch.Tensor:
    """The plain PyTorch version of `flash_full_attention`: `attend` with
    key s visible to query t iff s <= t and ``attn_mask[s] ==
    attn_mask[t]``; differentiable through autograd."""
    B, T = q.shape[:2]
    seg = _segments(attn_mask, B, T, q.device)
    idx = torch.arange(T, device=q.device)
    vis = (idx[:, None] >= idx[None, :])[None] & (seg[:, :, None] == seg[:, None, :])
    return attend(q, k, v, vis)


def flash_full_lse_ref(q: torch.Tensor, k: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The row log-sum-exp that kernel C's forward saves, in plain PyTorch:
    (B, nh, T) f32, natural-log units, over the visible scaled scores of
    each query (key s <= t with ``seg[s] == seg[t]``)."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    qr = q.reshape(B, T, kh, nh // kh, hd).float()
    scores = torch.einsum("btkgh,bskh->bkgts", qr, k.float()) / math.sqrt(hd)
    idx = torch.arange(T, device=q.device)
    vis = (idx[:, None] >= idx[None, :])[None] & (seg[:, :, None] == seg[:, None, :])
    scores = scores.masked_fill(~vis[:, None, None], float("-inf"))
    return torch.logsumexp(scores, dim=-1).reshape(B, nh, T)


def flash_full_backward_ref(
    q: torch.Tensor,  # (B, T, nh, hd)
    k: torch.Tensor,  # (B, T, kh, hd)
    v: torch.Tensor,  # (B, T, kh, hd)
    seg: torch.Tensor,  # (B, T) int segment ids
    o: torch.Tensor,  # (B, T, nh, hd): the forward's output
    lse: torch.Tensor,  # (B, nh, T) f32: the forward's row log-sum-exp, natural log
    dout: torch.Tensor,  # (B, T, nh, hd)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C's backward in plain PyTorch, tile-free but with the
    kernels' algebra: the probabilities are rebuilt from the saved LSE on
    exp2 (``P = 2^(c S - lse log2 e)`` with ``c = scale log2 e``, 0 where
    masked), ``D = rowsum(dO * O)``, ``dS = P (dP - D)``, the partial dK and
    dV of each q head are summed in q-head order within the GQA group, and
    the softmax scale goes onto dQ and dK at the end. Returns (dq, dk, dv)
    in f32."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    group = nh // kh
    scale = 1.0 / math.sqrt(hd)
    log2e = 1.4426950408889634
    qf, kf, vf, of, df = (t.float() for t in (q, k, v, o, dout))
    idx = torch.arange(T, device=q.device)
    vis = (idx[:, None] >= idx[None, :])[None] & (seg[:, :, None] == seg[:, None, :])
    delta = (df * of).sum(-1).permute(0, 2, 1)  # (B, nh, T)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for h in range(nh):  # ascending q heads: the kernels' fixed order of the GQA sum
        hk = h // group
        s = torch.einsum("btd,bsd->bts", qf[:, :, h], kf[:, :, hk])
        p = torch.exp2(s * (scale * log2e) - (lse[:, h] * log2e)[:, :, None])
        p = torch.where(vis, p, torch.zeros_like(p))
        dp = torch.einsum("btd,bsd->bts", df[:, :, h], vf[:, :, hk])
        ds = p * (dp - delta[:, h][:, :, None])
        dv[:, :, hk] += torch.einsum("bts,btd->bsd", p, df[:, :, h])
        dk[:, :, hk] += torch.einsum("bts,btd->bsd", ds, qf[:, :, h])
        dq[:, :, h] = torch.einsum("bts,bsd->btd", ds, kf[:, :, hk]) * scale
    return dq, dk * scale, dv


def _full_kernel_lib() -> ctypes.CDLL:
    global _full_lib
    if _full_lib is None:
        lib = _build.load("flash_full")
        ptrs, ints = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr in (("fwd", 6), ("bwd_dkdv", 8), ("bwd_reduce", 4), ("bwd_dq", 7)):
            fn = getattr(lib, f"flash_full_{name}_bf16")
            fn.argtypes = [ptrs] * n_ptr + [ints] * 4 + [ctypes.c_float, ptrs]
            fn.restype = ints
        lib.flash_full_bwd_pre_bf16.argtypes = [ptrs] * 4 + [ints] * 3 + [ptrs]
        lib.flash_full_bwd_pre_bf16.restype = ints
        lib.flash_full_error_string.argtypes = [ints]
        lib.flash_full_error_string.restype = ctypes.c_char_p
        _full_lib = lib
    return _full_lib


FULL_BWD_KERNELS = ("bwd_pre", "bwd_dkdv", "bwd_reduce", "bwd_dq")  # one backward, in order


def _full_launch(what: str, *args) -> None:
    """Launches kernel C's ``what`` kernel (fwd or one of
    `FULL_BWD_KERNELS`) and counts it; a refused launch raises."""
    global FULL_FWD_LAUNCHES, FULL_BWD_LAUNCHES
    lib = _full_kernel_lib()
    err = getattr(lib, f"flash_full_{what}_bf16")(*args)
    if err:
        raise KernelLaunchFailed(
            f"flash_full_attention: {what} launch failed: "
            + lib.flash_full_error_string(err).decode()
        )
    if what == "fwd":
        FULL_FWD_LAUNCHES += 1
    else:
        FULL_BWD_LAUNCHES += 1


def _full_check(**tensors: torch.Tensor) -> None:
    """The kernel takes bf16, contiguous, 16-byte aligned operands on one
    CUDA device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise KernelRefused(f"flash_full_attention: {name} on {t.device}, q on {dev}")
        if t.dtype != torch.bfloat16:
            raise KernelRefused(
                f"flash_full_attention: {name} is {t.dtype}, the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise KernelRefused(
                f"flash_full_attention: {name} must be contiguous and 16-byte aligned")


FULL_PAD = 128  # the kernels' resident tile: segment ids and row statistics are padded to it


_seg_memo: Optional[Tuple[torch.Tensor, int, torch.Tensor]] = None  # a mask, its version, its ids


def _kernel_segments(attn_mask: Optional[torch.Tensor], B: int, T: int, device) -> torch.Tensor:
    """`_segments` as kernel C reads them: (B, T rounded up to `FULL_PAD`)
    int32, -2 past T (an id that no token has), so that every tile's run of
    ids starts on a 16-byte boundary and can be copied in bulk. A decoder's
    layers all pass the same mask tensor, so the ids of the last mask are
    kept until another tensor, or that one changed in place, comes."""
    global _seg_memo
    device = torch.device(device)
    if attn_mask is not None and _seg_memo is not None:
        mask, version, seg = _seg_memo
        if mask is attn_mask and version == attn_mask._version and seg.device == device:
            return seg
    seg = torch.full((B, -(-T // FULL_PAD) * FULL_PAD), -2, dtype=torch.int32, device=device)
    seg[:, :T] = _segments(attn_mask, B, T, device)
    if attn_mask is not None:
        _seg_memo = (attn_mask, attn_mask._version, seg)
    return seg


def _full_forward(q, k, v, seg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's forward launch on checked CUDA operands and
    `_kernel_segments` ids: O and the row log-sum-exp ((B, nh, T) f32,
    natural log)."""
    B, T, nh, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _full_launch("fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B, T, nh, k.shape[2],
                 1.0 / math.sqrt(hd), stream)
    return out, lse


def _full_backward_plan(q, k, v, seg, out, lse, dout):
    """Kernel C's backward as data: the outputs (dq, dk, dv) and the four
    launches of `FULL_BWD_KERNELS` in order, each with its arguments: the
    row statistics (the LSE in log2 units and D = rowsum(dO * O), padded
    like the segment ids), the f32 partial dK/dV of every q head (scratch of
    2 x (B, T, nh, hd) f32), their sum over each GQA group in q-head order,
    and dQ."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowstats = torch.empty((2, B, nh, seg.shape[1]), dtype=torch.float32, device=q.device)
    part = torch.empty((2, B, T, nh, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), dout.data_ptr(),
              rowstats.data_ptr())
    dims = (B, T, nh, kh, 1.0 / math.sqrt(hd), stream)
    launches = {
        "bwd_pre": (out.data_ptr(), dout.data_ptr(), lse.data_ptr(), rowstats.data_ptr(),
                    B, T, nh, stream),
        "bwd_dkdv": (*inputs, part[0].data_ptr(), part[1].data_ptr(), *dims),
        "bwd_reduce": (part[0].data_ptr(), part[1].data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       *dims),
        "bwd_dq": (*inputs, dq.data_ptr(), *dims),
    }
    # the caller holds the scratch until the launches are queued (the
    # allocator then reuses its memory in stream order)
    return (dq, dk, dv), launches, (rowstats, part)


def _full_backward(q, k, v, seg, out, lse, dout):
    """Kernel C's backward on checked CUDA operands: the launches of
    `_full_backward_plan`. Deterministic: no atomics, a fixed summation
    order."""
    grads, launches, _scratch = _full_backward_plan(q, k, v, seg, out, lse, dout)
    for name in FULL_BWD_KERNELS:
        _full_launch(name, *launches[name])
    return grads


class _FlashFull(torch.autograd.Function):
    """Kernel C as an autograd function: the forward kernel saves O and the
    row log-sum-exp; the backward recomputes P from them in the kernels of
    `FULL_BWD_KERNELS`. Under activation checkpointing the forward runs
    again inside the backward (and counts again)."""

    @staticmethod
    def forward(ctx, q, k, v, seg):
        out, lse = _full_forward(q, k, v, seg)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        _full_check(dout=dout)
        return (*_full_backward(q, k, v, seg, out, lse, dout), None)


def flash_full_attention(
    q: torch.Tensor,  # (B, T, nh, hd)
    k: torch.Tensor,  # (B, T, kh, hd)
    v: torch.Tensor,  # (B, T, kh, hd)
    attn_mask: Optional[torch.Tensor] = None,  # (B, T) bool; None = no padding
) -> torch.Tensor:
    """Causal GQA self-attention over a (left- or right-)padded batch,
    differentiable in q, k and v. Key s is visible to query t iff s <= t
    and ``attn_mask[s] == attn_mask[t]`` (the JAX wrapper's segment ids):
    real rows equal `qwen2._attend` with ``causal & mask[s] & mask[t]`` when
    real positions increase along the sequence; pad rows attend only
    earlier pads and are never read by the loss.

    CPU tensors: the plain version. CUDA tensors: kernel C, which takes
    bf16, hd = 128 and contiguous operands; anything else raises
    `KernelRefused`, a refused launch `KernelLaunchFailed`."""
    if q.device.type == "cpu":
        return flash_full_attention_ref(q, k, v, attn_mask)
    if q.device.type != "cuda":
        raise KernelRefused(f"flash_full_attention: no kernel for device {q.device}")
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    if hd != 128:
        raise KernelRefused(f"flash_full_attention: head_dim {hd} (the kernel takes 128)")
    if (nh % kh or tuple(k.shape) != (B, T, kh, hd)
            or tuple(v.shape) != (B, T, kh, hd)):
        raise KernelRefused(
            f"flash_full_attention: inconsistent shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    _full_check(q=q, k=k, v=v)
    return _FlashFull.apply(q, k, v, _kernel_segments(attn_mask, B, T, q.device))


# ---------------------------------------------------------------------------
# Kernel D: non-causal attention of the ViT tower, forward only
# ---------------------------------------------------------------------------


def flash_vision_attention_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `flash_vision_attention`, the matmul
    route of `siglip._attend`: (N, T, nh, hd) non-causal MHA with f32
    scores and softmax, the probabilities rounded to the value dtype and
    the value product accumulated in f32."""
    hd = q.shape[-1]
    scores = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", probs, v).to(q.dtype)


def _vision_kernel_lib() -> ctypes.CDLL:
    global _vision_lib
    if _vision_lib is None:
        lib = _build.load("flash_vision")
        lib.flash_vision_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_vision_bf16.restype = ctypes.c_int
        lib.flash_vision_error_string.argtypes = [ctypes.c_int]
        lib.flash_vision_error_string.restype = ctypes.c_char_p
        _vision_lib = lib
    return _vision_lib


def flash_vision_attention(
    q: torch.Tensor,  # (N, T, nh, hd): every token real, no padding mask
    k: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """Non-causal self-attention for the ViT tower: each of the nh heads
    of each of the N images attends over all T tokens, with the softmax
    scale 1 / sqrt(hd). Returns (N, T, nh, hd) in q's dtype.

    CPU tensors: the plain version. CUDA tensors: kernel D, which takes
    bf16, hd a multiple of 8 up to 128, any T, and contiguous, 16-byte
    aligned operands of one shape on one device, none requiring a gradient
    under grad mode (it is forward only); anything else raises
    `KernelRefused`, a refused launch `KernelLaunchFailed`."""
    global VISION_LAUNCHES
    if q.device.type == "cpu":
        return flash_vision_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise KernelRefused(f"flash_vision_attention: no kernel for device {q.device}")
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise KernelRefused(
            f"flash_vision_attention: want q, k, v of one (N, T, nh, hd) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N, T, nh, hd = q.shape
    if hd % 8 or not 8 <= hd <= 128:
        raise KernelRefused(
            f"flash_vision_attention: head_dim {hd} (the kernel takes a multiple of 8 up to 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise KernelRefused(f"flash_vision_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise KernelRefused(
                f"flash_vision_attention: {name} is {t.dtype}, the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise KernelRefused(
                f"flash_vision_attention: {name} must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise KernelRefused(
            "flash_vision_attention: the kernel has no backward; q, k or v that requires a "
            "gradient cannot go through it on a CUDA device (a frozen tower runs under no_grad)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _vision_kernel_lib()
    err = lib.flash_vision_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), N, T, nh, hd,
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise KernelLaunchFailed(
            "flash_vision_attention: kernel launch failed: "
            + lib.flash_vision_error_string(err).decode())
    VISION_LAUNCHES += 1
    return out
