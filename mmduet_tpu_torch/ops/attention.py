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
launch the kernel in ``csrc/flash_decode.cu`` or raise.

**Kernel A, int8 cache** (``k_scale`` / ``v_scale`` given; the Pallas
kernel's ``quantized=True``): the cache holds int8 rows with one f32
scale per (layer, lane, head, slot). The K scale multiplies the scores
as a column scaling, the V scale is folded into the softmax numerators,
and the denominator sums the unscaled numerators; the chunk stays in the
activation dtype. The plain version does these column scalings in f32
on the int8 values. (The JAX package's jnp fallback instead dequantizes
the cache to the activation dtype first, which rounds differently in
bf16; in f32 the two agree to rounding.)

**Kernel C**, causal GQA attention over a padded batch, forward and
backward (the decoder's training attention): port of
`mmduet_tpu/ops/attention.py::flash_full_attention`. `flash_full_attention`
runs the plain version (`flash_full_attention_ref`, differentiable through
autograd) for CPU tensors and the kernels of ``csrc/flash_full.cu``
(forward; backward preprocess, dK/dV and dQ) for CUDA tensors.

There is no fallback from a kernel to its plain version. Kernel C's
refusals and failed launches raise a `KernelError` (a `KernelRefused`
ValueError or a `KernelLaunchFailed` RuntimeError), which the training
loop's skip-a-bad-batch guard lets through.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

# Kernel launches since the last reset to 0. Only the CUDA branch of
# `flash_decode_attention` adds to it, once per launch.
LAUNCHES = 0
# Those of them that went to the int8-cache variant.
INT8_LAUNCHES = 0
# Kernel C: forward launches, and backward launches (a backward launches
# the preprocess, dK/dV and dQ kernels, one count each). Only the CUDA
# branch adds to them.
FULL_FWD_LAUNCHES = 0
FULL_BWD_LAUNCHES = 0


class KernelError(Exception):
    """A kernel refused its operands or failed to launch: a fault of the
    run, never of one batch."""


class KernelRefused(KernelError, ValueError):
    pass


class KernelLaunchFailed(KernelError, RuntimeError):
    pass

_lib: Optional[ctypes.CDLL] = None
_full_lib: Optional[ctypes.CDLL] = None


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


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_decode")
        lib.flash_decode_bf16.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_decode_bf16.restype = ctypes.c_int
        lib.flash_decode_int8.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_decode_int8.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    chunk, a bf16 or int8 cache, hd = 128 and contiguous, 16-byte aligned
    operands on one device; anything else raises (`KernelRefused` for
    what concerns the int8 variant), as does a refused launch."""
    global LAUNCHES, INT8_LAUNCHES
    if q.device.type == "cpu":
        return flash_decode_attention_ref(
            q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real, layer,
            q_offset, k_scale, v_scale,
        )
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
    operands = dict(q=q, k_cache=k_cache, v_cache=v_cache,
                    chunk_k=chunk_k, chunk_v=chunk_v)
    for name, t in operands.items():
        if t.device != q.device:
            raise ValueError(f"flash_decode_attention: {name} on {t.device}, q on {q.device}")
        if quantized and name.endswith("_cache"):
            if t.dtype != torch.int8:
                raise KernelRefused(
                    f"flash_decode_attention: {name} is {t.dtype}; with scales the "
                    "kernel takes an int8 cache")
        elif t.dtype != torch.bfloat16:
            if t.dtype == torch.int8 and name.endswith("_cache"):
                raise KernelRefused(
                    f"flash_decode_attention: {name} is int8 and no scales were given")
            raise TypeError(f"flash_decode_attention: {name} is {t.dtype}, the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode_attention: {name} must be contiguous and 16-byte aligned")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)) if quantized else ():
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (L, B, kh, S) or not t.is_contiguous()):
            raise KernelRefused(
                f"flash_decode_attention: {name} must be a contiguous f32 ({L}, {B}, {kh}, "
                f"{S}) tensor on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    cl = _lanes(cache_len, "cache_len", B, q.device)
    tr = _lanes(t_real, "t_real", B, q.device)
    qo = _lanes(q_offset, "q_offset", B, q.device)
    out = torch.empty_like(q)
    lib = _kernel_lib()
    tail = (chunk_k.data_ptr(), chunk_v.data_ptr(),
            cl.data_ptr(), tr.data_ptr(), qo.data_ptr(), out.data_ptr(),
            B, T, nh, kh, S, Tc, int(layer), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if quantized:
        err = lib.flash_decode_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), *tail)
    else:
        err = lib.flash_decode_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *tail)
    if err:
        raise KernelLaunchFailed(
            "flash_decode_attention: kernel launch failed: "
            + lib.flash_decode_error_string(err).decode()
        )
    LAUNCHES += 1
    INT8_LAUNCHES += quantized
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


def _full_kernel_lib() -> ctypes.CDLL:
    global _full_lib
    if _full_lib is None:
        lib = _build.load("flash_full")
        ptrs, ints = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr in (("fwd", 6), ("bwd_dkdv", 9), ("bwd_dq", 8)):
            fn = getattr(lib, f"flash_full_{name}_bf16")
            fn.argtypes = [ptrs] * n_ptr + [ints] * 4 + [ctypes.c_float, ptrs]
            fn.restype = ints
        lib.flash_full_bwd_pre_bf16.argtypes = [ptrs] * 3 + [ints] * 3 + [ptrs]
        lib.flash_full_bwd_pre_bf16.restype = ints
        lib.flash_full_error_string.argtypes = [ints]
        lib.flash_full_error_string.restype = ctypes.c_char_p
        _full_lib = lib
    return _full_lib


def _full_launch(what: str, *args) -> None:
    """Launches kernel C's ``what`` kernel (fwd, bwd_pre, bwd_dkdv, bwd_dq)
    and counts it; a refused launch raises."""
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


class _FlashFull(torch.autograd.Function):
    """Kernel C as an autograd function: the forward kernel saves O and the
    row log-sum-exp; the backward recomputes P from them and launches the
    preprocess, dK/dV and dQ kernels. Under activation checkpointing the
    forward runs again inside the backward (and counts again)."""

    @staticmethod
    def forward(ctx, q, k, v, seg):
        B, T, nh, hd = q.shape
        kh = k.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty((B, nh, T), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _full_launch("fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), B, T, nh, kh, 1.0 / math.sqrt(hd), stream)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        _full_check(dout=dout)
        B, T, nh, hd = q.shape
        kh = k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty_like(lse)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr())
        dims = (B, T, nh, kh, 1.0 / math.sqrt(hd), stream)
        _full_launch("bwd_pre", out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                     B, T, nh, stream)
        _full_launch("bwd_dkdv", *inputs, dk.data_ptr(), dv.data_ptr(), *dims)
        _full_launch("bwd_dq", *inputs, dq.data_ptr(), *dims)
        return dq, dk, dv, None


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
    return _FlashFull.apply(q, k, v, _segments(attn_mask, B, T, q.device))
