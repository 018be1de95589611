"""The tolerances that hold each CUDA kernel against its plain version.

The kernel runs on bf16 operands; the plain version runs on the same
values in f32, so what separates them is the kernel's own bf16 rounding
and its order of summation. `chip_smoke.py` and `tests/test_torch_cuda.py`
check the kernels with these bounds; the `*_dropped` helpers build a wrong
plain version that a bound must refuse (the check that it is tight).

**Kernel A**, per output row (one query row of one head, hd values):
``|kernel - plain| <= ROW_REL * max|plain row| + ROW_ABS`` for what rounds
once, at the output: the bf16 output rounding is at most half an ulp,
2^-9 of |x| <= 2^-9 of the row's max; ROW_ABS covers f32 summation in
another order. With a bf16 cache the kernel also rounds every softmax
numerator p to bf16 before its value product (as the Pallas kernel does;
the plain version here keeps p in f32 on f32 operands). That is kernel D's
rounding, and it adds kernel D's term to each element:
``+ 2^-9 * SIGMAS * rms`` with rms = sqrt(sum_s p_s^2 v_s^2) over the
element's visible keys (cache and chunk), from the plain f32 softmax
(`decode_attention_rms`). The kernel's p is the numerator before the
division by l, so its relative rounding error (at most 2^-8, independent
between keys) carries through the division unchanged. A row bound on the
sum of |p v| 2^-8 instead would grow with the cache and let a lost key
tile through; `decode_attention_dropped` is the plain version without a
range of cache slots (a lost key tile or split), which must fail.

**Kernel C**, per element of o, dq, dk, dv:
``|kernel - plain| <= 2^-8 |plain| + 2^-9 * SIGMAS * rms + FULL_ABS``.
Each element is a sum of terms (p v for o, p dO for dv, dS k and dS q for
dq and dk, summed over keys or over query rows and the group's heads). The
kernel rounds one factor of every term to bf16 (p or dS: relative error at
most half an ulp, 2^-8, independent between terms), so the sum's error
has a standard deviation of at most 2^-8 * rms / sqrt(3), rms = sqrt(sum
of squared terms), computed from the plain f32 softmax; 2^-9 * SIGMAS *
rms with SIGMAS = 8 is 6.9 of those. The backward also takes D =
rowsum(dO * O) from the bf16 output O, whose error moves every dS of a row
together: that adds sqrt(sum_d dO^2 (|o| + rms_o)^2) * |sum_s P k| to dq's
rms (one error for the whole row) and P times that root to each dS of
dk's. Half an ulp of the bf16 output adds up to 2^-8 * |plain|. dK and dV
sum over up to T query rows of 7 heads: a bound on the sum of |terms|
would grow with that count and let a lost query tile through, while this
one grows as its square root.

**Kernel D**, per element of o: kernel C's forward bound. Its one bf16
rounding inside the sum is that of p, so the sum's error has the standard
deviation 2^-8 * rms / sqrt(3) with rms = sqrt(sum_s p^2 v^2) over all T
keys; `vision_attention_dropped` is the plain version without one key
tile.

**Kernel A, int8 cache**: the bf16 cache's bound, with the scales in its
rms term. The int8 values are exact in the kernel's bf16 tiles and the K
scale multiplies the f32 scores, but the kernel rounds each scaled
numerator p * v_scale to bf16 before its value product (as the Pallas
kernel's ``(p * vscale).astype(q.dtype)`` does), while the plain version
keeps it in f32. So rms = sqrt(sum_cache p^2 (v_scale v_int)^2 + sum_chunk
p^2 v^2) over the element's visible keys (`decode_attention_rms` with
``k_scale`` / ``v_scale``); `decode_attention_dropped` with the scales is
the plain version without a lost split or key tile, which must fail.

**Kernel B**, per output element:
``|kernel - plain| <= B_REL * sum_h |y_h| |q_h| s_h + B_ABS``. Kernel and
plain version multiply the same values exactly in f32 and differ only in
the order of their f32 sums; an f32 sum of n terms in any blocked order
stays within a few 2^-24 of the sum of the terms' magnitudes in
practice (n 2^-24 at worst). B_REL = 2^-18 leaves that room, and a plain
version that drops one group's scale or swaps the nibble halves misses it
by orders of magnitude (`int4_matmul_mutated`).

**The tower's fused passes** (`ops.vision_fused`): `bias_add3` and
`bias_act` are bit-equal to their plain versions on the same CUDA tensors
(the same f32 operations, each rounded where the eager chain rounds);
`bias_residual_layernorm`'s h_new is bit-equal, and its y, per element:
``|kernel - plain| <= ulp(plain) + LN_ABS_REL * (|xhat * scale| + |shift|)``
(`layernorm_ratio`). The LayerNorm's f32 sums run in another order than
the eager reductions', which moves the mean and 1/std by a few f32 ulps:
the f32 value before the rounding then differs by some 2^-22 of the
terms |xhat * scale| + |shift|, so the two bf16 roundings land at most one
bf16 ulp apart, except where xhat * scale + shift cancels to a value whose
bf16 ulp is below that f32 error (there an output near zero can be tens of
its own ulps off, at an absolute error of 2^-22 of the terms). LN_ABS_REL =
2^-16 gives that term 64 times room; a pass that lost its shift, its scale
or the residual misses the bound by far more.

The second half of the module computes each kernel's roofline bound: the
least time an H100 could take for the call, the larger of the bytes it
must move (each input read once, each output written once) over 3.35
TB/s and its operations over the 989 TFLOP/s bf16 tensor-core peak.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .quant_matmul import grouped_product, unpack_groups

ROW_REL, ROW_ABS = 2.0**-8, 1e-5
SIGMAS, FULL_ABS = 8.0, 1e-5
B_REL, B_ABS = 2.0**-18, 1e-6
LN_ABS_REL = 2.0**-16

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOP_PER_S = 989e12   # dense tensor-core peak, published

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def row_ratio(got: torch.Tensor, want: torch.Tensor, rms: Optional[torch.Tensor] = None) -> float:
    """Kernel A: the largest ``|got - want|`` over its row bound (<= 1
    passes); rows run along the last axis. ``rms``
    (`decode_attention_rms`) adds the term of p's rounding."""
    bound = ROW_REL * want.abs().amax(dim=-1, keepdim=True) + ROW_ABS
    if rms is not None:
        bound = bound + 2.0**-9 * SIGMAS * rms
    return ((got.float() - want).abs() / bound).max().item()


def _cache_values(v_cache, layer, v_scale) -> torch.Tensor:
    """Layer ``layer`` of the cache's V in f32, the int8 values times their
    scales when ``v_scale`` is given."""
    v = v_cache[layer].float()
    return v if v_scale is None else v * v_scale[layer].float()[..., None]


@torch.no_grad()
def decode_probs(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real, layer,
                 q_offset=None, drop_slots: slice = slice(0, 0), k_scale=None):
    """Kernel A's plain softmax in f32, as `attention.attend_split` forms
    it: (p over cache slots (B, kh, g, T, S), p over chunk columns (B, kh,
    g, T, Tc)); ``drop_slots`` masks a range of cache slots as well.
    ``k_scale`` (an int8 cache) scales the cache scores per column."""
    B, T, nh, hd = q.shape
    kc = k_cache[layer].float()
    kh, S, Tc = kc.shape[1], kc.shape[2], chunk_k.shape[2]
    qo = torch.zeros_like(cache_len) if q_offset is None else q_offset
    qr = q.float().reshape(B, T, kh, nh // kh, hd)
    s_cache = torch.einsum("btkgh,bksh->bkgts", qr, kc) / math.sqrt(hd)
    if k_scale is not None:
        s_cache *= k_scale[layer].float()[:, :, None, None, :]
    s_chunk = torch.einsum("btkgh,bkch->bkgtc", qr, chunk_k.float()) / math.sqrt(hd)
    slot = torch.arange(S, device=q.device)
    hidden = (slot[None, :] >= cache_len[:, None]) | (
        (slot >= (drop_slots.start or 0)) & (slot < (drop_slots.stop or 0)))[None]
    s_cache.masked_fill_(hidden[:, None, None, None, :], -1e30)
    col = torch.arange(Tc, device=q.device)[None, None, :]
    row = torch.arange(T, device=q.device)[None, :, None]
    vis = (col <= qo[:, None, None] + row) & (col < t_real[:, None, None])
    s_chunk.masked_fill_(~vis[:, None, None], -1e30)
    p = torch.softmax(torch.cat([s_cache, s_chunk], dim=-1), dim=-1)
    return p[..., :S], p[..., S:]


@torch.no_grad()
def decode_attention_rms(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real, layer,
                         q_offset=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """The rms of kernel A's p-rounding term for every output element,
    (B, T, nh, hd): sqrt(sum over visible keys of p^2 v^2), v the scaled
    values of an int8 cache (``k_scale`` / ``v_scale``)."""
    B, T, nh, hd = q.shape
    p_cache, p_chunk = decode_probs(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real,
                                    layer, q_offset, k_scale=k_scale)
    sq = torch.einsum("bkgts,bksh->btkgh", p_cache.square_(),
                      _cache_values(v_cache, layer, v_scale).square())
    sq += torch.einsum("bkgtc,bkch->btkgh", p_chunk.square_(), chunk_v.float().square())
    return sq.sqrt_().reshape(B, T, nh, hd)


@torch.no_grad()
def decode_attention_dropped(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real, layer,
                             q_offset=None, drop: slice = slice(0, 0), k_scale=None,
                             v_scale=None) -> torch.Tensor:
    """Kernel A's plain output in f32 without the cache slots ``drop`` (a
    kernel that lost a key tile or a split; an empty ``drop`` gives the
    true output), with the scales of an int8 cache if given."""
    B, T, nh, hd = q.shape
    p_cache, p_chunk = decode_probs(q, k_cache, v_cache, chunk_k, chunk_v, cache_len, t_real,
                                    layer, q_offset, drop, k_scale)
    out = torch.einsum("bkgts,bksh->btkgh", p_cache, _cache_values(v_cache, layer, v_scale))
    out += torch.einsum("bkgtc,bkch->btkgh", p_chunk, chunk_v.float())
    return out.reshape(B, T, nh, hd)


@torch.no_grad()
def full_probs(q, k, mask, drop_keys: slice = slice(0, 0)) -> torch.Tensor:
    """Kernel C's plain softmax P (B, kh, g, T, T) in f32; ``drop_keys``
    masks a range of keys as well (a forward that lost a key tile)."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    idx = torch.arange(T, device=q.device)
    vis = (idx[:, None] >= idx[None, :])[None] & (mask[:, :, None] == mask[:, None, :])
    vis[:, :, drop_keys] = False
    s = torch.einsum("btkgh,bskh->bkgts", q.float().reshape(B, T, kh, nh // kh, hd),
                     k.float()) / math.sqrt(hd)
    return torch.softmax(s.masked_fill_(~vis[:, None, None], -1e30), dim=-1)


@torch.no_grad()
def full_attention_rms(q, k, v, mask, dout, out) -> Grads:
    """The rms of kernel C's bound for every element of o, dq, dk, dv
    (``out`` is the kernel's output, standing in for |o|)."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    shape5 = (B, T, kh, nh // kh, hd)
    p = full_probs(q, k, mask)
    qf, kf, vf = q.float().reshape(shape5), k.float(), v.float()
    dof, of = dout.float().reshape(shape5), out.float().reshape(shape5)
    scale = 1.0 / math.sqrt(hd)
    p2 = p.square()
    o = torch.einsum("bkgts,bskh->btkgh", p2, vf.square()).sqrt()
    dv = torch.einsum("bkgts,btkgh->bskh", p2, dof.square()).sqrt()
    del p2
    d_err = (dof.square() * (of.abs() + o).square()).sum(-1).sqrt()  # (B, T, kh, g)
    pk = torch.einsum("bkgts,bskh->btkgh", p, kf).abs()
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)  # (B, kh, g, T)
    ds = torch.einsum("btkgh,bskh->bkgts", dof, vf).sub_(delta[..., None]).mul_(p)
    dq = torch.einsum("bkgts,bskh->btkgh", ds.square(), kf.square()).sqrt()
    dq = (dq + d_err[..., None] * pk) * scale
    u = ds.abs_().add_(p.mul_(d_err.permute(0, 2, 3, 1)[..., None]))
    dk = torch.einsum("bkgts,btkgh->bskh", u.square_(), qf.square()).sqrt() * scale
    return o.reshape(B, T, nh, hd), dq.reshape(B, T, nh, hd), dk, dv


def full_attention_ratio(got: torch.Tensor, want: torch.Tensor, rms: torch.Tensor) -> float:
    """Kernel C: the largest ``|got - want|`` over its element bound (<= 1
    passes)."""
    bound = 2.0**-8 * want.abs() + 2.0**-9 * SIGMAS * rms + FULL_ABS
    return ((got.float() - want).abs() / bound).max().item()


@torch.no_grad()
def full_attention_dropped(q, k, v, mask, dout, tile: slice) -> Grads:
    """Kernel C's plain o, dq, dk, dv in f32, each with one tile left out
    of the sum its kernel's tile loop makes: o is the softmax without keys
    ``tile`` (a forward that skipped a key tile), dq leaves out the terms
    of keys ``tile`` (a dQ kernel that skipped one), dk and dv leave out
    the terms of query rows ``tile`` (a dK/dV kernel that skipped a query
    tile). An empty ``tile`` gives the true gradients."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    shape5 = (B, T, kh, nh // kh, hd)
    qf, kf, vf = q.float().reshape(shape5), k.float(), v.float()
    dof = dout.float().reshape(shape5)
    scale = 1.0 / math.sqrt(hd)
    o_drop = torch.einsum("bkgts,bskh->btkgh", full_probs(q, k, mask, tile), vf)
    p = full_probs(q, k, mask)
    o = torch.einsum("bkgts,bskh->btkgh", p, vf)
    delta = (dof * o).sum(-1).permute(0, 2, 3, 1)  # (B, kh, g, T)
    ds = torch.einsum("btkgh,bskh->bkgts", dof, vf).sub_(delta[..., None]).mul_(p)
    rows = torch.ones(T, device=q.device)
    rows[tile] = 0.0
    dv = torch.einsum("bkgts,btkgh->bskh", p.mul_(rows[:, None]), dof)
    dk = torch.einsum("bkgts,btkgh->bskh", ds * rows[:, None], qf) * scale
    dq = torch.einsum("bkgts,bskh->btkgh", ds.mul_(rows), kf) * scale
    return o_drop.reshape(B, T, nh, hd), dq.reshape(B, T, nh, hd), dk, dv


# ---------------------------------------------------------------------------
# Kernel D
# ---------------------------------------------------------------------------


@torch.no_grad()
def vision_probs(q, k, drop_keys: slice = slice(0, 0)) -> torch.Tensor:
    """Kernel D's plain softmax P (N, nh, T, T) in f32; ``drop_keys`` masks
    a range of keys (a kernel that lost a key tile)."""
    hd = q.shape[-1]
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) / math.sqrt(hd)
    s[..., drop_keys] = -1e30
    return torch.softmax(s, dim=-1)


@torch.no_grad()
def vision_attention_rms(q, k, v) -> torch.Tensor:
    """The rms of kernel D's bound for every element of o, (N, T, nh, hd)."""
    p2 = vision_probs(q, k).square_()
    return torch.einsum("nhqk,nkhd->nqhd", p2, v.float().square()).sqrt()


@torch.no_grad()
def vision_attention_dropped(q, k, v, tile: slice) -> torch.Tensor:
    """Kernel D's plain o in f32 without the keys ``tile`` (an empty
    ``tile`` gives the true output)."""
    return torch.einsum("nhqk,nkhd->nqhd", vision_probs(q, k, tile), v.float())


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------


@torch.no_grad()
def int4_matmul_magnitude(y: torch.Tensor, qw4: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Kernel B: ``sum_h |y_h| |q_h| s_h`` per output element, (R, O) f32."""
    mag = grouped_product(y.float().abs(), unpack_groups(qw4).abs(), qs.float().abs())
    return mag.reshape(-1, mag.shape[-1])


@torch.no_grad()
def int4_matmul_mutated(y: torch.Tensor, qw4: torch.Tensor, qs: torch.Tensor,
                        kind: str) -> torch.Tensor:
    """Kernel B's plain version with one fault: ``"scale"`` leaves the
    middle group's scale out (the group counts unscaled), ``"halves"``
    reads the high nibbles as the first half of every group."""
    q, qs = unpack_groups(qw4), qs.float()
    if kind == "scale":
        qs = qs.clone()
        qs[qs.shape[0] // 2] = 1.0
    else:
        lo, hi = q.chunk(2, dim=1)
        q = torch.cat([hi, lo], dim=1)
    out = grouped_product(y, q, qs)
    return out.reshape(-1, out.shape[-1])


def int4_matmul_ratio(got: torch.Tensor, want: torch.Tensor, magnitude: torch.Tensor) -> float:
    """Kernel B: the largest ``|got - want|`` over its element bound (<= 1
    passes)."""
    bound = B_REL * magnitude + B_ABS
    return ((got.float() - want).abs() / bound).max().item()


# ---------------------------------------------------------------------------
# The tower's fused passes
# ---------------------------------------------------------------------------


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``t`` (f32): 2^(e - 8) for |t| = m
    2^e, m in [0.5, 1); the subnormal step at zero and below."""
    t = t.float()
    _, e = torch.frexp(t)
    e = torch.where(t == 0, torch.full_like(e, -125), e)
    return torch.ldexp(torch.ones_like(t), (e - 8).clamp(min=-133))


@torch.no_grad()
def layernorm_terms(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """``|xhat * scale| + |shift|`` in f32 for every element of the
    LayerNorm of ``h``, xhat = (h - mean) / std: the magnitude of the sum
    that the pass rounds."""
    x = h.float()
    mu = x.mean(-1, keepdim=True)
    xhat = (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + eps)
    return (xhat * scale.float()).abs() + shift.float().abs()


def layernorm_ratio(got: torch.Tensor, want: torch.Tensor, terms: torch.Tensor) -> float:
    """`vision_fused.bias_residual_layernorm`'s y: the largest ``|got -
    want|`` over ``ulp(want) + LN_ABS_REL * terms`` (<= 1 passes)."""
    bound = bf16_ulp(want) + LN_ABS_REL * terms
    return ((got.float() - want.float()).abs() / bound).max().item()


# ---------------------------------------------------------------------------
# Roofline bounds, from shapes: (milliseconds, "bytes" or "operations")
# ---------------------------------------------------------------------------


def _bound(n_bytes: float, flop: float) -> Tuple[float, str]:
    t_bytes, t_flop = n_bytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_flop), "bytes" if t_bytes >= t_flop else "operations"


def decode_attention_bound(B: int, T: int, nh: int, kh: int, hd: int, cache_len: int,
                           t_real: int, q_offset: int = 0, int8: bool = False) -> Tuple[float, str]:
    """Kernel A (``int8``: its int8-cache variant) for B lanes that each
    hold ``cache_len`` live slots and ``t_real`` chunk columns: q and the
    output (bf16), the live K/V slots (bf16, or int8 plus two f32 scales a
    slot), the chunk's visible K/V rows; two products over every visible
    (query, key) pair."""
    seen = sum(min(t_real, q_offset + t + 1) for t in range(T))  # chunk pairs per head
    slot = hd * (1 if int8 else 2) * 2 + (8 if int8 else 0)
    n_bytes = B * (2 * T * nh * hd * 2 + kh * cache_len * slot + kh * t_real * hd * 2 * 2)
    flop = 2 * 2 * hd * B * nh * (T * cache_len + seen)
    return _bound(n_bytes, flop)


def int4_matmul_bound(R: int, H: int, O: int, g: int = 128) -> Tuple[float, str]:
    """Kernel B: the activations (bf16), the packed weight (half a byte a
    value) and its bf16 scales read once, the f32 output written once;
    2 R H O operations."""
    n_bytes = R * H * 2 + H * O // 2 + (H // g) * O * 2 + R * O * 4
    return _bound(n_bytes, 2.0 * R * H * O)


def full_attention_bound(B: int, T: int, nh: int, kh: int, hd: int,
                         backward: bool = False) -> Tuple[float, str]:
    """Kernel C, causal over T rows. Forward: q, k, v read, o and the row
    log-sum-exp written; two products over the T (T + 1) / 2 visible pairs.
    Backward: q, k, v, o, dO and the log-sum-exp read, dq, dk, dv written;
    four products (the recompute of the scores is the kernel's choice and is
    not counted)."""
    pairs = T * (T + 1) // 2
    qo, kv = B * T * nh * hd * 2, B * T * kh * hd * 2
    if backward:
        n_bytes = 3 * qo + 2 * kv + B * nh * T * 4 + qo + 2 * kv
        return _bound(n_bytes, 4 * 2.0 * hd * B * nh * pairs)
    n_bytes = 2 * qo + 2 * kv + B * nh * T * 4
    return _bound(n_bytes, 2 * 2.0 * hd * B * nh * pairs)


def vision_attention_bound(N: int, T: int, nh: int, hd: int) -> Tuple[float, str]:
    """Kernel D: q, k, v read and o written once (bf16); two products over
    all T x T (query, key) pairs of every head."""
    return _bound(4 * N * T * nh * hd * 2, 2 * 2.0 * hd * N * nh * T * T)


def bias_add3_bound(rows: int, width: int) -> Tuple[float, str]:
    """`vision_fused.bias_add3`: q, k, v (rows, width) read and written once,
    their three biases read once (bf16)."""
    return _bound(3 * (2 * rows * width + width) * 2, 0.0)


def residual_layernorm_bound(rows: int, width: int, bias: bool = True, residual: bool = True,
                             norm: bool = True) -> Tuple[float, str]:
    """`vision_fused.bias_residual_layernorm`: p (and h) read, h_new (when
    a bias or a residual makes it new) and y (with the LayerNorm) written,
    the bias and the LayerNorm's scale and shift read once (bf16)."""
    rows_io = 1 + residual + (bias or residual) + norm
    return _bound((rows_io * rows * width + (bias + 2 * norm) * width) * 2, 0.0)


def bias_act_bound(rows: int, width: int) -> Tuple[float, str]:
    """`vision_fused.bias_act`: fc1's product read and the activation
    written once, the bias read once (bf16)."""
    return _bound((2 * rows * width + width) * 2, 0.0)
