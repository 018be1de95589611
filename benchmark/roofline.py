"""Roofline arithmetic: the least time one H100 could take for a piece of
work, from its shapes.

Frozen copy of the roofline half of `mmduet_tpu_torch/ops/bounds.py` at
commit 71a961d (`_bound`, `decode_attention_bound`, `int4_matmul_bound`,
`vision_attention_bound` and the two published peaks), kept here so that a
change to the program cannot move the yardstick. Two changes from the
original: each function returns the (bytes, operations) it counts, so
that work over many calls sums before one bound is taken, and kernel B's
output counts at 2 bytes, the bf16 that the next layer reads (the
original counts the kernel's f32 output). Each input byte is read once
and each output byte written once; the operations are those the inputs
need.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOP_PER_S = 989e12   # dense tensor-core peak, published

Work = Tuple[float, float]  # (bytes, operations)


def least_s(work: Work) -> float:
    """The larger of the bytes over the bandwidth and the operations over
    the bf16 peak, in seconds."""
    n_bytes, flop = work
    return max(n_bytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S)


def add(works: Iterable[Work]) -> Work:
    b = f = 0.0
    for wb, wf in works:
        b += wb
        f += wf
    return b, f


def decode_attention(lanes: Iterable[Tuple[int, int]], nh: int, kh: int, hd: int,
                     int8: bool = False) -> Work:
    """Kernel A's work in one layer for lanes of (``cache_len`` live slots,
    ``t`` chunk rows): q and the output (bf16), the live K/V slots (bf16,
    or int8 and two f32 scales a slot), the chunk's K/V (bf16); two
    products over every visible (query, key) pair."""
    slot = hd * (1 if int8 else 2) * 2 + (8 if int8 else 0)
    n_bytes = flop = 0.0
    for cache_len, t in lanes:
        seen = t * (t + 1) // 2  # causal pairs inside the chunk, per head
        n_bytes += 2 * t * nh * hd * 2 + kh * cache_len * slot + kh * t * hd * 2 * 2
        flop += 2 * 2 * hd * nh * (t * cache_len + seen)
    return n_bytes, flop


def int4_matmul(R: int, H: int, O: int, g: int = 128) -> Work:
    """Kernel B: the activations (bf16), the packed weight (half a byte a
    value) and its bf16 scales read once, the output written once as the
    bf16 the next layer reads; 2 R H O operations."""
    return R * H * 2 + H * O // 2 + (H // g) * O * 2 + R * O * 2, 2.0 * R * H * O


def vision_attention(N: int, T: int, nh: int, hd: int) -> Work:
    """Kernel D: q, k, v read and o written once (bf16); two products over
    all T x T (query, key) pairs of every head."""
    return 4 * N * T * nh * hd * 2, 2 * 2.0 * hd * N * nh * T * T
