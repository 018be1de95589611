"""Model operations that served traffic needs, counted from shapes (the
pattern of `chip_smoke._train_flops` at commit 71a961d, for serving).

Two operations a multiply-add. Counted: the tower for every frame encoded
(the patch embedding, each layer that runs up to the selected one, its
attention over all patch pairs) and the projector; the decoder for every
token fed (its seven projections, and attention over the keys each token
sees); the score heads at every frame scored; the LM head at every row
whose logits are read (a decode's prompt and each of its steps). Left
out: norms, activations, RoPE, the pooling (under 0.1 % of a frame) and
whatever padding or frozen lanes add, which the traffic does not need.
"""

from __future__ import annotations

from .model_shapes import Shapes


def decoder_token(s: Shapes) -> float:
    """The decoder's projections for one token (attention apart)."""
    layer = s.hidden * s.q_dim + 2 * s.hidden * s.kv_dim + s.q_dim * s.hidden
    layer += 3 * s.hidden * s.intermediate
    return 2.0 * s.layers * layer


def attention(s: Shapes, cache_len: int, t: int) -> float:
    """A chunk of ``t`` tokens after ``cache_len`` committed ones, every
    layer: QK and PV over each visible (query, key) pair."""
    pairs = t * cache_len + t * (t + 1) // 2
    return 2 * 2.0 * s.head_dim * s.heads * pairs * s.layers


def chunk(s: Shapes, cache_len: int, t: int) -> float:
    return t * decoder_token(s) + attention(s, cache_len, t)


def lm_head_row(s: Shapes) -> float:
    return 2.0 * s.hidden * s.vocab


def score_heads_frame(s: Shapes) -> float:
    return 2 * 2.0 * s.hidden * 2


def vision_frame(s: Shapes) -> float:
    """The tower up to its selected layer and the projector, one frame."""
    T, C, I = s.v_patches, s.v_hidden, s.v_intermediate
    layer = 2.0 * T * (4 * C * C + 2 * C * I) + 2 * 2.0 * T * T * C
    patch = 2.0 * T * 3 * s.patch ** 2 * C
    projector = 2.0 * T * (C * s.hidden + s.hidden * s.hidden)
    return s.v_used_layers * layer + patch + projector
