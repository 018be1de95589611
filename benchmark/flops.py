"""Model operations that served traffic needs, counted from shapes (the
pattern of `chip_smoke._train_flops` at commit 71a961d, for serving): the
counts every decoder architecture shares. An architecture
(``benchmark/arch/<architecture>.py``) counts its decoder's chunk and takes
these, or its own, for the rest.

Two operations a multiply-add. Counted: the tower for every frame encoded
(the patch embedding, each layer that runs up to the selected one, its
attention over all patch pairs) and the projector; the score heads at
every frame scored; the LM head at every row whose logits are read (a
decode's prompt and each of its steps). Left out: norms, activations, the
pooling (under 0.1 % of a frame) and whatever padding or frozen lanes add,
which the traffic does not need.
"""

from __future__ import annotations

from .model_shapes import Shapes


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
