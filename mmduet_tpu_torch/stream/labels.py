"""Label construction for the duet training objective.

Three label streams per example (reference semantics, with the
informative/relevance key-name bug of the reference fixed — see
SURVEY.md §2.10(1)):

1. **LM labels** — next-token targets over ``learn: True`` assistant spans,
   PRE-SHIFTED so `labels[i]` is the target for the logit at position `i`
   (reference `data/data_collator.py:29-35`).
2. **informative labels** — one 0/1/-100 per frame: the last
   ``response_frame_num`` frames before a learned assistant turn get 1
   (reference `data/stream.py:119-135`).
3. **relevance labels** — one 0/1/-100 per frame from ``related`` spans
   (reference `data/stream.py:137-146`).

Per-frame labels attach to the token position of the LAST ``<image>`` token
of each frame (reference `data/data_collator.py:37-42`), i.e. the position
whose hidden state the score heads read during streaming.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100


def get_informative_labels(conversation: Sequence[dict]) -> List[int]:
    """Per-frame informative (0/1) labels; -100 for un-learned streams."""
    labels: List[int] = []
    for i, turn in enumerate(conversation):
        if turn.get("role") != "stream" or turn.get("num_frames", 0) <= 0:
            continue
        n = turn["num_frames"]
        if turn.get("learn"):
            if i != len(conversation) - 1:
                nxt = conversation[i + 1]
                response_frame_num = nxt.get("response_frame_num", 1)
                next_is_assistant = nxt.get("role") == "assistant"
            else:
                response_frame_num = 1
                next_is_assistant = False
            # faithful to the reference (`stream.py:119-135`) including
            # its quirk: response_frame_num > num_frames yields MORE
            # labels than frames ([0]*negative == []); dataset builders
            # derive response_frame_num <= num_frames by construction
            labels += [0] * (n - response_frame_num)
            labels += [int(next_is_assistant)] * response_frame_num
        else:
            labels += [IGNORE_INDEX] * n
    return labels


def get_relevance_labels(conversation: Sequence[dict]) -> List[int]:
    """Per-frame relevance (0/1) labels from per-span ``related`` info."""
    labels: List[int] = []
    for turn in conversation:
        if turn.get("role") != "stream" or turn.get("num_frames", 0) <= 0:
            continue
        if turn.get("learn"):
            for span in turn["related"]:
                labels += [int(span["related"])] * span["num_frames"]
        else:
            labels += [IGNORE_INDEX] * turn["num_frames"]
    return labels


def char_ranges_to_token_labels(
    input_ids: np.ndarray,
    offsets: Sequence[Tuple[int, int]],
    learn_ranges: Sequence[range],
    strict: bool = False,
) -> np.ndarray:
    """Convert char learn-ranges into pre-shifted LM label vector.

    For each range, find the token whose char span STARTS at ``range.start``
    and the token starting at ``range.stop`` (or end-of-sequence for the
    final eos), then write ``labels[start-1:stop-1] = ids[start:stop]`` —
    the pre-shift contract of reference `data_collator.py:29-35`.

    BPE can merge a range boundary into a neighboring token (e.g. an
    assistant message starting with a newline glues onto the header's
    trailing ``\\n``, forming one multi-char token). The reference
    crashes on that (`data_collator.py:30` ``.item()`` on an empty
    match); here, unless ``strict``, the boundary snaps to the token
    CONTAINING the offset, so the span covers at most one extra merged
    token instead of killing the batch.
    """
    ids = np.asarray(input_ids)
    labels = np.full_like(ids, IGNORE_INDEX)
    starts = np.array([o[0] for o in offsets])
    ends = np.array([o[1] for o in offsets])

    def token_starting_at(pos: int, what: str) -> int:
        (idx,) = np.nonzero(starts == pos)
        if idx.size >= 1:
            return int(idx[0])
        if strict:
            raise ValueError(
                f"learn range {what} {pos} does not align with a token boundary"
            )
        # boundary merged by BPE: snap to the token containing `pos`
        (cover,) = np.nonzero((starts < pos) & (ends > pos))
        if cover.size == 0:
            raise ValueError(f"learn range {what} {pos} is outside the text")
        return int(cover[0])

    for r in learn_ranges:
        start = token_starting_at(r.start, "start")
        if starts[-1] >= r.stop:
            stop = token_starting_at(r.stop, "stop")
        else:  # range ends at the very last token (its trailing eos)
            stop = len(ids)
        labels[start - 1 : stop - 1] = ids[start:stop]
    return labels


def frame_label_positions(
    input_ids: np.ndarray, v_placeholder_id: int, frame_num_tokens: int
) -> np.ndarray:
    """Token index of the LAST ``<image>`` token of each frame."""
    (v_pos,) = np.nonzero(np.asarray(input_ids) == v_placeholder_id)
    return v_pos[frame_num_tokens - 1 :: frame_num_tokens]


def scatter_frame_labels(
    input_ids: np.ndarray,
    v_placeholder_id: int,
    frame_num_tokens: int,
    frame_labels: Optional[Sequence[int]],
) -> np.ndarray:
    """Expand per-frame labels to a per-token vector (-100 elsewhere)."""
    ids = np.asarray(input_ids)
    out = np.full_like(ids, IGNORE_INDEX)
    if frame_labels is None:
        return out
    pos = frame_label_positions(ids, v_placeholder_id, frame_num_tokens)
    fl = np.asarray(list(frame_labels), dtype=ids.dtype)
    if len(pos) != len(fl):
        raise ValueError(f"{len(fl)} frame labels for {len(pos)} frames in text")
    out[pos] = fl
    return out
