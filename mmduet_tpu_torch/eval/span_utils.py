"""Temporal-span score utilities shared by the grounding/QVH evaluators.

Semantics match the reference helpers (`test/evaluate.py:102-173`); the
debug-data parser additionally accepts BOTH per-frame score formats the
reference ever emitted (float from the active loop, 2-list from the
deprecated loop — the reference's own evaluator only reads the deprecated
format, SURVEY.md §2.10)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def parse_debug_scores(
    debug_data: Sequence[dict], head: str = "relevance_score"
) -> Tuple[List[float], List[float]]:
    """-> (video_times, scores). Handles 'time'/'video_time' keys and
    float / [p0, p1] score formats."""
    times, scores = [], []
    for e in debug_data:
        times.append(e.get("time", e.get("video_time", 0.0)))
        v = e.get(head, 0.0)
        if isinstance(v, (list, tuple)):
            v = v[1]
        scores.append(float(v))
    return times, scores


def smooth_scores(scores: Sequence[float], window: int) -> List[float]:
    """Symmetric running mean with half-window ``window``."""
    n = len(scores)
    return [
        float(np.mean(scores[max(0, i - window) : min(n, i + window + 1)]))
        for i in range(n)
    ]


def normalize_scores(scores: Sequence[float]) -> List[float]:
    lo, hi = min(scores), max(scores)
    if hi == lo:
        return [0.0 for _ in scores]
    return [(s - lo) / (hi - lo) for s in scores]


def time_in_spans(time: float, spans: Sequence[Sequence[float]]) -> bool:
    return any(s[0] <= time <= s[1] for s in spans)


def frame_iou(
    pred_scores: Sequence[float], gold_mask: Sequence[bool], threshold: float
) -> float:
    """IoU of thresholded per-frame predictions vs a boolean gold mask."""
    pred = [p >= threshold for p in pred_scores]
    inter = sum(p and g for p, g in zip(pred, gold_mask))
    union = sum(p or g for p, g in zip(pred, gold_mask))
    return 0.0 if union == 0 else inter / union


def span_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two [start, end] intervals (SODA convention: union capped at
    sum of lengths, reference `eval_dvc.py:iou`)."""
    s1, e1 = float(min(a)), float(max(a))
    s2, e2 = float(min(b)), float(max(b))
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = min(max(e1, e2) - min(s1, s2), (e1 - s1) + (e2 - s2))
    return inter / (union + 1e-8)


def qvh_to_charades_format(example: dict) -> dict:
    """Derive [start, end] timestamps from QVH saliency annotations
    (clips where max worker score >= 4; reference `evaluate.py:148-163`)."""
    timestamps, start_clip = [], None
    clip_id = None
    for score, clip_id in zip(
        example["answer"]["saliency_scores"], example["answer"]["relevant_clip_ids"]
    ):
        if max(score) < 4:
            if start_clip is not None:
                timestamps.append([clip_id * 2, clip_id * 2])
                start_clip = None
        else:
            if start_clip is None:
                start_clip = clip_id
    if start_clip is not None and clip_id is not None:
        timestamps.append([start_clip * 2, clip_id * 2 + 2])
    out = dict(example)
    out["timestamps"] = timestamps
    return out
