"""Temporal grounding evaluation (Charades-STA protocol).

Reference protocol (`test/evaluate.py:363-408`, `scripts/inference/
charades.sh`): per-frame relevance scores → smooth (window sweep 0-14) →
min-max normalize → binarize at thresholds 0.30..0.70 step 0.02 →
frame-level IoU vs gt spans → mIoU / R@{0.3,0.5,0.7} (+ an oracle
best-threshold row)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .span_utils import (
    frame_iou,
    normalize_scores,
    parse_debug_scores,
    qvh_to_charades_format,
    smooth_scores,
    time_in_spans,
)

THRESHOLDS = np.arange(0.30, 0.71, 0.02)


def _metrics(ious: Sequence[float]) -> List[float]:
    return [
        float(np.mean(ious)) * 100,
        float(np.mean([i >= 0.3 for i in ious])) * 100,
        float(np.mean([i >= 0.5 for i in ious])) * 100,
        float(np.mean([i >= 0.7 for i in ious])) * 100,
    ]


def evaluate_grounding(
    pred_examples: Sequence[dict],
    gold_examples: Sequence[dict],
    smooth_windows: Sequence[int] = range(0, 15),
    score_head: str = "relevance_score",
) -> List[dict]:
    """Returns one record per (smooth_window, threshold) with scores
    [mIoU, R@0.3, R@0.5, R@0.7] (×100), plus an 'oracle' record per window
    (best threshold per example)."""
    if "answer" in gold_examples[0] and isinstance(gold_examples[0]["answer"], dict) \
            and "saliency_scores" in gold_examples[0]["answer"]:
        gold_examples = [qvh_to_charades_format(e) for e in gold_examples]
    gold = {e["question_id"]: e for e in gold_examples}

    results = []
    for window in smooth_windows:
        iou_by_thr = {float(t): [] for t in THRESHOLDS}
        for pred in pred_examples:
            g = gold[pred["question_id"]]
            times, scores = parse_debug_scores(pred["debug_data"], score_head)
            scores = normalize_scores(smooth_scores(scores, window))
            gold_mask = [time_in_spans(t, g["timestamps"]) for t in times]
            for thr in iou_by_thr:
                iou_by_thr[thr].append(frame_iou(scores, gold_mask, thr))

        for thr, ious in iou_by_thr.items():
            results.append(
                {
                    "smooth_window_size": window,
                    "threshold": round(thr, 2),
                    "scores": _metrics(ious),
                }
            )
        oracle = [
            max(iou_by_thr[t][i] for t in iou_by_thr)
            for i in range(len(pred_examples))
        ]
        results.append(
            {
                "smooth_window_size": window,
                "threshold": "oracle",
                "scores": _metrics(oracle),
            }
        )
    return results


def best_result(results: Sequence[dict]) -> dict:
    """Highest-mIoU non-oracle row (the headline number)."""
    rows = [r for r in results if r["threshold"] != "oracle"]
    return max(rows, key=lambda r: r["scores"][0])


def span_iou_inclusive(pred_span, gold_span) -> float:
    """Interval IoU with +1 inclusive endpoints (reference
    `calculate_iou_span`, `test/evaluate.py:139-145` — used only by the
    text-span baseline eval; the streaming path uses frame IoU)."""
    ps, pe = pred_span
    gs, ge = gold_span
    inter = max(0.0, min(pe, ge) - max(ps, gs) + 1)
    union = max(pe, ge) - min(ps, gs) + 1
    return 0.0 if union == 0 else inter / union


def evaluate_grounding_baseline(
    pred_examples: Sequence[dict], gold_examples: Sequence[dict]
) -> List[float]:
    """Grounding eval for OFFLINE baseline outputs (reference
    `evaluate.py:411-428`): extract the two numbers in the generated
    text as a [start, end] span (vtimellm 'from X to Y' percentages are
    scaled by the video length), span-IoU vs the first gt span.
    Examples without exactly two numbers are skipped. Returns
    [mIoU, R@0.3, R@0.5, R@0.7] (x100)."""
    import re

    gold = {e["question_id"]: e for e in gold_examples}
    ious: List[float] = []
    for ex in pred_examples:
        g = gold[ex["question_id"]]
        text = ex["model_response"][0]
        nums = re.findall(r"\d+\.?\d*", text)
        if len(nums) != 2:
            continue
        start, end = float(nums[0]), float(nums[1])
        low = text.lower()
        if "from" in low and "to" in low:  # vtimellm percent format
            length = ex["video_duration"]
            start, end = start / 100 * length, end / 100 * length
        ious.append(span_iou_inclusive((start, end), g["timestamps"][0]))
    return _metrics(ious) if ious else [0.0, 0.0, 0.0, 0.0]
