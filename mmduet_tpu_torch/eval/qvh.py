"""QVHighlights metrics: HL-mAP / HL-Hit@1 and moment-retrieval mAP / R@1.

Metric definitions follow the official moment_detr evaluation the
reference vendors (`test/qvh/eval.py:222-246`, `test/qvh/utils.py:169-209`;
moment retrieval: `test/qvh/eval.py:19-153`, `test/qvh/utils.py:64-166`):

- gt saliency: per-2s-clip scores from 3 workers in [0,4]; binarized at
  min score Fair(2)/Good(3)/VeryGood(4);
- HL-Hit@1: does the top-scored predicted clip hit a positive clip
  (max over the 3 workers), averaged over queries;
- HL-mAP: interpolated AP of predicted clip scores vs each worker's binary
  labels, averaged over workers and queries.

The AP here recomputes sklearn's precision_recall_curve in plain numpy
(descending-score cut points) with the same interpolation + "precision at
each newly recalled sample" averaging.

The MMDuet prediction path (`test/evaluate.py:308-345`): per-frame
relevance scores → smooth (window sweep) → sum into 2-second clip scores.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .span_utils import parse_debug_scores, smooth_scores


def _precision_recall_curve(y_true: np.ndarray, y_score: np.ndarray):
    order = np.argsort(-y_score, kind="stable")
    y_true = y_true[order]
    tp = np.cumsum(y_true)
    # group ties: keep only the last index of each distinct score
    scores_sorted = y_score[order]
    distinct = np.r_[np.nonzero(np.diff(scores_sorted))[0], len(scores_sorted) - 1]
    tp = tp[distinct]
    fp = (distinct + 1) - tp
    total_pos = y_true.sum()
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / max(total_pos, 1)
    # sklearn returns the curve in ascending-threshold order with a final
    # (precision=1, recall=0) point appended — replicate exactly, because
    # the reference's forward max-interpolation depends on this ordering
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return precision, recall


def average_precision(y_true: Sequence[float], y_score: Sequence[float]) -> float:
    """Interpolated AP (video2gif / moment_detr convention)."""
    y_true = np.asarray(y_true, float)
    y_score = np.asarray(y_score, float)
    uniq = set(y_true.tolist())
    if uniq == {0.0}:
        return 0.0
    if uniq == {1.0}:
        return 1.0
    precision, recall = _precision_recall_curve(y_true, y_score)
    # curves above are in descending-threshold order like sklearn's output
    for i in range(1, len(precision)):
        precision[i] = max(precision[i - 1], precision[i])
    idx = np.where(np.diff(recall))[0]
    return float(np.mean(precision[idx]))


def mk_gt_scores(gt: dict, clip_length: float = 2.0) -> np.ndarray:
    ids = np.array(gt["relevant_clip_ids"])
    num_clips = int(gt["duration"] / clip_length)
    if len(ids) and int(ids.max()) >= num_clips:
        # the reference would IndexError here (`test/qvh/utils.py`); we
        # grow the clip axis instead, but LOUDLY — a grown axis changes
        # the AP denominator, so malformed gold must be visible
        import warnings

        warnings.warn(
            f"qid={gt.get('qid')}: relevant_clip_ids up to {int(ids.max())} "
            f"exceed duration/{clip_length}={num_clips} clips; growing the "
            "clip axis (malformed gold annotation?)",
            stacklevel=2,
        )
        num_clips = int(ids.max()) + 1
    full = np.zeros((num_clips, 3))
    full[ids] = np.array(gt["saliency_scores"])
    return full


def eval_highlight(
    submission: Sequence[dict], ground_truth: Sequence[dict]
) -> Dict[str, Dict[str, float]]:
    qid2pred = {d["qid"]: np.array(d["pred_saliency_scores"], float) for d in submission}
    qid2gt = {d["qid"]: mk_gt_scores(d) for d in ground_truth}
    out = {}
    for min_score, name in zip((2, 3, 4), ("Fair", "Good", "VeryGood")):
        hits = np.zeros((len(qid2pred), 3))
        aps = np.zeros((len(qid2pred), 3))
        for i, (qid, pred) in enumerate(qid2pred.items()):
            gt_bin = (qid2gt[qid] >= min_score).astype(float)  # (#clips, 3)
            top = int(np.argmax(pred))
            if top < len(gt_bin):
                hits[i] = gt_bin[top]
            for w in range(3):
                y_true = gt_bin[:, w]
                y_pred = pred
                if len(y_true) < len(y_pred):
                    y_pred = y_pred[: len(y_true)]
                elif len(y_true) > len(y_pred):
                    y_pred = np.r_[y_pred, np.zeros(len(y_true) - len(y_pred))]
                aps[i, w] = average_precision(y_true, y_pred)
        out[f"HL-min-{name}"] = {
            "HL-mAP": float(f"{100 * aps.mean():.2f}"),
            "HL-Hit1": float(f"{100 * hits.max(1).mean():.2f}"),
        }
    return out


# ---------------------------------------------------------------------------
# Moment retrieval (mAP over IoU 0.5:0.05:0.95 + R@1) — the half of the
# official QVH evaluation MMDuet itself never emits predictions for
# (`test/inference.py` produces saliency only), provided so submissions in
# the official `pred_relevant_windows` format evaluate identically here.
# Reference: `test/qvh/eval.py:19-153`, `test/qvh/utils.py:64-166`.
# ---------------------------------------------------------------------------

MR_IOU_THDS = tuple(float(f"{t:.2f}") for t in np.linspace(0.5, 0.95, 10))


def temporal_iou_cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise span IoU, (N,2) x (M,2) -> (N,M). Degenerate unions give 0
    only when the intersection is 0 too (matches the reference's plain
    divide, which yields nan there only if both spans are empty AND equal —
    excluded by construction upstream)."""
    inter = np.clip(
        np.minimum(a[:, None, 1], b[None, :, 1])
        - np.maximum(a[:, None, 0], b[None, :, 0]),
        0, None,
    )
    union = (
        (a[:, 1] - a[:, 0])[:, None] + (b[:, 1] - b[:, 0])[None, :] - inter
    )
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)
    return iou


def _voc_interpolated_ap(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-2011 interpolated AP (`test/qvh/utils.py:64-80`)."""
    mprec = np.r_[0.0, precision, 0.0]
    mrec = np.r_[0.0, recall, 1.0]
    # forward-fill precision from the right (running max)
    mprec = np.maximum.accumulate(mprec[::-1])[::-1]
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def detection_ap(
    gt_windows: np.ndarray,  # (G, 2)
    pred_windows: np.ndarray,  # (P, 2) already sorted by descending score
    iou_thds: Sequence[float] = MR_IOU_THDS,
) -> np.ndarray:
    """Single-query detection AP with greedy gt locking
    (`test/qvh/utils.py:83-166`, simplified: one query = one video-id)."""
    n_thd, n_gt, n_pred = len(iou_thds), len(gt_windows), len(pred_windows)
    ap = np.zeros(n_thd)
    if n_pred == 0:
        return ap
    if n_gt == 0:
        # the reference divides by num_positive == 0 here (nan); real QVH
        # gold always has windows, and range filtering removes empty ones
        return ap
    iou = temporal_iou_cross(pred_windows, gt_windows)  # (P, G)
    # best gt first per pred; argsort()[::-1] like the reference so exact
    # IoU ties resolve to the same gt index (`test/qvh/utils.py:140`)
    order = np.argsort(iou, axis=1)[:, ::-1]
    tp = np.zeros((n_thd, n_pred))
    for t, thd in enumerate(iou_thds):
        locked = np.zeros(n_gt, bool)
        for p in range(n_pred):
            for g in order[p]:
                if iou[p, g] < thd:
                    break  # descending: no later gt can match either
                if locked[g]:
                    continue
                tp[t, p] = 1.0
                locked[g] = True
                break
    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(1.0 - tp, axis=1)
    recall = tp_cum / n_gt
    precision = tp_cum / (tp_cum + fp_cum)
    for t in range(n_thd):
        ap[t] = _voc_interpolated_ap(precision[t], recall[t])
    return ap


def compute_mr_ap(
    submission: Sequence[dict], ground_truth: Sequence[dict],
    iou_thds: Sequence[float] = MR_IOU_THDS, max_pred_windows: int = 10,
) -> Dict[str, float]:
    """mAP over queries; per query: detection AP over its (<=10 top) predicted
    windows vs its gt windows (`test/qvh/eval.py:19-70`)."""
    gt_by_qid = {d["qid"]: np.asarray(d["relevant_windows"], float).reshape(-1, 2)
                 for d in ground_truth}
    ap_rows = []
    for d in submission:
        wins = np.asarray(d["pred_relevant_windows"], float).reshape(-1, 3)
        if max_pred_windows is not None:
            wins = wins[:max_pred_windows]
        # stable sort by descending score, like the reference's list.sort
        wins = wins[np.argsort(-wins[:, 2], kind="stable")]
        ap_rows.append(detection_ap(
            gt_by_qid.get(d["qid"], np.zeros((0, 2))), wins[:, :2], iou_thds
        ))
    ap_thds = np.mean(ap_rows, axis=0) if ap_rows else np.zeros(len(iou_thds))
    out = {str(t): float(f"{100 * v:.2f}") for t, v in zip(iou_thds, ap_thds)}
    out["average"] = float(f"{100 * np.mean(ap_thds):.2f}")
    return out


def compute_mr_r1(
    submission: Sequence[dict], ground_truth: Sequence[dict],
    iou_thds: Sequence[float] = MR_IOU_THDS,
) -> Dict[str, float]:
    """R@1: IoU of the TOP predicted window vs the best-matching gt window
    (`test/qvh/eval.py:73-98`)."""
    # a query with no predicted moments scores IoU 0 (a miss at every
    # threshold) instead of crashing the standalone evaluator
    pred_top = {d["qid"]: np.asarray(d["pred_relevant_windows"][0][:2], float)
                for d in submission if len(d["pred_relevant_windows"])}
    empty_qids = [d["qid"] for d in submission
                  if not len(d["pred_relevant_windows"])]
    ious = {}
    for d in ground_truth:
        qid = d["qid"]
        if qid not in pred_top:
            continue
        gts = np.asarray(d["relevant_windows"], float).reshape(-1, 2)
        iou_row = temporal_iou_cross(pred_top[qid][None, :], gts)[0]
        ious[qid] = float(iou_row.max()) if len(iou_row) else 0.0
    gt_qids = {d["qid"] for d in ground_truth}
    vals = np.array(
        [ious[q] for q in pred_top if q in ious]
        + [0.0 for q in empty_qids if q in gt_qids]
    )
    return {
        str(t): float(f"{np.mean(vals >= t) * 100:.2f}") if len(vals) else 0.0
        for t in iou_thds
    }


_MR_LENGTH_RANGES = {
    "short": (0, 10), "middle": (10, 30), "long": (30, 150), "full": (0, 150)
}


def _filter_by_gt_window_length(
    submission: Sequence[dict], ground_truth: Sequence[dict],
    len_range: tuple,
):
    """Keep gt windows with length in (min, max] and only the submissions
    whose qid still has gt (`test/qvh/eval.py:104-133`)."""
    lo, hi = len_range
    if (lo, hi) == (0, 150):  # dataset-wide bounds: identity
        return list(submission), list(ground_truth)
    gt_out, kept_qids = [], set()
    for d in ground_truth:
        wins = [w for w in d["relevant_windows"] if lo < w[1] - w[0] <= hi]
        if wins:
            gt_out.append({**d, "relevant_windows": wins})
            kept_qids.add(d["qid"])
    return [d for d in submission if d["qid"] in kept_qids], gt_out


def eval_moment_retrieval(
    submission: Sequence[dict], ground_truth: Sequence[dict],
    verbose: bool = False,
) -> Dict[str, dict]:
    """Per-length-range MR-mAP + MR-R1 (`test/qvh/eval.py:136-153`)."""
    out = {}
    for name, rng in _MR_LENGTH_RANGES.items():
        sub, gt = _filter_by_gt_window_length(submission, ground_truth, rng)
        if verbose:
            print(f"{name}: {list(rng)}, {len(gt)}/{len(ground_truth)} examples.")
        out[name] = {
            "MR-mAP": compute_mr_ap(sub, gt),
            "MR-R1": compute_mr_r1(sub, gt),
        }
    return out


def eval_submission(
    submission: Sequence[dict], ground_truth: Sequence[dict],
    match_number: bool = True,
) -> Dict:
    pred_qids = {e["qid"] for e in submission}
    gt_qids = {e["qid"] for e in ground_truth}
    if match_number:
        assert pred_qids == gt_qids
    else:
        shared = pred_qids & gt_qids
        submission = [e for e in submission if e["qid"] in shared]
        ground_truth = [e for e in ground_truth if e["qid"] in shared]
    brief: Dict[str, float] = {}
    out: Dict[str, dict] = {}
    if submission and "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(submission, ground_truth)
        out.update(mr)
        brief.update(sorted({
            "MR-full-mAP": mr["full"]["MR-mAP"]["average"],
            "MR-full-mAP@0.5": mr["full"]["MR-mAP"]["0.5"],
            "MR-full-mAP@0.75": mr["full"]["MR-mAP"]["0.75"],
            "MR-short-mAP": mr["short"]["MR-mAP"]["average"],
            "MR-middle-mAP": mr["middle"]["MR-mAP"]["average"],
            "MR-long-mAP": mr["long"]["MR-mAP"]["average"],
            "MR-full-R1@0.5": mr["full"]["MR-R1"]["0.5"],
            "MR-full-R1@0.7": mr["full"]["MR-R1"]["0.7"],
        }.items()))
    if submission and "pred_saliency_scores" in submission[0]:
        hl = eval_highlight(submission, ground_truth)
        out.update(hl)
        brief.update(
            (f"{k}-{sub.split('-')[1]}", v[sub]) for k, v in hl.items() for sub in v
        )
    return {"brief": brief, **out}


def preds_to_saliency(
    pred_examples: Sequence[dict], smooth_window: int,
    score_head: str = "relevance_score",
) -> List[dict]:
    """Per-frame scores → 2-sec clip saliency sums (reference
    `evaluate.py:317-330`)."""
    out = []
    for ex in pred_examples:
        times, scores = parse_debug_scores(ex["debug_data"], score_head)
        if len(times) < 2:
            continue
        frame_interval = times[1] - times[0]
        per_clip = max(1, int(round(2.0 / frame_interval)))
        scores = smooth_scores(scores, smooth_window)
        saliency = [
            float(sum(scores[i : i + per_clip]))
            for i in range(0, len(scores), per_clip)
        ]
        out.append({"qid": ex["question_id"], "pred_saliency_scores": saliency})
    return out


def evaluate_qvh(
    pred_examples: Sequence[dict], gold_examples: Sequence[dict],
    smooth_windows: Sequence[int] = range(0, 15),
) -> List[dict]:
    results = []
    for window in smooth_windows:
        sub = preds_to_saliency(pred_examples, window)
        res = eval_submission(sub, gold_examples, match_number=False)
        results.append({"smooth_window_size": window, "results": res})
    return results


def _main() -> None:
    """Standalone evaluator for official-format QVH submission JSONL
    (same CLI contract as the reference's `test/qvh/eval.py:326-344`)."""
    import argparse
    import json

    p = argparse.ArgumentParser(description="QVHighlights evaluation")
    p.add_argument("--submission_path", required=True)
    p.add_argument("--gt_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--not_verbose", action="store_true")
    args = p.parse_args()

    def load_jsonl(path):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    results = eval_submission(load_jsonl(args.submission_path),
                              load_jsonl(args.gt_path))
    if not args.not_verbose:
        print(json.dumps(results, indent=4))
    with open(args.save_path, "w") as f:
        f.write(json.dumps(results, indent=4))


if __name__ == "__main__":  # pragma: no cover - exercised via CLI test
    _main()
