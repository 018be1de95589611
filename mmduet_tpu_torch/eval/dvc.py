"""Dense video captioning evaluation (YouCook2 protocol).

Reimplements the reference's vendored evaluator (`test/dvc/eval_dvc.py`,
itself from SODA/vid2seq lineage) without Java dependencies:

- detection precision/recall over IoU {0.3, 0.5, 0.7, 0.9};
- caption metrics (CIDEr, METEOR) over IoU-matched (pred, gt) caption
  pairs, with random-string negatives for unmatched predictions;
- SODA_c: DP alignment maximizing IoU-gated caption similarity
  (`chased_dp_assignment` per github.com/fujiso/SODA);
- paragraph-level CIDEr/METEOR.

Entry: :func:`eval_dense_captioning` (in-memory) /
:func:`merge_response_segments` (engine JSONL → timed caption segments,
reference `test/evaluate.py:437-450`)."""

from __future__ import annotations

import random
import re
import string
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .captioning import Cider, make_meteor, make_ptb_tokenizer, ptb_tokenize
from .span_utils import span_iou

IOU_THRESHOLDS = (0.3, 0.5, 0.7, 0.9)


def merge_response_segments(model_response_list: Sequence[dict]) -> List[dict]:
    """Merge consecutive identical assistant responses into
    {'timestamp': [start, end], 'caption': text} segments."""
    captions, prev, start, end = [], None, None, None
    for turn in model_response_list:
        if turn["role"] == "user":
            continue
        if turn["content"] != prev:
            if start is not None:
                captions.append({"timestamp": [start, end], "caption": prev})
            prev, start, end = turn["content"], end, turn["time"]
        else:
            end = turn["time"]
    if start is not None:
        captions.append({"timestamp": [start, end], "caption": prev})
    return captions


def _random_string() -> str:
    return "".join(random.choice(string.ascii_lowercase) for _ in range(random.randint(10, 20)))


def chased_dp_assignment(scores: np.ndarray) -> Tuple[float, List[Tuple[int, int]]]:
    """Monotone DP matching maximizing total score (SODA)."""
    m, n = scores.shape
    dp = np.full((m, n), -1.0)
    path = np.zeros((m, n), int)
    for i in range(m):
        for j in range(n):
            # reference transition table, exactly:
            if i == 0 and j == 0:
                cands = [-1, -1, scores[i, j]]
            elif i == 0:
                cands = [-1, dp[i, j - 1], scores[i, j]]
            elif j == 0:
                cands = [dp[i - 1, j], -1, scores[i, j]]
            else:
                cands = [dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1] + scores[i, j]]
            dp[i, j] = max(cands)
            path[i, j] = int(np.argmax(cands))

    # iterative backtrack over the choice matrix: 0 = drop reference row,
    # 1 = drop candidate column, 2 = match (i, j) and step diagonally
    pairs: List[Tuple[int, int]] = []
    i, j = m - 1, n - 1
    while i >= 0 and j >= 0:
        move = path[i, j]
        if move == 2:
            pairs.append((i, j))
            i -= 1
            j -= 1
        elif move == 0:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    return float(dp[m - 1, n - 1]), pairs


def evaluate_detections(
    pred_segments: np.ndarray, gt_segments: np.ndarray
) -> Tuple[List[float], List[float], np.ndarray]:
    """(precision per IoU thr, recall per IoU thr, iou_matrix)."""
    n_pred = len(pred_segments)
    n_gt = len(gt_segments)
    iou_matrix = np.zeros((n_gt, max(n_pred, 1)))
    covered = {t: (set(), set()) for t in IOU_THRESHOLDS}
    for ig, g in enumerate(gt_segments):
        for ip, p in enumerate(pred_segments):
            s = span_iou(p, g)
            iou_matrix[ig, ip] = s
            for t in IOU_THRESHOLDS:
                if s > t:
                    covered[t][0].add(ip)
                    covered[t][1].add(ig)
    precision = [len(covered[t][0]) / max(float(n_pred), 1.0) for t in IOU_THRESHOLDS]
    recall = [len(covered[t][1]) / max(float(n_gt), 1.0) for t in IOU_THRESHOLDS]
    return precision, recall, iou_matrix


def match_captions(
    pred_segments, gt_segments, pred_captions, gt_captions
) -> Tuple[Dict, Dict]:
    """Per threshold: {key: [gt_caption]} / {key: [pred_caption]} pairs;
    unmatched predictions pair with a random string (zero score)."""
    gts = {t: {} for t in IOU_THRESHOLDS}
    preds = {t: {} for t in IOU_THRESHOLDS}
    isx = 0
    for ip, pseg in enumerate(pred_segments):
        added = {t: False for t in IOU_THRESHOLDS}
        for ig, gseg in enumerate(gt_segments):
            s = span_iou(pseg, gseg)
            for t in IOU_THRESHOLDS:
                if s >= t:
                    gts[t][str(isx)] = [gt_captions[ig]]
                    preds[t][str(isx)] = [pred_captions[ip]]
                    isx += 1
                    added[t] = True
        for t in IOU_THRESHOLDS:
            if not added[t]:
                gts[t][str(isx)] = [_random_string()]
                preds[t][str(isx)] = [pred_captions[ip]]
                isx += 1
    return gts, preds


def sodac(
    iou_matrix: np.ndarray,
    scorer,
    pred_captions: Sequence[str],
    gt_captions: Sequence[str],
    iou_threshold: float = 0.0,
) -> float:
    """SODA_c F1 for one video.

    NOTE the scorer argument order: SODA (and the reference's vendored
    copy, `eval_dvc.py:334-335`) scores each GT caption as the
    HYPOTHESIS against the predictions as references —
    ``compute_score(res, gt)`` — the reverse of the matched-pair caption
    metrics. METEOR is asymmetric, so this order is part of the
    protocol."""
    if not len(pred_captions):
        return 0.0
    res = {str(i): [p] for i, p in enumerate(pred_captions)}
    score_rows = []
    for g in gt_captions:
        gt_as_hyp = {k: [g] for k in res}
        _, per_item = scorer.compute_score(res, gt_as_hyp)
        score_rows.append(np.nan_to_num(per_item))
    score_matrix = np.array(score_rows)  # (n_gt, n_pred)
    iou_cur = np.where(iou_matrix < iou_threshold, 0.0, iou_matrix)
    max_score, _ = chased_dp_assignment(iou_cur * score_matrix)
    n_g, n_p = iou_cur.shape
    p = max_score / n_p
    r = max_score / n_g
    return 2 * p * r / (p + r) if p + r > 0 else 0.0


def eval_dense_captioning(
    pred_out: Dict[str, List[dict]],
    gold_out: Sequence[dict],
    seed: int = 0,
) -> Dict[str, float]:
    """pred_out: {question_id: [{'timestamp': [s,e], 'caption': str}]}.
    gold_out: [{'image_id', 'segments', 'pure_cap'}] (reference gold JSON).
    Returns {SODA_c, CIDEr, METEOR, Precision@avg, Recall@avg, F1} ×100."""
    random.seed(seed)
    # make_meteor / make_ptb_tokenizer prefer the reference's java-jar
    # subprocess backends when available ($METEOR_JAR / $CORENLP_JAR),
    # restoring jar-exact protocol scores
    cider, meteor = Cider(), make_meteor()
    try:
        return _eval_dense_captioning_inner(
            pred_out, gold_out, cider, meteor, make_ptb_tokenizer()
        )
    finally:
        if hasattr(meteor, "close"):
            meteor.close()  # the jar backend holds a java subprocess


def _eval_dense_captioning_inner(pred_out, gold_out, cider, meteor,
                                 tokenize_batch=None):
    if tokenize_batch is None:
        tokenize_batch = lambda texts: [ptb_tokenize(t) for t in texts]

    # tokenize every caption in ONE batch call (the jar backend pays one
    # JVM start per call, like the reference's single tokenize() pass);
    # keyed by gold ROW index so duplicate image_ids keep their own rows
    gold_caps_raw = [g["pure_cap"].split(". ") for g in gold_out]
    pred_caps_raw = [
        [p["caption"] or "" for p in pred_out.get(str(g["image_id"]), [])]
        for g in gold_out
    ]
    flat, spans = [], []
    for gc, pc in zip(gold_caps_raw, pred_caps_raw):
        spans.append((len(flat), len(gc), len(pc)))
        flat.extend(gc)
        flat.extend(pc)
    flat_tok = tokenize_batch(flat)
    gt_caps_tok = [flat_tok[s : s + ng] for s, ng, _ in spans]
    pred_caps_tok = [flat_tok[s + ng : s + ng + np_] for s, ng, np_ in spans]

    precisions, recalls = [], []
    soda_scores = []
    matched_gts = {t: {} for t in IOU_THRESHOLDS}
    matched_preds = {t: {} for t in IOU_THRESHOLDS}
    para_preds, para_gts = [], []

    for row, gold in enumerate(gold_out):
        key = str(gold["image_id"])
        gt_caps = gt_caps_tok[row]
        gt_segs = np.array(gold["segments"], float)
        preds = pred_out.get(key, [])
        pred_caps = pred_caps_tok[row]
        pred_segs = np.array([p["timestamp"] for p in preds], float) if preds else np.zeros((0, 2))

        prec, rec, iou_matrix = evaluate_detections(pred_segs, gt_segs)
        precisions.append(prec)
        recalls.append(rec)
        soda_scores.append(sodac(iou_matrix, meteor, pred_caps, gt_caps))

        g, p = match_captions(pred_segs, gt_segs, pred_caps, gt_caps)
        for t in IOU_THRESHOLDS:
            # keyed by gold ROW (not image_id): duplicate image_ids must
            # not overwrite each other's matched pairs. Key names are
            # identifiers only — CIDEr/METEOR scores are unaffected.
            for k, v in g[t].items():
                matched_gts[t][f"{row}_{k}"] = v
            for k, v in p[t].items():
                matched_preds[t][f"{row}_{k}"] = v

        para_preds.append(" ".join(pred_caps))
        para_gts.append([" ".join(gt_caps)])

    # caption metrics averaged over IoU thresholds
    cider_vals, meteor_vals = [], []
    for t in IOU_THRESHOLDS:
        if matched_gts[t]:
            cider_vals.append(np.nan_to_num(cider.compute_score(matched_gts[t], matched_preds[t])[0]))
            meteor_vals.append(np.nan_to_num(meteor.compute_score(matched_gts[t], matched_preds[t])[0]))
        else:
            cider_vals.append(0.0)
            meteor_vals.append(0.0)

    para_res = {str(i): [p] for i, p in enumerate(para_preds)}
    para_gt = {str(i): g for i, g in enumerate(para_gts)}

    precision = float(np.mean(precisions)) if precisions else 0.0
    recall = float(np.mean(recalls)) if recalls else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "SODA_c": float(np.mean(soda_scores)) * 100,
        "CIDEr": float(np.mean(cider_vals)) * 100,
        "METEOR": float(np.mean(meteor_vals)) * 100,
        "Para_CIDEr": float(cider.compute_score(para_gt, para_res)[0]) * 100,
        "Para_METEOR": float(meteor.compute_score(para_gt, para_res)[0]) * 100,
        "Precision": precision * 100,
        "Recall": recall * 100,
        "F1": f1 * 100,
    }
