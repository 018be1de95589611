"""Evaluation CLI dispatcher (reference `python -m test.evaluate --func ...`).

    python -m mmduet_tpu_torch.eval.evaluate --func grounding \
        --pred_file pred.jsonl --gold_file gold.json [--output_file out.json]

Functions: grounding | qvh_highlight | dense_captioning | magqa |
magqa_analyze | magqa_batch_input | magqa_batch_output.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_jsonl(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def _flag(v) -> bool:
    """Parse a bool CLI value: accepts 0/1/true/false (the reference uses
    `--is_online_model 0/1`, `test/evaluate.py:180`)."""
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() not in ("0", "false", "no", "")


def main(argv=None):
    p = argparse.ArgumentParser(description="MMDuet-TPU evaluation")
    p.add_argument("--func", required=True,
                   choices=["grounding", "qvh_highlight", "dense_captioning",
                            "magqa", "magqa_analyze", "magqa_batch_input",
                            "magqa_batch_output"])
    p.add_argument("--pred_file", required=True)
    p.add_argument("--gold_file", default=None)
    p.add_argument("--output_file", default=None)
    p.add_argument("--llm_pretrained", default=None,
                   help="judge model (HF path) or http:// judge server URL")
    p.add_argument("--openai_file", default=None)
    p.add_argument("--num_examples", type=int, default=2000)
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--end_idx", type=int, default=None)
    # baseline-output (timechat/vtimellm/plain-LLaVA) handling, reference
    # `test/evaluate.py:180,184-185`
    p.add_argument("--is_online_model", type=_flag, default=True,
                   help="0: pred_file holds baseline free-text outputs that"
                        " are reformatted in-eval (reference is_online_model=0)")
    p.add_argument("--concat_pred_list", type=_flag, default=False,
                   help="magqa: judge the deduped concatenation of all pred"
                        " turns as one answer (`evaluate.py:260-266`)")
    p.add_argument("--prev_output_file", default=None,
                   help="magqa: resume — reuse already-judged lines from a"
                        " previous output file (`evaluate.py:217-220`)")
    args = p.parse_args(argv)

    if args.func == "grounding":
        from .grounding import best_result, evaluate_grounding, evaluate_grounding_baseline

        preds = load_jsonl(args.pred_file)
        golds = json.load(open(args.gold_file))
        if not args.is_online_model or (
            preds and "model_response" in preds[0] and "debug_data" not in preds[0]
        ):
            # offline-baseline outputs: text spans, not per-frame scores
            m = evaluate_grounding_baseline(preds, golds)
            print(f"baseline: mIoU/R@.3/R@.5/R@.7 = "
                  f"{m[0]:.2f}/{m[1]:.2f}/{m[2]:.2f}/{m[3]:.2f}")
            if args.output_file:
                json.dump({"scores": m}, open(args.output_file, "w"), indent=2)
            return
        results = evaluate_grounding(preds, golds)
        best = best_result(results)
        m = best["scores"]
        print(
            f"best: window={best['smooth_window_size']} thr={best['threshold']}: "
            f"mIoU/R@.3/R@.5/R@.7 = {m[0]:.2f}/{m[1]:.2f}/{m[2]:.2f}/{m[3]:.2f}"
        )
        if args.output_file:
            json.dump(results, open(args.output_file, "w"), indent=2)

    elif args.func == "qvh_highlight":
        from .qvh import eval_submission, evaluate_qvh

        preds = load_jsonl(args.pred_file)
        golds = load_jsonl(args.gold_file)
        if not args.is_online_model:
            # baseline free-text spans → one-hot clip saliency
            # (reference `test/evaluate.py:347-360`; no window sweep)
            from .offline_baseline import baseline_qvh_saliency

            sub = [s for s in map(baseline_qvh_saliency, preds) if s is not None]
            results = eval_submission(sub, golds, match_number=False)
            print(results["brief"])
            if args.output_file:
                json.dump(results, open(args.output_file, "w"), indent=2)
            return
        results = evaluate_qvh(preds, golds)
        best = max(
            results,
            key=lambda r: r["results"]["brief"].get("HL-min-VeryGood-mAP", 0),
        )
        print(f"best window={best['smooth_window_size']}: {best['results']['brief']}")
        if args.output_file:
            json.dump(results, open(args.output_file, "w"), indent=2)

    elif args.func == "dense_captioning":
        from .dvc import eval_dense_captioning, merge_response_segments

        preds = load_jsonl(args.pred_file)
        golds = json.load(open(args.gold_file))
        if args.is_online_model:
            pred_out = {
                str(ex["question_id"]): merge_response_segments(ex["model_response_list"])
                for ex in preds
            }
        else:
            # baseline free text → timed captions; parse picked by the pred
            # FILENAME as in the reference (`test/evaluate.py:452-472`)
            from .offline_baseline import baseline_dvc_captions

            is_vtimellm = "vtimellm" in args.pred_file
            pred_out = {
                str(ex["question_id"]): baseline_dvc_captions(ex, is_vtimellm)
                for ex in preds
            }
        gold_out = []
        for g in golds:
            if str(g["question_id"]) not in pred_out:
                continue
            answers = [t["content"].replace(". ", ", ") for t in g["answer"]]
            gold_out.append(
                {
                    "image_id": str(g["question_id"]),
                    "segments": [t["time"] for t in g["answer"]],
                    "pure_cap": ". ".join(answers),
                }
            )
        metrics = eval_dense_captioning(pred_out, gold_out)
        print(json.dumps(metrics, indent=2))
        if args.output_file:
            json.dump(metrics, open(args.output_file, "w"), indent=2)

    elif args.func == "magqa":
        from .magqa import HFJudge, HTTPJudge, judge_example
        from .offline_baseline import convert_to_online_format

        preds = load_jsonl(args.pred_file)
        prev_outputs = (
            load_jsonl(args.prev_output_file) if args.prev_output_file else []
        )
        golds = {e["question_id"]: e for e in json.load(open(args.gold_file))}
        judge = (
            HTTPJudge(args.llm_pretrained)
            if args.llm_pretrained and args.llm_pretrained.startswith("http")
            else HFJudge(args.llm_pretrained)
        )
        end_idx = args.end_idx if args.end_idx is not None else len(preds)
        n_judged = 0
        with open(args.output_file, "w") as f:
            for i, ex in enumerate(preds):
                if i < args.start_idx or i >= end_idx:
                    continue
                # resume: reuse already-judged lines (`evaluate.py:217-220`).
                # The reference indexes prev output by example position,
                # which silently shifts rows whenever a prior run SKIPPED
                # an example (no assistant turns) or used --start_idx —
                # guard by question_id and re-judge on mismatch instead
                if i < len(prev_outputs):
                    prev = prev_outputs[i]
                    if prev.get("question_id") == ex.get("question_id"):
                        f.write(json.dumps(prev) + "\n")
                        continue
                    import warnings

                    warnings.warn(
                        f"prev_output_file row {i} is question_id="
                        f"{prev.get('question_id')!r}, expected "
                        f"{ex.get('question_id')!r} (a prior run skipped or"
                        " sliced examples) — re-judging this example"
                    )
                if not args.is_online_model:
                    ex = convert_to_online_format(ex)
                # no assistant turns at all → no output row (`evaluate.py:255-256`)
                if not any(
                    t["role"] == "assistant" for t in ex.get("model_response_list", [])
                ):
                    continue
                out = judge_example(
                    ex, golds[ex["question_id"]], judge,
                    concat_pred_list=args.concat_pred_list,
                )
                f.write(json.dumps(out) + "\n")
                n_judged += 1
                if n_judged % 10 == 0:
                    f.flush()
        print(f"judged {n_judged} examples -> {args.output_file}")

    elif args.func == "magqa_analyze":
        from .magqa import analyze_magqa

        results = analyze_magqa(load_jsonl(args.pred_file), args.num_examples)
        print(json.dumps(results, indent=2))
        # LaTeX row like the reference (`analyze_magqa_results.py:70-73`)
        print(f"{results['in_span_score']} & {results['turns']}/{results['turns_dedup']} & \\\\")

    elif args.func == "magqa_batch_input":
        from .openai_batch import build_batch_input

        preds = load_jsonl(args.pred_file)
        golds = json.load(open(args.gold_file))
        reqs = build_batch_input(preds, golds)
        with open(args.output_file, "w") as f:
            for r in reqs:
                f.write(json.dumps(r) + "\n")
        print(f"{len(reqs)} batch requests -> {args.output_file}")

    elif args.func == "magqa_batch_output":
        from .openai_batch import reformat_batch_output

        preds = load_jsonl(args.pred_file)
        golds = json.load(open(args.gold_file))
        lines = load_jsonl(args.openai_file)
        out = reformat_batch_output(preds, golds, lines)
        with open(args.output_file, "w") as f:
            for r in out:
                f.write(json.dumps(r) + "\n")
        print(f"reformatted {len(out)} examples -> {args.output_file}")


if __name__ == "__main__":
    main()
