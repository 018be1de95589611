"""OpenAI Batch-API tooling for the MAGQA judge (GPT-4o alternative).

File-format equivalents of the reference `test/openai_batch.py`:
- :func:`build_batch_input` — pred+gold → batch-input JSONL (custom_id
  encodes ``qid*gold_ids*pred_ids`` for later joining);
- :func:`reformat_batch_output` — batch output JSONL → the same
  ``evaluator_output`` matrix format the local judge produces;
- send/check/get are thin API calls, gated on the ``openai`` package and
  OPENAI_API_KEY (this environment has no egress; the file tooling is the
  testable part).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from .magqa import JUDGE_SYSTEM_BATCH, judge_user_message, text_score_to_int


def _pair_groups(pred_example: dict, gold_example: dict):
    answers = [e for e in pred_example["model_response_list"] if e["role"] == "assistant"]
    pred_list = [e["content"] for e in answers]
    pred_times = [e["time"] for e in answers]
    gold_list = [e["content"] for e in gold_example["answer"]]
    gold_spans = [e["time"] for e in gold_example["answer"]]

    def group(texts):
        d: Dict[str, List[int]] = {}
        for i, t in enumerate(texts):
            d.setdefault(t, []).append(i)
        return d

    return pred_list, pred_times, gold_list, gold_spans, group(pred_list), group(gold_list)


def build_batch_input(
    pred_examples: Sequence[dict],
    gold_examples: Sequence[dict],
    model: str = "gpt-4o",
) -> List[dict]:
    """One request per judged (gold_text, pred_text) pair (in-span only)."""
    gold_by_id = {e["question_id"]: e for e in gold_examples}
    requests = []
    for ex in pred_examples:
        gold = gold_by_id[ex["question_id"]]
        _, pred_times, _, gold_spans, pred_groups, gold_groups = _pair_groups(ex, gold)
        question = gold["conversation"][0]["content"]
        for g_text, g_ids in gold_groups.items():
            for p_text, p_ids in pred_groups.items():
                spans = [gold_spans[i] for i in g_ids]
                times = [pred_times[i] for i in p_ids]
                if not any(
                    (t == -1 or s[0] <= t <= s[1]) for s in spans for t in times
                ):
                    continue
                # reference custom_id format: qid*g0,g1*p0,p1
                # (`test/openai_batch.py:97`, comma-joined turn ids)
                custom_id = (
                    f"{ex['question_id']}*{','.join(map(str, g_ids))}"
                    f"*{','.join(map(str, p_ids))}"
                )
                requests.append(
                    {
                        "custom_id": custom_id,
                        "method": "POST",
                        "url": "/v1/chat/completions",
                        "body": {
                            "model": model,
                            "messages": [
                                {"role": "system", "content": JUDGE_SYSTEM_BATCH},
                                {
                                    "role": "user",
                                    "content": judge_user_message(question, g_text, p_text),
                                },
                            ],
                            "max_tokens": 8,
                        },
                    }
                )
    return requests


def reformat_batch_output(
    pred_examples: Sequence[dict],
    gold_examples: Sequence[dict],
    batch_output_lines: Sequence[dict],
) -> List[dict]:
    """Join batch results back into per-example evaluator_output matrices."""
    scores: Dict[str, Dict] = {}
    for line in batch_output_lines:
        custom_id = line["custom_id"]
        text = line["response"]["body"]["choices"][0]["message"]["content"]
        scores[custom_id] = text_score_to_int(text)

    gold_by_id = {e["question_id"]: e for e in gold_examples}
    out = []
    for ex in pred_examples:
        gold = gold_by_id[ex["question_id"]]
        pred_list, _, gold_list, gold_spans, _, _ = _pair_groups(ex, gold)
        matrix = np.ones((len(gold_list), len(pred_list)))
        prefix = f"{ex['question_id']}*"
        for cid, score in scores.items():
            if not cid.startswith(prefix):
                continue
            _, g_part, p_part = cid.split("*")
            for gi in map(int, g_part.split(",")):
                for pi in map(int, p_part.split(",")):
                    matrix[gi, pi] = score
        rec = dict(ex)
        rec.pop("debug_data", None)
        rec["evaluator_output"] = matrix.tolist()
        rec["answer"] = gold_list
        rec["answer_time"] = gold_spans
        out.append(rec)
    return out


def send_batch(batch_input_file: str, description: str = "magqa eval"):
    """Submit the batch (requires openai package + network)."""
    import openai

    client = openai.OpenAI()
    fobj = client.files.create(file=open(batch_input_file, "rb"), purpose="batch")
    return client.batches.create(
        input_file_id=fobj.id,
        endpoint="/v1/chat/completions",
        completion_window="24h",
        metadata={"description": description},
    )


def check_batches():
    import openai

    return openai.OpenAI().batches.list(limit=10)


def get_batch(file_id: str, output_file: str):
    import openai

    content = openai.OpenAI().files.content(file_id)
    with open(output_file, "wb") as f:
        f.write(content.read())
