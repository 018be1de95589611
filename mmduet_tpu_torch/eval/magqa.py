"""MAGQA evaluation: LLM-judge scoring + in-span score analysis.

Two stages, matching the reference protocol:

1. **Judge** (`test/evaluate.py:13-81,195-306`): every (gold, pred) answer
   pair whose pred time falls inside the gold timespan is scored 1-5 by an
   LLM judge; pairs never judged stay 1. Backends mirror the reference's
   prompt variants exactly:

   - local HF causal LM — the rubric + SIX in-context scoring examples,
     with the shared prompt's KV cache computed once and reused per pair
     (`test/evaluate.py:18-68`);
   - HTTP server (`LlamaServerEvaluator`, 0-shot server-side);
   - OpenAI Batch-API tooling — 0-shot with the "Only reply with a
     number" rubric suffix (`test/openai_batch.py:84-97` variant), in
     :mod:`openai_batch`.

2. **Analysis** (`test/analyze_magqa_results.py`): the in-span score =
   mean judge score of pred turns inside each gold span (missing spans
   score 1), plus #turns / #turns-dedup; missing examples padded with 1.

The rubric text and the six example pairs are protocol constants copied
verbatim — a judge-sensitive metric with a different prompt is a
different benchmark.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

JUDGE_RUBRIC = (
    "You are an evaluator for a video question answering system. Your task"
    " is to rate the correctness of the predicted answers against the"
    " ground truth answers. Use the following scale to assign a score:\n"
    "- 5: Perfect match; the predicted answer is completely correct and"
    " contains all the relevant information.\n"
    "- 4: Mostly correct; the predicted answer is largely accurate but may"
    " have minor omissions or slight inaccuracies.\n"
    "- 3: Partially correct; the predicted answer has some correct"
    " information, but also contains significant inaccuracies or missing"
    " key points.\n"
    "- 2: Slightly correct; the predicted answer has only a few correct"
    " elements, but most of the information is incorrect or irrelevant, or"
    " the predicted answer conflicts with the ground truth answer.\n"
    "- 1: Incorrect; the predicted answer is entirely wrong or does not"
    " address the question at all."
)

# System prompt of the 6-shot local judge (`test/evaluate.py:19-27`).
JUDGE_SYSTEM_FEWSHOT = JUDGE_RUBRIC + "\n\nHere are some examples to guide you:"

# System prompt of the 0-shot OpenAI batch judge (`test/openai_batch.py:84-93`).
JUDGE_SYSTEM_BATCH = (
    JUDGE_RUBRIC + "\nOnly reply with a number from 1 to 5, and nothing else."
)

# The six in-context scoring examples of the local judge
# (`test/evaluate.py:28-47`) — protocol constants, verbatim.
JUDGE_FEWSHOT: Tuple[Tuple[str, str], ...] = (
    (
        "Question: What is shown about the black car?\nGround Truth Answer: At night a black car is parked in the open space with its headlights on. The lights are very dazzling.\nPredicted Answer: The car's headlights are on and dazzling.",
        "4",
    ),
    (
        "Question: What is shown in the video?\nGround Truth Answer: In the video, a group of colorful paper birds on the wall move out from the upper right corner of the camera, and then a piece of blue folded paper appears in the camera.\nPredicted Answer: The colorful paper birds are created by folding paper.",
        "2",
    ),
    (
        "Question: What is the man doing?\nGround Truth Answer: The video shows a person wearing a helmet flipping several times in the air.\nPredicted Answer: The person wearing a helmet in the background is sitting in a crouch facing the other person.",
        "3",
    ),
    (
        "Question: What is the current scene about?\nGround Truth Answer: This is a close-up of a Mercedes-Benz car on display in the showroom.\nPredicted Answer: A Mercedes-Benz car is being displayed in the showroom.",
        "5",
    ),
    (
        "Question: What was the unexpected sight in the room with the formally dressed snakes?\nGround Truth Answer: The sight of the snake on the stage talking into a microphone, with many others holding cameras with their tongues out.\nPredicted Answer: A large snake lying on its back in a room with wooden walls and furniture, surrounded by other snakes.",
        "3",
    ),
    (
        "Question: What had changed between the beginning and the end of the scene with the man in a black suit and a tie?\nGround Truth Answer: The scene changed from the man talking in the chair to the man sitting on the sofa with a woman and a pizza box, and then to the man fixing his tie and turning to look at the woman.\nPredicted Answer: The man in a black suit and tie is eating pizza.",
        "1",
    ),
)


def judge_user_message(question: str, gold: str, pred: str) -> str:
    return (
        f"Question: {question}\nGround Truth Answer: {gold}\n"
        f"Predicted Answer: {pred}"
    )


def fewshot_prompt_conversation() -> List[dict]:
    """The shared prefix conversation of the local judge: rubric system
    turn + the six scored examples (`test/evaluate.py:18-48`). Its KV
    cache is computed once and reused for every judged pair."""
    conv: List[dict] = [{"role": "system", "content": JUDGE_SYSTEM_FEWSHOT}]
    for user, score in JUDGE_FEWSHOT:
        conv.append({"role": "user", "content": user})
        conv.append({"role": "assistant", "content": score})
    return conv


def text_score_to_int(text) -> int:
    if not isinstance(text, str):
        return int(text)
    return int(text[0]) if text and text[0] in "12345" else 1


class HFJudge:
    """Local HF causal-LM judge (reference `CorrectnessEvaluator`,
    `test/evaluate.py:13-68`): 6-shot prompt whose KV cache is computed
    ONCE at init and reused for every judged pair — per-pair work is one
    short user turn + a few generated tokens."""

    def __init__(self, llm_pretrained: str):
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(llm_pretrained)
        self.model = AutoModelForCausalLM.from_pretrained(
            llm_pretrained, torch_dtype=torch.bfloat16, device_map="auto"
        )
        prompt = self.tokenizer.apply_chat_template(
            fewshot_prompt_conversation(), return_tensors="pt", return_dict=True
        ).to(self.model.device)
        with torch.no_grad():
            out = self.model(**prompt, use_cache=True)
        # store the prompt KV as immutable per-layer tensors: generate()
        # MUTATES a DynamicCache in place (appends the new turn's KV), so
        # reusing one cache object across evaluate() calls would corrupt
        # the shared prompt; a fresh cache view is rebuilt per call
        kv = out.past_key_values
        self._prompt_kv_legacy = (
            kv.to_legacy_cache() if hasattr(kv, "to_legacy_cache") else kv
        )
        self.prompt_input_ids = prompt.input_ids
        self.n_prefix_fallbacks = 0

    def _fresh_prompt_cache(self):
        try:
            from transformers import DynamicCache

            return DynamicCache.from_legacy_cache(self._prompt_kv_legacy)
        except ImportError:  # older transformers: tuple caches are copied
            return self._prompt_kv_legacy

    def _fragment_ids(self, question: str, gold: str, pred: str):
        """Token ids of the new user turn + generation header ONLY.

        Renders the full conversation (shots + new pair) and slices off
        the cached-prompt prefix — template-agnostic, unlike the
        reference's hardcoded llama-3 `<|eot_id|>`-stripping heuristic
        (`evaluate.py:61`), while producing the identical conversation."""
        conv = fewshot_prompt_conversation() + [
            {"role": "user", "content": judge_user_message(question, gold, pred)}
        ]
        full = self.tokenizer.apply_chat_template(
            conv, add_generation_prompt=True, return_tensors="pt"
        ).to(self.model.device)
        n = self.prompt_input_ids.shape[1]
        if full.shape[1] <= n or not self.torch.equal(
            full[:, :n], self.prompt_input_ids
        ):
            # template renders a different prefix in-context (e.g. rewrites
            # the trailing turn when it is no longer last): the cached KV
            # cannot be reused for this pair — fall back to a full forward.
            # Counted + warned once: a template-mismatched judge silently
            # running every pair at full cost should be visible
            self.n_prefix_fallbacks += 1
            if self.n_prefix_fallbacks == 1:
                import warnings

                warnings.warn(
                    "HFJudge: chat template rewrites the cached few-shot "
                    "prefix; falling back to full forwards (correct but "
                    "~Nx slower). Counted in .n_prefix_fallbacks.",
                    stacklevel=2,
                )
            return full, False
        return full[:, n:], True

    def evaluate(self, question: str, gold: str, pred: str) -> int:
        new_ids, is_suffix = self._fragment_ids(question, gold, pred)
        if is_suffix:
            all_ids = self.torch.cat([self.prompt_input_ids, new_ids], dim=1)
            past = self._fresh_prompt_cache()
        else:
            # prefix-mismatch fallback: new_ids is the FULL conversation —
            # generate without the cached prompt KV
            all_ids, past = new_ids, None
        with self.torch.no_grad():
            out = self.model.generate(
                input_ids=all_ids,
                past_key_values=past,
                use_cache=True,
                max_new_tokens=32,
            )
        text = self.tokenizer.decode(
            out[0, all_ids.shape[1]:], skip_special_tokens=True
        )
        # strip: a leading space/newline from the chat template would make
        # the first-char digit check misscore every pair as 1
        return text_score_to_int(text.strip())


class HTTPJudge:
    """Remote judge server (reference `LlamaServerEvaluator`)."""

    def __init__(self, url: str):
        self.url = url

    def evaluate(self, question: str, gold: str, pred: str) -> int:
        import requests

        r = requests.post(
            self.url,
            json={"question": question, "gold_answer": gold, "pred_answer": pred},
        )
        text = r.json()["text"]
        return text_score_to_int(text[-1])


def judge_example(
    pred_example: dict, gold_example: dict, evaluator,
    concat_pred_list: bool = False,
) -> dict:
    """Score one example: fills 'evaluator_output' (gold×pred matrix,
    default 1), 'answer', 'answer_time'. Only in-span pairs are judged
    (reference `evaluate.py:284-301`); pred time -1 matches any span.

    ``concat_pred_list`` reproduces `evaluate.py:260-266`: dedup pred
    turns case-insensitively (keeping first spelling) and judge their
    space-joined concatenation as ONE pred turn. The reference leaves
    ``pred_time_list`` untouched, so the joined turn inherits the FIRST
    answer's timestamp for the in-span check, and the output matrix is
    gold×1 while ``model_response_list`` keeps all original turns."""
    answers = [e for e in pred_example["model_response_list"] if e["role"] == "assistant"]
    pred_list = [e["content"] for e in answers]
    pred_times = [e["time"] for e in answers]
    if concat_pred_list and pred_list:
        seen, uniq = set(), []
        for pred in pred_list:
            key = pred.lower().strip()
            if key not in seen:
                seen.add(key)
                uniq.append(pred)
        pred_list = [" ".join(uniq)]
    gold_list = [e["content"] for e in gold_example["answer"]]
    gold_spans = [e["time"] for e in gold_example["answer"]]
    question = gold_example["conversation"][0]["content"]

    # dedup identical texts (judge each distinct pair once)
    def group(texts):
        d: Dict[str, List[int]] = {}
        for i, t in enumerate(texts):
            d.setdefault(t, []).append(i)
        return d

    matrix = np.ones((len(gold_list), len(pred_list)))
    for g_text, g_ids in group(gold_list).items():
        for p_text, p_ids in group(pred_list).items():
            spans = [gold_spans[i] for i in g_ids]
            times = [pred_times[i] for i in p_ids]
            in_span = [
                (t == -1 or s[0] <= t <= s[1]) for s in spans for t in times
            ]
            if not any(in_span):
                continue
            score = evaluator.evaluate(question, g_text, p_text)
            for gi in g_ids:
                for pi in p_ids:
                    matrix[gi, pi] = score
    out = dict(pred_example)
    out.pop("debug_data", None)
    out["evaluator_output"] = matrix.tolist()
    out["answer"] = gold_list
    out["answer_time"] = gold_spans
    return out


def analyze_magqa(
    eval_examples: Sequence[dict],
    num_examples: int = 2000,
    baseline_all_match: bool = True,
    pad_with_one: bool = True,
) -> Dict[str, float]:
    """Final MAGQA metrics (reference `analyze_magqa_results.py:28-73`)."""
    num_turns, num_turns_dedup, in_span_scores = [], [], []
    for ex in list(eval_examples)[:num_examples]:
        sentences = [
            t["content"] for t in ex["model_response_list"] if t["role"] == "assistant"
        ]
        num_turns.append(len(sentences))
        num_turns_dedup.append(len(set(sentences)))

        turn_times = [
            t["time"] for t in ex["model_response_list"] if t["role"] == "assistant"
        ]
        per_span = []
        for score_row, span in zip(ex["evaluator_output"], ex["answer_time"]):
            idx = [
                i
                for i, t in enumerate(turn_times)
                if (span[0] <= t <= span[1]) or (baseline_all_match and t == -1)
            ]
            if not idx:
                per_span.append(1.0)
            else:
                per_span.append(float(np.mean([text_score_to_int(score_row[i]) for i in idx])))
        if per_span:
            in_span_scores.append(float(np.mean(per_span)))

    if pad_with_one and len(num_turns) < num_examples:
        missing = num_examples - len(num_turns)
        num_turns += [0] * missing
        num_turns_dedup += [0] * missing
        in_span_scores += [1.0] * missing

    return {
        "in_span_score": round(float(np.mean(in_span_scores)), 2),
        "turns": round(float(np.mean(num_turns)), 2),
        "turns_dedup": round(float(np.mean(num_turns_dedup)), 2),
        "n": len(num_turns),
    }
