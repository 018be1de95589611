"""Offline (non-streaming) baseline inference path.

Port of `mmduet_tpu/eval/offline_baseline.py` (which imports jax), the
rebuild of the reference's plain-LLaVA-OV comparison driver
(`test/inference.py:382-423`): the whole video is encoded up front, the
prompt is the qwen_1_5 conversation ``system: You are a helpful
assistant.`` + ``user: <frames>\\n{question}`` and the model greedily
generates ONE untimed answer (the baselines' outputs are later parsed
back into timed turns by `convert_to_online_format`, matching
`test/openai_batch.py:6-28`).

The runner is the streaming engine's device path: the prompt is
prefilled in 256-row chunks through the engine's bucketed `_feed` (kernel
A on a CUDA device), then one answer is greedily decoded by
`mmduet.decode_loop` on the engine's decode route (`decode_route`), the
engine's generate path; no score-threshold policy runs. The format
converters below the runner are copies of the JAX module's, pinned equal by
`tests/test_torch_hostcode.py`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch

from ..config import MMDuetConfig, TestArgs
from ..infer.engine import LiveInferEngine
from ..models import mmduet

BASELINE_SYSTEM = "You are a helpful assistant."


class OfflineBaselineRunner(LiveInferEngine):
    """Non-streaming whole-video QA over the same model components."""

    def __init__(self, params, cfg: MMDuetConfig, tokenizer, args: TestArgs,
                 **kw):
        # the streaming threshold policy is unused; satisfy the
        # exactly-one-threshold invariant with a never-triggering value
        args = type(args)(**{**args.__dict__,
                             "stream_end_prob_threshold": 1.0,
                             "stream_end_score_sum_threshold": None,
                             "threshold_z": None})
        super().__init__(params, cfg, tokenizer, args, **kw)

    @torch.inference_mode()
    def answer(self, video_frames, question: str,
               max_feed_chunk: int = 256) -> str:
        """Encode all frames + one prompt, greedy-decode one answer."""
        self.reset()
        self.input_video_stream(video_frames)
        tpl = self.tokenizer.template
        prefix = (
            f"{tpl.bos}system\n{BASELINE_SYSTEM}{tpl.eos}"
            f"\n{tpl.bos}user\n"
        )
        suffix = f"\n{question}{tpl.eos}\n{tpl.bos}assistant\n"
        H = self.frame_embeds.shape[-1]
        embeds = torch.cat(
            [
                self._embed_ids(self.tokenizer.encode(prefix)),
                self.frame_embeds.reshape(-1, H),
                self._embed_ids(self.tokenizer.encode(suffix)),
            ],
            dim=0,
        )
        # prefill everything except a generation tail in bucketed chunks
        tail = min(len(embeds), 64)
        body, gen_prompt = embeds[:-tail], embeds[-tail:]
        for i in range(0, len(body), max_feed_chunk):
            self._feed(body[i : i + max_feed_chunk])
        packed, _, _ = mmduet.decode_loop(
            self.params, self.cfg, gen_prompt[None], self.state.kv_cache,
            self.state.cursor, len(gen_prompt), self._pen_mask[None],
            max_new=self.args.max_new_tokens, eos_id=self.tokenizer.eos_token_id,
            rep=self.args.repetition_penalty, lora=self.lora,
            lora_scale=self.lora_scale, shard_ctx=self._shard_ctx,
            graphs=self._graphs,
        )
        packed = packed[0].tolist()  # ONE fetch: tokens + n + cursor
        self.state.cursor = packed[-1]
        token_ids = packed[: packed[-2]]
        self.tokens_generated += len(token_ids)
        return self.tokenizer.decode(token_ids, skip_special_tokens=True)


# ---------------------------------------------------------------------------
# Baseline-output → online-format conversion (reference
# `test/openai_batch.py:6-28`): parse vtimellm/timechat-style grounded
# text into timed turns; ungrounded answers become one turn at time -1.
# ---------------------------------------------------------------------------

_VTIMELLM_PAT = re.compile(r"From (\d+) to (\d+), (.*)")
_TIMECHAT_PAT = re.compile(r"(\d+\.\d+) - (\d+\.\d+)\s*seconds,\s*(.*)")


def convert_to_online_format(example: Dict) -> Dict:
    """Adds ``model_response_list`` parsed from ``model_response``.

    Matches the reference magqa reformat branch (`test/evaluate.py:224-250`),
    which accepts ``model_response`` as either a list or a bare string."""
    text = example["model_response"]
    if isinstance(text, list):
        text = text[0]
    video_length = example["video_duration"]
    turns: List[Dict] = []
    for m in _VTIMELLM_PAT.findall(text):
        t = (int(m[0]) / 100 * video_length + int(m[1]) / 100 * video_length) / 2
        turns.append({"time": t, "content": m[2], "role": "assistant"})
    for m in _TIMECHAT_PAT.findall(text):
        t = (float(m[0]) + float(m[1])) / 2
        turns.append({"time": t, "content": m[2], "role": "assistant"})
    if not turns:
        turns.append({"time": -1, "content": text, "role": "assistant"})
    example = dict(example)
    example["model_response_list"] = turns
    return example


_TWO_NUMBERS_PAT = re.compile(r"\d+\.?\d*")


def parse_baseline_span(example: Dict) -> Optional[tuple]:
    """Extract a (start_sec, end_sec) span from a baseline's free text.

    Reference qvh/grounding `is_online_model=0` parse
    (`test/evaluate.py:351-356,415-421`): exactly two numbers in the
    response; if the text contains both "from" and "to" it is a vtimellm
    percentage output, rescaled by the video duration. Returns None when
    the response does not contain exactly two numbers (the reference
    skips those examples)."""
    text = example["model_response"]
    if isinstance(text, list):
        text = text[0]
    matches = _TWO_NUMBERS_PAT.findall(text)
    if len(matches) != 2:
        return None
    start_sec, end_sec = float(matches[0]), float(matches[1])
    if "from" in text.lower() and "to" in text.lower():
        video_length = example["video_duration"]
        start_sec = start_sec / 100 * video_length
        end_sec = end_sec / 100 * video_length
    return start_sec, end_sec


def baseline_qvh_saliency(example: Dict) -> Optional[Dict]:
    """Baseline text → QVH saliency submission (`test/evaluate.py:348-358`):
    one-hot 2-sec clips inside the parsed span."""
    span = parse_baseline_span(example)
    if span is None:
        return None
    start_sec, end_sec = span
    video_length = example["video_duration"]
    scores = [1 if start_sec < sec < end_sec else 0
              for sec in range(0, int(video_length), 2)]
    return {"qid": example["question_id"], "pred_saliency_scores": scores}


def baseline_dvc_captions(example: Dict, is_vtimellm: bool) -> List[Dict]:
    """Baseline text → dense-captioning prediction rows
    (`test/evaluate.py:452-472`). The reference picks the parse by the
    pred FILENAME: vtimellm files use the "From P1 to P2" percent format,
    everything else the timechat "S - E seconds," format."""
    text = example["model_response"]
    if isinstance(text, list):
        text = text[0]
    captions: List[Dict] = []
    if is_vtimellm:
        video_length = example["video_duration"]
        for m in _VTIMELLM_PAT.findall(text):
            captions.append({
                "timestamp": [int(m[0]) / 100 * video_length,
                              int(m[1]) / 100 * video_length],
                "caption": m[2],
            })
    else:
        for m in _TIMECHAT_PAT.findall(text):
            captions.append({
                "timestamp": [float(m[0]), float(m[1])],
                "caption": m[2],
            })
    return captions
