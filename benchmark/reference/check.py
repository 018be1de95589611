"""The comparison that decides ``correct``.

What the timed path produced is judged after the window, once the
program's state is freed:

- ``protocol_errors`` (exact, limit 0), over every session of the window:
  in generation mode the threshold policy replayed on the program's own
  scores must trigger at the frames where the program answered; each
  answer's cursor must be the stream's length up to its trigger frame
  (the rollback of the frames after a trigger); each answer has its full
  length unless it ended. In grounding mode no session answers. In both,
  a retired session scored each of its frames once.
- ``score_gap``: the widest gap between the program's informative and
  relevance probabilities and the reference's, over every frame the
  program scored in the sessions checked (the tower, projector, pooling,
  the frame forwards through each lane's cache); ``score_gap_mean``: the
  mean of those gaps.
- ``token_gap``: the widest gap by which a served token's logit lies below
  the reference's best at its position (the batched greedy decode).

The sessions checked (`pick`): the deepest one (the longest answer
context, or in grounding mode the most frames scored), and one more drawn
from the seed from the other half of the lanes, with every answer they
finished in the window and every frame they scored. The reference (the
module that the configuration's ``reference`` names,
`benchmark.spec.reference`) works from the benchmark's weights made again
from the seed, the pixels and the token ids; a control (its ``control``
precision) is the same reference in the nearest lower precision, read at
the same positions.

The reference's stream is [a query at time 0, the frames], with answers
removed from the context (`supported` refuses a traffic mix it does not
describe, before any set-up).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..model_shapes import Shapes
from .template import answer_prompt_ids, query_ids


@dataclass
class Answer:
    session: int
    frame: int  # the trigger frame (its index in the session)
    cursor: int  # the lane's cursor when the answer's decode began
    tokens: List[int]
    latency_s: float = 0.0
    lane: int = 0


class Unsupported(ValueError):
    pass


# traffic key -> the values the check honours (None: any value); other keys
# are refused
TRAFFIC_KEYS = {
    "mode": ("generation", "grounding"), "lanes": None, "block_frames": None,
    "frame_fps": None, "max_num_frames": None, "remove_assistant_turns": None,
    "gen_coalesce_rounds": None, "score_heads": None,
    "stream_end_score_sum_threshold": None, "stream_end_prob_threshold": None,
    "max_new_tokens": None, "repetition_penalty": (None,), "frames": None,
    "resolution": None, "pool_videos": None, "pool_seed": None, "query_time": (0, 0.0),
    "queries": None, "source": None, "assumed": None,
}


def supported(mix: dict) -> None:
    """Raises `Unsupported` where the reference does not describe what
    ``mix`` would serve: another key, a query after time 0, a repetition
    penalty (the served token is then not the reference's first), answers
    kept in the context, or not exactly one of the two thresholds."""
    for key, value in mix.items():
        if key not in TRAFFIC_KEYS:
            raise Unsupported(f"traffic key {key}: not one the benchmark serves")
        if TRAFFIC_KEYS[key] is not None and value not in TRAFFIC_KEYS[key]:
            raise Unsupported(f"traffic {key} = {value!r}: the check holds "
                              f"{' or '.join(map(repr, TRAFFIC_KEYS[key]))}")
    if mix["mode"] == "generation" and not mix["remove_assistant_turns"]:
        raise Unsupported("generation mode keeps answers in the context: the check's "
                          "stream holds none (remove_assistant_turns)")
    thresholds = [k for k in ("stream_end_score_sum_threshold", "stream_end_prob_threshold")
                  if mix.get(k) is not None]
    if len(thresholds) != 1:
        raise Unsupported("exactly one of stream_end_score_sum_threshold and "
                          "stream_end_prob_threshold")


@dataclass
class Served:
    """What the window produced, as the check reads it."""

    sessions: Dict[int, object]  # index -> traffic.Session
    scores: Dict[int, List[Dict[str, float]]]  # index -> the engine's per-frame rows
    retired: set
    answers: List[Answer]
    pixels: np.ndarray  # the traffic's pixel pool
    mix: dict
    eos_id: int
    frame_tokens: int = 0
    lanes: Dict[int, int] = field(default_factory=dict)  # session -> its lane

    @property
    def grounding(self) -> bool:
        return self.mix["mode"] == "grounding"


def replay_triggers(mix: dict, scores: Sequence[Dict[str, float]]) -> List[int]:
    """The frames at which the traffic's policy triggers over ``scores``:
    the selected heads' probabilities add up until the sum passes the sum
    threshold, which triggers and starts the sum anew; or a frame's sum
    passes the probability threshold."""
    heads = mix["score_heads"].split(",")
    total_at, each_at = (mix.get("stream_end_score_sum_threshold"),
                         mix.get("stream_end_prob_threshold"))
    total, out = 0.0, []
    for i, row in enumerate(scores):
        score = sum(v for k, v in row.items() if k in heads)
        total += score
        if total_at is not None and total > total_at:
            total = 0.0
            out.append(i)
        elif each_at is not None and score > each_at:
            out.append(i)
    return out


def protocol_errors(served: Served) -> int:
    errors = 0
    by_session: Dict[int, List[Answer]] = {}
    for a in served.answers:
        by_session.setdefault(a.session, []).append(a)
    ft = served.frame_tokens
    for idx, rows in served.scores.items():
        sess = served.sessions[idx]
        if idx in served.retired and len(rows) != sess.frames:
            errors += 1
        if served.grounding:
            errors += len(by_session.get(idx, []))
            continue
        got = [a.frame for a in by_session.get(idx, [])]
        want = replay_triggers(served.mix, rows)
        errors += len(set(got) ^ set(want)) + (len(got) != len(set(got)))
        q = len(query_ids(sess.query))
        for a in by_session.get(idx, []):
            if a.cursor != q + (a.frame + 1) * ft:
                errors += 1
            full = len(a.tokens) == served.mix["max_new_tokens"]
            ended = bool(a.tokens) and a.tokens[-1] == served.eos_id
            if not (full or ended):
                errors += 1
    return errors


def pick(served: Served, seed: int) -> List[int]:
    """The sessions to check: the deepest (the deepest answer's; in
    grounding mode the one that scored most frames), and one drawn from the
    seed among those of the other half of the lanes (so that a fault in
    either half of a batch shows), or among all others where that half has
    none."""
    half = served.mix["lanes"] // 2
    if served.grounding:
        lane = served.lanes
        cands = sorted(i for i, rows in served.scores.items() if rows)
        if not cands:
            return []
        deep = max(cands, key=lambda i: (len(served.scores[i]), i))
        other = [i for i in cands if (lane.get(i, 0) < half) != (lane.get(deep, 0) < half)]
    else:
        if not served.answers:
            return []
        deep_answer = max(served.answers, key=lambda a: (a.frame, a.session))
        deep = deep_answer.session
        cands = sorted({a.session for a in served.answers})
        other = sorted({a.session for a in served.answers
                        if (a.lane < half) != (deep_answer.lane < half)})
    rest = other or [i for i in cands if i != deep]
    out = [deep]
    if rest:
        out.append(rest[int(np.random.default_rng([seed, 2]).integers(len(rest)))])
    return out


@torch.no_grad()
def reference_readings(ref, served: Served, s: Shapes, w: Dict, precisions: Sequence,
                       session_ids: Sequence[int], device) -> List[Dict[str, float]]:
    """For each precision: the widest and the mean score gap and the widest
    token gap of the program against the reference ``ref`` (the first
    precision, the configuration's own); for each later one (a control), the
    same of what that precision computes against the reference: its scores,
    and the reference's gap of the token it would put first at each
    position."""
    ref.no_tf32()
    ft = s.frame_tokens
    out = [dict(score_gap=0.0, token_gap=0.0) for _ in precisions]
    gap_sum, gap_n = [0.0] * len(precisions), 0
    by_session: Dict[int, List[Answer]] = {}
    for a in served.answers:
        by_session.setdefault(a.session, []).append(a)
    prompt = answer_prompt_ids()
    for idx in session_ids:
        sess = served.sessions[idx]
        rows = served.scores[idx]
        n = len(rows)
        q = query_ids(sess.query)
        answers = by_session.get(idx, [])
        branches = [ref.Branch(len(q) + (a.frame + 1) * ft, prompt + a.tokens[:-1],
                               len(prompt) - 1) for a in answers]
        pixels = torch.from_numpy(np.ascontiguousarray(served.pixels[sess.video, :n])).to(device)
        score_rows = torch.tensor([len(q) + (j + 1) * ft - 1 for j in range(n)], device=device)
        prog = torch.tensor([[r["informative_score"], r["relevance_score"]] for r in rows],
                            device=device, dtype=torch.float32)
        ref_logits = None
        ref_probs = None
        for k, p in enumerate(precisions):
            frames = ref.frame_embeds(w, s, p, pixels)
            stream = torch.cat([ref.embed_rows(w, s, p, q, device),
                                frames.reshape(-1, frames.shape[-1])])
            probs, logits = ref.decoder(w, s, p, stream, branches, score_rows)
            del frames, stream
            if k == 0:
                ref_probs, ref_logits = probs, logits
            gap = ((prog if k == 0 else probs) - ref_probs).abs()  # the program's, or the control's
            out[k]["score_gap"] = max(out[k]["score_gap"], gap.max().item())
            gap_sum[k] += gap.sum().item()
            if k == 0:
                gap_n += gap.numel()
                for a, lg in zip(answers, logits):
                    toks = torch.tensor(a.tokens, device=device)
                    gap = lg.max(dim=-1).values - lg.gather(1, toks[:, None])[:, 0]
                    out[0]["token_gap"] = max(out[0]["token_gap"], gap.max().item())
            else:
                for lg, rl in zip(logits, ref_logits):
                    first = lg.argmax(dim=-1)
                    gap = rl.max(dim=-1).values - rl.gather(1, first[:, None])[:, 0]
                    out[k]["token_gap"] = max(out[k]["token_gap"], gap.max().item())
        del ref_logits, ref_probs
    for k in range(len(precisions)):
        out[k]["score_gap_mean"] = gap_sum[k] / max(gap_n, 1)
    return out
