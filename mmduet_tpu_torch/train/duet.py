"""Duet training batches made in memory, collated as the training CLI
collates a dataset's samples.

Each sample has the shape of `StreamDataset.make_sample`'s output: system
prompt, a query, then learned stream turns each followed by a learned
answer, with random pixel frames. `duet_batches` groups them into
optimizer batches of ``accum`` micro-batches of one sample, padded by the
shared `Collator` to the CLI's length and frame buckets. `chip_smoke.py`
and `scripts/profile_torch.py` train on them at full width.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..config import DEFAULT_SYSTEM_PROMPT, MMDuetConfig
from ..data.collator import Collator, stack_accum
from ..stream.labels import get_informative_labels, get_relevance_labels

from .loop import parse_length_buckets

QUERY = "What is happening in the video?"


def duet_sample(tok, rng: np.random.RandomState, idx: int, turn_frames: Sequence[int],
                frame_size: int) -> tuple:
    """One sample and its index: (text, frames, learn ranges, informative
    labels, relevance labels, idx). Stream turn i holds ``turn_frames[i]``
    frames of ``frame_size`` pixels a side; the first is unrelated to the
    query, the rest related."""
    conv = [{"role": "system", "content": DEFAULT_SYSTEM_PROMPT},
            {"role": "user", "content": QUERY}]
    for i, n in enumerate(turn_frames):
        conv.append({"role": "stream", "num_frames": n, "learn": True,
                     "related": [{"related": bool(i), "num_frames": n}]})
        conv.append({"role": "assistant", "learn": True,
                     "content": f"Step {idx}.{i}: the person moves the cup to the left."})
    n_frames = sum(turn_frames)
    frames = rng.randint(0, 256, (n_frames, frame_size, frame_size, 3), dtype=np.uint8)
    return (tok.apply_chat_template(conv), frames, tok.get_learn_ranges(conv),
            get_informative_labels(conv)[:n_frames], get_relevance_labels(conv)[:n_frames], idx)


def duet_batches(tok, cfg: MMDuetConfig, n: int, accum: int, device,
                 turn_frames: Sequence[int] = (22, 26), seq_len: int = 5924,
                 max_frames: int = 100, seed: int = 3) -> List[dict]:
    """``n`` optimizer batches of ``accum`` micro-batches of one sample,
    collated with the buckets of ``parse_length_buckets("auto", seq_len)``
    and of ``max_frames`` (quantum 8), as tensors on ``device`` with the
    train step's keys. The defaults are the JAX CLI's at 49 tokens a frame;
    two turns of 22 and 26 frames then pad to the 2944-token bucket."""
    collator = Collator(
        tok, seq_len=seq_len, max_frames=max_frames, frame_size=cfg.frame_resolution,
        buckets=parse_length_buckets("auto", seq_len),
        frame_buckets=parse_length_buckets("auto", max_frames, quantum=8))
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        micro = [collator([duet_sample(tok, rng, accum * i + a, turn_frames,
                                       cfg.frame_resolution)])
                 for a in range(accum)]
        batch = stack_accum(micro)
        out.append({k: torch.from_numpy(v).to(device) for k, v in batch.items()
                    if k not in ("sample_idxs", "num_frames", "n_real_tokens")})
    return out
