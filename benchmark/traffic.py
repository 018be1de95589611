"""The one traffic generator: a mix's data file (``benchmark/traffic/<mix>.json``)
and ``--seed`` give the sessions a run offers and the pixels they carry.

A mix holds parameters only; the generator reads them:

- ``lanes``, ``block_frames``, ``frame_fps``, ``max_num_frames``, the
  threshold policy (``score_heads``, ``stream_end_score_sum_threshold``),
  ``remove_assistant_turns``, ``gen_coalesce_rounds``, ``max_new_tokens``,
  ``repetition_penalty``: the serving protocol;
- ``pool_videos``, ``resolution``, ``pool_seed`` and ``frames``
  (``{"min", "max"}``): a fixed set of videos, as an evaluation set is,
  made before the window from ``pool_seed`` (so that making pixels never
  falls in the window); video v has its own length, the lengths evenly
  spaced from min to max;
- each cycle of sessions streams every video once, in an order drawn by
  ``--seed``, so that every seed offers the same work in another order;
- ``queries`` and ``query_time``: one query a session, drawn by ``--seed``.

The videos are moving coloured blobs over noise: frames that differ from
one another and change smoothly, so the tower and the score heads see
varied content.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch

BLOBS = 8
NOISE = 12.0


@dataclass(frozen=True)
class Session:
    index: int
    video: int
    frames: int
    query: str


def lengths(mix: dict) -> List[int]:
    """Each video's length, evenly spaced from ``frames["min"]`` to
    ``frames["max"]``."""
    f, n = mix["frames"], mix["pool_videos"]
    if n == 1:
        return [f["min"]]
    return [int(round(f["min"] + (f["max"] - f["min"]) * i / (n - 1))) for i in range(n)]


def sessions(mix: dict, seed: int) -> Iterator[Session]:
    """Endless sessions: every video once a cycle, in an order drawn from
    ``seed``, each with a query drawn from it."""
    rng = np.random.default_rng([seed, 1])
    lens = lengths(mix)
    order: List[int] = []
    for index in itertools.count():
        if not order:
            order = [int(v) for v in rng.permutation(mix["pool_videos"])]
        video = order.pop()
        query = mix["queries"][int(rng.integers(len(mix["queries"])))]
        yield Session(index, video, lens[video], query)


@torch.no_grad()
def pixel_pool(mix: dict, device, batch: int = 25) -> np.ndarray:
    """(pool_videos, longest video, R, R, 3) uint8 pixels on the host, made
    on ``device`` from the mix's ``pool_seed``."""
    R = mix["resolution"]
    V, F = mix["pool_videos"], max(lengths(mix))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(mix["pool_seed"])

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    out = np.empty((V, F, R, R, 3), np.uint8)
    axis = torch.arange(R, device=dev, dtype=torch.float32)
    yy, xx = axis[:, None], axis[None, :]
    for v in range(V):
        base = uniform(3, lo=40, hi=200)
        centre = uniform(BLOBS, 2, hi=R)
        speed = uniform(BLOBS, 2, lo=-2.0, hi=2.0) * R / 384
        sigma = uniform(BLOBS, lo=0.05, hi=0.2) * R
        colour = uniform(BLOBS, 3, lo=-120, hi=120)
        for f0 in range(0, F, batch):
            t = torch.arange(f0, min(F, f0 + batch), device=dev, dtype=torch.float32)
            c = centre[None] + t[:, None, None] * speed[None]  # (n, K, 2)
            d2 = ((yy[None, None] - c[..., 0, None, None]) ** 2
                  + (xx[None, None] - c[..., 1, None, None]) ** 2)  # (n, K, R, R)
            w = torch.exp(-d2 / (2 * sigma[None, :, None, None] ** 2))
            img = base + torch.einsum("nkyx,kc->nyxc", w, colour)
            img = img + NOISE * torch.randn(img.shape, generator=gen, device=dev)
            out[v, f0:f0 + len(t)] = img.clamp_(0, 255).round_().to(torch.uint8).cpu().numpy()
    return out
