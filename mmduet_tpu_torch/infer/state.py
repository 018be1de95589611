"""Streaming state: preallocated KV cache + cursor + shape buckets, and
the host-side policy code the engines share.

`serving_cache` makes an engine's cache with the kv heads of its
parameters: a rank's own under tensor parallelism (the model axis of
`parallel.sharding.kv_cache_sharding`).

`upload_pixels` puts pixels in pinned host memory and copies them
``non_blocking`` on a given CUDA stream; `encode_uploaded` encodes them at
the one batch shape (`LiveInferEngine.stream_video`).

The host code here (`DEFAULT_BUCKETS`, `pick_bucket`,
`validate_threshold_args`, `build_prompt_fragments`, `frame_joiner_ids`,
`ThresholdPolicy`) is a copy of `mmduet_tpu/infer/state.py`, which imports
jax at its top; `tests/test_torch_engine.py` pins the copies equal to the
originals until both packages share one jax-free module.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Qwen2Config
from ..models.quant import out_width
from ..models.qwen2 import KVCache, init_kv_cache
from ..ops import attention, quant_matmul
from ..parallel import ProcessMesh
from ..trace import span

# Default prefill bucket widths. Frame steps are 49(+small joiner) tokens;
# query turns vary; the system-prompt opener can be larger.
DEFAULT_BUCKETS = (8, 16, 32, 64, 96, 128, 192, 256)


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (grows by doubling past the table)."""
    i = bisect.bisect_left(buckets, n)
    if i < len(buckets):
        return buckets[i]
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def pad_chunk(embeds: torch.Tensor, bucket: int) -> torch.Tensor:
    """(T, H) -> (bucket, H) zero-padded at the end."""
    t, h = embeds.shape
    if t == bucket:
        return embeds
    return torch.cat(
        [embeds, embeds.new_zeros((bucket - t, h))], dim=0
    )


def cache_slots(max_num_frames: int, frame_num_tokens: int,
                kv_cache_size: Optional[int] = None) -> int:
    """An engine's cache length: ``kv_cache_size``, or room for
    ``max_num_frames`` frames and 4096 tokens of text, rounded up to 2048
    slots as the JAX engines round (to their kernel's KV block), so all
    engines overflow at the same point."""
    size = kv_cache_size or (max_num_frames * frame_num_tokens + 4096)
    return -(-size // 2048) * 2048


def decode_route(device, mesh) -> str:
    """How an engine runs its device work: its streaming forwards (steps,
    frame blocks, batched dispatches), its decode's prompt prefill and each
    greedy decode step (`mmduet.decode_loop`). ``"graph"`` on a CUDA device
    without a process mesh (one-device `Mesh` included), where each of
    them replays a CUDA graph captured once a shape
    (`mmduet.EngineGraphs`), as the JAX engines run one compiled device
    program a shape; ``"eager"`` on the CPU and on a rank of a
    `ProcessMesh`, whose collectives a graph cannot hold. The same bodies
    (`mmduet.step_body`, `chunk_scores_body`, `frames_block_body`,
    `decode_step`) run on both routes."""
    if torch.device(device).type == "cuda" and not isinstance(mesh, ProcessMesh):
        return "graph"
    return "eager"


_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def split_scratch_need(params, cfg: Qwen2Config, lanes: int, width: int,
                       slots: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The most split scratch an engine's decoder forwards ask of kernels
    A and B: (A's f32 partials and int32 counters, B's f32 partials and
    int32 tickets) over every chunk of 1 to ``width`` tokens on ``lanes``
    lanes against ``slots`` cache slots (`attention.decode_scratch_numel`;
    `quant_matmul.int4_plan` for each int4 projection at ``lanes`` times
    the width rows, and the LM head at a row a lane), with the head counts
    and weight shapes of ``params`` (a rank's own tree on a process mesh).
    An engine on the graph route reserves it before its first capture
    (`reserve_split_scratch`), and `scripts/memory_budget_torch.py` prices
    it."""
    layers, hd = params["decoder"]["layers"], cfg.head_dim
    kh, nh = out_width(layers["k_proj"]) // hd, out_width(layers["q_proj"]) // hd
    a = b = (0, 0)
    for w in range(1, width + 1):
        n = attention.decode_scratch_numel(lanes, kh, w * (nh // kh), slots, hd)
        a = (max(a[0], n[0]), max(a[1], n[1]))
    int4 = [(layers[name], range(lanes, lanes * width + 1, lanes)) for name in _PROJECTIONS
            if isinstance(layers[name], dict) and "qw4" in layers[name]]
    if isinstance(params["lm_head"], dict) and "qw4" in params["lm_head"]:
        int4.append((params["lm_head"], (lanes,)))
    for leaf, rows in int4:
        G, g, O = leaf["qw4"].shape[-3], 2 * leaf["qw4"].shape[-2], leaf["qw4"].shape[-1]
        for R in rows:
            n = quant_matmul.split_scratch_numel(quant_matmul.int4_plan(R, G * g, O, g), R, O)
            b = (max(b[0], n[0]), max(b[1], n[1]))
    return a, b


def reserve_split_scratch(params, cfg: Qwen2Config, lanes: int, width: int, slots: int,
                          device) -> None:
    """Grows kernels A's and B's split scratch of ``device`` to what
    `split_scratch_need` gives, so that the captured graphs of an engine
    (`mmduet.EngineGraphs`, which keep the scratch they captured) all hold
    one scratch: a chunk of at most ``width`` tokens never grows it."""
    need_a, need_b = split_scratch_need(params, cfg, lanes, width, slots)
    if need_a[0]:
        attention.reserve_split_scratch(device, *need_a)
    if need_b[0]:
        quant_matmul.reserve_split_scratch(device, *need_b)


def serving_cache(cfg: Qwen2Config, decoder, batch: int, max_len: int, dtype: torch.dtype,
                  device, quant: Optional[str] = None) -> KVCache:
    """A zero (L, batch, kh, max_len, hd) cache, bf16 or int8, with kh the
    kv heads of the ``decoder`` tree's k projection (whose output dim is
    last in every leaf layout): ``cfg.num_kv_heads``, or a rank's part of
    them in its local tree."""
    k_proj = decoder["layers"]["k_proj"]
    out = (k_proj["qw4"] if "qw4" in k_proj else k_proj["qw"]) if isinstance(k_proj, dict) \
        else k_proj
    return init_kv_cache(cfg, batch, max_len, dtype, device, quant=quant,
                         num_kv_heads=out.shape[-1] // cfg.head_dim)


def _frames_array(video_frames) -> np.ndarray:
    if isinstance(video_frames, (list, tuple)):
        video_frames = np.stack(video_frames)
    video_frames = np.asarray(video_frames)
    if video_frames.ndim != 4 or video_frames.shape[-1] != 3:
        raise ValueError(
            f"expected (T,H,W,3) uint8 frames, got {video_frames.shape}"
        )
    return video_frames


class Uploaded(NamedTuple):
    """Pixels on the device (`upload_pixels`): ``buf`` (padded to a
    multiple of the encode batch), ``n`` real frames, and ``host``, the
    pinned host copy the transfer reads (None on the CPU), which the
    caller holds until the transfer has finished."""

    buf: torch.Tensor
    n: int
    host: Optional[torch.Tensor]


def upload_pixels(video_frames, device, batch: int = 32,
                  stream: Optional["torch.cuda.Stream"] = None) -> Uploaded:
    """uint8 (T, H, W, 3) pixels, zero-padded to a multiple of ``batch``
    frames, onto ``device``.

    On a CUDA device the pixels are first put in pinned (page-locked) host
    memory and copied ``non_blocking`` on ``stream`` (default: the current
    one): the host does not wait for the transfer, so a caller can start
    the next chunk's upload while the card decodes the current one
    (`LiveInferEngine.stream_video`). A copy from pageable memory would
    block the host until it ends. On the CPU the array is used in place."""
    video_frames = _frames_array(video_frames)
    n = video_frames.shape[0]
    pad = -n % batch
    if pad:
        video_frames = np.concatenate(
            [video_frames, np.zeros((pad, *video_frames.shape[1:]), video_frames.dtype)])
    host = torch.from_numpy(np.ascontiguousarray(video_frames))
    device = torch.device(device)
    if device.type != "cuda":
        return Uploaded(host.to(device), n, None)
    host = host.pin_memory()
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        buf = host.to(device, non_blocking=True)
    return Uploaded(buf, n, host)


def encode_uploaded(visual_fn: Callable[[torch.Tensor], torch.Tensor],
                    buf: torch.Tensor, n: int, batch: int = 32) -> torch.Tensor:
    """Vision-encode an uploaded padded pixel buffer ``batch`` frames at a
    time (every encode at the one batch shape, as the whole batches of
    `staged_visual_encode` are); returns the (n, ft, H) embeddings of the
    real frames."""
    outs = [visual_fn(buf[j: j + batch]) for j in range(0, buf.shape[0], batch)]
    return torch.cat(outs, dim=0)[:n]


def staged_visual_encode(visual_fn: Callable[[torch.Tensor], torch.Tensor],
                         video_frames, device, batch: int = 32) -> torch.Tensor:
    """Vision-encode uint8 (T, H, W, 3) pixels ``batch`` frames at a time
    on ``device`` through ``visual_fn`` (pixels -> (n, ft, H) embeddings),
    for the single-stream engine and the batched engines; returns
    (T, ft, H). Each batch is uploaded just before its encode, so one
    batch of pixels is resident; a ragged tail runs at its own length
    (frames are independent in the tower, and nothing is compiled per
    shape). Each batch's upload and encode are the spans ``vision.upload``
    and ``vision.encode``."""
    video_frames = _frames_array(video_frames)
    if video_frames.shape[0] == 0:
        raise ValueError("staged_visual_encode: no frames to encode")
    outs = []
    for i in range(0, video_frames.shape[0], batch):
        n = min(batch, video_frames.shape[0] - i)
        with span("vision.upload", frames=n):
            px = torch.from_numpy(np.ascontiguousarray(video_frames[i: i + n])).to(device)
        with span("vision.encode", frames=n):
            outs.append(visual_fn(px))
    return torch.cat(outs, dim=0)


def validate_threshold_args(args) -> None:
    """Exactly one threshold mode must be set (reference
    `test/inference.py:53-54`). Shared by both engines."""
    n_set = sum(
        x is not None
        for x in (
            args.stream_end_prob_threshold,
            args.stream_end_score_sum_threshold,
            args.threshold_z,
        )
    )
    if n_set != 1:
        raise ValueError(
            "exactly one of stream_end_prob_threshold, "
            "stream_end_score_sum_threshold, threshold_z must be set "
            f"(got prob={args.stream_end_prob_threshold}, "
            f"sum={args.stream_end_score_sum_threshold}, z={args.threshold_z})"
        )
    rl = args.running_list_length
    if (
        args.threshold_z is not None
        and isinstance(rl, int) and rl > 0
        and (args.first_n_frames_no_generate or 0) > rl
    ):
        import warnings

        # reference-faithful footgun (`test/inference.py:144-156`): the
        # no-generate gate compares against the TRUNCATED rolling list,
        # so first_n > running_list_length can never be satisfied and the
        # run emits zero responses
        warnings.warn(
            f"threshold_z with first_n_frames_no_generate="
            f"{args.first_n_frames_no_generate} > running_list_length={rl}: "
            "the rolling list never reaches first_n, so generation never "
            "triggers (the reference behaves identically)"
        )


def build_prompt_fragments(tokenizer, system_prompt: str):
    """The three pre-tokenized incremental fragments every engine feeds
    (reference `inference.py:61-63`): (start_ids, stream_open_ids,
    gen_prompt_ids)."""
    start_ids = tokenizer.apply_chat_template(
        [{"role": "system", "content": system_prompt}], tokenize=True
    )
    stream_open_ids = tokenizer.encode(
        f"\n{tokenizer.template.bos}stream\n"
    )
    gen_prompt_ids = tokenizer.encode(
        f"{tokenizer.template.eos}\n{tokenizer.template.bos}assistant\n"
    )
    return start_ids, stream_open_ids, gen_prompt_ids


def frame_joiner_ids(
    cursor: int,
    last_role: str,
    pending_ids: List[int],
    remove_assistant_turns: bool,
    start_ids,
    stream_open_ids,
) -> List[int]:
    """Token ids to prepend to the next frame chunk (reference
    `inference.py:229-234`). The caller clears ``pending_ids`` when the
    joiner consumed them (i.e. whenever a non-start joiner is returned)."""
    if cursor == 0:
        return list(start_ids)
    if last_role == "assistant" and not remove_assistant_turns:
        return list(pending_ids) + list(stream_open_ids)
    return []


class ThresholdPolicy:
    """Per-stream response-trigger policy (reference `test/inference.py:
    287-299` sum-reset / single-frame modes plus the z-score adaptive mode
    of `_call_for_streaming`, `inference.py:144-156`). Each stream owns
    one instance; trigger decisions are tiny host-side scalar work.
    """

    def __init__(self, args):
        self.args = args
        self.reset()

    def reset(self) -> None:
        self.prob_list: List[float] = []
        self.score_sum: float = 0.0

    def _append(self, s: float) -> None:
        self.prob_list.append(s)
        rl = self.args.running_list_length
        if isinstance(rl, int) and rl > 0:
            self.prob_list = self.prob_list[-rl:]

    def triggered(self, stream_end_score: float) -> bool:
        a = self.args
        if a.threshold_z is not None:
            # adaptive: mean + z*std of the rolling window (computed BEFORE
            # appending the current score — reference inference.py:144-156)
            if len(self.prob_list) < (a.first_n_frames_no_generate or 0):
                # the reference's warmup threshold is literally 1 (not inf,
                # `inference.py:146`): with BOTH score heads selected the
                # summed score can exceed 1 and trigger during warmup —
                # reproduced exactly
                thr = 1.0
            else:
                lst = self.prob_list
                thr = (
                    (np.mean(lst) + a.threshold_z * np.std(lst))
                    if lst
                    else float("inf")
                )
            self._append(stream_end_score)
            return stream_end_score > thr
        self._append(stream_end_score)
        self.score_sum += stream_end_score
        if (
            a.stream_end_score_sum_threshold is not None
            and self.score_sum > a.stream_end_score_sum_threshold
        ):
            self.score_sum = 0.0
            return True
        if (
            a.stream_end_prob_threshold is not None
            and stream_end_score > a.stream_end_prob_threshold
        ):
            return True
        return False


@dataclass
class StreamState:
    """Host-side handle on the device stream: cache + cursor."""

    kv_cache: KVCache
    cursor: int = 0  # tokens committed to the cache

    @property
    def capacity(self) -> int:
        return self.kv_cache.max_len

    def check_fits(self, n: int) -> None:
        if self.cursor + n > self.capacity:
            raise RuntimeError(
                f"KV cache overflow: cursor {self.cursor} + chunk {n} "
                f"> capacity {self.capacity}. Raise kv_cache_size."
            )
