"""LiveInferEngine — single-stream streaming duet inference on one device.

Port of `mmduet_tpu/infer/engine.py` (`LiveInferEngine`), the rebuild of
the reference `LiveInferForBenchmark` (`test/inference.py:20-313`):

- every forward runs at one of a few bucket widths against the
  preallocated KV cache, which the forwards update in place (the JAX
  engine donates the buffers to jitted functions instead);
- fused multi-frame blocks score ``block_frames`` frames per forward; a
  response trigger mid-block rolls the rest back (a cursor rewind), so
  results equal single-frame stepping;
- generation is `mmduet.decode_loop`: prefill + greedy decode into a
  scratch cache with the repetition penalty as a token bitmask;
- ``remove_assistant_turns`` is a cursor rewind;
- all three threshold policies (`state.ThresholdPolicy`);
- a per-frame latency record;
- quantized serving: int8 / int4 weight leaves in ``params``
  (`models.quant`), ``kv_cache_quant="int8"`` (a per-token int8 KV cache),
  and a runtime LoRA adapter (``lora``, ``lora_scale``) passed to every
  forward.

Protocol-parity quirks kept (they define the published numbers): the
first stream chunk is ``[system tokens] + frames`` with no stream header,
and after a kept assistant turn the next frame is joined with ``[last
generated token] + stream header`` (`inference.py:229-234`).

Not ported yet: ``mesh`` (raises `NotImplementedError`), and `prewarm`,
`stream_video`, `append_frames`.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MMDuetConfig, TestArgs

from ..models import mmduet
from ..models.qwen2 import embed_tokens, init_kv_cache, ints_to
from .state import (
    StreamState,
    ThresholdPolicy,
    build_prompt_fragments,
    frame_joiner_ids,
    pad_chunk,
    pick_bucket,
    validate_threshold_args,
    visual_encode,
)

VISION_BATCH = 32


class LiveInferEngine:
    """Streaming inference over one video conversation at a time, on the
    device that holds ``params``."""

    def __init__(
        self,
        params,
        cfg: MMDuetConfig,
        tokenizer,
        args: TestArgs,
        lora=None,
        lora_scale: float = 0.0,
        kv_cache_size: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        block_frames: Optional[int] = None,
        mesh=None,
        kv_cache_quant: Optional[str] = None,  # "int8": per-token int8 KV
        # cache ({"qw", "qs"} leaves, `qwen2.init_kv_cache`)
    ):
        if mesh is not None:
            raise NotImplementedError("LiveInferEngine: mesh serving is not ported yet")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.lora = lora
        self.lora_scale = lora_scale
        final_norm = params["decoder"]["final_norm"]
        self.device = final_norm.device
        # activation dtype: that of a norm leaf (the weight leaves may be
        # quantized)
        self.dtype = dtype or final_norm.dtype
        self.kv_cache_quant = kv_cache_quant

        validate_threshold_args(args)
        self.args = args
        self.score_heads = args.score_heads.split(",")
        self.grounding_mode = args.grounding_mode

        # pre-tokenized incremental fragments (reference inference.py:61-63)
        self._start_ids, self._stream_open_ids, self._gen_prompt_ids = (
            build_prompt_fragments(tokenizer, args.system_prompt)
        )

        cache_size = kv_cache_size or (
            args.max_num_frames * cfg.frame_num_tokens + 4096
        )
        # rounded up to 2048 slots as the JAX engine rounds (to its
        # kernel's KV block), so both engines overflow at the same point
        self._cache_size = -(-cache_size // 2048) * 2048
        self.set_fps(args.frame_fps)

        # Frames per fused chunk forward. Grounding mode never generates,
        # so a trigger never rolls frames back and a big block is a pure
        # win; generation keeps blocks moderate so a mid-block trigger
        # discards little work.
        if block_frames is None:
            block_frames = 32 if args.grounding_mode else 8
        self.block_frames = max(1, block_frames)
        self.reset()

    # ------------------------------------------------------------------
    # session control
    # ------------------------------------------------------------------

    def set_fps(self, fps: Optional[float] = None, frame_interval: Optional[float] = None):
        assert (fps is None) != (frame_interval is None)
        if fps is not None and fps <= 0:
            # 'auto' sentinel (--frame_fps 0): the CLI sets the real
            # per-sample rate later via set_fps(sample.fps)
            fps = 1.0
        self.frame_fps = fps if fps is not None else 1.0 / frame_interval
        self.frame_interval = 1.0 / self.frame_fps

    @torch.inference_mode()
    def reset(self):
        self.state = StreamState(init_kv_cache(
            self.cfg.text, 1, self._cache_size, self.dtype, self.device,
            quant=self.kv_cache_quant,
        ))
        self.query_queue = collections.deque()
        self.frame_embeds: Optional[torch.Tensor] = None  # (T, ft, H)
        self.frame_times: List[float] = []
        self._next_frame = 0
        self.video_time = 0.0
        self.frame_idx = 0
        self.last_role = "system"
        self._pending_ids: List[int] = []
        self.debug_data_list: List[Dict[str, Any]] = []
        self.frame_latencies_ms: List[float] = []
        self.tokens_generated = 0  # over every response since the reset
        self._policy = ThresholdPolicy(self.args)
        self._pen_mask = torch.zeros(
            (self.cfg.text.vocab_size,), dtype=torch.bool, device=self.device
        )

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def _visual(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        px = mmduet.normalize_pixels(self.cfg, pixels_u8).to(self.dtype)
        return mmduet.visual_embed(self.params, self.cfg, px)

    @torch.inference_mode()
    def input_video_stream(self, video_frames) -> None:
        """Vision-encode all frames on the device, VISION_BATCH at a time;
        the embeddings stay on the device."""
        embeds = visual_encode(self._visual, video_frames, self.device, VISION_BATCH)
        self.frame_embeds = embeds
        self.frame_times = [i / self.frame_fps for i in range(len(embeds))]
        self._next_frame = 0

    @torch.inference_mode()
    def input_frame_embeds(self, frame_embeds) -> None:
        """Post-projector frame embeddings (T, frame_tokens, H)."""
        self.frame_embeds = torch.as_tensor(
            frame_embeds, dtype=self.dtype, device=self.device
        )
        self.frame_times = [i / self.frame_fps for i in range(len(frame_embeds))]
        self._next_frame = 0

    @torch.inference_mode()
    def input_vision_feats(self, feats) -> None:
        """Pre-extracted RAW SigLIP patch features (T, P, C); projector +
        pooling run on the device here."""
        feats = torch.as_tensor(feats, dtype=self.dtype, device=self.device)
        self.input_frame_embeds(
            mmduet.spatial_pool(mmduet.project(self.params, feats), self.cfg)
        )

    def input_query_stream(self, conversation: Sequence[dict]) -> None:
        for turn in conversation:
            if turn["role"] == "user":
                self.query_queue.append((turn["time"], turn["content"]))

    # ------------------------------------------------------------------
    # device feeding
    # ------------------------------------------------------------------

    def _embed_ids(self, ids: Sequence[int]) -> torch.Tensor:
        return embed_tokens(
            self.params["decoder"], ints_to(ids, self.device),
            self.cfg.text.vocab_size,
        ).to(self.dtype)

    def _feed(self, embeds: torch.Tensor, compute_lm: bool = False):
        """Feed a (T, H) chunk: bucket-pad, run one step, advance cursor."""
        t_real = embeds.shape[0]
        bucket = pick_bucket(t_real)
        # guard on the PADDED size: the write is bucket-wide
        self.state.check_fits(bucket)
        out = mmduet.step_forward(
            self.params, self.cfg, pad_chunk(embeds, bucket)[None],
            self.state.kv_cache, self.state.cursor, t_real,
            lora=self.lora, lora_scale=self.lora_scale,
            compute_lm_logits=compute_lm,
        )
        # both score probs in ONE tensor: one device->host copy per frame
        probs = torch.stack([out.informative_prob[0], out.relevance_prob[0]])
        self.state.cursor += t_real
        return probs, out.last_logits[0] if compute_lm else None

    def _needs_joiner(self) -> bool:
        return self.state.cursor == 0 or (
            self.last_role == "assistant" and not self.args.remove_assistant_turns
        )

    def _frame_joiner_ids(self) -> List[int]:
        """Token ids to prepend to the next frame chunk (reference
        `inference.py:229-234` semantics)."""
        ids = frame_joiner_ids(
            self.state.cursor, self.last_role, self._pending_ids,
            self.args.remove_assistant_turns,
            self._start_ids, self._stream_open_ids,
        )
        if self.state.cursor != 0 and ids:
            self._pending_ids = []
        return ids

    def _encode_frame(self) -> Optional[Dict[str, float]]:
        if self.frame_embeds is None or self._next_frame >= len(self.frame_times):
            return None
        t0 = time.perf_counter()
        idx = self._next_frame
        self._next_frame += 1
        joiner = self._frame_joiner_ids()
        frame = self.frame_embeds[idx]
        chunk = (
            torch.cat([self._embed_ids(joiner), frame], dim=0) if joiner else frame
        )
        probs, _ = self._feed(chunk)
        inf, rel = probs.tolist()  # host sync: ONE transfer
        self.frame_latencies_ms.append((time.perf_counter() - t0) * 1000)
        self.frame_idx += 1
        self.last_role = "stream"
        return {"informative_score": inf, "relevance_score": rel}

    def _dispatch_frames_block(self, n: int) -> torch.Tensor:
        """Enqueue one n-frame fused block WITHOUT a host sync; returns the
        device-resident (2, n) scores. Cache/cursor/role state advance
        immediately (the device runs the queue in order)."""
        ft = self.cfg.frame_num_tokens
        self.state.check_fits(n * ft)
        idx = self._next_frame
        inf, rel, _ = mmduet.frames_block_forward(
            self.params, self.cfg, self.frame_embeds[idx : idx + n],
            self.state.kv_cache, self.state.cursor,
            lora=self.lora, lora_scale=self.lora_scale,
        )
        self.state.cursor += n * ft
        self._next_frame += n
        self.frame_idx += n
        self.last_role = "stream"
        return torch.stack([inf, rel])

    def _encode_frames_block(self, n: int) -> List[Dict[str, float]]:
        """Score n joiner-free frames in one forward (ONE host sync for all
        n scores). Exactly the cache contents of n single steps."""
        t0 = time.perf_counter()
        inf, rel = self._dispatch_frames_block(n).tolist()  # ONE transfer
        per_frame = (time.perf_counter() - t0) * 1000 / n
        self.frame_latencies_ms.extend([per_frame] * n)
        return [
            {"informative_score": i, "relevance_score": r}
            for i, r in zip(inf, rel)
        ]

    def _rollback_frames(self, k: int) -> None:
        """Un-consume the last k block frames: cursor rewind + queue rewind.
        Their cache slots are overwritten when they are re-encoded."""
        if k <= 0:
            return
        ft = self.cfg.frame_num_tokens
        self.state.cursor -= k * ft
        self._next_frame -= k
        self.frame_idx -= k
        del self.frame_latencies_ms[-k:]

    def _encode_query(self) -> None:
        _, query = self.query_queue.popleft()
        ids = self.tokenizer.apply_chat_template(
            [{"role": "user", "content": query}],
            tokenize=True,
            add_stream_query_prompt=self.last_role == "stream",
            add_stream_prompt=True,
        )
        self._feed(self._embed_ids(ids))
        self.last_role = "user"

    def _generate_response(self) -> str:
        gen_embeds = self._embed_ids(self._gen_prompt_ids)
        t_real = gen_embeds.shape[0]
        # prompt prefill + the W-wide scratch commit after it
        # (`decode_loop` capacity contract: W = max(max_new - 1, 1))
        self.state.check_fits(t_real + max(self.args.max_new_tokens - 1, 1))
        pre_gen_cursor = self.state.cursor
        packed, _, pen_mask = mmduet.decode_loop(
            self.params, self.cfg, gen_embeds[None], self.state.kv_cache,
            pre_gen_cursor, t_real, self._pen_mask[None],
            max_new=self.args.max_new_tokens,
            eos_id=self.tokenizer.eos_token_id,
            rep=self.args.repetition_penalty,
            lora=self.lora, lora_scale=self.lora_scale,
        )
        self._pen_mask = pen_mask[0]
        packed = packed[0].tolist()  # ONE fetch: tokens + n + cursor
        n, cursor = packed[-2], packed[-1]
        self.tokens_generated += n
        token_ids = packed[:n]
        if self.args.remove_assistant_turns:
            # rewind: keep the pre-response stream context only
            self.state.cursor = pre_gen_cursor
            self._pending_ids = []
        else:
            self.state.cursor = cursor
            self._pending_ids = [token_ids[-1]] if n else []
        response = self.tokenizer.decode(token_ids, skip_special_tokens=True)
        self.last_role = "assistant"
        return response

    # ------------------------------------------------------------------
    # the streaming loop (reference inference.py:276-313)
    # ------------------------------------------------------------------

    def _block_budget(self) -> int:
        """How many frames can run in one block before the next query is due
        or the stream ends."""
        remaining = len(self.frame_times) - self._next_frame
        n = min(self.block_frames, remaining)
        if self.query_queue:
            q_time = self.query_queue[0][0]
            # frame i of the block is checked at video_time + i*interval
            free = int(
                np.ceil((q_time - self.video_time) / self.frame_interval - 1e-9)
            )
            n = min(n, max(free, 0))
        return n

    def _inference_grounding(self) -> List[Dict[str, Any]]:
        """Grounding-mode streaming with one-deep block pipelining: the
        next block is enqueued BEFORE the previous block's scores are
        fetched, so the host round trip hides behind device compute.

        Safe because grounding never generates: a trigger cannot roll
        enqueued frames back, so the schedule is score-independent. Scores
        are processed in frame order, so outputs equal the sequential
        loop's. Per-frame latency is the aggregate wall-clock over frames
        (overlap makes per-block walls unobservable)."""
        responses = [
            {"time": t, "content": q, "role": "user"} for t, q in self.query_queue
        ]
        t_wall = time.perf_counter()
        start_frame = self._next_frame
        lat_start = len(self.frame_latencies_ms)
        pending: Optional[Tuple[torch.Tensor, int, float]] = None

        def process(scores: Dict[str, float], t: float) -> None:
            self.debug_data_list.append(dict(time=t, **scores))
            self._policy.triggered(sum(
                v for k_, v in scores.items() if k_ in self.score_heads
            ))

        def drain_pending() -> None:
            nonlocal pending
            if pending is None:
                return
            dev, n, base_t = pending
            pending = None
            inf, rel = dev.tolist()  # ONE transfer, overlapped with the next block
            t = base_t
            for j in range(n):
                process({"informative_score": inf[j], "relevance_score": rel[j]}, t)
                # repeated addition, bit-exact with the sequential loop's
                # per-frame accumulation
                t += self.frame_interval

        while self._next_frame < len(self.frame_times):
            if self.query_queue and self.video_time >= self.query_queue[0][0]:
                self._encode_query()
            n = self._block_budget()
            if n == self.block_frames and n >= 2 and not self._needs_joiner():
                base_t = self.video_time
                dev = self._dispatch_frames_block(n)
                # previous block: its round trip hides behind this one
                drain_pending()
                pending = (dev, n, base_t)
                for _ in range(n):  # repeated addition: bit-exact clocks
                    self.video_time += self.frame_interval
            else:
                drain_pending()
                scores = self._encode_frame()
                process(scores, self.video_time)
                self.video_time += self.frame_interval
        drain_pending()

        n_frames = self._next_frame - start_frame
        total_ms = (time.perf_counter() - t_wall) * 1000
        # replace only THIS call's entries with the uniform aggregate
        del self.frame_latencies_ms[lat_start:]
        self.frame_latencies_ms.extend([total_ms / max(n_frames, 1)] * n_frames)
        return sorted(responses, key=lambda x: x["time"])

    @torch.inference_mode()
    def inference(self) -> List[Dict[str, Any]]:
        """Stream all frames; returns the time-sorted response list in the
        reference's JSONL schema (`test/inference.py:276-313` semantics).

        Frames run in blocks of ``block_frames`` per forward when no query
        or turn-joiner interrupts; a response trigger mid-block rolls the
        un-consumed frames back (cursor rewind), so results equal
        single-frame stepping. Grounding mode, which never generates, runs
        the pipelined loop (`_inference_grounding`)."""
        if self.grounding_mode:
            return self._inference_grounding()
        responses = [
            {"time": t, "content": q, "role": "user"} for t, q in self.query_queue
        ]
        while self._next_frame < len(self.frame_times):
            if self.query_queue and self.video_time >= self.query_queue[0][0]:
                self._encode_query()

            n = self._block_budget()
            # only full blocks run fused; tails and joiner-bearing frames
            # run as single steps
            if n == self.block_frames and n >= 2 and not self._needs_joiner():
                scores_list = self._encode_frames_block(n)
            else:
                scores_list = [self._encode_frame()]

            for i, scores in enumerate(scores_list):
                self.debug_data_list.append(dict(time=self.video_time, **scores))
                stream_end_score = sum(
                    v for k, v in scores.items() if k in self.score_heads
                )
                if self._policy.triggered(stream_end_score):
                    # discard not-yet-evaluated block frames, re-run later
                    self._rollback_frames(len(scores_list) - 1 - i)
                    response = self._generate_response()
                    responses.append(
                        {
                            "time": self.video_time,
                            "content": response,
                            "role": "assistant",
                        }
                    )
                    self.video_time += self.frame_interval
                    break
                self.video_time += self.frame_interval
        return sorted(responses, key=lambda x: x["time"])
