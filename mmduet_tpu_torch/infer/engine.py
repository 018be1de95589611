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
  scratch cache with the repetition penalty as a token bitmask, its loop
  state on the device; the host reads one flag a step and the packed
  tokens once a response;
- on a CUDA device without a process mesh (``decode_route == "graph"``,
  `state.decode_route`) every step, frame block, decode prefill and
  decode step replays a CUDA graph captured once a shape
  (`mmduet.EngineGraphs`), the port's counterpart of the JAX engine's
  compiled `_step`, `_frames_block` and `lax.while_loop`;
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

``mesh``: a (data, model) `parallel.Mesh` on the parameters' device; the
parameters stay whole and the streaming attention runs per kv-head shard
of the ``model`` axis (`ops.attention.flash_decode_attention_sharded`,
bit-equal to the unsharded kernel). The vision tower's attention is kernel
D on a CUDA device, also under a mesh.

Tensor-parallel serving, one process per card: with ``mesh`` this rank's
`parallel.ProcessMesh` (data D, model N) and ``params`` its local tree
(`parallel.shard_params`), the engine keeps a cache of the rank's own kv
heads and launches kernels A, B and D on its shards directly; the
collectives of `parallel.collectives` join the ranks inside the forwards.
A stream is one lane, which the data axis does not divide: every data
rank runs the whole stream on its replica (the JAX engines' replicated
lane), with no collective over ``data``.
Every rank runs this same host loop, and every host decision (trigger,
rollback, stop token) is taken from values the collectives made the same
bits on every rank (scores from the reduced hidden states, tokens from the
gathered logits). `prewarm` also pays the group's first collectives.

Live sources: `append_frames` / `append_frame_embeds` add frames to a
running session (chunked feeding equals one-shot feeding), and
`stream_video` encodes chunk i+1 while chunk i is decoded. On a CUDA
device the vision tower (upload, kernel D, projector) then runs on a side
stream of its own, and the decoder on a stream of higher priority, ordered
after the caller's current stream and before it again at the end: kernels
A and B, whose split scratch is shared per device (`ops.attention`,
`ops.quant_matmul`), run on one stream at a time.
`prewarm` takes what a cold first session would pay (the kernels'
builds, their scratch, cuBLAS's handles, the allocator's pool, the decode
captures) before it. The engine keeps one KV cache for its life:
`reset` zeros it in place, so the captured graphs' addresses stay valid.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MMDuetConfig, TestArgs

from ..models import mmduet
from ..models.qwen2 import embed_tokens, ints_to, zero_kv_cache
from ..ops import _build
from ..parallel import serving_shard_ctx
from .state import (
    DEFAULT_BUCKETS,
    StreamState,
    ThresholdPolicy,
    build_prompt_fragments,
    cache_slots,
    decode_route,
    encode_uploaded,
    frame_joiner_ids,
    pad_chunk,
    pick_bucket,
    reserve_split_scratch,
    serving_cache,
    upload_pixels,
    validate_threshold_args,
    staged_visual_encode,
)

VISION_BATCH = 32


def live_block_frames(grounding_mode: bool) -> int:
    """`LiveInferEngine`'s frames per fused chunk forward by default."""
    return 32 if grounding_mode else 8


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
        self.mesh = mesh
        # one lane: only the heads are cut, over the mesh's model axis
        self._shard_ctx = serving_shard_ctx(
            mesh, cfg.text.num_heads, cfg.text.num_kv_heads, 1, self.device)
        # "graph": each forward and decode step replays a captured CUDA
        # graph; "eager" on the CPU and on a rank of a process mesh
        self.decode_route = decode_route(self.device, mesh)
        self._graphs = mmduet.EngineGraphs() if self.decode_route == "graph" else None

        validate_threshold_args(args)
        self.args = args
        self.score_heads = args.score_heads.split(",")
        self.grounding_mode = args.grounding_mode
        # one-deep block pipelining in grounding mode (False forces the
        # sequential loop; the results are the same)
        self.pipeline_grounding = True
        self._streams_: Optional[Tuple[torch.cuda.Stream, torch.cuda.Stream]] = None

        # pre-tokenized incremental fragments (reference inference.py:61-63)
        self._start_ids, self._stream_open_ids, self._gen_prompt_ids = (
            build_prompt_fragments(tokenizer, args.system_prompt)
        )

        self._cache_size = cache_slots(args.max_num_frames, cfg.frame_num_tokens,
                                       kv_cache_size)
        self.set_fps(args.frame_fps)

        # Frames per fused chunk forward. Grounding mode never generates,
        # so a trigger never rolls frames back and a big block is a pure
        # win; generation keeps blocks moderate so a mid-block trigger
        # discards little work.
        if block_frames is None:
            block_frames = live_block_frames(args.grounding_mode)
        self.block_frames = max(1, block_frames)
        self.state: Optional[StreamState] = None
        self.reset()
        if self._graphs is not None:  # one split scratch for all the graphs
            reserve_split_scratch(params, cfg.text, 1, max(
                DEFAULT_BUCKETS[-1], self.block_frames * cfg.frame_num_tokens),
                self._cache_size, self.device)

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
        # one cache for the engine's life, zeroed in place (the values of a
        # new one): the captured decode step holds its address
        if self.state is None:
            cache = serving_cache(
                self.cfg.text, self.params["decoder"], 1, self._cache_size, self.dtype,
                self.device, quant=self.kv_cache_quant,
            )
        else:
            cache = zero_kv_cache(self.state.kv_cache)
        self.state = StreamState(cache)
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

    @torch.inference_mode()
    def prewarm(
        self,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        block: bool = True,
        generate: bool = True,
        vision: bool = False,
    ) -> None:
        """Pay before the first live session what its first calls would.

        What a cold first session pays is the `nvcc` builds of the
        kernels (`ops._build`), kernel A's split scratch and its memo for
        each launch shape, kernel B's scratch (int4 leaves), cuBLAS's
        handles and workspaces, the caching allocator's pool and, on the
        graph route, the captures of what it feeds (the JAX engine's
        compiles). This feeds a zero chunk at each prefill bucket (query
        turns and frame steps bucket to these widths), the fused frame
        block, the greedy decode (its prompt's prefill and, on the graph
        route with no end of sequence, a step that runs and is captured),
        one chunk on `stream_video`'s decoder stream (a CUDA device) and, with
        ``vision``, one encode of VISION_BATCH frames on the current stream
        and one through `stream_video`'s path (pinned upload, the side
        stream on a CUDA device). Resets the engine afterwards: a session
        after it equals one on a cold engine."""
        if self.device.type == "cuda":
            _build.build()  # every source at once, one nvcc each
        H = self.cfg.text.hidden_size
        zeros = lambda *shape: torch.zeros(shape, dtype=self.dtype, device=self.device)  # noqa: E731
        for b in buckets:
            if self.state.capacity < b:
                continue
            self.state.cursor = 0
            self._feed(zeros(b, H))
        if block and self.block_frames >= 2:
            self.state.cursor = 0
            mmduet.frames_block_forward(
                self.params, self.cfg, zeros(self.block_frames, self.cfg.frame_num_tokens, H),
                self.state.kv_cache, 0, lora=self.lora, lora_scale=self.lora_scale,
                shard_ctx=self._shard_ctx, graphs=self._graphs,
            )
        if generate:
            self.state.cursor = 0
            self._generate_response(eos_id=-1 if self._graphs is not None else None)
        main, _ = self._streams()
        if main is not None:  # stream_video's decoder stream: its cuBLAS workspace
            main.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(main):
                self.state.cursor = 0
                self._feed(zeros(min(DEFAULT_BUCKETS[-1], self.state.capacity), H))
        if vision:
            r = self.cfg.frame_resolution
            px = np.zeros((VISION_BATCH, r, r, 3), np.uint8)
            staged_visual_encode(self._visual, px, self.device, VISION_BATCH)
            self._encode_chunk(self._upload(px))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()

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
        embeds = staged_visual_encode(self._visual, video_frames, self.device, VISION_BATCH)
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
    def append_frames(self, video_frames) -> None:
        """Add frames to the running session: the live-source path
        (camera, stream, chunked upload). Encodes the new pixels and
        appends their embeddings; the next `inference()` call continues the
        same stream (cache, clocks, policy state), so chunked feeding equals
        one-shot feeding."""
        self.append_frame_embeds(
            staged_visual_encode(self._visual, video_frames, self.device, VISION_BATCH))

    @torch.inference_mode()
    def append_frame_embeds(self, frame_embeds) -> None:
        """`append_frames` for post-projector embeddings (T, ft, H).

        The embeddings live in one (max_num_frames, ft, H) buffer,
        allocated at the first append and written in place with `copy_`,
        so an append costs its own chunk (concatenating would copy the
        whole history at every call). More than ``max_num_frames`` frames
        in a session raise ValueError."""
        new = torch.as_tensor(frame_embeds, dtype=self.dtype, device=self.device)
        base = len(self.frame_times)
        cap = self.args.max_num_frames
        if base + len(new) > cap:
            raise ValueError(
                f"append_frame_embeds: {base} + {len(new)} frames exceeds "
                f"max_num_frames {cap}"
            )
        if self.frame_embeds is None or self.frame_embeds.shape[0] != cap:
            buf = torch.zeros((cap, self.cfg.frame_num_tokens, new.shape[-1]),
                              dtype=self.dtype, device=self.device)
            if self.frame_embeds is not None and base:
                buf[:base].copy_(self.frame_embeds[:base])
            self.frame_embeds = buf
        self.frame_embeds[base: base + len(new)].copy_(new)
        self.frame_times.extend((base + i) / self.frame_fps for i in range(len(new)))

    def _streams(self) -> Tuple[Optional[torch.cuda.Stream], Optional[torch.cuda.Stream]]:
        """(decoder stream, vision stream) of `stream_video`, made once per
        engine on the parameters' CUDA device (making them raises if they
        cannot be made); (None, None) on the CPU, where the steps run in
        order. The decoder's stream has the higher priority: the card
        dispatches its blocks first, and the vision tower's fill the time
        the decoder leaves idle (at equal priority the next chunk's encode,
        enqueued first, holds the SMs the decode beside it waits for)."""
        if self.device.type != "cuda":
            return None, None
        if self._streams_ is None:
            self._streams_ = (torch.cuda.Stream(device=self.device, priority=-1),
                              torch.cuda.Stream(device=self.device, priority=0))
        return self._streams_

    def _upload(self, pixels):
        """Pixels onto the device on the side stream (pinned, non_blocking)."""
        return upload_pixels(pixels, self.device, VISION_BATCH, self._streams()[1])

    def _encode_chunk(self, up):
        """Enqueue the vision encode of uploaded pixels ``up`` on the side
        stream; returns (embeds, done, up): ``done`` is the event the
        current stream waits on before it reads ``embeds`` (None on the
        CPU), and ``up`` keeps the pinned pixels referenced."""
        side = self._streams()[1]
        if side is None:
            return encode_uploaded(self._visual, up.buf, up.n, VISION_BATCH), None, up
        # after whatever the current stream made before (the parameters);
        # between stream_video's chunks the current stream is idle here
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            embeds = encode_uploaded(self._visual, up.buf, up.n, VISION_BATCH)
            done = torch.cuda.Event()
            done.record(side)
        return embeds, done, up

    @torch.inference_mode()
    def stream_video(self, video_frames, chunk_frames: int = 64,
                     upload_ahead: bool = False) -> List[Dict[str, Any]]:
        """Pixels -> responses with the vision of chunk i+1 under the
        decode of chunk i (`input_video_stream` + `inference()` run the
        two phases one after the other).

        On a CUDA device each chunk's upload (pinned, ``non_blocking``),
        vision tower (kernel D) and projector run on a side stream; the
        decoder (kernels A and B) runs on the engine's decoder stream, of a
        higher priority, which waits on the chunk's event before it reads
        the embeddings. The decoder's host syncs wait on its stream only,
        so the next chunk's vision runs beside them. The decoder's stream
        starts after the caller's current stream and the caller's stream
        waits for it at the end, so kernels A and B, whose split scratch is
        per device, never run on two streams at once. Each chunk is encoded
        at the one VISION_BATCH shape, padded. On the CPU the same steps
        run in order.

        ``upload_ahead=True`` overlaps only the transfer: chunk i+1's
        pixels are uploaded while chunk i decodes, and its encode is
        enqueued just before its own decode.

        Queries must be fed (`input_query_stream`) BEFORE this call. The
        results equal the one-shot path's: chunks after the first go
        through `append_frame_embeds` and ``inference(drain=False)``, which
        leaves a tail shorter than a block for the next chunk."""
        video_frames = np.asarray(video_frames)
        # user turns are reported once up front; the per-chunk inference()
        # calls would re-list whatever is still queued at each call
        user_turns = [
            {"time": t, "content": q, "role": "user"} for t, q in self.query_queue
        ]
        responses: List[Dict[str, Any]] = []
        main, _ = self._streams()

        def run_pending(embeds, done, up, drain: bool) -> None:
            if done is not None:
                main.wait_event(done)
                # made on the side stream, read on this one: its memory is
                # not reused before this stream's reads are done
                embeds.record_stream(main)
            self.append_frame_embeds(embeds)
            # drain=False mid-stream: tails shorter than a block wait for
            # the next chunk instead of degrading to single-frame steps
            responses.extend(
                r for r in self.inference(drain=drain) if r["role"] != "user"
            )

        chunks = [video_frames[s: s + chunk_frames]
                  for s in range(0, len(video_frames), chunk_frames)]
        caller = torch.cuda.current_stream(self.device) if main is not None else None
        if main is not None:
            main.wait_stream(caller)
        try:
            with torch.cuda.stream(main):  # no-op on the CPU (None)
                pending = None
                for chunk in chunks:
                    if upload_ahead:
                        ahead = self._upload(chunk)  # in flight through the decode below
                        if pending is not None:
                            run_pending(*self._encode_chunk(pending), drain=False)
                    else:
                        ahead = self._encode_chunk(self._upload(chunk))  # under the decode
                        if pending is not None:
                            run_pending(*pending, drain=False)
                    pending = ahead
                if pending is not None:
                    run_pending(*(self._encode_chunk(pending) if upload_ahead else pending),
                                drain=True)
        finally:
            if main is not None:
                caller.wait_stream(main)
        return sorted(responses + user_turns, key=lambda x: x["time"])

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

    # `_feed` and `_generate_response` write the cache (an inference tensor,
    # made in `reset`) in place, so they enter inference mode themselves:
    # `demo.live.LiveInferForDemo` calls them from outside the public entry
    # points
    @torch.inference_mode()
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
            compute_lm_logits=compute_lm, shard_ctx=self._shard_ctx, graphs=self._graphs,
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
            lora=self.lora, lora_scale=self.lora_scale, shard_ctx=self._shard_ctx,
            graphs=self._graphs,
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

    @torch.inference_mode()
    def _generate_response(self, eos_id: Optional[int] = None) -> str:
        """One greedy answer at the cursor, on the engine's decode route.
        ``eos_id``: the id that ends it (None: the tokenizer's; -1: none,
        for `prewarm`)."""
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
            eos_id=self.tokenizer.eos_token_id if eos_id is None else eos_id,
            rep=self.args.repetition_penalty,
            lora=self.lora, lora_scale=self.lora_scale, shard_ctx=self._shard_ctx,
            graphs=self._graphs,
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

    def _threshold_triggered(self, stream_end_score: float) -> bool:
        return self._policy.triggered(stream_end_score)

    # views over the shared ThresholdPolicy state
    @property
    def stream_end_prob_list(self) -> List[float]:
        return self._policy.prob_list

    @property
    def stream_end_score_sum(self) -> float:
        return self._policy.score_sum

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

    def _stops_early(self, drain: bool) -> bool:
        """``drain=False``: fewer than a block of frames is left and no
        query is due, so the tail waits for the next chunk."""
        return not drain and (
            len(self.frame_times) - self._next_frame < self.block_frames
            and not (self.query_queue and self.video_time >= self.query_queue[0][0])
        )

    def _inference_grounding(self, drain: bool = True) -> List[Dict[str, Any]]:
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
            self._threshold_triggered(sum(
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
            if self._stops_early(drain):
                break
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
        # (earlier calls' entries stay, for chunked live feeding)
        del self.frame_latencies_ms[lat_start:]
        self.frame_latencies_ms.extend([total_ms / max(n_frames, 1)] * n_frames)
        return sorted(responses, key=lambda x: x["time"])

    @torch.inference_mode()
    def inference(self, drain: bool = True) -> List[Dict[str, Any]]:
        """Stream all frames; returns the time-sorted response list in the
        reference's JSONL schema (`test/inference.py:276-313` semantics).

        Frames run in blocks of ``block_frames`` per forward when no query
        or turn-joiner interrupts; a response trigger mid-block rolls the
        un-consumed frames back (cursor rewind), so results equal
        single-frame stepping. Grounding mode, which never generates, runs
        the pipelined loop (`_inference_grounding`) unless
        ``pipeline_grounding`` is False.

        ``drain=False`` (chunked live feeding, `stream_video`): stop once
        fewer than ``block_frames`` frames remain and no query is due,
        leaving the tail for after the next `append_frame_embeds`, so a
        chunk boundary never degrades to single-frame steps. Responses,
        times and cursors are unchanged, and so are the scores where the
        blocks are the same; where they are not, the scores differ by the
        rounding of other forward shapes."""
        if self.grounding_mode and self.pipeline_grounding:
            return self._inference_grounding(drain)
        responses = [
            {"time": t, "content": q, "role": "user"} for t, q in self.query_queue
        ]
        while self._next_frame < len(self.frame_times):
            if self._stops_early(drain):
                break
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
                if self._threshold_triggered(stream_end_score) and not self.grounding_mode:
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
