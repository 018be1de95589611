"""Multi-stream batched serving: B concurrent videos on one device.

Port of `mmduet_tpu/infer/batch_engine.py`. One forward over a (B, T)
chunk reads the weights once and serves B independent streams: each lane
keeps its own slice of the (L, B, kh, S, hd) KV cache, its own cursor and
its own (different-length) query prefix, so its scores and answers equal
those of a `LiveInferEngine` session of its own (pinned by
`tests/test_torch_batch_engine.py`, against the JAX engines too).

Two surfaces:

- `BatchedStreamScorer` — lockstep score streaming (the grounding
  protocol: scores only, no generation). Streams shorter than the batch's
  longest simply stop consuming scores; their lanes keep receiving the
  shared block shape, which is wasted but correct work.
- `BatchedStreamEngine` — the full streaming loop (continuous batching):
  per-stream query queues, threshold policies, triggered greedy
  generation with frozen lanes, joiners and `remove_assistant_turns`
  rollbacks, and `serve()` with admission of new sessions into lanes
  that finish.

What differs from the JAX engines: the forwards update the cache in
place (no jit, donation or sharding constraints); the lanes a dispatch
does not feed, and the frozen lanes of a batched decode, are not written
at all (the JAX package writes their rows past the lane's cursor, where
nothing reads them) while the overflow guards raise at the same points
with the same messages; the vision tower's attention is kernel D on a
CUDA device, also under a mesh; a ``mesh`` lies on one device
(`parallel.make_mesh`) and only cuts the streaming attention into shards
(`ops.attention.flash_decode_attention_sharded`, bit-equal to the
unsharded kernel). `BatchedStreamEngine.prewarm` pays before the first
group what its first calls would (the kernels' builds, their scratch,
cuBLAS's handles, the allocator's pool, the captures). A batched decode
keeps its loop state on the device. On a CUDA device without a process
mesh (``decode_route == "graph"``, as in `LiveInferEngine`) every
prefix, dispatch, lockstep block, decode prefill and decode step replays
a CUDA graph captured once a shape over all lanes, the frozen and unfed
ones included (`mmduet.EngineGraphs`). An engine keeps one KV cache for
its life: `reset` zeros it in place.

Under a `parallel.ProcessMesh` (one process per card) each rank holds
its local tree and a cache of its own kv heads (the ``model`` axis, as
`LiveInferEngine` does), and over the ``data`` axis the device state of
its own block of lanes (`parallel.lane_block`, where ``data`` divides B:
its (L, B/D, kh/M, S, hd) cache, frame buffer and penalty-mask rows; all
B lanes otherwise, replicated). Every rank runs the same host loop over
all B lanes (cursors, clocks, queues, policies, admission, coalescing,
the overflow guards) on values the collectives made equal. A dispatch
runs the forward on the rank's lanes at the chunk width all B lanes pick,
and its (B/D, 2, K) probabilities, like a batched decode's packed rows,
are gathered over ``data`` (`collectives.gather_data`), the axis's only
collectives: so a rank's decode stops at its own lanes' end of sequence,
and a rank none of whose lanes is fed or decoding skips the forward and
gives its zero block to the gather. A rank encodes the frames of its own
lanes' sessions only.
"""

from __future__ import annotations

import collections
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_SYSTEM_PROMPT, MMDuetConfig
from ..models import mmduet
from ..models.qwen2 import embed_tokens, ints_to, zero_kv_cache
from ..ops import _build, vision_fused
from ..parallel import lane_block, serving_shard_ctx
from ..parallel.collectives import gather_data
from ..trace import span
from .state import (
    DEFAULT_BUCKETS,
    ThresholdPolicy,
    build_prompt_fragments,
    cache_slots,
    decode_route,
    frame_joiner_ids,
    pad_chunk,
    pick_bucket,
    reserve_split_scratch,
    serving_cache,
    staged_visual_encode,
    validate_threshold_args,
)

VISION_BATCH = 32

# `BatchedStreamEngine`'s counters, zeroed by its `reset()` and read
# through `counters()`: batched dispatches and the decoder forwards this
# process ran (dispatches that fed one of its lanes, each batched decode's
# prefill and steps on its lanes); frames fed (rolled-back ones each time)
# and rolled back; each dispatch that feeds a lane here runs lanes x bucket
# rows, of which each fed lane's real tokens are live; batched decodes,
# their lanes, steps and done-flag reads; a decode's rows are its lanes
# here x (1 + steps), of which each active lane's tokens are live; tokens
# over every response; sessions admitted, their frames, and the tower's
# batches that encoded them here
COUNTERS = ("dispatches", "forwards", "frames_fed", "frames_rolled_back", "dispatch_rows_run",
            "dispatch_rows_live", "decodes", "decode_lanes", "decode_steps", "flag_reads",
            "decode_rows_run", "decode_rows_live", "tokens_generated", "admissions",
            "frames_admitted", "vision_batches")


def chunk_buckets(block_frames: int, frame_num_tokens: int) -> tuple:
    """`BatchedStreamEngine`'s chunk widths: `DEFAULT_BUCKETS`, a full
    joiner-free block, and a block with headroom for joiners and queries."""
    block = block_frames * frame_num_tokens
    return tuple(sorted(set(DEFAULT_BUCKETS) | {block, block + 64}))


class BatchedStreamScorer:
    """Score ``n_streams`` videos in lockstep blocks of ``block_frames``."""

    def __init__(
        self,
        params,
        cfg: MMDuetConfig,
        tokenizer,
        n_streams: int,
        frame_fps: float = 2.0,
        max_num_frames: int = 400,
        block_frames: int = 32,
        system_prompt: Optional[str] = None,
        kv_cache_size: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        mesh=None,
        kv_cache_quant: Optional[str] = None,  # "int8": per-token int8
        # KV caches (`qwen2.init_kv_cache`): half the bytes of the largest
        # consumer of device memory at batched scale
        lora=None,  # runtime LoRA tree: ONE adapter applied to all lanes
        lora_scale: float = 0.0,
    ):
        """``mesh``: a (data, model) `parallel.Mesh` on the parameters'
        device. The parameters stay whole; the streaming attention runs
        per shard: kv heads (with their query heads) over ``model`` and,
        when ``data`` divides ``n_streams``, lanes over ``data``. Or this
        rank's `parallel.ProcessMesh`, with ``params`` its local tree
        (`parallel.shard_params(mode="replicate")`): kv heads over
        ``model``, and this rank's block of lanes over ``data`` when it
        divides ``n_streams`` (see the module docstring)."""
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.B = n_streams
        self.mesh = mesh
        final_norm = params["decoder"]["final_norm"]
        self.device = final_norm.device
        self._shard_ctx = serving_shard_ctx(
            mesh, cfg.text.num_heads, cfg.text.num_kv_heads, n_streams, self.device)
        # the lanes [lo, hi) whose device state this process holds
        self._lo, self._hi = lane_block(mesh, n_streams)
        self._lane_sharded = self._hi - self._lo < n_streams
        # non-positive = the CLI's auto sentinel (real per-stream rates
        # then arrive via set_stream_fps, defined below)
        self.frame_fps = frame_fps if frame_fps > 0 else 1.0
        self.block_frames = block_frames
        self.dtype = dtype or final_norm.dtype
        self.kv_cache_quant = kv_cache_quant
        self.lora = lora
        self.lora_scale = lora_scale
        self.system_prompt = system_prompt or DEFAULT_SYSTEM_PROMPT
        self._cache_size = cache_slots(max_num_frames, cfg.frame_num_tokens, kv_cache_size)
        self._cache = None
        # "graph": each forward and decode step replays a captured CUDA
        # graph; "eager" on the CPU and on a rank of a process mesh
        self.decode_route = decode_route(self.device, mesh)
        self._graphs = mmduet.EngineGraphs() if self.decode_route == "graph" else None
        self.reset()
        if self._graphs is not None:  # one split scratch for all the graphs
            reserve_split_scratch(params, cfg.text, self._hi - self._lo, self._widest_chunk(),
                                  self._cache_size, self.device)

    def _widest_chunk(self) -> int:
        """Tokens a lane feeds one forward at most: a prefix bucket or a
        lockstep block."""
        return max(DEFAULT_BUCKETS[-1], self.block_frames * self.cfg.frame_num_tokens)

    # ------------------------------------------------------------------

    def _visual(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        px = mmduet.normalize_pixels(self.cfg, pixels_u8).to(self.dtype)
        return mmduet.visual_embed(self.params, self.cfg, px)

    def _embed_ids(self, ids: Sequence[int]) -> torch.Tensor:
        return embed_tokens(
            self.params["decoder"], ints_to(ids, self.device),
            self.cfg.text.vocab_size,
        ).to(self.dtype)

    @torch.inference_mode()
    def reset(self):
        # one (L, lanes, kh, S, hd) cache of this process's lanes with the
        # lane dim on the model's batch axis, the layout of B = 1 serving,
        # made once and zeroed in place here (the values of a new one): the
        # captured decode step holds its address, and at protocol scale a
        # second cache beside the weights would not fit the card
        if self._cache is None:
            self._cache = serving_cache(
                self.cfg.text, self.params["decoder"], self._hi - self._lo, self._cache_size,
                self.dtype, self.device, quant=self.kv_cache_quant,
            )
        else:
            zero_kv_cache(self._cache)
        self._cursor = np.zeros((self.B,), np.int64)  # host-authoritative
        self._frame_embeds: Optional[torch.Tensor] = None
        self._lengths: Optional[np.ndarray] = None
        self._next = 0
        # per-stream clocks (every fps-dependent quantity is host-side
        # scalar math); real rates arrive via set_stream_fps
        self._fps = np.full((self.B,), float(self.frame_fps))
        # host-side upper bound on the per-stream cursors, for capacity
        # checks
        self._max_cursor = 0

    def set_stream_fps(self, fps: Sequence[float]) -> None:
        """Per-stream frame rates. Call after `reset()`, before feeding."""
        fps = np.asarray(fps, float)
        if fps.shape != (self.B,) or not (fps > 0).all():
            raise ValueError(f"want {self.B} positive frame rates, got {fps}")
        self._fps = fps

    @torch.inference_mode()
    def start_sessions(self, queries: Sequence[Optional[str]]) -> None:
        """Feed each stream's prefix — the exact token stream
        `LiveInferEngine` produces at the start of a grounding run: a
        time-0 user query is encoded BEFORE the first frame, which
        advances the cursor past 0, so the system turn is never fed — a
        reference quirk (`test/inference.py:230,281-282`) that must be
        mirrored for score parity. Streams WITHOUT a query get the system
        turn via the first-frame joiner instead."""
        self._check_lanes(queries, "queries")
        per_stream = []
        for q in queries:
            if q is None:
                ids = list(self.tokenizer.apply_chat_template(
                    [{"role": "system", "content": self.system_prompt}],
                    tokenize=True,
                ))
            else:
                ids = list(self.tokenizer.apply_chat_template(
                    [{"role": "user", "content": q}],
                    tokenize=True,
                    add_stream_query_prompt=False,  # stream not open at t=0
                    add_stream_prompt=True,
                ))
            per_stream.append(ids)
        bucket = pick_bucket(max(len(ids) for ids in per_stream))
        lo, hi = self._lo, self._hi
        embeds = torch.stack([
            pad_chunk(self._embed_ids(ids), bucket) for ids in per_stream[lo:hi]
        ])
        t_real = [len(ids) for ids in per_stream]
        self._max_cursor += bucket  # bucket-wide writes: the overflow bound
        if self._max_cursor > self._cache_size:
            raise RuntimeError(
                f"KV cache overflow: prefixes need {self._max_cursor} slots "
                f"> capacity {self._cache_size}. Raise kv_cache_size."
            )
        mmduet.step_forward(
            self.params, self.cfg, embeds, self._cache, self._cursor[lo:hi].tolist(),
            t_real[lo:hi], lora=self.lora, lora_scale=self.lora_scale,
            compute_lm_logits=False, shard_ctx=self._shard_ctx, graphs=self._graphs,
        )
        self._cursor += np.array(t_real)

    @torch.inference_mode()
    def input_video_streams(self, videos: Sequence[np.ndarray]) -> None:
        """Encode every stream's pixels (uint8 (T_b,H,W,3); lengths may
        differ) into frame embeddings in one shared-weights pass (of this
        process's lanes' streams only)."""
        self._check_lanes(videos, "videos")
        lengths = np.array([len(v) for v in videos])
        T = int(lengths.max())
        local = videos[self._lo:self._hi]
        all_px = np.zeros(
            (len(local) * T, *videos[0].shape[1:]), dtype=np.uint8
        )
        for b, vframes in enumerate(local):
            all_px[b * T : b * T + len(vframes)] = vframes
        flat = staged_visual_encode(self._visual, all_px, self.device, VISION_BATCH)
        self._set_frames(
            flat.reshape(len(local), T, self.cfg.frame_num_tokens, -1), lengths.astype(np.int64)
        )

    @torch.inference_mode()
    def input_frame_embeds(self, embeds, lengths=None) -> None:
        """(B, T, ft, H) pre-computed frame embeddings (tests/feeds).
        ``lengths``: optional per-stream real frame counts (trailing
        frames of shorter streams are padding)."""
        self._set_frames(*self._checked_embeds(embeds, lengths))

    def _set_frames(self, local: torch.Tensor, lengths: np.ndarray) -> None:
        """Take this process's lanes' (lanes, T, ft, H) embeddings and
        every stream's real frame count; the engine subclass writes them
        into its preallocated per-lane buffer instead."""
        self._frame_embeds, self._lengths = local, lengths
        self._next = 0

    def _check_lanes(self, per_lane, what: str) -> None:
        if len(per_lane) != self.B:
            raise ValueError(f"{len(per_lane)} {what} for {self.B} streams")

    def _checked_embeds(self, embeds, lengths) -> Tuple[torch.Tensor, np.ndarray]:
        """This process's lanes' rows of (B, T, ft, H) embeddings on the
        device in the activation dtype, and the (B,) int64 real frame
        counts (all T without ``lengths``)."""
        embeds = torch.as_tensor(embeds)
        self._check_lanes(embeds, "rows of frame embeddings")
        embeds = embeds[self._lo:self._hi].to(device=self.device, dtype=self.dtype)
        if lengths is None:
            return embeds, np.full((self.B,), embeds.shape[1], np.int64)
        lengths = np.asarray(lengths)
        if lengths.shape != (self.B,) or lengths.max() > embeds.shape[1]:
            raise ValueError(f"lengths {lengths} do not fit {self.B} streams of "
                             f"{embeds.shape[1]} frames")
        return embeds, lengths.astype(np.int64)

    @torch.inference_mode()
    def score_all(self) -> List[List[Dict[str, float]]]:
        """Stream every frame; returns per-stream debug rows
        ``{time, informative_score, relevance_score}`` (same schema as
        `LiveInferEngine.debug_data_list`).

        One-deep block pipelining: block i+1 is enqueued before block
        i's scores are fetched, hiding the host round trip behind the
        device's work (scores-only streaming never rolls back, same
        argument as `LiveInferEngine._inference_grounding`)."""
        if self._frame_embeds is None:
            raise RuntimeError("input video streams first")
        T = self._frame_embeds.shape[1]
        out: List[List[Dict[str, float]]] = [[] for _ in range(self.B)]
        pending = None  # (dev_scores, first_frame_idx, n)

        def drain():
            nonlocal pending
            if pending is None:
                return
            dev, first, n = pending
            pending = None
            scores = self._all_lanes(dev)  # ONE host sync for B*2*n scores
            inf, rel = scores[:, 0], scores[:, 1]
            for b in range(self.B):
                for j in range(n):
                    t_idx = first + j
                    if t_idx >= self._lengths[b]:
                        continue  # stream b already ended: padded garbage
                    out[b].append({
                        "time": t_idx / self._fps[b],
                        "informative_score": float(inf[b, j]),
                        "relevance_score": float(rel[b, j]),
                    })

        ft = self.cfg.frame_num_tokens
        lo, hi = self._lo, self._hi
        while self._next < T:
            n = min(self.block_frames, T - self._next)
            self._max_cursor += n * ft
            if self._max_cursor > self._cache_size:
                raise RuntimeError(
                    f"KV cache overflow: cursor bound {self._max_cursor} > "
                    f"capacity {self._cache_size}. Raise kv_cache_size."
                )
            frames = self._frame_embeds[:, self._next : self._next + n]
            # a lockstep (lanes, n, ft, H) frame block: probs (lanes, 2, n)
            dev, _ = mmduet.chunk_scores_forward(
                self.params, self.cfg, frames.reshape(hi - lo, n * ft, -1), self._cache,
                self._cursor[lo:hi].tolist(), n * ft, [(j + 1) * ft - 1 for j in range(n)],
                lora=self.lora, lora_scale=self.lora_scale, shard_ctx=self._shard_ctx,
                graphs=self._graphs,
            )
            self._cursor += n * ft
            drain()  # previous block: its round trip hides behind this dispatch
            pending = (dev, self._next, n)
            self._next += n
        drain()
        return out

    def _all_lanes(self, rows: torch.Tensor) -> np.ndarray:
        """The host copy of every lane's rows from this process's (lanes,
        ...) rows: one fetch, after the gather over ``data`` where the
        lanes are cut over it."""
        return (gather_data(rows, 0) if self._lane_sharded else rows).cpu().numpy()


class BatchedStreamEngine(BatchedStreamScorer):
    """Continuous-batched streaming serving for B concurrent sessions,
    INCLUDING triggered generation — the full `LiveInferEngine.inference()`
    semantics (reference `test/inference.py:276-313`) per stream, batched:

    - every forward (query turns, frame scoring, fused blocks, greedy
      decode steps) is ONE dispatch over all B streams, so the weights
      are read once per step instead of once per stream;
    - streams keep independent caches, cursors, video clocks, query
      queues, threshold policies, repetition-penalty token sets and
      `remove_assistant_turns` rollbacks, so per-stream outputs are
      identical to B separate `LiveInferEngine` runs;
    - generation is a single batched greedy decode: lanes that finished
      (EOS) or never triggered are frozen and commit nothing.

    Scheduling: a round mirrors one iteration of the single-stream loop
    for every live stream — (one due query?) then (a per-lane chunk of
    joiner + 1..K frames). Block boundaries do not affect results (block
    scoring equals stepping, with mid-block triggers rolled back per
    stream), so lanes may run blocks at different frame offsets once
    their clocks diverge.
    """

    def __init__(
        self,
        params,
        cfg: MMDuetConfig,
        tokenizer,
        args,
        n_streams: int,
        block_frames: int = 8,
        system_prompt: Optional[str] = None,
        kv_cache_size: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        mesh=None,
        gen_coalesce_rounds: int = 0,
        kv_cache_quant: Optional[str] = None,
        lora=None,
        lora_scale: float = 0.0,
    ):
        validate_threshold_args(args)
        self.args = args
        self.score_heads = args.score_heads.split(",")
        self.grounding_mode = args.grounding_mode
        # generation COALESCING (throughput knob, default off): a
        # triggered lane may wait up to this many scheduling rounds —
        # its own stream stalled at the trigger point, others streaming
        # on — so staggered triggers merge into ONE batched decode. Each
        # lane's token stream is identical either way (the decode runs at
        # the same cursor and clock state); only wall-clock order changes.
        self.gen_coalesce_rounds = gen_coalesce_rounds
        # chunk buckets: the per-lane scheduler's common shapes are a full
        # joiner-free K-frame block (K*ft exactly) and mixed rounds with
        # small joiners/queries on some lanes (K*ft + headroom); adding
        # both keeps the hot block dispatch UNPADDED while query-heavy
        # rounds bucket tightly instead of doubling to the next power
        self._buckets = chunk_buckets(block_frames, cfg.frame_num_tokens)
        super().__init__(
            params, cfg, tokenizer,
            n_streams=n_streams,
            frame_fps=args.frame_fps,
            max_num_frames=args.max_num_frames,
            block_frames=block_frames,
            system_prompt=system_prompt or args.system_prompt,
            kv_cache_size=kv_cache_size,
            dtype=dtype,
            mesh=mesh,
            kv_cache_quant=kv_cache_quant,
            lora=lora,
            lora_scale=lora_scale,
        )
        # pre-tokenized incremental fragments (reference inference.py:61-63)
        self._start_ids, self._stream_open_ids, self._gen_prompt_ids = (
            build_prompt_fragments(tokenizer, self.system_prompt)
        )

    def _widest_chunk(self) -> int:
        return max(self._buckets)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def reset(self):
        super().reset()
        B = self.B
        # authoritative HOST cursors (device calls take them as operands)
        self._cur = np.zeros((B,), np.int64)
        self._next_b = np.zeros((B,), np.int64)
        self._vt = [0.0] * B
        self._last_role = ["system"] * B
        self._pending_ids: List[List[int]] = [[] for _ in range(B)]
        self._queues: List[collections.deque] = [
            collections.deque() for _ in range(B)
        ]
        self._pen_mask = torch.zeros(
            (self._hi - self._lo, self.cfg.text.vocab_size), dtype=torch.bool,
            device=self.device,
        )
        # lane -> rounds waited for a coalesced generation (see __init__)
        self._pending_gen: Dict[int, int] = {}
        self._policies = [ThresholdPolicy(self.args) for _ in range(B)]
        self.debug_data_lists: List[List[Dict[str, float]]] = [
            [] for _ in range(B)
        ]
        # all lanes idle: zero-length streams until fed/admitted
        self._lengths = np.zeros((B,), np.int64)
        self._lane_sess: List[Optional[int]] = [None] * B
        self._responses: List[List[Dict[str, Any]]] = [[] for _ in range(B)]
        for name in COUNTERS:  # counts since the reset
            setattr(self, name, 0)
        self._fused_at_reset = vision_fused.LAUNCHES

    def counters(self) -> Dict[str, int]:
        """One flat dict: the engine's `COUNTERS` since its last `reset()`;
        ``graph_replays`` and ``graph_captures`` since the engine was made
        (`mmduet.EngineGraphs.counts`, zeros off the graph route);
        ``kernel_builds``, this process's ``nvcc`` runs (`_build.BUILDS`);
        and ``vision_fused_launches``, the launches of the tower's fused
        passes in this process since the reset (`vision_fused.LAUNCHES`: 4
        a layer and 1 a tower call on a CUDA device, 0 on the CPU)."""
        out = {name: getattr(self, name) for name in COUNTERS}
        out["vision_fused_launches"] = vision_fused.LAUNCHES - self._fused_at_reset
        out.update(self._graphs.counts() if self._graphs is not None
                   else {"graph_replays": 0, "graph_captures": 0})
        out["kernel_builds"] = _build.BUILDS
        return out

    def start_sessions(self, queries):  # pragma: no cover - guard
        raise NotImplementedError(
            "BatchedStreamEngine tracks host-side cursors; time-0 queries "
            "go through input_query_streams + stream_all (the inherited "
            "device-cursor API would silently desync)"
        )

    def score_all(self):  # pragma: no cover - guard
        raise NotImplementedError(
            "BatchedStreamEngine streams via stream_all(); score_all is "
            "the lockstep BatchedStreamScorer API"
        )

    def input_query_streams(self, conversations: Sequence[Sequence[dict]]) -> None:
        """Per-stream conversations; user turns become timed queries
        (engine `input_query_stream` per lane)."""
        self._check_lanes(conversations, "conversations")
        for b, conv in enumerate(conversations):
            for turn in conv or ():
                if turn["role"] == "user":
                    self._queues[b].append((turn["time"], turn["content"]))

    # ------------------------------------------------------------------
    # frame feeding (preallocated per-lane buffer — admission-capable)
    # ------------------------------------------------------------------

    def _ensure_frame_buffer(self, H: int) -> None:
        """(lanes, max_num_frames, ft, H) zeros buffer of this process's
        lanes; lanes own rows, so a session can be admitted into one lane
        without touching others."""
        cap = self.args.max_num_frames
        ft = self.cfg.frame_num_tokens
        if (
            self._frame_embeds is None
            or self._frame_embeds.shape[1] != cap
            or self._frame_embeds.shape[-1] != H
        ):
            self._frame_embeds = torch.zeros(
                (self._hi - self._lo, cap, ft, H), dtype=self.dtype, device=self.device
            )

    def _set_frames(self, embeds: torch.Tensor, lengths: np.ndarray) -> None:
        """This process's lanes' (lanes, T, ft, H) frame embeddings,
        written into the preallocated per-lane buffer in place."""
        cap = self.args.max_num_frames
        if embeds.shape[1] > cap:
            raise ValueError(
                f"{embeds.shape[1]} frames exceed max_num_frames {cap}"
            )
        self._ensure_frame_buffer(embeds.shape[-1])
        self._frame_embeds[:, : embeds.shape[1]] = embeds
        self._lengths = lengths
        self._next = 0

    # ------------------------------------------------------------------
    # dynamic session admission (continuous batching, literal)
    # ------------------------------------------------------------------

    def _admit(self, lane: int, sess: Dict[str, Any]) -> None:
        """Admit one session into a finished/idle lane: fresh cursor,
        clock, policy, penalty-mask row and query queue; frames written
        into the lane's buffer row (rows past the session's length keep
        what they held and are never read). Other lanes are untouched —
        their caches/cursors never see the admission. A lane another
        process holds records only the session's length: its frames are
        encoded and kept where the lane lives. In the span ``engine.admit``
        (``engine.frames_write`` the frames' write)."""
        with span("engine.admit", session=self._lane_sess[lane], lane=lane):
            frames = sess.get("frame_embeds")
            local = self._lo <= lane < self._hi
            T = len(frames if frames is not None else sess["frames"])
            if local and frames is None:
                frames = staged_visual_encode(
                    self._visual, sess["frames"], self.device, VISION_BATCH
                )
                self.vision_batches += -(-T // VISION_BATCH)
            cap = self.args.max_num_frames
            if T > cap:
                raise ValueError(f"session has {T} frames > max_num_frames {cap}")
            if local:
                with span("engine.frames_write", lane=lane):
                    frames = torch.as_tensor(frames).to(device=self.device, dtype=self.dtype)
                    self._ensure_frame_buffer(frames.shape[-1])
                    self._frame_embeds[lane - self._lo, :T] = frames
                    # fresh repetition-penalty token set for the new session
                    self._pen_mask[lane - self._lo] = False
            self.admissions += 1
            self.frames_admitted += T
            self._lengths[lane] = T
            self._cur[lane] = 0
            self._next_b[lane] = 0
            self._vt[lane] = 0.0
            self._last_role[lane] = "system"
            self._pending_ids[lane] = []
            self._fps[lane] = float(sess.get("fps") or self.frame_fps)
            self._queues[lane] = collections.deque(
                (t["time"], t["content"])
                for t in sess.get("conversation") or ()
                if t["role"] == "user"
            )
            self._policies[lane] = ThresholdPolicy(self.args)
            self.debug_data_lists[lane] = []
            self._responses[lane] = [
                {"time": t, "content": q, "role": "user"}
                for t, q in self._queues[lane]
            ]

    @torch.inference_mode()
    def serve(self, sessions):
        """Continuous-batched serving with DYNAMIC session admission:
        stream any number of sessions through the B lanes; the moment a
        lane's stream ends, the next queued session is admitted into that
        lane (fresh cursor/clock/policy/frames) while the other lanes
        stream on undisturbed.

        ``sessions``: iterable of dicts with
          - ``"frames"`` (uint8 (T,H,W,3) pixels) OR ``"frame_embeds"``
            ((T, ft, H) post-projector embeddings);
          - ``"conversation"``: reference-schema turns (user turns become
            timed queries);
          - ``"fps"``: per-session stream rate (defaults to engine fps).
        Pulled lazily — at most B sessions' frames are resident.

        Yields ``(session_index, responses, debug_data)`` in COMPLETION
        order as sessions finish. Per-session outputs are identical to
        running each session through its own engine. Call `reset()`
        before starting a new serve run."""
        it = iter(enumerate(sessions))
        exhausted = False
        while True:
            while not exhausted:
                idle = [b for b in range(self.B) if self._lane_sess[b] is None]
                if not idle:
                    break
                nxt = next(it, None)
                if nxt is None:
                    exhausted = True
                    break
                idx, sess = nxt
                self._lane_sess[idle[0]] = idx
                self._admit(idle[0], sess)
            # a zero-frame session (nothing to stream, no pending
            # generation) never enters `live` — retire it NOW, not when
            # every other lane drains: under continuous admission a
            # long-stream round would otherwise wedge its lane for
            # effectively the whole run. Flagged on stderr so downstream
            # eval can tell "no frames decoded" apart from "streamed with
            # no triggers" — the yielded tuples look alike.
            drained = [
                b for b in range(self.B)
                if self._lane_sess[b] is not None
                and self._remaining(b) == 0 and b not in self._pending_gen
            ]
            if drained:
                for b in drained:
                    if self._lengths[b] == 0:
                        print(
                            f"serve: session {self._lane_sess[b]} admitted "
                            "with zero frames (decode failure upstream?) — "
                            "retiring with no scores", file=sys.stderr,
                        )
                    yield self._retire(b)
                continue  # freed lanes: admit before the next round
            live = [
                b for b in range(self.B)
                if self._lane_sess[b] is not None
                and (self._remaining(b) > 0 or b in self._pending_gen)
            ]
            if not live:
                # every lane idle (drained lanes were retired above)
                if exhausted:
                    return
                continue
            self._run_round(live)
            for b in live:
                if self._remaining(b) == 0 and b not in self._pending_gen:
                    yield self._retire(b)

    def _retire(self, lane: int):
        idx = self._lane_sess[lane]
        self._lane_sess[lane] = None
        self._lengths[lane] = 0
        self._next_b[lane] = 0
        return (
            idx,
            sorted(self._responses[lane], key=lambda x: x["time"]),
            self.debug_data_lists[lane],
        )

    # ------------------------------------------------------------------

    def _check_fits(self, b: int, n: int) -> None:
        if self._cur[b] + n > self._cache_size:
            raise RuntimeError(
                f"KV cache overflow on stream {b}: cursor {self._cur[b]} + "
                f"chunk {n} > capacity {self._cache_size}. Raise kv_cache_size."
            )

    def _guard_frozen_writes(self, width: int, fed) -> None:
        """The JAX engine's batched dispatches write ``width`` K/V slots
        into EVERY lane at its cursor, frozen lanes included, and it
        raises here for a frozen lane within ``width`` of capacity, whose
        clamped write would overwrite committed slots. This engine writes
        no frozen lane, but raises under the same conditions with the
        same message, so that both packages accept and refuse the same
        runs. Finished streams are exempt — UNLESS a coalesced
        generation is still pending on the lane (it triggered on its
        final frame)."""
        for b in range(self.B):
            if b in fed:
                continue  # fed lanes carry their own (>=) _check_fits
            if (
                self._lengths is not None
                and self._next_b[b] >= self._lengths[b]
                and b not in self._pending_gen
            ):
                continue
            if self._cur[b] + width > self._cache_size:
                raise RuntimeError(
                    f"KV cache overflow on frozen stream {b}: cursor "
                    f"{self._cur[b]} + dispatch width {width} > capacity "
                    f"{self._cache_size}; a clamped write would corrupt its "
                    "committed cache. Raise kv_cache_size."
                )

    def _frame_joiner_ids(self, b: int) -> List[int]:
        ids = frame_joiner_ids(
            int(self._cur[b]), self._last_role[b], self._pending_ids[b],
            self.args.remove_assistant_turns,
            self._start_ids, self._stream_open_ids,
        )
        if self._cur[b] != 0 and ids:
            self._pending_ids[b] = []
        return ids

    @torch.inference_mode()
    def _dispatch_sched(
        self, chunks: Dict[int, Tuple[List[int], int, int]]
    ) -> np.ndarray:
        """Feed per-lane ``[token ids + n <= K frames]`` chunks in ONE
        batched dispatch — lanes may carry different joiners, different
        frame counts, or no frames at all (query turns), so one chatty
        lane never degrades the others' block rate.

        ``chunks``: lane -> (ids, frame_start, n_frames). Returns
        (B, 2, K) score probs; entry j of lane b is frame j's scores —
        entries beyond the lane's frame count (and all entries of id-only
        or unfed lanes) are garbage the caller must ignore. Unfed lanes
        run a 1-token dummy chunk and commit nothing. The chunk width is
        picked over all B lanes; the forward runs on this process's lanes,
        and not at all when none of them is fed (its rows are then zeros).
        In the span ``engine.dispatch``: ``engine.assemble`` builds the
        chunk, ``engine.scores_read`` fetches the probabilities."""
        with span("engine.dispatch"):
            ft = self.cfg.frame_num_tokens
            K = self.block_frames
            t_real = [len(chunks[b][0]) + chunks[b][2] * ft if b in chunks else 1
                      for b in range(self.B)]
            bucket = pick_bucket(max(t_real), self._buckets)
            for b in chunks:
                self._check_fits(b, bucket)
            self._guard_frozen_writes(bucket, chunks)
            lo, hi = self._lo, self._hi
            lanes = range(lo, hi)
            fed = [b in chunks for b in lanes]
            if any(fed):
                with span("engine.assemble", bucket=bucket):
                    embeds, score_pos = self._assemble(chunks, bucket)
                probs, _ = mmduet.chunk_scores_forward(
                    self.params, self.cfg, embeds, self._cache, self._cur[lo:hi].tolist(),
                    t_real[lo:hi], score_pos, lora=self.lora,
                    lora_scale=self.lora_scale, shard_ctx=self._shard_ctx, commit=fed,
                    graphs=self._graphs,
                )
                self.forwards += 1
                self.dispatch_rows_run += (hi - lo) * bucket
                self.dispatch_rows_live += sum(t_real[b] for b in lanes if b in chunks)
            else:  # the lanes here sit this dispatch out: their zero rows join the gather
                probs = torch.zeros((len(lanes), 2, K), dtype=torch.float32, device=self.device)
            self.dispatches += 1
            self.frames_fed += sum(nf for _, _, nf in chunks.values())
            for b in chunks:
                self._cur[b] += t_real[b]
            with span("engine.scores_read"):
                return self._all_lanes(probs)  # ONE host fetch for all (B, 2, K) scores

    def _assemble(self, chunks: Dict[int, Tuple[List[int], int, int]],
                  bucket: int) -> Tuple[torch.Tensor, List[List[int]]]:
        """A dispatch's (lanes, bucket, H) chunk of this process's lanes,
        each fed lane's ``[ids + frames]`` padded to ``bucket`` and each
        unfed lane a 1-token dummy, and each lane's K score positions."""
        ft = self.cfg.frame_num_tokens
        K = self.block_frames
        H = self.params["decoder"]["final_norm"].shape[-1]
        embeds_l, score_pos = [], []
        for b in range(self._lo, self._hi):
            if b in chunks:
                ids, fstart, nf = chunks[b]
                parts = []
                if ids:
                    parts.append(self._embed_ids(ids))
                if nf:
                    parts.append(
                        self._frame_embeds[b - self._lo, fstart : fstart + nf]
                        .reshape(nf * ft, -1)
                    )
                emb = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
                pos = [len(ids) + (j + 1) * ft - 1 for j in range(nf)]
                score_pos.append(pos + [0] * (K - nf))
            else:  # unfed lane: 1-token dummy, scores ignored by caller
                emb = torch.zeros((1, H), dtype=self.dtype, device=self.device)
                score_pos.append([0] * K)
            embeds_l.append(emb)
        return torch.stack([pad_chunk(c, bucket) for c in embeds_l]), score_pos

    @torch.inference_mode()
    def _generate_batch(self, lanes: Sequence[int],
                        eos_id: Optional[int] = None) -> Dict[int, str]:
        """Batched greedy decode for the triggered lanes; returns
        stream -> response text, applying per-lane
        `remove_assistant_turns` cursor rollback and pending-token
        bookkeeping (engine `_generate_response`). The generation prompt
        is shared; lanes outside ``lanes`` are frozen throughout
        (`mmduet.decode_loop`, on the engine's decode route). ``eos_id``:
        the id that ends an answer (None: the tokenizer's; -1: none, for
        `prewarm`). In the span ``engine.generate``: `decode_loop`'s spans,
        ``engine.tokens_read`` (the fetch of the packed tokens) and
        ``engine.detokenize``."""
        with span("engine.generate", lanes=lanes):
            t = len(self._gen_prompt_ids)
            W = max(self.args.max_new_tokens - 1, 1)
            for b in lanes:
                self._check_fits(b, t + W)
            # the JAX engine's frozen lanes receive BOTH the prompt-width
            # prefill write and the W-wide scratch commit at their cursor
            self._guard_frozen_writes(max(t, W), set(lanes))
            here = range(self._lo, self._hi)
            active = [b in lanes for b in here]
            pre = self._cur.copy()
            steps = {}
            if any(active):
                gen_embeds = self._embed_ids(self._gen_prompt_ids)
                packed, _, self._pen_mask = mmduet.decode_loop(
                    self.params, self.cfg, gen_embeds[None].expand(len(here), -1, -1),
                    self._cache, self._cur[self._lo:self._hi].tolist(), t, self._pen_mask,
                    active, max_new=self.args.max_new_tokens,
                    eos_id=self.tokenizer.eos_token_id if eos_id is None else eos_id,
                    rep=self.args.repetition_penalty, lora=self.lora,
                    lora_scale=self.lora_scale, shard_ctx=self._shard_ctx, graphs=self._graphs,
                    counts=steps,
                )
            else:  # no lane here decodes: zero rows join the gather
                packed = torch.zeros((len(here), self.args.max_new_tokens + 2),
                                     dtype=torch.int32, device=self.device)
            with span("engine.tokens_read"):
                packed = self._all_lanes(packed)  # ONE fetch: tokens + n + cursor
            if any(active):  # the prefill and the steps
                self.forwards += 1 + steps["decode_steps"]
                self.decode_steps += steps["decode_steps"]
                self.flag_reads += steps["flag_reads"]
                self.decode_rows_run += len(here) * (1 + steps["decode_steps"])
                self.decode_rows_live += int(packed[self._lo:self._hi, -2][active].sum())
            self.decodes += 1
            self.decode_lanes += len(lanes)
            buf = packed[:, :-2]
            out: Dict[int, str] = {}
            with span("engine.detokenize"):
                for b in lanes:
                    n, cursor = int(packed[b, -2]), int(packed[b, -1])
                    self.tokens_generated += n
                    token_ids = buf[b, :n]
                    if self.args.remove_assistant_turns:
                        self._cur[b] = pre[b]  # rewind: keep pre-response context
                        self._pending_ids[b] = []
                    else:
                        self._cur[b] = cursor
                        self._pending_ids[b] = [int(token_ids[-1])] if n else []
                    out[b] = self.tokenizer.decode(token_ids, skip_special_tokens=True)
                    self._last_role[b] = "assistant"
            return out

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def prewarm(
        self,
        buckets: Optional[Sequence[int]] = None,
        block: bool = True,  # kept for the JAX engine's signature: the block
        # shapes are in the engine's bucket table and warm in the same loop
        generate: bool = True,
        vision: bool = False,
    ) -> None:
        """Pay before the first group what its first calls would
        (`LiveInferEngine.prewarm`: the kernels' builds, kernel A's split
        scratch and memo per launch shape, kernel B's scratch, cuBLAS's
        handles, the allocator's pool, the captures): one batched dispatch
        of zeros at each chunk bucket over this process's lanes, as
        `_dispatch_sched` feeds them (every lane committed), a batched
        decode of every lane (the group's first gathers; on the graph route
        with no end of sequence, so that a step runs and is captured) and,
        with ``vision``, one VISION_BATCH encode. Resets the engine
        afterwards. In the span ``engine.prewarm``."""
        with span("engine.prewarm"):
            if self.device.type == "cuda":
                _build.build()
            H = self.params["decoder"]["final_norm"].shape[-1]
            n = self._hi - self._lo
            zeros = [0] * n
            for b in buckets if buckets is not None else self._buckets:
                if b > self._cache_size:
                    continue
                mmduet.chunk_scores_forward(
                    self.params, self.cfg,
                    torch.zeros((n, b, H), dtype=self.dtype, device=self.device),
                    self._cache, zeros, [b] * n, [[0] * self.block_frames] * n,
                    lora=self.lora, lora_scale=self.lora_scale, shard_ctx=self._shard_ctx,
                    commit=[True] * n, graphs=self._graphs,
                )
            if generate:
                self._cur[:] = 0
                self._generate_batch(list(range(self.B)),
                                     -1 if self._graphs is not None else None)
            if vision:
                r = self.cfg.frame_resolution
                staged_visual_encode(self._visual, np.zeros((VISION_BATCH, r, r, 3), np.uint8),
                                     self.device, VISION_BATCH)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.reset()

    def _remaining(self, b: int) -> int:
        return int(self._lengths[b]) - int(self._next_b[b])

    def _budget(self, b: int) -> int:
        """Frames lane b may run before its next query is due or its
        stream ends (engine `_block_budget` per lane)."""
        n = min(self.block_frames, self._remaining(b))
        if self._queues[b]:
            q_time = self._queues[b][0][0]
            interval = 1.0 / self._fps[b]
            free = int(np.ceil((q_time - self._vt[b]) / interval - 1e-9))
            n = min(n, max(free, 0))
        return n

    def _run_round(self, live: Sequence[int]) -> None:
        """One scheduling round — one iteration of the single-stream loop
        for every live lane: (at most one due query each) then (a
        per-lane chunk of joiner + 1..K frames) in ONE dispatch. Lanes
        schedule INDEPENDENTLY: a lane at a query boundary or needing a
        joiner feeds a short chunk while clean lanes run their full
        K-frame block in the same dispatch — no lane waits for the whole
        group. In the span ``engine.round``; step (3) in ``engine.policy``."""
        with span("engine.round", lanes=live):
            # lanes with a deferred (coalescing) generation are stalled at
            # their trigger point: no queries, no frames this round
            for b in self._pending_gen:
                self._pending_gen[b] += 1
            sched = [b for b in live if b not in self._pending_gen]

            # (1) one due query per live stream (engine loop head)
            due = {
                b: self._queues[b][0]
                for b in sched
                if self._queues[b] and self._vt[b] >= self._queues[b][0][0]
            }
            if due:
                qchunks = {}
                for b, (_, query) in due.items():
                    self._queues[b].popleft()
                    qchunks[b] = (
                        self.tokenizer.apply_chat_template(
                            [{"role": "user", "content": query}],
                            tokenize=True,
                            add_stream_query_prompt=self._last_role[b] == "stream",
                            add_stream_prompt=True,
                        ),
                        0, 0,
                    )
                self._dispatch_sched(qchunks)
                for b in due:
                    self._last_role[b] = "user"

            # (2) per-lane frame chunks in ONE dispatch
            ft = self.cfg.frame_num_tokens
            chunks = {}
            for b in sched:
                n = min(max(self._budget(b), 1), self._remaining(b))
                chunks[b] = (self._frame_joiner_ids(b), int(self._next_b[b]), n)
            if chunks:
                probs = self._dispatch_sched(chunks)

            # (3) per-stream host policy + rollback (engine loop body)
            with span("engine.policy"):
                to_gen = []
                for b in sched:
                    nf = chunks[b][2]
                    self._next_b[b] += nf
                    self._last_role[b] = "stream"
                    interval = 1.0 / self._fps[b]
                    for i in range(nf):
                        scores = {
                            "informative_score": float(probs[b, 0, i]),
                            "relevance_score": float(probs[b, 1, i]),
                        }
                        self.debug_data_lists[b].append(
                            dict(time=self._vt[b], **scores)
                        )
                        stream_end_score = sum(
                            v for k_, v in scores.items() if k_ in self.score_heads
                        )
                        need = self._policies[b].triggered(stream_end_score)
                        if need and not self.grounding_mode:
                            # roll back not-yet-evaluated chunk frames
                            k_back = nf - 1 - i
                            if k_back > 0:
                                self._cur[b] -= k_back * ft
                                self._next_b[b] -= k_back
                                self.frames_rolled_back += k_back
                            to_gen.append(b)
                            break
                        self._vt[b] += interval

            # (4) batched generation — newly triggered lanes join the
            # pending set; flush when any lane has waited out the coalesce
            # window or no other lane has frames to stream meanwhile
            for b in to_gen:
                self._pending_gen[b] = 0
            if self._pending_gen:
                others = any(
                    self._remaining(b) > 0
                    for b in live if b not in self._pending_gen
                )
                if (
                    max(self._pending_gen.values()) >= self.gen_coalesce_rounds
                    or not others
                ):
                    lanes = sorted(self._pending_gen)
                    texts = self._generate_batch(lanes)
                    for b in lanes:
                        self._responses[b].append(
                            {"time": self._vt[b], "content": texts[b],
                             "role": "assistant"}
                        )
                        self._vt[b] += 1.0 / self._fps[b]
                    self._pending_gen.clear()

    @torch.inference_mode()
    def stream_all(self) -> List[List[Dict[str, Any]]]:
        """Stream every fed session to completion (closed-group mode; see
        `serve` for dynamic admission); per-stream time-sorted response
        lists in the reference JSONL schema (engine `inference()` per
        lane). Per-frame scores land in ``self.debug_data_lists``."""
        if self._frame_embeds is None:
            raise RuntimeError("input video streams first")
        self._responses = [
            [{"time": t, "content": q, "role": "user"}
             for t, q in self._queues[b]]
            for b in range(self.B)
        ]
        while True:
            live = [
                b for b in range(self.B)
                if self._remaining(b) > 0 or b in self._pending_gen
            ]
            if not live:
                break
            self._run_round(live)
        return [sorted(r, key=lambda x: x["time"]) for r in self._responses]
