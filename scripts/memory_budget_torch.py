"""Per-card memory of the PyTorch port's configurations, from shapes.

    python scripts/memory_budget_torch.py [--out PATH]

The port's counterpart of `scripts/memory_budget.py`, which compiles the JAX
train step for a virtual mesh and reads XLA's `memory_analysis()`. The port
has no compiler to ask, so this script adds up, term by term, the bytes a
rank holds: every tree it builds on ``torch.device("meta")`` (no weight is
materialized, nothing is allocated on any device) through the port's own
rules, never a copy of them:

- the weights: `init_mmduet_params` (int4: `quant.quantize_params`), a
  rank's block by `parallel.shard_params` (`param_shardings` / `_spec_for`,
  and the int4 input cut of a row-cut projection);
- training: `train.step.init_train_state` cut by
  `parallel.shard_train_state` (the trainable leaves by the parameter
  rules, each f32 Adam moment by `moment_spec` over ``data``), and the f32
  gradient accumulators of the rank's trainable leaves;
- serving: the KV cache of `infer.state.serving_cache` with a rank's
  lanes from `parallel.local_cache_dims` (`kv_cache_sharding`), its length
  by the engines' `infer.state.cache_slots`, and the frame embeddings the
  engine keeps; the chunk widths are the engines' own
  (`infer.engine.live_block_frames`, `infer.batch_engine.chunk_buckets`);
  a generating engine's decode state (`models.mmduet.decode_state`),
  which on the graph route (one process: `infer.state.decode_route`) is
  the captured step's for the engine's life, and on a rank of a process
  mesh is made for each decode; on the graph route also the engine's graph
  pool (`models.mmduet.EngineGraphs`): the largest moment a capture holds
  and the graphs' static inputs, which the pool keeps for the engine's
  life (a rank of a process mesh runs eagerly and has none).

On top of those persistent terms, each configuration lists its transient
terms at the moments where the code holds the most at once, each from a
tensor the code allocates (a shape times an element size): the staged batch
(`train.loop._to_device` moves the rank's share of the (A, B, T) window to
the device, `train.step.rank_batch`: its B / D samples' rows and its frame
slots); in serving the tower's 32-frame batch, the decoder's widest chunk,
the chunk's K/V rows and their commit, kernel A's and B's split scratch,
a decode step's activations and f32 logits (on the graph route the first,
eager call of each shape; its capture holds the same in the graph pool);
in
training under remat each layer's saved input, one layer's recompute and
backward, the projector's saved input and activations and the
loss's f32 logits with their gradients at T. The estimate is the
persistent bytes plus the largest moment. Nothing is fitted to a card: a
tensor the code allocates that no term names is a miss of the model.

Configurations: the reference recipe as `scripts/memory_budget.py` has it
(7B + so400m widths, seq 5120, accum 16, global batch 8, 100 frames a
sample) on ``zero2_8x1`` (8, 1) replicate (ZeRO-2), ``fsdp_8x1`` (8, 1)
fsdp and ``fsdp_tp_4x2`` (4, 2) fsdp, each judged against an H100 80GB
HBM3's ``total_memory``, and labelled an estimate. `chip_smoke.py` builds the
configurations of the peaks it measures (`Serving`, `Training`) and holds
these estimates against them. The table goes to stdout (``--out``: also to
a Markdown file), then one JSON object.

Where the port's layout is not the JAX package's, its per-rank bytes
differ on purpose: each rank keeps its trainable leaves whole over
``data`` (also under fsdp), and its Adam moments are f32 blocks cut inside
the rank's trainable block (`parallel.sharding.shard_train_state`), where
the JAX package cuts each whole moment, kept in the leaf's dtype.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mmduet_tpu_torch.config import MMDuetConfig, TestArgs, TrainArgs  # noqa: E402
from mmduet_tpu_torch.infer.batch_engine import (BatchedStreamEngine,  # noqa: E402
                                                 BatchedStreamScorer, chunk_buckets)
from mmduet_tpu_torch.infer.engine import VISION_BATCH, live_block_frames  # noqa: E402
from mmduet_tpu_torch.infer.state import (DEFAULT_BUCKETS, cache_slots,  # noqa: E402
                                          serving_cache, split_scratch_need)
from mmduet_tpu_torch.models import init_clip_params, init_lora, init_mmduet_params  # noqa: E402
from mmduet_tpu_torch.models import quant  # noqa: E402
from mmduet_tpu_torch.ops import attention, quant_matmul  # noqa: E402
from mmduet_tpu_torch.parallel import ProcessMesh  # noqa: E402
from mmduet_tpu_torch.parallel.sharding import (local_cache_dims, shard_params,  # noqa: E402
                                                shard_train_state)
from mmduet_tpu_torch.train.optimizer import make_optimizer, tree_map  # noqa: E402
from mmduet_tpu_torch.train.step import init_train_state  # noqa: E402

GIB = 2 ** 30
META = torch.device("meta")
# torch.cuda.get_device_properties(0).total_memory of an H100 80GB HBM3, as
# `chip_smoke.py` printed it; it judges the recipe by the card's own reading
H100_80GB_BYTES = 85_017_493_504
BF16, F32, I32, I64 = 2, 4, 4, 8

# the reference recipe (`scripts/memory_budget.py`, `scripts/train.sh`)
RECIPE_SEQ, RECIPE_FRAMES, RECIPE_BATCH, RECIPE_ACCUM = 5120, 100, 8, 16
RECIPE = (("zero2_8x1", (8, 1), "replicate"), ("fsdp_8x1", (8, 1), "fsdp"),
          ("fsdp_tp_4x2", (4, 2), "fsdp"))


@dataclasses.dataclass
class Budget:
    """One configuration's estimate for one rank: persistent terms, and
    the transient terms of each moment, as (name, bytes, what) rows."""

    name: str
    persistent: List[Tuple[str, int, str]]
    moments: Dict[str, List[Tuple[str, int, str]]]

    @property
    def persistent_bytes(self) -> int:
        return sum(b for _, b, _ in self.persistent)

    @property
    def peak_moment(self) -> Tuple[str, int]:
        """(name, transient bytes) of the moment that holds the most."""
        return max(((k, sum(b for _, b, _ in v)) for k, v in self.moments.items()),
                   key=lambda kv: kv[1], default=("none", 0))

    @property
    def total_bytes(self) -> int:
        return self.persistent_bytes + self.peak_moment[1]

    def rows(self) -> List[str]:
        """The terms, one line each, in GiB."""
        out = [f"{self.name}: estimate {self.total_bytes / GIB:.2f} GiB = persistent "
               f"{self.persistent_bytes / GIB:.2f} + moment '{self.peak_moment[0]}' "
               f"{self.peak_moment[1] / GIB:.2f}"]
        out += [f"    persistent  {b / GIB:8.3f} GiB  {n} ({w})" for n, b, w in self.persistent]
        name = self.peak_moment[0]
        out += [f"    {name[:11]:11s} {b / GIB:8.3f} GiB  {n} ({w})"
                for n, b, w in self.moments.get(name, [])]
        return out

    def as_dict(self) -> dict:
        return {"name": self.name, "estimate_gib": self.total_bytes / GIB,
                "persistent_gib": self.persistent_bytes / GIB,
                "peak_moment": self.peak_moment[0],
                "persistent": {n: b for n, b, _ in self.persistent},
                "moment": {n: b for n, b, _ in self.moments.get(self.peak_moment[0], [])}}


# ---------------------------------------------------------------------------
# Trees on the meta device, through the port's rules
# ---------------------------------------------------------------------------


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def rank_mesh(shape: Tuple[int, int]) -> ProcessMesh:
    """Rank (0, 0) of a `ProcessMesh` on the meta device, made without
    `torch.distributed`: the rules need only its shape and coordinates.
    Every rank's blocks have the bytes of rank (0, 0)'s (the rules cut only
    dims that divide their axis)."""
    return ProcessMesh(tuple(shape), (0, 0), META)


def model_params(cfg: MMDuetConfig, weights: str = "bf16", clip: bool = False) -> dict:
    """The whole tree of ``cfg`` as `init_mmduet_params` builds it, bf16;
    ``weights="int8"`` / ``"int4"``: `quant.quantize_params` of it (the
    decoder, embedding and LM head); ``clip``: the CLIP-L/14-336 tower and its
    projector in place of SigLIP's (`chip_smoke.clip_model`)."""
    params = init_mmduet_params(cfg, torch.Generator(), META, torch.bfloat16)
    if clip:
        vh, h = cfg.vision.hidden_size, cfg.text.hidden_size
        z = lambda *s: torch.empty(s, dtype=torch.bfloat16, device=META)  # noqa: E731
        params = dict(params, vision=init_clip_params(cfg.vision, torch.Generator(), META,
                                                      torch.bfloat16),
                      projector={"fc1": z(vh, h), "fc1_bias": z(h), "fc2": z(h, h),
                                 "fc2_bias": z(h)})
    if weights in ("int8", "int4"):
        params = quant.quantize_params(params, bits=int(weights[3:]))
    elif weights != "bf16":
        raise ValueError(f"weights {weights!r} (bf16, int8 or int4)")
    return params


def rank_params(params: dict, mesh: Tuple[int, int], mode: str = "replicate") -> dict:
    """A rank's local tree: `shard_params` on a meta mesh."""
    return shard_params(params, rank_mesh(mesh), mode=mode)


def rank_cache(cfg: MMDuetConfig, local_params: dict, mesh: Tuple[int, int], lanes: int,
               slots: int, quant_kind: Optional[str]):
    """The rank's serving cache: `serving_cache` over its lanes
    (`local_cache_dims`) and the kv heads of its local k projection."""
    lanes_here, heads_here = local_cache_dims(rank_mesh(mesh), cfg.text.num_kv_heads, lanes)
    cache = serving_cache(cfg.text, local_params["decoder"], lanes_here, slots,
                          torch.bfloat16, META, quant=quant_kind)
    k = cache.k["qw"] if isinstance(cache.k, dict) else cache.k
    if k.shape[2] != heads_here:
        raise AssertionError(f"serving_cache's {k.shape[2]} kv heads against "
                             f"local_cache_dims' {heads_here}")
    return cache, lanes_here


def rank_train_state(cfg: MMDuetConfig, params: dict, mesh: Tuple[int, int], lora_r: int):
    """A rank's `TrainState`: `init_train_state` of the whole tree and a
    LoRA adapter, cut by `shard_train_state` (trainable whole over data)."""
    tx, _ = make_optimizer(TrainArgs(), 1)
    lora = init_lora(torch.Generator(), cfg.text, rank=lora_r, device=META)
    state = init_train_state(params, lora, tx)
    return shard_train_state(state, rank_mesh(mesh))


# ---------------------------------------------------------------------------
# Kernel scratch
# ---------------------------------------------------------------------------


def decode_scratch_bytes(lanes: int, kv_heads: int, q_per_kv: int, tokens: int,
                         slots: int, head_dim: int) -> int:
    """Kernel A's split partials and counters for one launch, as
    `ops.attention._split_args` allocates them (`decode_scratch_numel`):
    nothing when the grid has one span."""
    n_part, n_counters = attention.decode_scratch_numel(lanes, kv_heads, tokens * q_per_kv,
                                                        slots, head_dim)
    return n_part * F32 + n_counters * I32


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


ENGINES = {"live": None, "batched": BatchedStreamEngine, "scorer": BatchedStreamScorer}


@dataclasses.dataclass
class Serving:
    """A serving configuration as one rank holds it.

    ``engine``: ``"live"`` (`LiveInferEngine`, one lane), ``"batched"``
    (`BatchedStreamEngine`) or ``"scorer"`` (`BatchedStreamScorer`);
    ``lanes``: the engine's lanes over all data ranks; ``grounding``: the
    live engine's mode, which sets its block (`live_block_frames`; the
    batched engines' blocks are their defaults); ``max_num_frames``: the
    engine's argument (None: its default), which sizes its cache
    (`cache_slots`) and the batched engine's (lanes, max_num_frames, ft,
    H) frame buffer; ``frames``: the session's video, whose embeddings
    the live engine and the scorer keep whole; ``pixels``: the frames
    arrive as pixels and the tower encodes them (else as embeddings);
    ``max_new``: the tokens a greedy answer may take (the live engine in
    generation mode and the batched engine generate)."""

    name: str
    cfg: MMDuetConfig
    weights: str = "bf16"
    clip: bool = False
    mesh: Tuple[int, int] = (1, 1)
    engine: str = "live"
    lanes: int = 1
    kv_cache_quant: Optional[str] = None
    grounding: bool = False
    max_num_frames: Optional[int] = None
    frames: int = 0
    pixels: bool = True
    max_new: int = TestArgs.max_new_tokens
    params: Optional[dict] = None  # the whole meta tree, when the caller has it

    def _default(self, arg: str):
        return inspect.signature(ENGINES[self.engine].__init__).parameters[arg].default

    def block(self) -> int:
        if self.engine == "live":
            return live_block_frames(self.grounding)
        return self._default("block_frames")

    def frame_cap(self) -> int:
        """``max_num_frames``, or the engine's default: the scorer's own
        argument's, the others' from their `TestArgs`."""
        if self.max_num_frames:
            return self.max_num_frames
        return self._default("max_num_frames") if self.engine == "scorer" \
            else TestArgs.max_num_frames

    def chunk_tokens(self) -> int:
        """The widest chunk a lane feeds one decoder forward: the batched
        engine's widest bucket, else a block of frames (a query or prompt
        chunk is at most the widest default bucket)."""
        ft = self.cfg.frame_num_tokens
        if self.engine == "batched":
            return max(chunk_buckets(self.block(), ft))
        return max(self.block() * ft, DEFAULT_BUCKETS[-1])


def _vision_moments(cfg: MMDuetConfig, N: int, M: int, clip: bool) -> Dict[str, List]:
    """The tower's call on N frames (`mmduet.visual_embed`): at its MLP's
    activation (`siglip.encoder_layer`'s fused pass on the card), and at
    the projector and the bilinear pooling (`mmduet.project`,
    `spatial_pool`); a rank of a model axis of
    M holds its 1/M of the heads, the MLP units and the projector's fc1."""
    v, H = cfg.vision, cfg.text.hidden_size
    C, Iv = v.hidden_size, v.intermediate_size // M
    P = v.num_patches + (1 if clip else 0)
    px = v.image_size if clip else cfg.frame_resolution
    pixels = ("pixels", N * px * px * 3 * (1 + BF16), f"uint8 and bf16 ({N}, {px}, {px}, 3)")
    out = {"vision tower": [
        pixels,
        ("tower rows", N * P * (2 * C + 4 * (C // M)) * BF16,
         f"bf16 layer input and output ({N}, {P}, {C}), q/k/v and attention ({N}, {P}, {C // M})"),
        ("tower MLP", N * P * Iv * 2 * BF16,
         f"fc1 out and its activation, bf16 ({N}, {P}, {Iv}; `vision_fused.bias_act`)"),
    ]}
    if clip:  # CLS + adaptive-pooled patches go to the projector: small
        return out
    side = v.num_patches_per_side
    pooled = -(-side // cfg.video_pooling_stride)
    pool = [
        pixels,
        ("projector out", N * P * H * BF16, f"bf16 ({N}, {P}, {H})"),
        ("pooling f32", 2 * N * P * H * F32 + N * pooled * side * H * F32,
         f"the f32 grid, its contraction copy and ({N}, {pooled}, {side}, {H}) (`spatial_pool`)"),
    ]
    if M > 1:
        pool.append(("fc2 partial f32", N * P * H * F32,
                     f"the f32 partial product before the sum over model ({N}, {P}, {H})"))
    out["vision pooling"] = pool
    return out


def serving_budget(s: Serving) -> Budget:
    if s.engine not in ENGINES:
        raise ValueError(f"engine {s.engine!r} (live, batched or scorer)")
    cfg, t = s.cfg, s.cfg.text
    params = s.params if s.params is not None else model_params(cfg, s.weights, s.clip)
    local = rank_params(params, s.mesh)
    cap = s.frame_cap()
    slots = cache_slots(cap, cfg.frame_num_tokens)
    cache, lanes = rank_cache(cfg, local, s.mesh, s.lanes, slots, s.kv_cache_quant)
    M = s.mesh[1]
    H, L, hd, V = t.hidden_size, t.num_layers, t.head_dim, t.vocab_size
    kh = t.num_kv_heads // M if t.num_kv_heads % M == 0 else t.num_kv_heads
    nh = t.num_heads // M if t.num_heads % M == 0 else t.num_heads
    inter = t.intermediate_size // M
    ft = cfg.frame_num_tokens
    T = s.chunk_tokens()
    R = lanes * T
    (a_part, a_counters), (b_part, b_tickets) = split_scratch_need(local, t, lanes, T, slots)
    persistent = [
        ("base weights", tree_bytes(local), f"{s.weights} tree, rank (0, 0) of {s.mesh}"),
        ("KV cache", tree_bytes(cache),
         f"(L {L}, lanes {lanes}, kh {kh}, S {slots}, hd {hd}) {s.kv_cache_quant or 'bf16'}"),
        ("penalty rows", lanes * V, "bool (lanes, V)"),
        ("kernel A scratch", a_part * F32 + a_counters * I32,
         f"split partials and counters, the most a chunk of 1 to {T} tokens asks "
         "(`infer.state.split_scratch_need`)"),
    ]
    if s.weights == "int4":
        persistent.append(("kernel B scratch", b_part * F32 + b_tickets * I32,
                           "split partials and tickets, the same"))
    if s.engine == "batched":
        persistent.append(("frame buffer", lanes * cap * ft * H * BF16,
                           f"bf16 (lanes {lanes}, {cap}, {ft}, {H})"))
    elif s.frames:
        persistent.append(("frame embeddings", lanes * s.frames * ft * H * BF16,
                           f"bf16 ({lanes} x {s.frames}, {ft}, {H})"))
    kv_rows = 2 * L * R * kh * hd * BF16
    moments: Dict[str, List] = {
        # the widest chunk at the last layer's MLP (`qwen2._out_mlp`): every
        # layer's chunk K/V kept for the commit, the chunk's rows, the
        # gate/up products with the f32 SiLU; the last rows' f32 logits
        "decoder chunk": [
            ("chunk K/V rows", kv_rows,
             f"2 x {L} layers x bf16 (lanes {lanes}, kh {kh}, {T}, {hd})"),
            ("chunk rows", R * (4 * H + 2 * nh * hd) * BF16,
             f"bf16 embeddings, residual, norm and layer output ({R}, {H}), q and attention "
             f"({R}, {nh * hd})"),
            ("MLP gate/up", 2 * R * inter * BF16, f"bf16 2 x ({R}, {inter})"),
            ("MLP SiLU f32", 2 * R * inter * F32, f"f32 gate and SiLU ({R}, {inter})"),
            ("LM head logits", lanes * (V // M + V) * F32, "f32 last rows, the rank's and whole"),
        ],
        # the commit (`qwen2.commit_rows`): every layer's rows; an int8
        # cache's f32 copies of the rows being quantized; the batched
        # engine's commit mask gathers its lanes' slots and selects
        "commit": [("chunk K/V rows", kv_rows, "every layer's rows (`qwen2._stream_forward`)")]
        + ([("quantized rows f32", kv_rows * F32 // BF16, "x.float() and x / scale of one "
             "of K, V (`quantize_kv_rows`)")] if s.kv_cache_quant else
           [("masked rows", kv_rows, "the slots' rows gathered and the selection, one of K, V "
             "(`qwen2._put_rows`)")] if s.engine == "batched" else []),
    }
    if s.engine == "batched" or (s.engine == "live" and not s.grounding):
        W = max(s.max_new - 1, 1)
        state = ("decode state", lanes * (s.max_new * (I32 + 2 * (F32 + I64)) + V + 4 * I32 + 2)
                 + 2 * I32 + 2 * L * lanes * kh * W * hd * BF16,
                 f"`decode_state`: the (L, lanes, kh, {W}, hd) bf16 scratch, the (lanes, V) "
                 f"penalty mask, tokens and each step's top-2")
        step = [("step rows", lanes * (4 * H + 2 * nh * hd + 2 * inter) * BF16
                 + 2 * lanes * inter * F32,
                 f"bf16 rows ({lanes}, {H}), q and attention, gate/up; the f32 SiLU"),
                ("step f32 logits", 4 * lanes * (V // M + V) * F32,
                 "the rank's and whole logits, the penalty's two products and its result")]
        if s.mesh == (1, 1):  # the graph route: the captured step's state, for the engine's life
            persistent.append(state)
            moments["decode step"] = step
        else:
            moments["decode step"] = [state] + step
    if s.mesh == (1, 1):  # the graph route: the engine's pool, for its life
        captured = max(sum(b for _, b, _ in moments[m]) for m in CAPTURED if m in moments)
        persistent.append(("graph pool", captured + graph_io_bytes(s),
                           "the captures' largest moment, and the static input embeddings of "
                           "each chunk width (`mmduet.EngineGraphs`)"))
    if s.pixels:
        moments.update(_vision_moments(cfg, VISION_BATCH, M, s.clip))
    return Budget(s.name, persistent, moments)


# The moments a captured graph holds in its pool (on the graph route the
# first, eager call of each shape holds them in the caching allocator's
# general pool as well).
CAPTURED = ("decoder chunk", "commit", "decode step")


def graph_io_bytes(s: Serving) -> int:
    """The static input embeddings an engine's graphs keep in their pool:
    one (lanes, width, H) bf16 buffer for each chunk width of the engine's
    table (`DEFAULT_BUCKETS` and a frame block, or the batched engine's
    `chunk_buckets`) that fits its cache. The cursors, the score positions
    and the outputs are a few hundred bytes a graph, left out."""
    ft, H = s.cfg.frame_num_tokens, s.cfg.text.hidden_size
    slots = cache_slots(s.frame_cap(), ft)
    widths = (chunk_buckets(s.block(), ft) if s.engine == "batched"
              else set(DEFAULT_BUCKETS) | {s.block() * ft})
    lanes = s.lanes // s.mesh[0] if s.lanes % s.mesh[0] == 0 else s.lanes
    return lanes * sum(w for w in widths if w <= slots) * H * BF16


def release_split_scratch() -> int:
    """Drops kernels A's and B's split scratch of every device (and A's
    memo of it), as a measurement does before a configuration's pass: the
    scratch is the configuration's own (its persistent term), which a new
    process would allocate in the pass; what an earlier engine's captured
    graphs hold stays theirs. Returns the bytes dropped from the modules."""
    held = 0
    for scratch in (attention._split_scratch, quant_matmul._split_scratch):
        held += sum(t.numel() * t.element_size() for ts in scratch.values() for t in ts)
        scratch.clear()
    attention._split_memo.clear()
    return held


def pool_idle_bytes(graphs) -> int:
    """The bytes of an engine's graph pool (`mmduet.EngineGraphs`) that no
    tensor holds, from the caching allocator's segments: the pool keeps
    them for the engine's life, so a measured peak on the graph route adds
    them to `torch.cuda.max_memory_allocated()`. 0 without a pool."""
    if graphs is None or graphs.pool is None:
        return 0
    pool = tuple(graphs.pool)
    return sum(seg["total_size"] - seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Training:
    """A training configuration as one rank holds it: a (data, model) mesh,
    ``param_mode`` (replicate: ZeRO-2; fsdp: the frozen base cut over
    data too), A = ``accum`` micro-batches of ``batch`` samples (the global
    batch) padded to ``seq`` tokens, ``frames`` frame slots a micro-batch
    (all samples), ``rank_frames`` of them this rank stages and encodes in
    each micro-batch (its samples' frames, one unused slot where they hold
    none, `train.step.rank_batch`; None: ``frames`` / data, all the slots
    where data is 1). The loop holds one `TrainState` and stages the rank's
    share of one step's A micro-batches at a time (`train.loop._to_device`)."""

    name: str
    cfg: MMDuetConfig
    mesh: Tuple[int, int] = (1, 1)
    param_mode: str = "replicate"
    accum: int = 16
    batch: int = 8
    seq: int = 5120
    frames: int = 800
    rank_frames: Optional[int] = None
    lora_r: int = 16
    params: Optional[dict] = None


def training_budget(c: Training) -> Budget:
    cfg, t, v = c.cfg, c.cfg.text, c.cfg.vision
    params = c.params if c.params is not None else model_params(cfg)
    D, M = c.mesh
    local = rank_params(params, c.mesh, c.param_mode)
    state = rank_train_state(cfg, params, c.mesh, c.lora_r)
    trainable = tree_bytes(state.trainable)
    moments_b = tree_bytes(state.opt_state["mu"]) + tree_bytes(state.opt_state["nu"])
    grads = tree_bytes(tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                      device=META), state.trainable))
    A, B, T = c.accum, c.batch, c.seq
    px = cfg.frame_resolution
    b = B // D if B % D == 0 else B  # the rank's samples a micro-batch
    n = c.rank_frames if c.rank_frames is not None else c.frames // D
    persistent = [
        ("base weights", tree_bytes(local), f"bf16, rank (0, 0) of {c.mesh} {c.param_mode}"),
        ("trainable", trainable, "LoRA f32, projector and heads bf16; whole over data"),
        ("Adam moments", moments_b, "f32 mu + nu, cut over data"),
        ("gradients", grads, "f32 accumulators of the rank's trainable leaves"),
        ("staged batch", A * (b * T * (4 * I32 + 1) + n * px * px * 3),
         f"the rank's share of {A} micro-batches: ({b}, T {T}) int32 x 4 + bool, uint8 "
         f"frames ({n}, {px}, {px}, 3)"),
    ]
    H, L, V = t.hidden_size, t.num_layers, t.vocab_size // M
    inter, hd = t.intermediate_size // M, t.head_dim
    nh, kh = t.num_heads // M, t.num_kv_heads // M
    P, C, Iv = v.num_patches, v.hidden_size, v.intermediate_size // M
    rows = b * T
    saved = [
        ("remat inputs", L * rows * H * BF16, f"{L} layers x bf16 ({b}, {T}, {H})"),
        ("projector saved", n * P * (H // M) * (BF16 + F32),
         f"fc1 out bf16 and its f32 GELU input ({n}, {P}, {H // M})"),
        ("tower output", n * P * C * BF16,
         f"bf16 ({n}, {P}, {C}): the projector's fc1 input, kept for its weight gradient"),
        ("final norm", rows * H * (BF16 + F32),
         f"its f32 input and bf16 output ({b}, {T}, {H}); the embeddings are layer 0's "
         "remat input"),
    ]
    moments = {
        # the loss's backward starts: the f32 logits, the log-softmax (or the
        # vocabulary-parallel shifted logits and their exponentials) and two
        # gradients (`mmduet.masked_ce`)
        "loss backward": saved + [("f32 logits and gradients", 4 * rows * V * F32,
                                   f"4 x f32 ({b}, {T}, {V})")],
        # one layer recomputed and its backward (`checkpoint`), with kernel
        # C's f32 partials (`_full_backward_plan`)
        "layer backward": saved + [
            ("layer activations", rows * (2 * inter * (2 * BF16 + 2 * F32)
                                          + 8 * H * BF16 + 2 * (nh + 2 * kh) * hd * BF16),
             f"gate/up bf16 and f32 with their gradients ({rows}, {inter}), q/k/v and "
             "the residual rows"),
            ("kernel C partials", 2 * rows * nh * hd * F32, f"f32 (2, {b}, {T}, {nh}, {hd})"),
        ],
        # the frozen tower on the rank's frames (no graph)
        "vision": [("pixels", n * px * px * 3 * (F32 + BF16), f"f32 and bf16 ({n}, {px}, {px}, 3)"),
                   ("tower rows", n * P * (2 * C + 4 * (C // M)) * BF16,
                    f"bf16 ({n}, {P}, {C}) x 2 and ({n}, {P}, {C // M}) x 4"),
                   ("tower MLP", n * P * Iv * 2 * BF16,
                    f"fc1 out and its activation, bf16 ({n}, {P}, {Iv}; "
                    "`vision_fused.bias_act`)")],
    }
    if c.param_mode == "fsdp" and D > 1:
        # leaves cut over data are gathered where they are used: one layer
        # (again in its recompute), and the LM head, held by the loss's graph
        layer = tree_bytes({k: x[0] for k, x in params["decoder"]["layers"].items()}) // M
        for k in ("loss backward", "layer backward"):
            moments[k].append(("gathered layer", layer, "one decoder layer whole over data"))
        moments["loss backward"].append(("gathered LM head", H * V * BF16, f"bf16 ({H}, {V})"))
    return Budget(c.name, persistent, moments)


def recipe_budgets(params: Optional[dict] = None) -> List[Budget]:
    """The reference recipe's three layouts at 7B + so400m widths, one rank
    each (global batch 8: one sample a data rank; 100 frames a sample)."""
    cfg = MMDuetConfig()
    params = params if params is not None else model_params(cfg)
    return [training_budget(Training(
        name, cfg, mesh, mode, accum=RECIPE_ACCUM, batch=RECIPE_BATCH, seq=RECIPE_SEQ,
        frames=RECIPE_BATCH * RECIPE_FRAMES, rank_frames=RECIPE_FRAMES * (RECIPE_BATCH // mesh[0]),
        params=params)) for name, mesh, mode in RECIPE]


def check(budget: Budget, measured_bytes: int, resident_bytes: int = 0) -> Tuple[bool, str]:
    """``budget`` against a measured peak less ``resident_bytes`` (what
    earlier work left allocated that is not part of the configuration): the
    persistent part at most the peak, the estimate within max(10 % of the
    peak, 1 GiB) of it. Returns (held, one line)."""
    peak = measured_bytes - resident_bytes
    tol = max(0.1 * peak, GIB)
    ok = budget.persistent_bytes <= peak and abs(budget.total_bytes - peak) <= tol
    line = (f"{budget.name}: measured {peak / GIB:.2f} GiB (peak {measured_bytes / GIB:.2f} less "
            f"{resident_bytes / GIB:.2f} resident from earlier phases), estimate "
            f"{budget.total_bytes / GIB:.2f} GiB (persistent {budget.persistent_bytes / GIB:.2f}"
            f" + '{budget.peak_moment[0]}' {budget.peak_moment[1] / GIB:.2f}), off by "
            f"{(budget.total_bytes - peak) / GIB:+.2f} of +-{tol / GIB:.2f}: "
            f"{'held' if ok else 'MISSED'}")
    return ok, line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="also write the table as Markdown here")
    args = p.parse_args(argv)
    cap = H100_80GB_BYTES
    budgets = recipe_budgets()
    lines = ["# 7B training memory per card, the PyTorch port (an estimate from shapes)", "",
             f"Reference recipe: seq {RECIPE_SEQ}, accum {RECIPE_ACCUM}, global batch "
             f"{RECIPE_BATCH}, {RECIPE_FRAMES} frames a sample, bf16 weights, f32 LoRA, "
             "gradients and Adam moments, remat on; one rank of each mesh. Generated by "
             "`python scripts/memory_budget_torch.py`; not a measurement.", "",
             "| config | mesh | base weights | trainable | Adam moments | staged batch | "
             f"peak moment | estimate | fits {cap / GIB:.2f} GiB |",
             "|---|---|---|---|---|---|---|---|---|"]
    out = {"capacity_bytes": cap, "estimates": []}
    for (name, mesh, mode), b in zip(RECIPE, budgets):
        per = {n: nbytes for n, nbytes, _ in b.persistent}
        fits = b.total_bytes <= cap
        lines.append(
            f"| {name} | {mesh} {mode} | {per['base weights'] / GIB:.2f} GiB | "
            f"{per['trainable'] / GIB:.3f} GiB | {per['Adam moments'] / GIB:.3f} GiB | "
            f"{per['staged batch'] / GIB:.2f} GiB | {b.peak_moment[0]} "
            f"{b.peak_moment[1] / GIB:.2f} GiB | **{b.total_bytes / GIB:.2f} GiB** | "
            f"{'yes' if fits else 'no'} |")
        out["estimates"].append(dict(b.as_dict(), mesh=list(mesh), param_mode=mode, fits=fits))
    lines.append("")
    for b in budgets:
        lines += b.rows()
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
