"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only]

Phases (any failure ends the run with a nonzero exit):

1. the card's name and power limit, from nvidia-smi;
2. every CUDA kernel of the paths, built from the sources in this checkout
   (one nvcc per source, all at once), held against its plain PyTorch
   version on the card at the shapes the paths give it, and timed beside
   it and beside its roofline bound (`ops/bounds.py`): kernel A (streaming
   attention) with a bf16 and with an int8 cache (each timed at the decode
   step, cache_len 2048 and 24000, the frame step and the 8- and 32-frame
   blocks;
   a kernel's ms is its device time, replayed from a CUDA graph, beside the
   eager time through the wrapper and the wrapper's host time per call), kernel B (the int4
   matrix product) at the five weight shapes of the 7B decoder and six row
   counts (timed as kernel A is at 1, 392 and 1568 rows, beside
   `_weight_int4pack_mm`, the library's W4A16 call, once it reproduces the
   plain version, and the dense bf16 weight on cuBLAS), kernel C (training attention: forward, its saved log-sum-exp
   and the three input gradients, two runs bit-equal, timed at the three
   training buckets beside `scaled_dot_product_attention` as the library's
   yardstick, the backward's four kernels also each on its own), kernel A' (kernel A per shard of a one-device mesh: for four
   mesh shapes, both caches and three chunk shapes at 8 lanes, bit-equal to
   one launch; timed on the (2, 2) mesh beside one
   `scaled_dot_product_attention` a shard) and kernel D (the ViT tower's attention at 32 frames x 729
   patches x 16 heads of 72, at CLIP-L/14-336's 32 x 577 x 16 heads of 64,
   both timed beside `scaled_dot_product_attention`, and at small ragged
   shapes), and the tower's fused passes (`ops.vision_fused`: bias_add3
   and bias_act bit-equal to their eager chains, the LayerNorm pass within
   one ulp, at a 32-frame batch of SigLIP, of CLIP-L/14-336 and a rank's
   MLP half; each timed at the SigLIP shape beside its plain version and
   its byte bound). Plain versions with one fault (a lost
   tile for kernels C and D, a lost split or key tile for kernel A with
   either cache; a
   dropped group scale or swapped nibble halves for kernel B) must fail the
   bounds, and so must shards of kernel A' that
   read another shard's cursors or kv heads. Then kernels A (both caches),
   B, C and D again at the shapes a rank of a (1, 2) tensor-parallel mesh
   gives them (14 query heads over 2 kv heads; the six local weight shapes
   from 3584 -> 1792 to the LM head's 3584 -> 76032; C forward and backward
   at one sample of the 2944-token bucket; 8 of 16 heads), and kernel A
   (both caches) at a (1, 4) rank's 7 query heads over 1 kv head, timed
   beside their bounds and the library calls. ``--kernels-only`` stops here
   (no result line);
3. an HF-format llava-OV directory at the published widths (2 decoder and
   2 vision layers: all of them would write ~16 GB, past the time; random
   weights from seed 0, two shards and an index, written by
   `write_hf_dir` here: the card has no safetensors package) through the
   port's converter, bf16 and ``--quantize int4``; `load_checkpoint` puts
   both on the card, every leaf bit-equal to the HF tensors under the
   documented transposes (int4: to `quantize_params(bits=4)` of the bf16
   output), and 16 frames served from each (int4 with the int8 cache:
   kernels B and A-int8) score as the same weights built in memory;
   conversion seconds, GB read and written, the host's peak RSS; then the
   port's side of the parity gate (`scripts/verify_checkpoint_parity_torch.py`'s
   `port_outputs`: next-token logits, score probabilities, the tower's
   features, the projector and the pooled count) on the bf16 directory,
   on the card (bf16, kernels A and D launched) against the CPU (f32, the
   plain versions) within the PARITY_* tolerances;
4. the serving path at the full width of the default model (Qwen2-7B
   decoder, SigLIP-so400m tower, random bf16 weights from a seed, all 28
   layers): `LiveInferEngine` streams 64 frames with a query at t=0 and
   generates, then streams them again in grounding mode, every forward on
   the engine's graph route (a CUDA graph captured once a shape and
   replayed); kernel A's
   launches over that run must be positive; a greedy decode of 32 tokens
   after it is timed on the engine's decode route (its prefill and each
   step a captured CUDA graph) and eagerly, tokens/s and the idle share
   under torch.profiler.
   Then the decode-graph phase: on a new engine of one lane (cursor 3000)
   and of 8 lanes (two frozen), `decode_loop`'s captured step against the
   eager route bit for bit (tokens, n, cursors, penalty mask, cache) at
   its capture, in replay, and in replay after an 8-frame block grew
   kernel A's split scratch, the launches of both routes equal, the
   engines' ``decode_route`` "graph"; both routes timed at 8 lanes. Then
   the frame-graph phase: on engines of the graph route against engines
   whose graphs are taken away, a generation session of 24 frames (8-frame
   blocks, answers with their rollbacks, joiners and prefills) and a
   pipelined grounding session of 32-frame blocks on one lane, and 8 lanes
   of `BatchedStreamEngine` (lanes ending early sit out dispatches and
   decodes, frozen; n < K frame chunks) with no mesh and on the (2, 2)
   one-device mesh, each bit-equal to the eager route in scores, answers,
   times, cursors, every cache byte and the launches of A, A-int8, A' and
   B, at the captures, in replay and in replay after eager launches grew
   kernel A's split scratch; then both routes timed in this run (median and
   range of 3, idle share under torch.profiler): the per-frame p50 / p90 of
   64 frames in 8-frame and in 32-frame blocks at B = 1, and the batched
   frame pass's frames/s and ms a frame fed. Then live feeding on that
   model: `stream_video` in chunks of 16 (generation, grounding, grounding
   with ``upload_ahead``) equals `input_video_stream` + `inference()` bit
   for bit, kernels A and D launch as the layers imply, both routes' wall
   times, and a `torch.profiler` trace shows kernel D (on the engine's side
   stream) overlapping kernel A; `prewarm(vision=True)` timed, a session
   after it equal to a cold engine's; the offline baseline's one answer
   over 64 frames and a question (kernels A and D launched, a finite
   cache). Then, on the same weights, offline feature extraction
   (`data.preprocess._encode_frames`: the 64 frames' SigLIP features, bit
   for bit the engine's tower output on the same 32-frame batches; a
   grounding pass over them with the pixel route's times and triggers; the
   ``--bf16`` file read back), the live demo (`LiveInferForDemo` after
   `prewarm(vision=True)`, a `DemoState` thread over the 64 frames behind
   the demo's HTTP handler on 127.0.0.1, paused mid-stream for a query sent
   through ``/query`` and ``/resume``, ``/state`` read to the last frame),
   and the CLIP arch at published widths (CLIP-L/14-336 in place of the
   SigLIP tower, CLS + 7 x 7 pooled tokens, the same 7B decoder): the 64
   frames at 336 px in generation and grounding mode, kernel D's 24 launches
   a tower call and kernel A's counted, every attention of a 32-frame tower
   call within D's bound of the plain version;
5. the training path at the same width: `make_train_step` takes 3
   optimizer steps of A=2 collated duet micro-batches (pixel frames at 384
   px, padded to the 2944-token bucket), LoRA r 16 / alpha 32 on the seven
   projections, gradient checkpointing on; kernel C's launches must equal
   what 28 layers x A x steps predict (two forwards per layer under remat,
   four backward kernels);
6. the vision tower with kernel D (asked for and by auto) and, for the
   comparison, with the plain version put in the kernel's place from here
   (frames/s each; the package refuses that route for CUDA tensors) and with
   the eager chains in the fused passes' place, then
   the batched serving path at the same width:
   `BatchedStreamEngine.serve()` streams 12 sessions of 40-64 frames
   through 8 lanes (generation mode, 8-frame blocks, lanes retiring and
   admitting, batched decodes), and `BatchedStreamScorer` scores 8 sessions
   in lockstep 32-frame blocks; once without a mesh, once under a (2, 2)
   mesh laid on the one card, whose responses, times and scores must equal
   the first run's exactly, and once (generation mode) with an int8 cache.
   The launches of kernels A, A' and D and of the fused passes must equal
   what the layers, the mesh's shards, the decoder forwards and the vision
   batches predict;
7. the quantized serving path at the same width: the decoder, embedding
   and LM head quantized to group-128 int4 on the card
   (`quantize_params(bits=4)`), `LiveInferEngine(kv_cache_quant="int8")`,
   the same two passes as in 3; kernel B's launches must equal seven per
   layer and decoder forward plus one per generated token (the LM head),
   and every attention launch must be of the int8 variant (a replayed
   decode step adds what its capture launched); then the decode-graph
   phase's one-lane check on this tree and cache, kernel B's scratch
   grown too, and the frame-graph phase's one-lane checks and times;
8. tensor-parallel serving: two ranks of a (1, 2) process mesh, spawned
   from here, share the one card over gloo (NCCL refuses two ranks on one
   device), each holding its shard (`parallel.shard_params`) of the same
   seed-0 weights; they run the passes of 4 and 7 and a batched pass (10
   sessions of random frame embeddings through 8 lanes), which the one
   process also runs; each batched session is made on one rank and shared
   (`eval.inference.mesh_items`, as the inference CLI shares a decoded
   sample), and every session a rank receives must be bit-equal to what
   its owner made (the same SHA-256 on every rank); each rank prints what
   it made, the bytes it sent and received and the seconds the pass waited
   for its sessions. Both ranks' rows must be the same bits; against the
   one process, scores within the larger of TP_SCORE_TOL and twice the one
   process's own spread under a permuted MLP (`permuted_mlp`: the same
   function, sums in another order), answers equal or differing only at a
   trigger or a near tie (TP_MARGIN_TOL). Each rank's launches (kernel A
   direct, no A' shards), peak memory, p50 / p90 per frame and decode
   tokens/s are printed. Two ranks on one card measure correctness and
   memory, not a speedup across cards;
9. the serving data axis (lanes over ranks): two ranks of a (2, 1) process
   mesh, spawned on the one card over gloo, each holding the seed-0 model
   at all 28 layers (`shard_params(mode="replicate")`) and the device state
   of its 4 of the 8 lanes, run the batched path of 6 (12 pixel sessions
   through `serve()`, bf16 and int8 caches; the scorer's 8 lockstep lanes),
   each encoding its own lanes' frames; then four ranks of a (2, 2) mesh,
   the decoder cut to 2 layers at the 7B widths, serve the TP batched
   sessions. Each session (and each of the scorer's videos) is made on one
   rank and shared, bit-equal to its owner's on every rank, as in 8. Every
   rank's rows must be the same bits; against the one
   process (6's runs; the cut model's own run) scores within the larger of
   TP_SCORE_TOL and twice the one process's spread under a permuted MLP,
   answers equal or differing at a trigger or a near tie; each rank's
   launches of kernels A / A-int8 must be the layers times the decoder
   forwards of its own lanes (none of A' or a plain version), of D the
   tower layers times its lanes' 32-frame batches. Each rank's peak
   memory, frames/s, ms per frame fed, decode tokens/s, dispatches,
   mean lanes a decode, sessions made and bytes shared are printed, and the
   phase's wall time;
10. the training mesh: 2 decoder layers at the 7B widths (the full
   SigLIP tower), LoRA r 16 / alpha 32, A = 2 micro-batches of two duet
   samples with other lengths, frames and label counts in the 2944-token
   bucket; the one process takes a warm-up and 2 steps, and again under a
   permuted MLP (its own rounding spread); then ranks spawned on the one
   card over gloo, (2, 1) replicate (ZeRO-2) and (2, 2) fsdp + TP + ZeRO-2,
   take the same steps, each rank staging only its share of each batch
   (`rank_batch`: its samples' rows and frame slots, cut on the host; its
   staged bytes printed beside the one process's): every rank's metrics
   the same bits, each step's metrics and the update of the gathered
   trainable leaves within the larger of a floor and twice the one
   process's own spread, kernel C's and D's launches a rank as its shapes
   imply, each rank's peak memory and s/step
   (gloo-bound) printed; each rank also reads 2 steps of the same samples
   from a dataset in memory by `train.loop.rank_real_batches` (model rank
   m fetching, collating and padding only its data rank's positions of
   the micro-batches i = m mod M, its shapes agreed through a sum over
   ``data`` on the card, the share sent to the other model ranks),
   bit-equal on the card to `rank_batch`'s cut of the steps `real_batches`
   collates whole, having fetched only its own positions (its samples,
   host batch bytes and bytes shared printed beside the one process's);
   the (2, 2) ranks' checkpoint of step 1, resumed in the one process,
   gives its step 2;
11. the training recipe: ``TINY_RANDOM=1 DEVICE=cuda bash
   scripts/train_torch.sh`` (synthetic steps) in one process, then with
   ``NPROC=2 DIST_BACKEND=gloo DEVICE=cuda:0`` (two ranks sharing the card
   under ``torch.distributed.run``): rc 0 and finite losses in
   ``log.jsonl`` each;
12. the memory budget: every peak measured above (serving bf16 and int4,
   the batched passes, training, CLIP, the TP, data and training-mesh
   ranks, each rank's own; each serving pass on its own, from a reset
   just before it, and training with one state and one step's batch on
   the card, as the CLI's loop holds them) against
   `scripts/memory_budget_torch.py`'s estimate of its configuration from
   shapes, printed term by term beside the peak and the bytes earlier
   work left resident (subtracted): the persistent part at most the peak,
   the whole within max(10 %, 1 GiB) of it (a one-process serving pass's
   peak with the bytes its engine's graph pool keeps beside its tensors,
   each pass from its own split scratch), and a training-mesh run's
   staged batch term equal to the bytes it staged; then the reference
   recipe's three layouts against this card's memory, labelled estimates;
13. small-model checks, card (bf16, kernels) against CPU (f32, plain
   versions): grounding scores of the engine, dense and quantized (int4
   weights, int8 cache, a LoRA adapter), of the batched engine (also
   against single-stream runs on the card), the offline baseline's prompt
   cache, and one train step's loss and gradient norm; and the inference
   CLI with ``--prewarm --profile_dir`` on the card, whose Chrome trace
   names kernel A;
14. one JSON line for the seven kernels (kernel D's entry also holds its
   ``clip336_*`` numbers and its launches on the CLIP path; A, A-int8, B
   and D their ``tp_local`` numbers and rank 0's launches on the TP path,
   C's two entries theirs at a rank's heads and the (2, 2) rank 0's
   launches on the training mesh, A' its ``process_mesh`` form; A, A-int8
   and D rank 0's launches on the data-axis path under ``data_axis``),
   then the result line
   ``{"ok": true, "device": {...}}``.

It needs `torch` with CUDA; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import random
import resource
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer
from typing import List

import numpy as np
import torch

from mmduet_tpu_torch.config import ClipConfig, MMDuetConfig, TestArgs, TrainArgs, tiny_config
from mmduet_tpu_torch.data import preprocess
from mmduet_tpu_torch.demo.app import DemoState, make_handler
from mmduet_tpu_torch.demo.live import LiveInferForDemo
from mmduet_tpu_torch.stream import CharTokenizer
from mmduet_tpu_torch.infer import BatchedStreamEngine, BatchedStreamScorer, LiveInferEngine
from mmduet_tpu_torch.infer.state import DEFAULT_BUCKETS, cache_slots
from mmduet_tpu_torch.models import (clip, init_clip_params, init_lora, init_mmduet_params,
                                     mmduet, quant, qwen2, siglip)
from mmduet_tpu_torch.models.io import load_config
from mmduet_tpu_torch.models.qwen2 import kv_arr, kv_quantized, quantize_kv_rows
from mmduet_tpu_torch.ops import _build, attention, bounds, quant_matmul, vision_fused
from mmduet_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, ProcessMesh, lane_block, make_mesh
from mmduet_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from mmduet_tpu_torch.train.duet import QUERY, duet_batches
from mmduet_tpu_torch.train.step import rank_batch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import memory_budget_torch as budget  # noqa: E402
import verify_checkpoint_parity_torch as parity  # noqa: E402


# --- an HF-format llava-OV directory, written without the safetensors
# package (the GPU machine has none); the CPU tests read it back with it

_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
              torch.int8: "I8", torch.int32: "I32"}


def write_safetensors(path: str, tensors: dict) -> int:
    """``tensors`` as one safetensors file: an 8-byte little-endian header
    length, the JSON header (``dtype``, ``shape``, ``data_offsets``) padded
    with spaces to 8 bytes, then each tensor's bytes in order. Returns the
    bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def hf_state_dict(params: dict, cfg: MMDuetConfig) -> dict:
    """The port's tree under the llava-OV checkpoint's keys and layouts:
    the inverse of `models.convert.convert_mmduet` (HF Linear weights are
    (out, in), per-layer tensors unstacked, the patch embedding a conv
    weight (out, 3, p, p); the vision tower nested as llava nests it)."""
    sd = {}

    def layers(tree, prefix, names):
        for leaf, (key, transpose) in names.items():
            if leaf in tree:
                for i, w in enumerate(tree[leaf].unbind(0)):
                    sd[prefix.format(i=i) + key] = w.t() if transpose else w

    dec = params["decoder"]
    sd["model.embed_tokens.weight"] = dec["embed"]
    sd["model.norm.weight"] = dec["final_norm"]
    layers(dec["layers"], "model.layers.{i}.", {
        "input_norm": ("input_layernorm.weight", False),
        "post_attn_norm": ("post_attention_layernorm.weight", False),
        **{p: (f"self_attn.{p}.weight", True) for p in ("q_proj", "k_proj", "v_proj", "o_proj")},
        **{p: (f"mlp.{p}.weight", True) for p in ("gate_proj", "up_proj", "down_proj")},
        **{f"{p}_bias": (f"self_attn.{p}_proj.bias", False) for p in "qkv"},
    })
    sd["lm_head.weight"] = params["lm_head"].t()
    for head in ("informative_head", "relevance_head"):
        sd[f"{head}.weight"] = params[head].t()
    pj = params["projector"]
    sd.update({"model.mm_projector.0.weight": pj["fc1"].t(),
               "model.mm_projector.0.bias": pj["fc1_bias"],
               "model.mm_projector.2.weight": pj["fc2"].t(),
               "model.mm_projector.2.bias": pj["fc2_bias"]})
    vis, vp = params["vision"], "model.vision_tower.vision_tower.vision_model."
    p = cfg.vision.patch_size
    sd[vp + "embeddings.patch_embedding.weight"] = vis["patch_embed"].t().reshape(-1, 3, p, p)
    sd[vp + "embeddings.patch_embedding.bias"] = vis["patch_bias"]
    sd[vp + "embeddings.position_embedding.weight"] = vis["pos_embed"]
    layers(vis["layers"], vp + "encoder.layers.{i}.", {
        **{f"ln{n}_{w}": (f"layer_norm{n}.{'weight' if w == 'scale' else 'bias'}", False)
           for n in (1, 2) for w in ("scale", "bias")},
        **{f"{p}_proj": (f"self_attn.{p}_proj.weight", True) for p in "qkv"},
        **{f"{p}_bias": (f"self_attn.{p}_proj.bias", False) for p in "qkv"},
        "o_proj": ("self_attn.out_proj.weight", True), "o_bias": ("self_attn.out_proj.bias", False),
        "fc1": ("mlp.fc1.weight", True), "fc1_bias": ("mlp.fc1.bias", False),
        "fc2": ("mlp.fc2.weight", True), "fc2_bias": ("mlp.fc2.bias", False),
    })
    return sd


def hf_config(cfg: MMDuetConfig) -> dict:
    """The HF ``config.json`` entries `models.convert.config_from_hf` reads."""
    t, v = cfg.text, cfg.vision
    return {
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size, "num_hidden_layers": t.num_layers,
        "num_attention_heads": t.num_heads, "num_key_value_heads": t.num_kv_heads,
        "head_dim": t.head_dim, "rope_theta": t.rope_theta, "rms_norm_eps": t.rms_norm_eps,
        "tie_word_embeddings": t.tie_word_embeddings, "eos_token_id": cfg.eos_token_id,
        "video_pooling_stride": cfg.video_pooling_stride,
        "vision_config": {
            "image_size": v.image_size, "patch_size": v.patch_size,
            "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_layers, "num_attention_heads": v.num_heads},
    }


def write_hf_dir(path: str, params: dict, cfg: MMDuetConfig, shards: int = 2) -> int:
    """An HF-format llava-OV directory of ``params``: ``config.json`` and
    the tensors in ``shards`` safetensors files listed by
    ``model.safetensors.index.json``. Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    sd = hf_state_dict(params, cfg)
    names = list(sd)
    cut = [names[i * len(names) // shards: (i + 1) * len(names) // shards]
           for i in range(shards)]
    weight_map, written = {}, 0
    for i, part in enumerate(cut):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        written += write_safetensors(os.path.join(path, fname), {k: sd[k] for k in part})
        weight_map.update({k: fname for k in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": written}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    return written


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph and replayed back to back, so that the host's time per call,
    which `_time_ms` holds when a kernel is shorter than it, is left out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = _time_ms(graph.replay, 5, warmup=0) / iters
    del graph
    return ms


def _host_us(fn, calls: int = 200) -> float:
    """Median host microseconds per call of ``fn`` over five runs of
    ``calls``, each started on an idle device."""
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return float(np.median(runs))


# The attention shapes of the 7B main path: nh=28, kh=4, hd=128; the cache
# is 4 stacked layers of the engine's S=24576 (400 frames x 49 + 4096,
# rounded to 2048). (name, T, Tc, t_real, q_offset)
ATTN_SHAPES = (
    ("decode step", 1, 31, 11, 10),
    ("frame step", 64, 64, 53, 0),
    ("8-frame block", 392, 392, 392, 0),
    ("32-frame block", 1568, 1568, 1568, 0),
)
CACHE_LENS = (0, 1, 2047, 2048, 9999, 24000)
TIMED_CACHE_LENS = {"decode step": (2048, 24000)}  # every other shape: 2048
DROP = {"decode step": slice(256, 512), "8-frame block": slice(640, 704)}  # a split, a key tile


def check_attention_kernel(log, nh: int = 28, kh: int = 4,
                           cache_lens=CACHE_LENS) -> List[dict]:
    """flash_decode_attention (CUDA) vs flash_decode_attention_ref on the
    card, with a bf16 cache and with the int8 cache that `quantize_kv_rows`
    makes of it, at ``nh`` query heads over ``kh`` kv heads (the 7B's, or
    a rank's under tensor parallelism); returns the two kernels' JSON
    entries (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    hd, L, S = 128, 4, 24576

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    worst = {"bf16": [0.0, 0.0], "int8": [0.0, 0.0]}  # max|diff|, max ratio
    timed = {}
    cases = [(shape, cl, 1) for shape in ATTN_SHAPES for cl in cache_lens]
    cases.append((ATTN_SHAPES[1], (2047, 9999), 2))  # B=2, two cursors
    for i, ((name, T, Tc, t_real, q_off), cache_len, B) in enumerate(cases):
        layer = 3 if i % 2 else 0
        q = randn(B, T, nh, hd)
        k_cache, v_cache = randn(L, B, kh, S, hd), randn(L, B, kh, S, hd)
        ck, cv = randn(B, kh, Tc, hd), randn(B, kh, Tc, hd)
        cl = cache_len if isinstance(cache_len, tuple) else (cache_len,) * B
        cursors = (torch.tensor(cl, dtype=torch.int32, device=dev),
                   torch.tensor((t_real,) * B, dtype=torch.int32, device=dev),
                   layer, torch.tensor((q_off,) * B, dtype=torch.int32, device=dev))
        (kq, ks), (vq, vs) = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
        variants = {"bf16": ((q, k_cache, v_cache, ck, cv) + cursors, {}),
                    "int8": ((q, kq, vq, ck, cv) + cursors, dict(k_scale=ks, v_scale=vs))}
        for variant, (args, scales) in variants.items():
            got = attention.flash_decode_attention(*args, **scales)
            # the plain version on the same values in f32 (p unrounded) and
            # on the live slots only (the others are masked); the kernel
            # rounds p (times the V scales of an int8 cache) to bf16, and its
            # bound has the rms term
            live = slice(0, max(max(cl), 1))
            up = tuple(a[..., live, :] if i in (1, 2) else a for i, a in enumerate(args))
            up = tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                       for a in up)
            cut = {k_: s[..., live] for k_, s in scales.items()}
            want = attention.flash_decode_attention_ref(*up, **cut)
            rms = bounds.decode_attention_rms(*up, **cut)
            torch.cuda.synchronize()
            real = slice(0, t_real)
            err = (got[:, real].float() - want[:, real]).abs().max().item()
            ratio = bounds.row_ratio(got[:, real], want[:, real], rms[:, real])
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(
                    f"flash_decode kernel ({variant} cache) vs plain: {name} B={B} "
                    f"cache_len={cl} layer={layer}: max|diff| {err}, {ratio} times the row "
                    f"bound {bounds.ROW_REL} * max|row| + {bounds.ROW_ABS} + 2^-9 "
                    f"{bounds.SIGMAS} rms")
            worst[variant] = [max(worst[variant][0], err), max(worst[variant][1], ratio)]
            if B == 1 and cache_len == 2048 and name in DROP:
                # the bound is tight: the plain version without one split (or
                # one key tile) fails it
                dropped = bounds.decode_attention_dropped(*up, drop=DROP[name], **cut)
                factor = bounds.row_ratio(got[:, real], dropped[:, real], rms[:, real])
                if not factor > 1.0:
                    raise AssertionError(f"flash_decode check ({variant} cache): {name} without "
                                         f"cache slots {DROP[name]} passes the bound ({factor} "
                                         "of it)")
                log(f"flash_decode {name}, {variant} cache: the plain version without the cache "
                    f"slots [{DROP[name].start}, {DROP[name].stop}) fails the bound by "
                    f"{factor:.1f}x")
                del dropped
            if B == 1 and cache_len in TIMED_CACHE_LENS.get(name, (2048,)):
                call = lambda: attention.flash_decode_attention(*args, **scales)  # noqa: E731
                ms = _graph_ms(call)
                eager_ms = _time_ms(call, 20)
                plain_ms = _time_ms(
                    lambda: attention.flash_decode_attention_ref(*args, **scales), 3)
                bound_ms, bound_by = bounds.decode_attention_bound(
                    B, T, nh, kh, hd, cache_len, t_real, q_off, int8=variant == "int8")
                library_ms = lib_ratio = None
                if variant == "bf16":  # the library takes no per-token scales
                    library_ms, lib_ratio = _time_sdpa_decode(
                        q, k_cache, v_cache, ck, cv, layer, cache_len, t_real, q_off,
                        want[:, real], rms[:, real])
                timed[variant, name, cache_len] = (ms, plain_ms, bound_ms, bound_by, library_ms)
                log(f"flash_decode {name}, {variant} cache: T={T} Tc={Tc} cache_len={cache_len} "
                    f"kernel {ms:.4f} ms (eager through the wrapper {eager_ms:.4f}), plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})"
                    + ("" if library_ms is None else
                       f", scaled_dot_product_attention (explicit mask, enable_gqa) "
                       f"{library_ms:.4f} ms, its output {lib_ratio:.3f} of the row bound"))
                if name == "decode step" and cache_len == 2048:
                    log(f"flash_decode {name}, {variant} cache: the wrapper's host time "
                        f"{_host_us(call):.2f} us per call")
            del got, want, rms, up
        del q, k_cache, v_cache, ck, cv, kq, ks, vq, vs, variants
    entries = []
    for variant, label in (("bf16", "flash_decode_attention"),
                           ("int8", "flash_decode_attention (int8 cache)")):
        log(f"flash_decode, {variant} cache: {len(cases)} cases within {bounds.ROW_REL} * "
            f"max|row| + {bounds.ROW_ABS} + 2^-9 {bounds.SIGMAS} rms (max|diff| "
            f"{worst[variant][0]}, at most {worst[variant][1]} of the row bound)")
        for name, *_ in ATTN_SHAPES:
            for cache_len in TIMED_CACHE_LENS.get(name, (2048,)):
                ms, _, bound_ms, bound_by, _ = timed[variant, name, cache_len]
                log(f"flash_decode, {variant} cache, {name} at cache_len {cache_len}: {ms:.4f} ms,"
                    f" bound {bound_ms:.5f} ms ({bound_by}), {ms / bound_ms:.1f}x the bound")
        ms, plain_ms, bound_ms, bound_by, library_ms = timed[variant, "8-frame block", 2048]
        entries.append({
            "name": label,
            "route": "cuda",
            "source": "mmduet_tpu_torch/ops/csrc/flash_decode.cu",
            "replaces": "mmduet_tpu/ops/attention.py:218",
            "max_abs_err": worst[variant][0],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # bf16: one SDPA call over the cache prefix and the chunk; int8: none takes
            # per-token scales
            "library_ms": library_ms,
        })
    return entries


def _time_sdpa_decode(q, k_cache, v_cache, ck, cv, layer: int, cache_len: int, t_real: int,
                      q_off: int, want, rms) -> tuple:
    """The library's yardstick for kernel A with a bf16 cache, timed here
    and called nowhere in the port: one `scaled_dot_product_attention` over
    the cache's first ``cache_len`` slots of ``layer`` and the chunk (the
    two concatenated beforehand, outside the timing), with an explicit
    boolean mask (every cache slot; chunk col j for query row t iff j <=
    q_off + t and j < t_real) and ``enable_gqa``. Returns (its ms by CUDA
    graph replay, its real rows' largest ratio to kernel A's row bound
    against the plain version, which must be <= 1: the same function)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    T, Tc, dev = q.shape[1], ck.shape[2], q.device
    k = torch.cat([k_cache[layer, :, :, :cache_len], ck], dim=2)
    v = torch.cat([v_cache[layer, :, :, :cache_len], cv], dim=2)
    row, col = torch.arange(T, device=dev)[:, None], torch.arange(Tc, device=dev)[None]
    mask = torch.cat([torch.ones((T, cache_len), dtype=torch.bool, device=dev),
                      (col <= q_off + row) & (col < t_real)], dim=1)
    qh = q.transpose(1, 2)
    try:
        sdpa(qh, k, v, attn_mask=mask, enable_gqa=True)
        kw = dict(attn_mask=mask, enable_gqa=True)
    except TypeError:  # an older PyTorch: the kv heads repeated beforehand
        rep = q.shape[2] // k.shape[1]
        k, v = (x.repeat_interleave(rep, dim=1) for x in (k, v))
        kw = dict(attn_mask=mask)
    out = sdpa(qh, k, v, **kw).transpose(1, 2)[:, :t_real]
    ratio = bounds.row_ratio(out, want, rms)
    if not ratio <= 1.0:
        raise AssertionError(f"scaled_dot_product_attention at T={T} cache_len={cache_len}: "
                             f"{ratio} of kernel A's row bound: not the same function")
    return _graph_ms(lambda: sdpa(qh, k, v, **kw)), ratio


def _time_sdpa_shards(q, k_cache, v_cache, ck, cv, cl, tr, qo, layer: int, mesh: tuple,
                      want, rms) -> tuple:
    """The library's yardstick for kernel A' with a bf16 cache, timed here
    and called nowhere in the port: for each (lane shard, head shard) of a
    ``mesh`` (data, model) on one device, one `scaled_dot_product_attention`
    over the shard's lanes and heads, on the cache's first max(cursor) slots
    of ``layer`` and the chunk (concatenated beforehand, outside the timing),
    with an explicit boolean mask a lane (cache slot j iff j < cache_len[b];
    chunk col j for query row t iff j <= q_offset[b] + t and j < t_real[b])
    and ``enable_gqa``. Returns (the shards' calls together, ms by CUDA graph
    replay; the real rows' largest ratio to kernel A's row bound against
    the plain version, which must be <= 1: the same function)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, T, nh, _ = q.shape
    kh, Tc, dev = k_cache.shape[2], ck.shape[2], q.device
    (data_n, model_n), lb = mesh, B // mesh[0]
    hq, hk = nh // model_n, kh // model_n
    row, col = torch.arange(T, device=dev)[:, None], torch.arange(Tc, device=dev)[None]
    calls, out = [], torch.empty_like(q)
    for i in range(data_n):
        ln = slice(i * lb, (i + 1) * lb)
        n = int(cl[ln].max())
        mask = torch.cat([
            (torch.arange(n, device=dev)[None, None] < cl[ln, None, None]).expand(lb, T, n),
            (col[None] <= qo[ln, None, None] + row[None]) & (col[None] < tr[ln, None, None])],
            dim=2)[:, None]
        for j in range(model_n):
            kv, qh = slice(j * hk, (j + 1) * hk), slice(j * hq, (j + 1) * hq)
            k = torch.cat([k_cache[layer, ln, kv, :n], ck[ln, kv]], dim=2)
            v = torch.cat([v_cache[layer, ln, kv, :n], cv[ln, kv]], dim=2)
            qt = q[ln, :, qh].transpose(1, 2)
            call = lambda qt=qt, k=k, v=v, mask=mask: sdpa(  # noqa: E731
                qt, k, v, attn_mask=mask, enable_gqa=True)
            out[ln, :, qh] = call().transpose(1, 2)
            calls.append(call)
    ratio = max(bounds.row_ratio(out[b, :int(tr[b])], want[b, :int(tr[b])], rms[b, :int(tr[b])])
                for b in range(B))
    if not ratio <= 1.0:
        raise AssertionError(f"scaled_dot_product_attention on the shards of {mesh}: {ratio} of "
                             "kernel A's row bound: not the same function")
    return _graph_ms(lambda: [call() for call in calls]), ratio


# Kernel A' at B = 8 lanes with a cursor of its own each; (data, model) mesh
# shapes whose shards divide 8 lanes, 28 heads and 4 kv heads.
SHARD_LANES = (0, 1, 63, 700, 2047, 2048, 4999, 6000)
SHARD_MESHES = ((2, 2), (1, 4), (4, 1), (8, 1))


def check_sharded_attention_kernel(log) -> dict:
    """flash_decode_attention_sharded on the card: for every mesh shape, bf16
    and int8 cache, decode-step, frame and 8-frame-block shapes, the sharded
    output is bit-equal to one unsharded launch of kernel A, which is within
    kernel A's row bound of the plain version; a lane shard fed another
    shard's cursors, or a head shard fed its neighbour's kv heads, is not.
    Returns kernel A' JSON entry (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    nh, kh, hd, L, S, B = 28, 4, 128, 2, 24576, len(SHARD_LANES)
    live = 6016  # the plain version attends the slots below this; none is live past it

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    k_cache, v_cache = randn(L, B, kh, S, hd), randn(L, B, kh, S, hd)
    (kq, ks), (vq, vs) = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
    cl = torch.tensor(SHARD_LANES, dtype=torch.int32, device=dev)
    ctxs = {shape: attention.ShardCtx(
        make_mesh(shape, devices=[dev] * (shape[0] * shape[1])),
        lane_axis=DATA_AXIS if shape[0] > 1 else None,
        head_axis=MODEL_AXIS if shape[1] > 1 else None) for shape in SHARD_MESHES}
    worst, n_equal, timed = 0.0, 0, None
    for name, T, Tc, t_real, q_off in ATTN_SHAPES[:3]:
        layer = 1 if T == 64 else 0
        q, ck, cv = randn(B, T, nh, hd), randn(B, kh, Tc, hd), randn(B, kh, Tc, hd)
        tr = torch.tensor([max(1, t_real - 3 * b) for b in range(B)], dtype=torch.int32,
                          device=dev)
        qo = torch.full((B,), q_off, dtype=torch.int32, device=dev)
        for variant, (kc, vc, scales) in {
                "bf16": (k_cache, v_cache, {}),
                "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}.items():
            one = attention.flash_decode_attention(q, kc, vc, ck, cv, cl, tr, layer,
                                                   q_offset=qo, **scales)
            cut = {k_: v_[..., :live] for k_, v_ in scales.items()}
            up = (q.float(), kc[..., :live, :] if scales else kc[..., :live, :].float(),
                  vc[..., :live, :] if scales else vc[..., :live, :].float(),
                  ck.float(), cv.float(), cl, tr, layer, qo)
            want = attention.flash_decode_attention_ref(*up, **cut)
            # the kernel rounds p: its bound has the rms term
            rms = bounds.decode_attention_rms(*up, **cut)
            rows = [(one[b, :int(tr[b])], want[b, :int(tr[b])], rms[b, :int(tr[b])])
                    for b in range(B)]
            ratio = max(bounds.row_ratio(g, w, r) for g, w, r in rows)
            worst = max(worst, max((g.float() - w).abs().max().item() for g, w, _ in rows))
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(f"flash_decode kernel at B={B} ({variant} cache, {name}) "
                                     f"vs plain: {ratio} times the row bound")
            del rows
            for shape, ctx in ctxs.items():
                before = attention.SHARDED_LAUNCHES
                got = attention.flash_decode_attention_sharded(
                    q, kc, vc, ck, cv, cl, tr, layer, ctx, q_offset=qo, **scales)
                torch.cuda.synchronize()
                if attention.SHARDED_LAUNCHES - before != shape[0] * shape[1]:
                    raise AssertionError(f"sharded attention, mesh {shape}: "
                                         f"{attention.SHARDED_LAUNCHES - before} launches")
                if not torch.equal(got, one):
                    raise AssertionError(
                        f"sharded attention, mesh {shape}, {variant} cache, {name}: not "
                        f"bit-equal to one launch (max|diff| "
                        f"{(got.float() - one.float()).abs().max().item()})")
                n_equal += 1
            # the check is tight: shards that read what is not theirs differ
            ctx = ctxs[2, 2]
            half = B // 2
            wrong_lanes = attention.flash_decode_attention_sharded(
                q, kc, vc, ck, cv, cl[:half].repeat(2), tr, layer, ctx, q_offset=qo, **scales)
            rolled = {k_: v_.roll(kh // 2, dims=2) for k_, v_ in scales.items()}
            wrong_heads = attention.flash_decode_attention_sharded(
                q, kc.roll(kh // 2, dims=2), vc.roll(kh // 2, dims=2), ck, cv, cl, tr, layer,
                ctx, q_offset=qo, **rolled)
            for what, bad in (("the first lane shard's cursors on every shard", wrong_lanes),
                              ("each head shard on its neighbour's kv heads", wrong_heads)):
                r = bounds.row_ratio(bad[half:, :1], one[half:, :1].float())
                if torch.equal(bad, one) or not r > 1.0:
                    raise AssertionError(f"sharded attention check ({variant}, {name}): {what} "
                                         f"passes ({r} of the row bound)")
            del wrong_lanes, wrong_heads, rolled
            if name == "8-frame block" and variant == "bf16":
                args = (q, kc, vc, ck, cv, cl, tr, layer)
                one_ms = _graph_ms(lambda: attention.flash_decode_attention(
                    *args, q_offset=qo))
                ms = _graph_ms(lambda: attention.flash_decode_attention_sharded(
                    *args, ctx, q_offset=qo))
                plain_ms = _time_ms(lambda: attention.flash_decode_attention_ref(
                    q, kc[..., :live, :], vc[..., :live, :], ck, cv, cl, tr, layer,
                    q_offset=qo), 2, warmup=1)
                parts = [bounds.decode_attention_bound(1, T, nh, kh, hd, c, int(t), q_off)
                         for c, t in zip(SHARD_LANES, tr.tolist())]
                bound_ms = sum(p[0] for p in parts)
                library_ms, lib_ratio = _time_sdpa_shards(q, kc, vc, ck, cv, cl, tr, qo, layer,
                                                          (2, 2), want, rms)
                timed = (ms, plain_ms, bound_ms, parts[-1][1], library_ms)
                log(f"flash_decode sharded, {name}, B={B} lanes at cursors {SHARD_LANES}: the "
                    f"(2, 2) mesh's four launches {ms:.4f} ms, one launch {one_ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({parts[-1][1]}), "
                    f"scaled_dot_product_attention on each shard (explicit mask, enable_gqa) "
                    f"{library_ms:.4f} ms, its output {lib_ratio:.3f} of the row bound")
            del want, rms
        del q, ck, cv
    log(f"flash_decode sharded: {n_equal} (mesh, cache, shape) cases bit-equal to one launch, "
        f"which is within the row bound of the plain version (max|diff| {worst}); wrong "
        f"cursors and wrong kv heads both fail")
    ms, plain_ms, bound_ms, bound_by, library_ms = timed
    return {
        "name": "flash_decode_attention_sharded ((2, 2) mesh on one device: four launches)",
        "route": "cuda",
        "source": "mmduet_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "mmduet_tpu/ops/attention.py:421",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # one SDPA call a shard over its lanes and heads, the four calls together
        "library_ms": library_ms,
    }


# Kernel D: (N, T, nh, hd). The serving shape (VISION_BATCH frames of 729
# patches through SigLIP-so400m's 16 heads of 72), CLIP-L/14-336's (1 + 24 x
# 24 tokens through 16 heads of 64: the last 192-query block holds one row,
# the last 128-key tile 65 keys), then small ragged ones.
VISION_SHAPES = ((32, 729, 16, 72), (32, 577, 16, 64), (1, 50, 16, 64), (2, 129, 3, 128),
                 (3, 64, 2, 8), (1, 1, 1, 40))
VISION_DROP = slice(64 * 5, 64 * 6)  # the key tile of the mutated plain version
# the shapes timed, and the prefix of their fields in kernel D's entry
VISION_TIMED = {(32, 729, 16, 72): "", (32, 577, 16, 64): "clip336_"}


def _time_vision(q, k, v, rms, got, log) -> dict:
    """Kernel D at one timed shape: the plain version without one key tile
    must fail the bound; the kernel, the plain version and SDPA timed
    beside the bound."""
    N, T, nh, hd = q.shape
    dropped = bounds.vision_attention_dropped(q, k, v, VISION_DROP)
    factor = bounds.full_attention_ratio(got, dropped, rms)
    del dropped
    if not factor > 1.0:
        raise AssertionError(f"flash_vision check at {tuple(q.shape)}: the plain version "
                             f"without one key tile passes the bound ({factor} of it)")
    log(f"flash_vision {tuple(q.shape)}: the plain version without the keys "
        f"[{VISION_DROP.start}, {VISION_DROP.stop}) fails the bound by {factor:.1f}x")
    ms = _time_ms(lambda: attention.flash_vision_attention(q, k, v), 20)
    plain_ms = _time_ms(lambda: attention.flash_vision_attention_ref(q, k, v), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))  # (N, nh, T, hd)
    # the library's yardstick, timed here and called nowhere in the port
    library_ms = _time_ms(lambda: sdpa(qh, kh_, vh), 20)
    bound_ms, bound_by = bounds.vision_attention_bound(N, T, nh, hd)
    log(f"flash_vision N={N} T={T} nh={nh} hd={hd} bf16: kernel {ms:.4f} ms "
        f"({4e-9 * N * nh * T * T * hd / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_vision_attention_kernel(log) -> dict:
    """flash_vision_attention (CUDA) vs flash_vision_attention_ref on the
    card; returns kernel D's JSON entry (without launches), with the
    CLIP-L/14-336 shape's numbers as ``clip336_*`` fields."""
    worst, worst_ratio, timed = check_vision_shapes(log, VISION_SHAPES, VISION_TIMED, seed=6)
    log(f"flash_vision: {len(VISION_SHAPES)} shapes within 2^-8 |plain| + 2^-9 {bounds.SIGMAS} "
        f"rms + {bounds.FULL_ABS} (max|diff| {worst}, at most {worst_ratio:.3f} of the bound)")
    return {
        "name": "flash_vision_attention",
        "route": "cuda",
        "source": "mmduet_tpu_torch/ops/csrc/flash_vision.cu",
        "replaces": "mmduet_tpu/ops/attention.py:520",
        "max_abs_err": worst,
        **timed,
    }


def check_vision_shapes(log, shapes, timed_prefixes: dict, seed: int):
    """Kernel D against its plain version at each (N, T, nh, hd) of
    ``shapes``; the shapes of ``timed_prefixes`` are timed (`_time_vision`)
    and their numbers keyed with their prefix. Returns (max|diff|, the
    largest share of the bound, the timed numbers)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = worst_ratio = 0.0
    timed = {}
    for shape in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        got = attention.flash_vision_attention(q, k, v)
        want = attention.flash_vision_attention_ref(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        rms = bounds.vision_attention_rms(q, k, v)
        ratio = bounds.full_attention_ratio(got, want, rms)
        err = (got.float() - want).abs().max().item()
        if not math.isfinite(ratio) or ratio > 1.0:
            raise AssertionError(
                f"flash_vision kernel vs plain at {shape}: max|diff| {err}, {ratio} times the "
                f"bound 2^-8 |plain| + 2^-9 {bounds.SIGMAS} rms + {bounds.FULL_ABS}")
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        if shape in timed_prefixes:
            del want
            prefix = timed_prefixes[shape]
            timed.update({prefix + key: x
                          for key, x in _time_vision(q, k, v, rms, got, log).items()})
            if prefix:
                timed[prefix + "shape"] = list(shape)
                timed[prefix + "max_abs_err"] = err
        del q, k, v, got, rms
        torch.cuda.empty_cache()
    return worst, worst_ratio, timed


# The tower's fused passes (`ops.vision_fused`): (rows, hidden, MLP width) of a
# 32-frame SigLIP batch, the timed shape, and of CLIP-L/14-336 and a (1, 2)
# rank's MLP half, held only
FUSED_SHAPES = ((32 * 729, 1152, 4304), (32 * 577, 1024, 4096), (4 * 729, 1152, 2152))


def check_vision_fused_kernels(log) -> dict:
    """The three passes of `ops.vision_fused` against their plain versions
    on the same CUDA tensors at ``FUSED_SHAPES``: `bias_add3` and `bias_act`
    (both activations) bit-equal, `bias_residual_layernorm` in its four
    forms with h_new bit-equal and y within `bounds.layernorm_ratio`; at the
    first shape each pass timed (device ms by graph replay) beside its
    plain version and its byte bound. Returns the passes' JSON entry
    (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    timed, worst, worst_ratio, same = {}, 0.0, 0.0, 0.0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    for n, (rows, C, inter) in enumerate(FUSED_SHAPES):
        p3 = [randn(rows, C) for _ in range(3)]
        b3 = [randn(C) for _ in range(3)]
        got = vision_fused.bias_add3(*p3, *b3)
        want = vision_fused.bias_add3_ref(*p3, *b3)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"bias_add3 at ({rows}, {C}) is not bit-equal to its plain "
                                 "version")
        h, scale, shift = randn(rows, C), 1 + 0.1 * randn(C), randn(C)
        forms = {"o_proj": (p3[0], b3[0], h, scale, shift), "ln1": (p3[0], None, None, scale, shift),
                 "last": (p3[0], b3[0], h, None, None)}
        for form, args in forms.items():
            (gh, gy), (wh, wy) = (vision_fused.bias_residual_layernorm(*args, 1e-6),
                                  vision_fused.bias_residual_layernorm_ref(*args, 1e-6))
            ratio = 0.0 if gy is None else bounds.layernorm_ratio(
                gy, wy, bounds.layernorm_terms(wh, scale, shift, 1e-6))
            if not torch.equal(gh, wh) or not ratio <= 1.0:
                raise AssertionError(f"bias_residual_layernorm ({form}) at ({rows}, {C}): h_new "
                                     f"equal {torch.equal(gh, wh)}, y at {ratio} of its bound")
            if gy is not None:
                worst = max(worst, (gy.float() - wy.float()).abs().max().item())
                worst_ratio = max(worst_ratio, ratio)
                same = max(same, (gy != wy).float().mean().item())
        fc1, b1 = randn(rows, inter), randn(inter)
        for act in (vision_fused.gelu_tanh, vision_fused.quick_gelu):
            if not torch.equal(vision_fused.bias_act(fc1, b1, act),
                               vision_fused.bias_act_ref(fc1, b1, act)):
                raise AssertionError(f"bias_act ({act.__name__}) at ({rows}, {inter}) is not "
                                     "bit-equal to its plain version")
        if n == 0:
            rows_ = (
                ("bias_add3", lambda: vision_fused.bias_add3(*p3, *b3),
                 lambda: vision_fused.bias_add3_ref(*p3, *b3), bounds.bias_add3_bound(rows, C)),
                ("bias_residual_layernorm",
                 lambda: vision_fused.bias_residual_layernorm(*forms["o_proj"], 1e-6),
                 lambda: vision_fused.bias_residual_layernorm_ref(*forms["o_proj"], 1e-6),
                 bounds.residual_layernorm_bound(rows, C)),
                ("bias_act", lambda: vision_fused.bias_act(fc1, b1, vision_fused.gelu_tanh),
                 lambda: vision_fused.bias_act_ref(fc1, b1, vision_fused.gelu_tanh),
                 bounds.bias_act_bound(rows, inter)))
            for name, fused, plain, (bound_ms, bound_by) in rows_:
                ms, plain_ms = _graph_ms(fused), _graph_ms(plain)
                log(f"{name} at {rows} rows x {C} (MLP {inter}): kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, "
                    f"{100 * bound_ms / ms:.1f} % of it)")
                timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by}
        del p3, b3, got, want, h, fc1
        torch.cuda.empty_cache()
    log(f"vision_fused: {len(FUSED_SHAPES)} shapes, bias_add3 and bias_act bit-equal, the "
        f"LayerNorm pass's y max|diff| {worst} at most {worst_ratio:.3f} of its bound, "
        f"at most {100 * same:.4f} % of its values not bit-equal")
    return {"name": "vision_fused", "route": "cuda",
            "source": "mmduet_tpu_torch/ops/csrc/vision_fused.cu", "replaces": None,
            "shape": list(FUSED_SHAPES[0]), "max_abs_err": worst, **timed}


# Kernel B at the 7B decoder's weight shapes (H, O): q/o projections, k/v
# projections, gate/up, down, and the LM head; group 128. Rows: a decode
# step, a small chunk, a joiner + frame step, the 8- and 32-frame blocks,
# and one row past 2048 (where the TPU kernel's wrapper chunks its rows).
INT4_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064))
INT4_ROWS = (1, 8, 53, 392, 1568, 2049)
INT4_TIMED_ROWS = (1, 392, 1568)
INT4_ENTRY = ((3584, 18944), 392)  # the shape and rows of the kernels line
INT4_MUTANT_FACTOR = 10.0  # a plain version with one fault misses the bound by this much or more
LIB_REL = 2.0**-8  # `_weight_int4pack_mm` against the plain version: bf16 weights and output


def int4pack_operands(qw4: torch.Tensor, qs: torch.Tensor, inner_k_tiles: int = 8):
    """Kernel B's split-halves int4 leaf as `torch.ops.aten._weight_int4pack_mm`
    takes it: the unsigned values q + 8, two a byte along k (the even k in
    the high nibble) in an (O, H / 2) uint8 tensor for
    `_convert_weight_to_int4pack`, and (G, O, 2) bf16 scales and zero points
    (0), which that call reads as w = (u - 8) s + z = q s."""
    q = quant_matmul.unpack_groups(qw4)  # (G, g, O) int8 in [-8, 7]
    u = (q.reshape(-1, q.shape[-1]).t().to(torch.int32) + 8)  # (O, H)
    packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous()
    weight = torch.ops.aten._convert_weight_to_int4pack(packed, inner_k_tiles)
    s = qs[:, 0, :].to(torch.bfloat16)
    scales_zeros = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()
    return weight, scales_zeros


def check_int4_library(y, qw4, qs, want, mag):
    """`_weight_int4pack_mm` on kernel B's operands: (callable, None) when
    it reproduces the plain version within ``LIB_REL * (|plain| + sum|y||q|s)``
    (its weight and output are bf16), else (None, the reason)."""
    g = 2 * qw4.shape[1]
    try:
        weight, scales_zeros = int4pack_operands(qw4, qs)
        call = lambda: torch.ops.aten._weight_int4pack_mm(y, weight, g, scales_zeros)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
    except RuntimeError as e:  # the build of torch may lack the CUDA kernel
        return None, f"_weight_int4pack_mm failed: {str(e).splitlines()[0]}"
    ratio = ((got.float() - want).abs() / (LIB_REL * (want.abs() + mag) + 1e-6)).max().item()
    if not ratio <= 1.0:
        return None, f"_weight_int4pack_mm misses the plain version by {ratio:.3g}x its bf16 bound"
    return call, None


def check_int4_kernel(log) -> dict:
    """int4_matmul (CUDA) vs int4_matmul_ref on the card; returns kernel
    B's JSON entry (without launches)."""
    worst, worst_ratio, timed = check_int4_shapes(log, INT4_SHAPES, INT4_ROWS, seed=3)
    n_cases = len(INT4_SHAPES) * len(INT4_ROWS)
    log(f"int4_matmul: {n_cases} cases within {bounds.B_REL} * sum|y||w| + {bounds.B_ABS} "
        f"(max|diff| {worst}, at most {worst_ratio:.4f} of the bound)")
    return {
        "name": "int4_matmul",
        "route": "cuda",
        "source": "mmduet_tpu_torch/ops/csrc/int4_matmul.cu",
        "replaces": "mmduet_tpu/ops/quant_matmul.py:108",
        "max_abs_err": worst,
        **timed[INT4_ENTRY],
    }


def check_int4_shapes(log, shapes, rows, seed: int):
    """Kernel B against its plain version at each (H, O) of ``shapes`` and
    each row count of ``rows``, the bound's tightness at the fourth shape,
    the times at `INT4_TIMED_ROWS`; returns (max|diff|, the largest share
    of the bound, {((H, O), R): times})."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = worst_ratio = 0.0
    timed = {}
    for H, O in shapes:
        w = torch.randn((H, O), generator=gen, device=dev, dtype=torch.bfloat16) / math.sqrt(H)
        leaf = quant.quantize_weight_int4(w, 0)
        leaf8 = quant.quantize_weight(w, 0)
        qw4, qs = leaf["qw4"], leaf["qs"]
        # copies to rotate through while timing, so that a launch finds its
        # weight in device memory, not in the 50 MB L2, as a layer's does
        n_copies = max(1, min(8, -(-(120 << 20) // qw4.numel())))
        copies = [(qw4.clone(), qs.clone()) for _ in range(n_copies)]
        for R in rows:
            y = torch.randn((R, H), generator=gen, device=dev, dtype=torch.bfloat16)
            got = quant_matmul.int4_matmul(y, qw4, qs)
            want = quant_matmul.int4_matmul_ref(y, qw4, qs)
            mag = bounds.int4_matmul_magnitude(y, qw4, qs)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ratio = bounds.int4_matmul_ratio(got, want, mag)
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(
                    f"int4_matmul kernel vs plain: R={R} H={H} O={O}: max|diff| {err}, {ratio} "
                    f"times the bound {bounds.B_REL} * sum|y||w| + {bounds.B_ABS}")
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
            if (H, O) == shapes[3] and R in (1, 392):
                # the bound is tight: plain versions with one fault fail it
                factors = {kind: bounds.int4_matmul_ratio(
                    got, bounds.int4_matmul_mutated(y, qw4, qs, kind), mag)
                    for kind in ("scale", "halves")}
                if not all(f >= INT4_MUTANT_FACTOR for f in factors.values()):
                    raise AssertionError(f"int4_matmul check: a mutated plain version misses "
                                         f"the bound by less than {INT4_MUTANT_FACTOR}x at "
                                         f"R={R}: {factors}")
                log(f"int4_matmul R={R} H={H} O={O}: plain versions with one group's scale "
                    f"dropped / the nibble halves swapped fail the bound by "
                    f"{factors['scale']:.0f}x / {factors['halves']:.0f}x")
            if R in INT4_TIMED_ROWS:
                timed[(H, O), R] = time_int4(log, y, w, leaf8, qw4, qs, copies, want, mag)
            del y, got, want, mag
        del w, leaf, leaf8, qw4, qs, copies
        torch.cuda.empty_cache()
    return worst, worst_ratio, timed


def time_int4(log, y, w, leaf8, qw4, qs, copies, want, mag) -> dict:
    """Kernel B's times at one shape: device ms from a CUDA graph's replay,
    the eager ms and host us per call through the wrapper, beside the plain
    version, the bound, `_weight_int4pack_mm` (the library's W4A16 call) and
    the dense bf16 weight on cuBLAS; returns the kernels line's numbers."""
    R, H = y.shape
    O = qw4.shape[-1]
    turn = iter(range(10 ** 9))

    def launch():
        a, b = copies[next(turn) % len(copies)]
        return quant_matmul.int4_matmul(y, a, b)

    ms = _graph_ms(launch)
    eager_ms = _time_ms(launch, 20 if R == 1 else 8)
    host_us = _host_us(launch, 200 if R == 1 else 20)
    plain_ms = _time_ms(lambda: quant_matmul.int4_matmul_ref(y, qw4, qs), 2, warmup=1)
    bound_ms, bound_by = bounds.int4_matmul_bound(R, H, O)
    plan = quant_matmul.int4_plan(R, H, O, 2 * qw4.shape[1])
    log(f"int4_matmul R={R} H={H} O={O}: kernel {ms:.4f} ms ({plan.path}, ks {plan.ks}; "
        f"eager through the wrapper {eager_ms:.4f}, host {host_us:.2f} us per call), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), {ms / bound_ms:.2f}x it; "
        f"packed weight {qw4.numel() / 1e6:.1f} MB at {qw4.numel() / ms / 1e6:.1f} GB/s, "
        f"{2e-9 * R * H * O / ms:.2f} TFLOP/s")
    library, why = check_int4_library(y, qw4, qs, want, mag)
    library_ms = _graph_ms(library) if library is not None else None
    # beside it, on the same activations: the dense bf16 weight on cuBLAS,
    # and the int8 leaf's route (a bf16 copy of the weight per call, cuBLAS,
    # one row of scales), which has no kernel
    dense_ms = _graph_ms(lambda: quant.matmul_f32(y, w))
    int8_ms = _time_ms(lambda: quant.quantized_matmul(y, leaf8), 8)
    log(f"int4_matmul R={R} H={H} O={O}: _weight_int4pack_mm "
        + (f"{library_ms:.4f} ms (kernel/library {ms / library_ms:.2f})" if why is None else
           f"not timed: {why}")
        + f"; the dense bf16 weight on cuBLAS {dense_ms:.4f} ms (kernel/cuBLAS "
        f"{ms / dense_ms:.2f}; one weight every launch: {2 * H * O / 1e6:.1f} MB of bf16, in L2 "
        f"if under 50 MB); the int8 leaf's plain route {int8_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# Kernel C at the training shapes: 7B heads (nh 28, kh 4, hd 128), bf16.
# (T, real tokens per lane, padding side): the three length buckets of
# parse_length_buckets("auto", 5924) right-padded as the collator pads, one
# left-padded case, one tiny T, and two lanes with different pad lengths at
# a T one past a tile.
FULL_CASES = ((1536, (1400,), "right"), (2944, (2700,), "right"), (5924, (5500,), "right"),
              (2944, (2000,), "left"), (40, (29,), "right"), (705, (650, 130), "left"))
TIMED_T = 2944  # the bucket of the kernels line; the other two are timed beside it
LSE_TOL = 1e-3  # natural-log units: the kernel sums exp2 of f32 scores of the same bf16 values
DROP_TILE = 20  # the tile [64 * 20, 64 * 21) of the mutated plain versions


def check_full_attention_kernel(log, nh: int = 28, kh: int = 4,
                                cases=FULL_CASES) -> List[dict]:
    """flash_full_attention (CUDA, forward and backward) vs
    flash_full_attention_ref on the card, at ``nh`` query heads over ``kh``
    kv heads; returns kernel C's two JSON entries (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    hd = 128
    worst = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}  # max|diff|, max ratio
    worst_lse = 0.0
    timed = library = None
    for T, n_real, side in cases:
        B = len(n_real)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

        q, k, v, dout = randn(B, T, nh, hd), randn(B, T, kh, hd), randn(B, T, kh, hd), randn(B, T, nh, hd)
        mask = torch.zeros((B, T), dtype=torch.bool, device=dev)
        for b, n in enumerate(n_real):
            if side == "right":
                mask[b, :n] = True
            else:
                mask[b, T - n:] = True
        worst_lse = max(worst_lse, _check_lse_and_determinism(q, k, v, mask, dout, T, side))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = attention.flash_full_attention(*leaves, mask)
        got.backward(dout)
        got, got_grads = got.detach(), [x.grad for x in leaves]
        # the plain version on the same values in f32
        ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
        want = attention.flash_full_attention_ref(*ref_leaves, mask)
        want.backward(dout.float())
        want = want.detach()
        want_grads = [x.grad for x in ref_leaves]
        del ref_leaves
        torch.cuda.synchronize()
        rms = bounds.full_attention_rms(q, k, v, mask, dout, got)
        outputs = dict(zip(("o", "dq", "dk", "dv"), [got] + got_grads))
        for (name, g), w, r in zip(outputs.items(), [want] + want_grads, rms):
            ratio = bounds.full_attention_ratio(g, w, r)
            err = (g.float() - w).abs().max().item()
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(
                    f"flash_full kernel vs plain: T={T} real={n_real} {side}-padded: {name} "
                    f"max|diff| {err}, {ratio} times the bound 2^-8 |plain| + 2^-9 "
                    f"{bounds.SIGMAS} rms + {bounds.FULL_ABS}")
            key = "fwd" if name == "o" else "bwd"
            worst[key] = [max(worst[key][0], err), max(worst[key][1], ratio)]
        if T == TIMED_T and side == "right":
            _check_bound_is_tight(q, k, v, mask, dout, outputs, rms, log)
        if T >= 1536:  # a training bucket: kernel, plain version, the library's call
            t = _time_full(q, k, v, mask, dout)
            lib = _time_sdpa(q, k, v, dout)
            each = _time_full_backward_kernels(q, k, v, mask, dout)
            log(f"flash_full T={T} ({side}-padded, nh {nh}, kh {kh}, hd 128, bf16): forward kernel "
                f"{t['fwd'][0]:.4f} ms, plain {t['fwd'][1]:.4f} ms; backward kernel "
                f"{t['bwd'][0]:.4f} ms, plain {t['bwd'][1]:.4f} ms; forward+backward "
                f"kernel {t['fwd+bwd'][0]:.4f} ms, plain {t['fwd+bwd'][1]:.4f} ms; "
                f"scaled_dot_product_attention (causal, no padding mask) forward "
                f"{lib['fwd']:.4f} ms, backward {lib['bwd']:.4f} ms")
            log(f"flash_full T={T} ({side}-padded): the backward's kernels on their own: "
                + ", ".join(f"{name} {ms:.4f} ms" for name, ms in each.items()))
            if T == TIMED_T and side == "right":
                timed, library = t, lib
        del q, k, v, dout, leaves, got, got_grads, want, want_grads, rms, outputs
        torch.cuda.empty_cache()
    log(f"flash_full: {len(cases)} cases, o within the bound at most "
        f"{worst['fwd'][1]:.3f} of it (max|diff| {worst['fwd'][0]}); dq, dk, dv at most "
        f"{worst['bwd'][1]:.3f} of it (max|diff| {worst['bwd'][0]}); the saved log-sum-exp "
        f"within {worst_lse:.2e} of the plain one (<= {LSE_TOL}); two forward and two "
        f"backward runs bit-equal in every case")
    entry = {"route": "cuda", "source": "mmduet_tpu_torch/ops/csrc/flash_full.cu",
             "replaces": "mmduet_tpu/ops/attention.py:569"}
    entries = []
    for key, name in (("fwd", "flash_full_attention (forward)"),
                      ("bwd", "flash_full_attention (backward: preprocess, dK/dV partials, "
                              "their reduction, dQ; launches count each of the four)")):
        bound_ms, bound_by = bounds.full_attention_bound(1, TIMED_T, nh, kh, hd,
                                                         backward=key == "bwd")
        log(f"flash_full T={TIMED_T} {key}: bound {bound_ms:.5f} ms ({bound_by})")
        entries.append(dict(entry, name=name, max_abs_err=worst[key][0], ms=timed[key][0],
                            plain_ms=timed[key][1], bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library[key]))
    return entries


def _check_lse_and_determinism(q, k, v, mask, dout, T, side) -> float:
    """The forward's saved row log-sum-exp against the plain one (returns
    max|diff|), and two forward and two backward runs of the kernels on the
    same inputs against each other, bit for bit (no atomics, a fixed
    summation order)."""
    B = q.shape[0]
    seg = attention._kernel_segments(mask, B, T, q.device)
    out, lse = attention._full_forward(q, k, v, seg)
    out2, lse2 = attention._full_forward(q, k, v, seg)
    first = attention._full_backward(q, k, v, seg, out, lse, dout)
    second = attention._full_backward(q, k, v, seg, out, lse, dout)
    want = attention.flash_full_lse_ref(q, k, seg[:, :T])
    torch.cuda.synchronize()
    err = (lse - want).abs().max().item()
    if not err <= LSE_TOL:
        raise AssertionError(f"flash_full T={T} {side}-padded: log-sum-exp max|diff| {err} "
                             f"> {LSE_TOL}")
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip(first, second))):
        raise AssertionError(f"flash_full T={T} {side}-padded: two runs on the same inputs "
                             f"differ")
    return err


def _time_full_backward_kernels(q, k, v, mask, dout) -> dict:
    """ms of each of the backward's launches on its own, in their order."""
    B, T = mask.shape
    seg = attention._kernel_segments(mask, B, T, q.device)
    out, lse = attention._full_forward(q, k, v, seg)
    plan = attention._full_backward_plan(q, k, v, seg, out, lse, dout)
    before = attention.FULL_BWD_LAUNCHES
    times = {name: _time_ms(lambda: attention._full_launch(name, *plan[1][name]), 10)
             for name in attention.FULL_BWD_KERNELS}
    attention.FULL_BWD_LAUNCHES = before
    return times


def _check_bound_is_tight(q, k, v, mask, dout, outputs, rms, log) -> None:
    """The bound catches a kernel that loses one tile: plain versions that
    leave keys [64 DROP_TILE, 64 DROP_TILE + 64) out of o and dq, and those
    query rows out of dk and dv, must each fail it against the kernel."""
    tile = slice(64 * DROP_TILE, 64 * DROP_TILE + 64)
    dropped = bounds.full_attention_dropped(q, k, v, mask, dout, tile)
    factors = {}
    for (name, g), w, r in zip(outputs.items(), dropped, rms):
        factors[name] = bounds.full_attention_ratio(g, w, r)
        if not factors[name] > 1.0:
            raise AssertionError(f"flash_full check: {name} without one tile passes the bound "
                                 f"({factors[name]} of it)")
    log(f"flash_full: plain versions without the tile [{tile.start}, {tile.stop}) (keys for "
        f"o and dq, query rows for dk and dv) fail the bound by " + ", ".join(
            f"{name} {f:.1f}x" for name, f in factors.items()))


def _time_full(q, k, v, mask, dout) -> dict:
    """{"fwd" | "bwd" | "fwd+bwd": (kernel ms, plain ms)} on bf16 inputs."""
    out = {}
    for name, fn, iters in (("kernel", attention.flash_full_attention, 10),
                            ("plain", attention.flash_full_attention_ref, 2)):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        fwd = _time_ms(lambda: fn(q, k, v, mask), iters, warmup=1)
        res = fn(*leaves, mask)
        bwd = _time_ms(lambda: res.backward(dout, retain_graph=True), iters, warmup=1)
        both = _time_ms(lambda: fn(*leaves, mask).backward(dout), iters, warmup=1)
        for key, ms in (("fwd", fwd), ("bwd", bwd), ("fwd+bwd", both)):
            out.setdefault(key, [None, None])[name == "plain"] = ms
        del res, leaves
    return out


def _time_sdpa(q, k, v, dout) -> dict:
    """The library's yardstick for kernel C, timed here and called nowhere
    in the port: `scaled_dot_product_attention` on the same q, k, v, causal
    and without the padding mask (it takes one or the other; the real rows
    of a right-padded batch see the same keys). {"fwd" | "bwd": ms}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))  # (B, heads, T, hd)
    try:
        sdpa(qh, kh_, vh, is_causal=True, enable_gqa=True)
        kw = dict(is_causal=True, enable_gqa=True)
    except TypeError:  # an older PyTorch: the kv heads repeated beforehand
        rep = q.shape[2] // k.shape[2]
        kh_, vh = (x.repeat_interleave(rep, dim=1) for x in (kh_, vh))
        kw = dict(is_causal=True)
    fwd = _time_ms(lambda: sdpa(qh, kh_, vh, **kw), 10, warmup=1)
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh_, vh)]
    res = sdpa(*leaves, **kw)
    g = dout.transpose(1, 2)
    bwd = _time_ms(lambda: res.backward(g, retain_graph=True), 10, warmup=1)
    return {"fwd": fwd, "bwd": bwd}


def _args(max_new_tokens: int = 16, **kw) -> TestArgs:
    return TestArgs(frame_fps=2.0, max_new_tokens=max_new_tokens, **kw)


def _grounding_scores(engine, frames, query) -> List[float]:
    engine.reset()
    engine.input_video_stream(frames)
    engine.input_query_stream([{"role": "user", "content": query, "time": 0.0}])
    engine.inference()
    return [d["informative_score"] for d in engine.debug_data_list]


SMALL_TOL = 3e-2  # score probabilities through 2 layers with bf16
# activations (8-bit mantissa) on the card vs f32 on the CPU, on the
# same bf16-valued weights (quantized: the same int4 values and scales;
# an int8 cache row may round across one int8 step between the two)


def check_small_input(log, quantized: bool = False) -> float:
    """The card's bf16 engine (kernels) against the same engine on the CPU
    in f32 (plain versions), on a small model whose head_dim is 128:
    grounding scores agree. ``quantized``: int4 weights (kernel B), an
    int8 cache (kernel A's int8 variant) and a LoRA adapter at scale 1, on
    the same quantized tree on both sides."""
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    cpu = torch.device("cpu")
    params = init_mmduet_params(cfg, torch.Generator(device=cpu).manual_seed(1), cpu)
    params = _tree_map(lambda t: t.to(torch.bfloat16).float(), params)
    engine_kw = {}
    if quantized:
        params = quant.quantize_params(params, bits=4)
        gen = torch.Generator(device=cpu).manual_seed(4)
        lora = _tree_map(  # a trained adapter has a nonzero b
            lambda t: (0.02 * torch.randn(t.shape, generator=gen)).to(torch.bfloat16).float(),
            init_lora(torch.Generator(device=cpu).manual_seed(3), cfg.text, rank=8))
        engine_kw = dict(lora=lora, lora_scale=1.0, kv_cache_quant="int8")
    frames = np.random.RandomState(1).randint(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    args = _args(stream_end_prob_threshold=1.0, grounding_mode=True, max_num_frames=16)
    want = _grounding_scores(LiveInferEngine(params, cfg, tok, args, **engine_kw), frames, "Q?")

    def to_card(t):  # dense f32 leaves to bf16; int8 values and bf16 scales as they are
        return t.to("cuda", torch.bfloat16) if t.dtype == torch.float32 else t.to("cuda")

    if quantized:
        engine_kw["lora"] = _tree_map(to_card, engine_kw["lora"])
    before = attention.LAUNCHES, attention.INT8_LAUNCHES, quant_matmul.B_LAUNCHES
    got = _grounding_scores(
        LiveInferEngine(_tree_map(to_card, params), cfg, tok, args, **engine_kw), frames, "Q?")
    ran = (attention.LAUNCHES - before[0], attention.INT8_LAUNCHES - before[1],
           quant_matmul.B_LAUNCHES - before[2])
    if ran[0] <= 0 or ran[1:] != ((ran[0], 7 * ran[0]) if quantized else (0, 0)):
        raise AssertionError(f"small input (quantized: {quantized}): launches of kernel A, "
                             f"its int8 variant and kernel B {ran}")
    err = float(np.abs(np.array(got) - np.array(want)).max())
    what = "int4 weights, int8 cache, LoRA; " if quantized else ""
    if len(got) != len(want) or not err <= SMALL_TOL:
        raise AssertionError(f"small input ({what}hd=128): card vs CPU scores max|diff| {err} "
                             f"> {SMALL_TOL}")
    log(f"small input ({what}hd=128, 2 layers, 12 frames): card bf16 vs CPU f32 "
        f"scores max|diff| {err} <= {SMALL_TOL}")
    return err


SMALL_TRAIN_TOL = 3e-2  # relative, loss and grad_norm: one step with bf16
# activations (8-bit mantissa) and bf16 weights on the card vs f32 on the
# CPU, on the same bf16-valued weights, through 2 layers and the heads


def check_small_train(log) -> float:
    """One train step on the card (bf16, attention through kernel C at
    T = 640 with padding) against the same step on the CPU (f32, the plain
    attention) on a small model whose head_dim is 128."""
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    params = init_mmduet_params(cfg, torch.Generator(device=cpu).manual_seed(2), cpu)
    params = _tree_map(lambda t: t.to(torch.bfloat16).float(), params)
    lora = init_lora(torch.Generator(device=cpu).manual_seed(3), cfg.text, rank=16)
    r = np.random.RandomState(4)
    A, T, ft = 2, 640, cfg.frame_num_tokens
    ids = r.randint(0, 250, (A, 1, T)).astype(np.int32)
    ids[:, :, 4:4 + 2 * ft] = cfg.v_placeholder_id
    mask = np.zeros((A, 1, T), bool)
    mask[0, :, :600], mask[1, :, :540] = True, True
    labels = np.where(mask & (np.arange(T) % 3 == 0), ids, -100).astype(np.int32)
    inf = np.full((A, 1, T), -100, np.int32)
    inf[:, :, [3 + ft, 3 + 2 * ft]] = 1
    batch = {"input_ids": ids, "attn_mask": mask, "labels": labels,
             "informative_labels": inf, "relevance_labels": inf.copy(),
             "frames": r.randint(0, 256, (A, 2, 32, 32, 3)).astype(np.uint8)}
    args = _args(lr_schedule="constant", learning_rate=1e-3)
    tx, _ = make_optimizer(args, 10)
    step = make_train_step(cfg, args, tx)
    _, want = step(init_train_state(params, lora, tx), params,
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    card = _tree_map(lambda t: t.to(dev, torch.bfloat16), params)
    before = attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES
    _, got = step(init_train_state(card, _tree_map(lambda t: t.to(dev), lora), tx), card,
                  {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    if (attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES) <= before:
        raise AssertionError("small train step: kernel C was not launched on the card")
    err = max(abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm"))
    if not err <= SMALL_TRAIN_TOL:
        raise AssertionError(f"small train step: card {got} vs CPU {want}: relative "
                             f"difference {err} > {SMALL_TRAIN_TOL}")
    log(f"small train step (hd=128, 2 layers, T=640 padded): card bf16 vs CPU f32 loss "
        f"{got['loss']:.5f} / {want['loss']:.5f}, grad_norm {got['grad_norm']:.5f} / "
        f"{want['grad_norm']:.5f}: relative difference {err:.2e} <= {SMALL_TRAIN_TOL}")
    return err


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _resident(inputs_bytes: int) -> int:
    """Bytes on the card at a phase's start that are not part of its
    configuration: what is allocated once earlier engines caught in
    reference cycles are collected and kernels A's and B's split scratch,
    the configuration's own, is released (`budget.release_split_scratch`),
    less the bytes of the phase's own inputs already on the card (its
    weights)."""
    gc.collect()
    budget.release_split_scratch()
    return torch.cuda.memory_allocated() - inputs_bytes


def _mem(resident: int, graphs=None) -> dict:
    """A phase's peak since its reset, with the bytes of the engine's graph
    pool that no tensor holds (`budget.pool_idle_bytes`: the pool keeps
    them for the engine's life), and what it found resident."""
    return {"peak": torch.cuda.max_memory_allocated() + budget.pool_idle_bytes(graphs),
            "resident": resident}


N_FRAMES = 64


def full_width_config():
    """(cfg, tok): the default MMDuetConfig and the CharTokenizer at its
    frame tokens and vocabulary, whose special ids the config takes."""
    cfg = MMDuetConfig()
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens, vocab_size=cfg.text.vocab_size)
    return cfg.replace(v_placeholder_id=tok.v_placeholder_id,
                       eos_token_id=tok.eos_token_id), tok


def full_width_model(log):
    """The default MMDuetConfig with random bf16 weights from seed 0 on the
    card, and the CharTokenizer at its vocabulary: (cfg, tok, params)."""
    dev = torch.device("cuda")
    cfg, tok = full_width_config()
    t0 = time.perf_counter()
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"params: {n_params / 1e9:.3f} B bf16 in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    return cfg, tok, params


class TokenRecorder:
    """While entered, records each greedy step's top-2 logits of every lane:
    `mmduet.decode_loop` is wrapped to open a record per call (which lanes
    decode, and for whom: ``owners()`` gives each lane's session at the
    call), and `mmduet.decode_outputs`, which reads the finished loop's
    state, to copy that state's top-2 rows (`DecodeState.top_v` /
    ``top_i``: the prompt's and each step's, which the step writes on the
    device, also when a CUDA graph replays it). The copies stay on the
    device until `steps` reads them, so recording adds no host sync."""

    def __init__(self, eos_id: int, owners=lambda: [0]):
        self.eos_id, self.owners, self.calls = eos_id, owners, []

    def __enter__(self):
        self._decode, self._outputs = mmduet.decode_loop, mmduet.decode_outputs

        def decode(*args, **kw):
            active = kw.get("active", args[7] if len(args) > 7 else None)
            owners = list(self.owners())
            self.calls.append((owners, [True] * len(owners) if active is None
                               else [bool(a) for a in active], []))
            return self._decode(*args, **kw)

        def outputs(state):
            if self.calls:
                self.calls[-1][2].append((state.top_v.clone(), state.top_i.clone(),
                                          state.i.clone()))
            return self._outputs(state)

        mmduet.decode_loop, mmduet.decode_outputs = decode, outputs
        return self

    def __exit__(self, *exc):
        mmduet.decode_loop, mmduet.decode_outputs = self._decode, self._outputs

    def steps(self, session=0) -> list:
        """[(token, top-1 minus top-2 logit)] of ``session``'s greedy steps,
        call by call, each call's up to its end of sequence."""
        out = []
        for owners, active, tops in self.calls:
            for top_v, top_i, i in tops:
                rows = int(i)  # the prompt's row and one a step
                values, tokens = top_v[:rows].cpu(), top_i[:rows].cpu()
                for b, (owner, on) in enumerate(zip(owners, active)):
                    if owner != session or not on:
                        continue
                    for r in range(rows):
                        tok = int(tokens[r, b, 0])
                        out.append((tok, float(values[r, b, 0] - values[r, b, 1])))
                        if tok == self.eos_id:
                            break
        return out


def run_main_path(cfg, tok, params, log, kv_cache_quant=None, mesh=None) -> dict:
    """The 7B-width serving path: generation pass, then grounding pass.
    Every kernel count of the path is set to 0 just before the passes and
    read just after them; returns the counts and the passes' numbers, and
    in ``passes`` each pass's per-frame scores, answers and greedy steps
    (`TokenRecorder`). ``mesh``: a rank's process mesh, ``params`` its
    local tree. Each pass's peak memory is measured on its own, from a
    reset just before it (``mem``): the generation engine, kept for its
    decode timing, is resident in the grounding pass."""
    resident = _resident(budget.tree_bytes(params))
    frames = np.random.RandomState(0).randint(
        0, 256, (N_FRAMES, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    query = [{"role": "user", "content": QUERY, "time": 0.0}]

    def engine_for(name):
        return LiveInferEngine(params, cfg, tok, _args(
            stream_end_score_sum_threshold=1.0, grounding_mode=name == "grounding"),
            kv_cache_quant=kv_cache_quant, mesh=mesh)

    gen = engine_for("generation")
    gen.input_video_stream(frames[:32])  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    gen.reset()

    stats, mems, engines = {}, {}, {}
    _zero_counts()  # the main path starts here
    for name in ("generation", "grounding"):
        if name == "grounding":
            resident = _resident(budget.tree_bytes(params))
        engine = engines[name] = gen if name == "generation" else engine_for(name)
        torch.cuda.reset_peak_memory_stats()
        before = attention.LAUNCHES
        t0 = time.perf_counter()
        engine.input_video_stream(frames)
        torch.cuda.synchronize()
        t_vision = time.perf_counter() - t0
        engine.input_query_stream(query)
        t0 = time.perf_counter()
        with TokenRecorder(tok.eos_token_id) as rec:
            responses = engine.inference()
            torch.cuda.synchronize()
        stats[name] = dict(
            launches=attention.LAUNCHES - before, responses=responses,
            vision_s=t_vision, stream_s=time.perf_counter() - t0,
            p50_ms=float(np.percentile(engine.frame_latencies_ms, 50)),
            p90_ms=float(np.percentile(engine.frame_latencies_ms, 90)),
            scores=[[d["informative_score"], d["relevance_score"]]
                    for d in engine.debug_data_list],
            answers=[[float(r["time"]), r["content"]] for r in responses
                     if r["role"] == "assistant"],
            steps=rec.steps(),
        )
        _check_pass(engine, name, stats[name]["launches"], responses, QUERY)
        mems[name] = _mem(resident, engine._graphs)
    counts = _kernel_counts()  # the main path ends here
    _check_counts(params, cfg, counts, sum(e.tokens_generated for e in engines.values()),
                  kv_cache_quant)

    for name, s in stats.items():
        engine = engines[name]
        log(f"{name} pass: block {engine.block_frames}, "
            f"{N_FRAMES} frames, p50 per-frame {s['p50_ms']:.3f} ms, stream "
            f"{s['stream_s']:.3f} s, vision {N_FRAMES / s['vision_s']:.2f} frames/s, "
            f"{s['launches']} attention launches, "
            f"{sum(r['role'] == 'assistant' for r in s['responses'])} responses")
    log(f"kernel launches over the two passes: {counts}; {gen.tokens_generated} tokens "
        f"generated")
    del engines
    peak_gib = max(m["peak"] for m in mems.values()) / 2**30
    log("peak device memory (streaming passes): " + ", ".join(
        f"{name} {m['peak'] / 2**30:.2f} GiB" for name, m in mems.items()))
    passes = {name: {k: s[k] for k in ("scores", "answers", "steps", "p50_ms", "p90_ms")}
              for name, s in stats.items()}
    return dict(counts, p50_ms=stats["generation"]["p50_ms"],
                grounding_p50_ms=stats["grounding"]["p50_ms"], peak_gib=peak_gib, mem=mems,
                decode_tokens_per_s=_time_decode(gen, cfg, log), passes=passes)


def _check_counts(params, cfg, counts: dict, tokens_generated: int, kv_cache_quant) -> None:
    """The kernels the weights and the cache call for were the ones
    launched. A decoder forward launches the attention once per layer;
    through int4 leaves it launches kernel B seven times per layer (the
    projections), and the LM head launches it once per generated token
    (the prompt's prefill gives the first token, every decode step one
    more; streaming chunks take no logits)."""
    int4 = "qw4" in params["lm_head"] if isinstance(params["lm_head"], dict) else False
    want_int8 = counts["attention"] if kv_cache_quant == "int8" else 0
    forwards, rest = divmod(counts["attention"], cfg.text.num_layers)
    want_b = 7 * counts["attention"] + tokens_generated if int4 else 0
    if (counts["attention"] <= 0 or rest or counts["attention_int8"] != want_int8
            or counts["int4_matmul"] != want_b):
        raise AssertionError(
            f"main path (int4 weights: {int4}, cache: {kv_cache_quant}): launches {counts}; "
            f"want the attention a multiple of {cfg.text.num_layers} layers, {want_int8} of "
            f"them on the int8 variant, and {want_b} of kernel B ({forwards} decoder "
            f"forwards x {cfg.text.num_layers} layers x 7 projections + {tokens_generated} "
            f"LM-head calls)")


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _check_pass(engine, name: str, launches: int, responses, query: str) -> None:
    """What one streaming pass must leave behind: kernel launches, one
    finite probability pair per frame, responses only when generating,
    and a cursor and cache that match the tokens fed."""
    if launches <= 0:
        raise AssertionError(f"{name} pass: the attention kernel was never launched")
    n_frames = len(engine.frame_times)
    rows = engine.debug_data_list
    if len(rows) != n_frames or engine._next_frame != n_frames:
        raise AssertionError(f"{name} pass: {len(rows)} score rows for {n_frames} frames")
    scores = [r[k] for r in rows for k in ("informative_score", "relevance_score")]
    if not all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores):
        raise AssertionError(f"{name} pass: a score is not a finite probability")
    answers = [r for r in responses if r["role"] == "assistant"]
    # the query at t=0 is fed before the first frame, so that frame takes
    # no joiner: the stream is [query turn] + frames (+ kept answers)
    query_ids = engine.tokenizer.apply_chat_template(
        [{"role": "user", "content": query}], tokenize=True,
        add_stream_query_prompt=False, add_stream_prompt=True)
    fed = len(query_ids) + n_frames * engine.cfg.frame_num_tokens
    cursor = engine.state.cursor
    if engine.grounding_mode:
        if answers or cursor != fed:
            raise AssertionError(
                f"grounding pass: cursor {cursor}, fed {fed}, {len(answers)} answers")
    elif not answers or cursor <= fed:  # kept answers add their tokens
        raise AssertionError(
            f"generation pass: cursor {cursor}, fed {fed}, {len(answers)} answers")
    # every committed slot holds a K row; nothing lies past the cursor
    # beyond one rolled-back block plus bucket padding
    k = kv_arr(engine.state.kv_cache.k)  # int8 values under an int8 cache
    margin = engine.block_frames * engine.cfg.frame_num_tokens + 256
    if not bool((k[:, 0, :, :cursor].abs().amax(dim=-1) > 0).all()):
        raise AssertionError(f"{name} pass: a committed cache slot is empty")
    if kv_quantized(engine.state.kv_cache):
        scales = engine.state.kv_cache.k["qs"]
        if not bool((scales[:, 0, :, :cursor] > 0).all()) or not bool(
                torch.isfinite(scales).all()):
            raise AssertionError(f"{name} pass: a committed slot's int8 scale is not positive")
    if bool((k[:, 0, :, cursor + margin:] != 0).any()):
        raise AssertionError(f"{name} pass: cache written past the cursor")


def _device_ms(fn) -> float:
    """The summed device time (ms) of the kernels one call of ``fn`` runs,
    under torch.profiler (CUDA graph replays included); 0.0 where the
    profiler saw none."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1000


def time_decode(params, cfg, embeds, cache, cursors, graphs, log, what: str,
                n_new: int = 32, idle: bool = True) -> dict:
    """Greedy decodes of ``n_new`` tokens (EOS off) after the prompt
    ``embeds`` at ``cursors`` of ``cache``, on the graph route (``graphs``;
    skipped when None) and on the eager one: each timed with a device sync
    after one untimed run, the median tokens/s (over all lanes) of three
    runs and their range, and, with ``idle``, the decode's idle share, 1 -
    the device time torch.profiler sums over one more call / the median
    wall time. Returns {route: {"tokens_per_s", "range", "idle"}}; ``idle``
    is None where it was not measured (or the profiler saw no device
    time)."""
    B = embeds.shape[0]
    pen = torch.zeros((B, cfg.text.vocab_size), dtype=torch.bool, device=embeds.device)
    out = {}
    for route, g in (("graph", graphs), ("eager", None)):
        if route == "graph" and g is None:
            continue

        def call():
            packed, _, _ = mmduet.decode_loop(params, cfg, embeds, cache, cursors,
                                              embeds.shape[1], pen, max_new=n_new, eos_id=-1,
                                              rep=1.05, graphs=g)
            return packed

        walls = []
        with torch.inference_mode():
            for run in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = call()[:, -2]
                torch.cuda.synchronize()
                if run:
                    walls.append(time.perf_counter() - t0)
                if not bool((n == n_new).all()):
                    raise AssertionError(f"decode ({what}, {route}): {n.tolist()} tokens, "
                                         f"want {n_new}")
            device = _device_ms(call) if idle else 0.0
        wall = float(np.median(walls))
        rates = [B * n_new / w for w in walls]
        share = 1 - device / (1e3 * wall) if device else None
        out[route] = {"tokens_per_s": B * n_new / wall, "range": [min(rates), max(rates)],
                      "idle": share}
        log(f"decode ({what}), {route} route: {n_new} tokens a lane, {B} lanes: median "
            f"{B * n_new / wall:.2f} tokens/s of 3 runs (range {min(rates):.2f}-"
            f"{max(rates):.2f}; prompt prefill included); device {device:.3f} ms of "
            f"{1e3 * wall:.3f} ms wall, idle "
            + (f"{100 * share:.1f} %" if share is not None else "not measured"))
    return out


# Tokens a rank of a process mesh decodes in `_time_decode` (gloo-bound: a
# token takes the ranks 0.1-0.2 s on one card); one process decodes 32.
RANK_DECODE_TOKENS = 8


def _time_decode(engine, cfg, log) -> float:
    """`time_decode` at the cache length the generation pass left, on the
    engine's route and eagerly (the idle share measured in one process,
    not on a process mesh's ranks, which decode RANK_DECODE_TOKENS);
    returns the engine route's median tokens/s."""
    embeds = engine._embed_ids(engine._gen_prompt_ids)[None]
    rank = isinstance(engine.mesh, ProcessMesh)
    rates = time_decode(engine.params, cfg, embeds, engine.state.kv_cache, engine.state.cursor,
                        engine._graphs, log,
                        f"B = 1 at cache length {engine.state.cursor}",
                        n_new=RANK_DECODE_TOKENS if rank else 32, idle=not rank)
    return rates[engine.decode_route]["tokens_per_s"]


# The decode-graph phase: decodes of DG_MAX_NEW tokens (EOS off) on one lane
# at cursor 3000 and on 8 lanes at these cursors, two of them frozen.
DG_MAX_NEW = 16
DG_CURSORS = (3000, 520, 1900, 64, 2600, 1200, 700, 2200)
DG_ACTIVE = (True, False, True, True, False, True, True, True)


def _cache_leaves(cache) -> list:
    return [t for leaf in cache for t in (leaf.values() if isinstance(leaf, dict) else (leaf,))]


def _clone_cache(cache):
    return type(cache)(*({k: t.clone() for k, t in leaf.items()} if isinstance(leaf, dict)
                         else leaf.clone() for leaf in cache))


def check_decode_graph(engine, cache, cursors, active, log, what: str) -> None:
    """``engine``'s graph route (a new engine, whose decode step is captured
    here) against the eager route: `decode_loop` from the same random
    history below ``cursors`` of ``cache`` (the engine's own), EOS off,
    with the repetition penalty. The eager run goes first, on a copy; then
    the graph route three times on the engine's cache, each from the same
    history: its first step eager and captured, then every step replayed,
    then replayed again after an 8-frame block on every lane has grown
    kernel A's split scratch (and kernel B's, under int4 weights; the
    scratch is emptied before the capture, so that the block must grow
    it). Each time the tokens, n, cursors, penalty mask and the whole cache
    (the committed rows included) must be the eager run's bits, and the
    launches of kernels A and B the eager run's: L layers a forward, the
    prompt's and one a step (and 7 L + 1 of B)."""
    params, cfg = engine.params, engine.cfg
    if engine.decode_route != "graph" or len(engine._graphs):
        raise AssertionError(f"decode graph ({what}): route {engine.decode_route}, "
                             f"{len(engine._graphs or ())} graphs captured before")
    L, t = cfg.text.num_layers, cfg.text
    int4 = isinstance(params["lm_head"], dict) and "qw4" in params["lm_head"]
    B, dev = len(cursors), kv_arr(cache.k).device
    want_counts = (L * DG_MAX_NEW, (7 * L + 1) * DG_MAX_NEW if int4 else 0)
    splits = (attention._split_scratch, quant_matmul._split_scratch)

    def run(graphs, c):
        before = attention.LAUNCHES, quant_matmul.B_LAUNCHES
        packed, c, mask = mmduet.decode_loop(
            params, cfg, embeds, c, list(cursors), embeds.shape[1], pen, list(active),
            max_new=DG_MAX_NEW, eos_id=-1, rep=1.05, graphs=graphs)
        torch.cuda.synchronize()
        counts = attention.LAUNCHES - before[0], quant_matmul.B_LAUNCHES - before[1]
        if counts != want_counts:
            raise AssertionError(f"decode graph ({what}): launches (A, B) {counts}, want "
                                 f"{want_counts}")
        return packed, c, mask

    t0 = time.perf_counter()
    with torch.inference_mode():  # the engine's cache is an inference tensor
        gen = torch.Generator(device=dev).manual_seed(11)
        shape = (L, B, t.num_kv_heads, max(cursors), t.head_dim)
        qwen2.commit_lanes(cache, *(torch.randn(shape, generator=gen, device=dev,
                                                dtype=torch.bfloat16) for _ in "kv"), 0)
        start = _clone_cache(cache)
        embeds = engine._embed_ids(engine._gen_prompt_ids)[None].expand(B, -1, -1)
        pen = torch.zeros((B, t.vocab_size), dtype=torch.bool, device=dev)
        pen[:, [3, 70, 300]] = True
        blocks = torch.randn((B, 8 * cfg.frame_num_tokens, t.hidden_size), generator=gen,
                             device=dev, dtype=torch.bfloat16) * 0.05
        for split in splits:
            split.pop(dev, None)
        attention._split_memo.clear()
        want, want_cache, want_pen = run(None, _clone_cache(start))
        for state in ("capture", "replays", "replays after the scratch grew"):
            if state.endswith("grew"):
                held = [split.get(dev) for split in splits]
                mmduet.chunk_scores_forward(params, cfg, blocks, cache, list(cursors),
                                            blocks.shape[1], [[0]] * B)
                grew = [held[i] is not splits[i].get(dev) for i in range(1 + int4)]
                if not all(grew):
                    raise AssertionError(f"decode graph ({what}): the 8-frame block grew "
                                         f"kernel A's / B's scratch: {grew}")
            for x, y in zip(_cache_leaves(cache), _cache_leaves(start)):
                x.copy_(y)
            got, got_cache, got_pen = run(engine._graphs, cache)
            same = (torch.equal(got, want) and torch.equal(got_pen, want_pen) and all(
                torch.equal(x, y) for x, y in zip(_cache_leaves(got_cache),
                                                  _cache_leaves(want_cache))))
            if not same:
                raise AssertionError(f"decode graph ({what}), {state}: the graph route's "
                                     "tokens, cursors, penalty mask or cache differ from the "
                                     "eager route's")
    log(f"decode graph ({what}): the graph route equals the eager route bit for bit (tokens, "
        f"n, cursors, penalty mask, cache) at the capture, in replay and in replay after an "
        f"8-frame block grew the split scratch of kernel A{' and B' if int4 else ''}; "
        f"graphs captured {engine._graphs.kinds()}; launches (A, B) {want_counts} a decode "
        f"of {DG_MAX_NEW} tokens on both routes; {time.perf_counter() - t0:.1f} s")


def run_decode_graph(cfg, tok, params, log, kv_cache_quant=None, batched: bool = True) -> dict:
    """The decode-graph phase: `check_decode_graph` on a new
    `LiveInferEngine` (one lane at cursor 3000, the engine's cache) and,
    with ``batched``, a new `BatchedStreamEngine` of 8 lanes (cursors
    DG_CURSORS, two frozen; a cache of 8192 slots), each engine reporting
    ``decode_route == "graph"``; then `time_decode` at 8 lanes on both
    routes. Returns the 8 lanes' rates."""
    t0 = time.perf_counter()
    tag = "int4 weights, int8 cache" if kv_cache_quant else "bf16"
    args = dict(stream_end_score_sum_threshold=1.0)
    live = LiveInferEngine(params, cfg, tok, _args(**args), kv_cache_quant=kv_cache_quant)
    check_decode_graph(live, live.state.kv_cache, DG_CURSORS[:1], DG_ACTIVE[:1], log,
                       f"{tag}, B = 1")
    del live
    rates = {}
    if batched:
        eng = BatchedStreamEngine(params, cfg, tok,
                                  _args(BATCH_MAX_NEW, max_num_frames=N_FRAMES, **args),
                                  n_streams=len(DG_CURSORS), kv_cache_quant=kv_cache_quant)
        check_decode_graph(eng, eng._cache, DG_CURSORS, DG_ACTIVE, log,
                           f"{tag}, {len(DG_CURSORS)} lanes, {DG_ACTIVE.count(False)} frozen")
        embeds = eng._embed_ids(eng._gen_prompt_ids)[None].expand(len(DG_CURSORS), -1, -1)
        rates = time_decode(params, cfg, embeds, eng._cache, list(DG_CURSORS),
                            eng._graphs, log, f"{tag}, {len(DG_CURSORS)} lanes at cursors "
                            f"{min(DG_CURSORS)}..{max(DG_CURSORS)}")
        del eng
    torch.cuda.empty_cache()
    log(f"decode-graph phase ({tag}) in {time.perf_counter() - t0:.1f} s")
    return rates


# The frame-graph phase: the frame path's graph route (steps, frame blocks,
# batched dispatches, the decode's prefill, each replaying a CUDA graph
# captured once a shape) against the eager route of the same engine type.
FG_FRAMES = 24  # frames of a checked session: three 8-frame blocks
FG_MAX_NEW = 8  # tokens an answer may take in the checks and the timed passes
FG_LENGTHS = (24, 9, 20, 6, 24, 17, 12, 22)  # 8 lanes: the 6- and 9-frame ones end first
FG_QUERIES = (0.0, 1.5, 3.0, 0.5, 2.0, 0.0, 4.0, 1.0)
FG_RUNS = 3  # timed runs a route


def _fg_counts() -> tuple:
    return (attention.LAUNCHES, attention.INT8_LAUNCHES, attention.SHARDED_LAUNCHES,
            quant_matmul.B_LAUNCHES)


def _fg_run(engine, session, cache_of) -> tuple:
    """``session(engine)`` from a reset: (outputs, cache bytes, the launches
    of A, A-int8, A' and B)."""
    before = _fg_counts()
    engine.reset()
    with torch.inference_mode():
        got = session(engine)
    torch.cuda.synchronize()
    return got, [t.clone() for t in _cache_leaves(cache_of(engine))], tuple(
        a - b for a, b in zip(_fg_counts(), before))


def _grow_scratch(cfg, dev, int4: bool) -> None:
    """Eager launches of kernel A (a frame step's chunk of 146 tokens, the
    most a 64-row tile split asks, over 4096 slots) and, under int4
    weights, of kernel B (down_proj's shape), each on the fewest lanes or
    rows that need more split scratch than the card holds: the engines of
    the graph route reserve theirs (`infer.state.reserve_split_scratch`),
    and this makes new tensors, which the captured graphs do not hold."""
    t = cfg.text
    bf = dict(dtype=torch.bfloat16, device=dev)
    splits = (attention._split_scratch, quant_matmul._split_scratch)
    held = [s.get(dev) for s in splits]
    have = [h[0].numel() if h is not None else 0 for h in held]
    T, rows = 146, 146 * (t.num_heads // t.num_kv_heads)
    B = next(b for b in range(1, 1024) if attention.decode_scratch_numel(
        b, t.num_kv_heads, rows, 4096, t.head_dim)[0] > have[0])
    lanes = torch.full((B,), 3000, dtype=torch.int32, device=dev)
    cache = torch.randn(1, B, t.num_kv_heads, 4096, t.head_dim, **bf)
    chunk = torch.randn(B, t.num_kv_heads, T, t.head_dim, **bf)
    attention.flash_decode_attention(torch.randn(B, T, t.num_heads, t.head_dim, **bf), cache,
                                     cache, chunk, chunk, lanes, torch.full_like(lanes, T), 0)
    if int4:
        H, O = t.intermediate_size, t.hidden_size
        R = next(r for r in range(64, 65536, 64) if quant_matmul.split_scratch_numel(
            quant_matmul.int4_plan(r, H, O, 128), r, O)[0] > have[1])
        leaf = quant.quantize_weight_int4(torch.randn(H, O, **bf), 0)
        quant_matmul.int4_matmul(torch.randn(R, H, **bf), leaf["qw4"], leaf["qs"])
    now = [s.get(dev) for s in splits]
    if any(a is b for a, b in zip(held[:1 + int4], now[:1 + int4])):
        raise AssertionError("frame graph: the eager launches did not grow the split scratch")


def check_frame_graph(make, session, cache_of, log, what: str, int4: bool) -> dict:
    """``session`` on an engine of the eager route (its graphs taken away)
    and on one of the graph route, three times: at the captures, in replay,
    and in replay after `_grow_scratch`. Every graph run must give the
    eager run's outputs (scores, answers, times, cursors), its cache bytes
    (an int8 cache's ``qs`` included, a lane that was not fed or was frozen
    untouched as on the eager route) and its launches of A, A-int8, A' and
    B. Returns the graph engine's captured graphs by entry."""
    t0 = time.perf_counter()
    eager, graph = make(), make()
    if graph.decode_route != "graph":
        raise AssertionError(f"frame graph ({what}): decode_route {graph.decode_route}")
    eager._graphs = None
    dev = torch.device("cuda", torch.cuda.current_device())
    want, want_cache, want_counts = _fg_run(eager, session, cache_of)
    if want_counts[0] <= 0:
        raise AssertionError(f"frame graph ({what}): kernel A was never launched")
    for state in ("capture", "replays", "replays after the scratch grew"):
        if state.endswith("grew"):
            _grow_scratch(graph.cfg, dev, int4)
        got, cache, counts = _fg_run(graph, session, cache_of)
        if got != want or counts != want_counts or not all(
                torch.equal(a, b) for a, b in zip(cache, want_cache)):
            raise AssertionError(
                f"frame graph ({what}), {state}: the graph route differs from the eager route "
                f"(outputs {got == want}, launches {counts} vs {want_counts}, cache "
                f"{all(torch.equal(a, b) for a, b in zip(cache, want_cache))})")
    kinds = graph._graphs.kinds()
    log(f"frame graph ({what}): the graph route equals the eager route bit for bit (scores, "
        f"answers, times, cursors, every cache byte{', qs included' if int4 else ''}) at the "
        f"captures, in replay and in replay after an eager launch grew the split scratch of "
        f"kernel A{' and B' if int4 else ''}; launches (A, A-int8, A', B) {want_counts} on both "
        f"routes; graphs captured {kinds}; {time.perf_counter() - t0:.1f} s")
    del eager, graph
    return kinds


def _fg_live_session(frames, query):
    def session(engine):
        engine.input_frame_embeds(frames)
        engine.input_query_stream(query)
        out = engine.inference()
        return (out, [(d["time"], d["informative_score"], d["relevance_score"])
                      for d in engine.debug_data_list], engine.state.cursor, engine.frame_idx)
    return session


def _idle(fn, wall_s: float):
    device = _device_ms(fn)
    return 1 - device / (1e3 * wall_s) if device else None


def time_frame_routes(make, frames, query, log, what: str) -> dict:
    """The frame path of one stream on both routes, FG_RUNS timed runs each
    after one untimed: 64 frames with a query at t=0, no answer triggered
    (a threshold no score reaches), so every frame runs in a full block;
    each run's per-frame p50 and p90 (`frame_latencies_ms`), their median
    and range, and the idle share of one more run under torch.profiler (1
    - device time / its wall)."""
    out = {}
    for route in ("graph", "eager"):
        engine = make()
        if route == "eager":
            engine._graphs = None
        p50, p90, walls = [], [], []

        def run():
            engine.reset()
            engine.input_frame_embeds(frames)
            engine.input_query_stream(query)
            t0 = time.perf_counter()
            engine.inference()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        with torch.inference_mode():
            for i in range(FG_RUNS + 1):
                wall = run()
                if i:
                    walls.append(wall)
                    p50.append(float(np.percentile(engine.frame_latencies_ms, 50)))
                    p90.append(float(np.percentile(engine.frame_latencies_ms, 90)))
            idle = _idle(run, float(np.median(walls)))
        out[route] = {"p50_ms": float(np.median(p50)), "p50_range": [min(p50), max(p50)],
                      "p90_ms": float(np.median(p90)), "p90_range": [min(p90), max(p90)],
                      "idle": idle}
        log(f"frame path ({what}), {route} route: {len(frames)} frames in blocks of "
            f"{engine.block_frames}, per-frame p50 {out[route]['p50_ms']:.3f} ms (range "
            f"{min(p50):.3f}-{max(p50):.3f}), p90 {out[route]['p90_ms']:.3f} ms (range "
            f"{min(p90):.3f}-{max(p90):.3f}), median of {FG_RUNS}; idle "
            + (f"{100 * idle:.1f} %" if idle is not None else "not measured"))
        del engine
    return out


def time_batched_frame_routes(cfg, tok, params, embeds, log, what: str, mesh=None) -> dict:
    """The batched frame pass on both routes: 8 lanes of FG_LENGTHS frames
    (embeddings) with a query each, no answer triggered, through
    `BatchedStreamEngine.stream_all`; FG_RUNS timed runs a route after one
    untimed: aggregate frames/s and ms a frame fed (the dispatches' wall
    over the frames they fed), median and range, and the idle share."""
    out = {}
    n = int(sum(FG_LENGTHS))
    for route in ("graph", "eager"):
        engine = BatchedStreamEngine(params, cfg, tok, _args(
            FG_MAX_NEW, stream_end_prob_threshold=1.0, max_num_frames=FG_FRAMES),
            n_streams=len(FG_LENGTHS), mesh=mesh)
        if route == "eager":
            engine._graphs = None
        walls = []

        def run():
            engine.reset()
            engine.input_frame_embeds(embeds, lengths=np.array(FG_LENGTHS))
            engine.input_query_streams([[{"role": "user", "content": QUERY, "time": 0.0}]]
                                       * len(FG_LENGTHS))
            t0 = time.perf_counter()
            engine.stream_all()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        with torch.inference_mode():
            for i in range(FG_RUNS + 1):
                wall = run()
                if i:
                    walls.append(wall)
            idle = _idle(run, float(np.median(walls)))
        fps = [n / w for w in walls]
        wall = float(np.median(walls))
        out[route] = {"frames_per_s": n / wall, "range": [min(fps), max(fps)],
                      "ms_per_frame": 1e3 * wall / n, "idle": idle}
        log(f"batched frame pass ({what}), {route} route: {len(FG_LENGTHS)} lanes, {n} frames, "
            f"{engine.dispatches} dispatches: median {n / wall:.2f} frames/s of {FG_RUNS} "
            f"(range {min(fps):.2f}-{max(fps):.2f}), {1e3 * wall / n:.3f} ms a frame fed; idle "
            + (f"{100 * idle:.1f} %" if idle is not None else "not measured"))
        del engine
    return out


def run_frame_graph(cfg, tok, params, log, kv_cache_quant=None, batched: bool = True) -> dict:
    """The frame-graph phase after a main path: `check_frame_graph` on one
    lane (a generation session of FG_FRAMES frames with answers, their
    rollbacks and prefills, and a pipelined grounding session of 32-frame
    blocks) and, with ``batched``, on 8 lanes of `BatchedStreamEngine`
    (FG_LENGTHS: lanes that end early sit out dispatches and decodes,
    frozen) with no mesh and on the (2, 2) one-device mesh; then the
    routes' times (`time_frame_routes`, `time_batched_frame_routes`)."""
    t0 = time.perf_counter()
    int4 = kv_cache_quant is not None
    tag = "int4 weights, int8 cache" if int4 else "bf16"
    dev = torch.device("cuda", torch.cuda.current_device())
    t, ft = cfg.text, cfg.frame_num_tokens
    gen = torch.Generator(device=dev).manual_seed(21)
    frames = torch.randn((N_FRAMES, ft, t.hidden_size), generator=gen, device=dev,
                         dtype=torch.bfloat16) * 0.05
    query = [{"role": "user", "content": QUERY, "time": 0.0}]
    out = {"kinds": {}}

    def live(grounding, **kw):
        return lambda: LiveInferEngine(params, cfg, tok, _args(
            FG_MAX_NEW, grounding_mode=grounding, max_num_frames=N_FRAMES, **kw),
            kv_cache_quant=kv_cache_quant)

    for grounding in (False, True):
        mode = "grounding, 32-frame blocks, pipelined" if grounding else "generation"
        out["kinds"][mode] = check_frame_graph(
            live(grounding, stream_end_score_sum_threshold=1.0),
            _fg_live_session(frames[:32 if grounding else FG_FRAMES], query),
            lambda e: e.state.kv_cache, log, f"{tag}, B = 1, {mode}", int4)
    for grounding in (False, True):
        mode = "grounding" if grounding else "generation"
        out[mode] = time_frame_routes(live(grounding, stream_end_prob_threshold=1.0), frames,
                                      query, log, f"{tag}, B = 1, {mode}")
    if batched:
        embeds = (torch.randn((len(FG_LENGTHS), FG_FRAMES, ft, t.hidden_size), generator=gen,
                              device=dev, dtype=torch.bfloat16) * 0.05)
        queries = [[{"role": "user", "content": QUERY, "time": q}] for q in FG_QUERIES]

        def session(engine):
            engine.input_frame_embeds(embeds, lengths=np.array(FG_LENGTHS))
            engine.input_query_streams(queries)
            return (engine.stream_all(), engine.debug_data_lists, engine._cur.tolist(),
                    (engine.decodes, engine.decode_lanes))

        for name, mesh in (("no mesh", None), ("(2, 2) one-device mesh",
                                                 make_mesh((2, 2), devices=[dev] * 4))):
            out["kinds"][name] = check_frame_graph(
                lambda: BatchedStreamEngine(params, cfg, tok, _args(
                    FG_MAX_NEW, stream_end_score_sum_threshold=1.0, max_num_frames=FG_FRAMES),
                    n_streams=len(FG_LENGTHS), kv_cache_quant=kv_cache_quant, mesh=mesh),
                session, lambda e: e._cache, log,
                f"{tag}, {len(FG_LENGTHS)} lanes, {name}", int4)
        out["batched"] = time_batched_frame_routes(cfg, tok, params, embeds, log,
                                                   f"{tag}, no mesh")
    torch.cuda.empty_cache()
    log(f"frame-graph phase ({tag}) in {time.perf_counter() - t0:.1f} s")
    return out


# The batched path: 12 sessions of 40-64 frames through 8 lanes, so that
# lanes retire and admit; answers of at most 16 tokens.
BATCH_LANES, BATCH_SESSIONS, BATCH_MAX_NEW = 8, 12, 16
BATCH_LENGTHS = tuple(int(n) for n in np.random.RandomState(7).randint(40, 65, BATCH_SESSIONS))


def _batch_session(cfg, i: int) -> dict:
    """Session ``i``: random 384 x 384 frames from a seed, one query at t = 0."""
    frames = np.random.RandomState(100 + i).randint(
        0, 256, (BATCH_LENGTHS[i], cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    return {"frames": frames, "fps": 2.0,
            "conversation": [{"role": "user", "content": QUERY, "time": 0.0}]}


def _vision_batches(n_frames: int) -> int:
    """Launches of the tower's attention per layer for one
    `staged_visual_encode` of ``n_frames``: 32-frame encodes."""
    return -(-n_frames // 32)


def _timed(engine, name: str, acc: dict, sync: bool = False) -> None:
    """Wrap ``engine.<name>`` to add its seconds to ``acc[name]``. ``sync``:
    wait for the device first (the dispatchers end in a fetch from the
    device and need none)."""
    fn = getattr(engine, name)

    def wrapped(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        if sync:
            torch.cuda.synchronize()
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(engine, name, wrapped)


def _kernel_counts() -> dict:
    return dict(attention=attention.LAUNCHES, attention_int8=attention.INT8_LAUNCHES,
                attention_sharded=attention.SHARDED_LAUNCHES, vision=attention.VISION_LAUNCHES,
                vision_fused=vision_fused.LAUNCHES, int4_matmul=quant_matmul.B_LAUNCHES)


def _zero_counts() -> None:
    attention.LAUNCHES = attention.INT8_LAUNCHES = attention.SHARDED_LAUNCHES = 0
    attention.VISION_LAUNCHES = quant_matmul.B_LAUNCHES = vision_fused.LAUNCHES = 0


def _session_rows(results: dict, rec) -> dict:
    """{session: {scores, answers, steps}} of a batched pass, as
    `compare_tp_pass` reads them (steps: `TokenRecorder`'s)."""
    return {str(i): {"scores": [[d["informative_score"], d["relevance_score"]] for d in debug],
                     "answers": [[float(r["time"]), r["content"]] for r in resp
                                 if r["role"] == "assistant"],
                     "steps": rec.steps(i)}
            for i, (resp, debug) in sorted(results.items())}


def mesh_sessions(make, n: int, mesh, held: list, stats: dict):
    """Sessions ``make(0) .. make(n - 1)`` on this rank of the process
    ``mesh``, each made by one rank alone and shared
    (`eval.inference.mesh_items`, two ahead on the owner), as the inference
    CLI decodes each sample once on a mesh; each kept in ``held`` for
    `record_shared`, ``stats`` counting what this rank made and the bytes it
    sent and received, and ``stats["wait_s"]`` the seconds the pass waited
    for them (the owners' making and the shares)."""
    from mmduet_tpu_torch.eval.inference import mesh_items

    items, stats["wait_s"] = mesh_items(n, make, mesh, 2, stats), 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        item = next(items)
        stats["wait_s"] += time.perf_counter() - t0
        held.append(item)
        yield item


def session_digest(session: dict) -> str:
    """SHA-256 of a session: each array's kind, dtype, shape and bytes, and
    the JSON of every other value, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in session.items():
        if torch.is_tensor(v):
            h.update(f"{k} torch {v.dtype} {tuple(v.shape)}".encode())
            h.update(v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(v, np.ndarray):
            h.update(f"{k} numpy {v.dtype.str} {v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(f"{k} {json.dumps(v)}".encode())
    return h.hexdigest()


def record_shared(held: list, stats: dict, what: str, log) -> None:
    """The digests of the sessions that reached this rank (``held``, in
    order; an owner's own are what it made) into ``stats["digests"]``:
    every rank's must be the same, which the caller of the ranks checks.
    Prints what this rank made and the bytes it sent and received."""
    stats["digests"] = [session_digest(x) for x in held]
    log(f"{what}: {len(held)} sessions shared; made {stats['fetched']} here, sent "
        f"{stats['sent']} bytes, received {stats['received']} bytes; the pass waited "
        f"{stats['wait_s']:.3f} s for them")


def check_digests(ranks: list, what: str, log, *path) -> None:
    """Every rank's digests of its shared sessions (``rank[path...]``) the
    same: each session reached every rank bit-equal to what its owner made."""
    def digests(x):
        for key in path:
            x = x[key]
        return x["digests"]

    if any(digests(x) != digests(ranks[0]) for x in ranks[1:]):
        raise AssertionError(f"{what}: a rank's shared sessions differ from their owners'")
    log(f"{what}: the {len(digests(ranks[0]))} shared sessions have the same SHA-256 on every "
        "rank, their owners' included")


def run_batched_path(cfg, tok, params, log, mesh=None, kv_cache_quant=None,
                     grounding: bool = True) -> dict:
    """The 7B-width batched path: `BatchedStreamEngine.serve()` streams
    BATCH_SESSIONS sessions through BATCH_LANES lanes in generation mode
    (8-frame blocks, continuous admission), then, with ``grounding``,
    `BatchedStreamScorer` scores the first BATCH_LANES sessions in lockstep
    32-frame blocks. Every kernel count of the path is set to 0 just before
    and read just after; the counts must equal what the decoder forwards,
    the mesh and the vision batches predict. ``mesh``: a one-device mesh
    or this rank's `ProcessMesh` (``params`` its local tree), whose lanes
    ``lane_block`` gives: its forwards, vision batches and greedy steps are
    those of its own lanes, and each session (each of the scorer's videos)
    is made on one rank and shared (`mesh_sessions`). Returns outputs and
    numbers, with each pass's peak memory measured on its own (``mem``)."""
    rank_mesh = isinstance(mesh, ProcessMesh)
    shards = mesh.size if mesh is not None and not rank_mesh else 1
    lo, hi = lane_block(mesh, BATCH_LANES)
    layers, v_layers = cfg.text.num_layers, cfg.vision.num_layers - 1
    what = f"mesh {dict(mesh.shape) if mesh is not None else None}, cache {kv_cache_quant or 'bf16'}"
    if rank_mesh:
        what += f", lanes {lo}-{hi - 1}"
    resident = _resident(budget.tree_bytes(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, mems = {}, {}

    engine = BatchedStreamEngine(
        params, cfg, tok, _args(BATCH_MAX_NEW, stream_end_score_sum_threshold=2.0),
        n_streams=BATCH_LANES, mesh=mesh, gen_coalesce_rounds=1, kv_cache_quant=kv_cache_quant)
    acc, fed, admitted = {}, [], []
    _timed(engine, "_dispatch_sched", acc)
    _timed(engine, "_generate_batch", acc)
    _timed(engine, "_admit", acc, sync=True)
    sched, admit = engine._dispatch_sched, engine._admit
    engine._dispatch_sched = lambda chunks: (fed.append(sum(c[2] for c in chunks.values()))
                                             or sched(chunks))
    engine._admit = lambda lane, sess: admitted.append((lane, len(sess["frames"]))) or admit(
        lane, sess)
    made, held, shared = functools.partial(_batch_session, cfg), [], {}
    sessions = (mesh_sessions(made, BATCH_SESSIONS, mesh, held, shared) if rank_mesh
                else map(made, range(BATCH_SESSIONS)))
    _zero_counts()  # the main path starts here
    t0 = time.perf_counter()
    with TokenRecorder(tok.eos_token_id, owners=lambda: engine._lane_sess[lo:hi]) as rec:
        results = {i: (resp, debug) for i, resp, debug in engine.serve(sessions)}
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()  # the generation pass ends here
    n_frames = sum(BATCH_LENGTHS)
    if sorted(results) != list(range(BATCH_SESSIONS)):
        raise AssertionError(f"batched serve ({what}): sessions retired {sorted(results)}")
    for i, (resp, debug) in results.items():
        scores = [d[k] for d in debug for k in ("informative_score", "relevance_score")]
        if len(debug) != BATCH_LENGTHS[i] or not all(
                math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores):
            raise AssertionError(f"batched serve ({what}): session {i} has {len(debug)} score "
                                 f"rows for {BATCH_LENGTHS[i]} frames, or a score that is no "
                                 "finite probability")
    if rank_mesh:
        record_shared(held, shared, f"batched serve ({what})", log)
        del held
    n_answers = sum(r["role"] == "assistant" for resp, _ in results.values() for r in resp)
    gens = engine.decodes
    sharded = mesh is not None and not rank_mesh
    local = [n for lane, n in admitted if lo <= lane < hi]
    want_vision = v_layers * sum(_vision_batches(n) for n in local)
    want_fused = (4 * v_layers + 1) * sum(_vision_batches(n) for n in local)
    if (n_answers < 1 or counts["attention"] != layers * shards * engine.forwards
            or counts["attention_int8"] != (counts["attention"] if kv_cache_quant else 0)
            or counts["attention_sharded"] != (counts["attention"] if sharded else 0)
            or counts["vision"] != want_vision or counts["vision_fused"] != want_fused):
        raise AssertionError(
            f"batched serve ({what}): {n_answers} answers, launches {counts}; want the "
            f"attention = {layers} layers x {shards} shards x {engine.forwards} decoder "
            f"forwards (of {engine.dispatches} dispatches and {gens} batched decodes), all of "
            f"them int8 / sharded under an int8 cache / a one-device mesh, and the vision "
            f"attention {want_vision} = {v_layers} layers x the vision batches of the "
            f"{len(local)} sessions in lanes {lo}-{hi - 1}, and the fused passes {want_fused} "
            f"= (4 x {v_layers} + 1) x those batches")
    t_sched, t_gen = acc["_dispatch_sched"], acc["_generate_batch"]
    frames_fed = sum(fed)  # frames rolled back by a trigger are fed again
    log(f"batched generation pass ({what}): {BATCH_SESSIONS} sessions, {n_frames} frames "
        f"through {BATCH_LANES} lanes in {wall:.3f} s = {n_frames / wall:.2f} frames/s "
        f"aggregate (admission with vision {acc['_admit']:.3f} s = "
        f"{n_frames / acc['_admit']:.2f} frames/s, {engine.dispatches} dispatches "
        f"{t_sched:.3f} s = {1e3 * t_sched / engine.dispatches:.3f} ms each, "
        f"{1e3 * t_sched / frames_fed:.3f} ms per frame fed ({frames_fed} fed, a trigger's "
        f"rolled-back frames twice), {gens} batched decodes {t_gen:.3f} s); {n_answers} answers, "
        f"{engine.tokens_generated} tokens = {engine.tokens_generated / t_gen:.2f} tokens/s "
        f"with {engine.decode_lanes / max(gens, 1):.2f} lanes decoding together on average")
    log(f"batched generation pass ({what}): launches {counts} = {layers} x {shards} x "
        f"{engine.forwards} decoder forwards ({engine.dispatches} dispatches, {gens} decodes "
        f"of {engine.decode_lanes / max(gens, 1):.2f} lanes on average); vision {v_layers} x "
        f"{want_vision // v_layers} batches")
    out.update(results=results, sessions=_session_rows(results, rec), counts=counts,
               frames_per_s=n_frames / wall, dispatch_ms_per_frame=1e3 * t_sched / frames_fed,
               decode_tokens_per_s=engine.tokens_generated / t_gen,
               vision_frames_per_s=n_frames / acc["_admit"], dispatches=engine.dispatches,
               decode_lanes_mean=engine.decode_lanes / max(gens, 1), forwards=engine.forwards,
               shared=shared)
    mems["serve"] = _mem(resident, engine._graphs)
    # the wrappers hold the engine and the engine holds them: without them
    # its cache is freed here, before the next engine allocates its own
    for name in ("_dispatch_sched", "_generate_batch", "_admit"):
        delattr(engine, name)
    del engine, sched, admit
    torch.cuda.empty_cache()

    if grounding:
        resident = _resident(budget.tree_bytes(params))
        torch.cuda.reset_peak_memory_stats()
        scorer = BatchedStreamScorer(
            params, cfg, tok, n_streams=BATCH_LANES, frame_fps=2.0, mesh=mesh,
            kv_cache_quant=kv_cache_quant)
        if rank_mesh:  # each video made on one rank, as the serve pass's sessions
            held, shared = [], {}
            videos = [x["frames"] for x in mesh_sessions(made, BATCH_LANES, mesh, held, shared)]
            record_shared(held, shared, f"batched grounding pass ({what})", log)
            del held
            out["shared_scorer"] = shared
        else:
            videos = [made(i)["frames"] for i in range(BATCH_LANES)]
        lengths = BATCH_LENGTHS[:BATCH_LANES]
        before = attention.LAUNCHES, attention.VISION_LAUNCHES
        t0 = time.perf_counter()
        scorer.input_video_streams(videos)
        torch.cuda.synchronize()
        t_vision = time.perf_counter() - t0
        t0 = time.perf_counter()
        scorer.start_sessions([QUERY] * BATCH_LANES)
        rows = scorer.score_all()
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        launches = attention.LAUNCHES - before[0], attention.VISION_LAUNCHES - before[1]
        blocks = -(-max(lengths) // scorer.block_frames)
        want = (layers * shards * (1 + blocks),
                v_layers * _vision_batches((hi - lo) * max(lengths)))
        ok = all(len(r) == n and all(math.isfinite(d["informative_score"]) for d in r)
                 for r, n in zip(rows, lengths))
        if launches != want or not ok:
            raise AssertionError(
                f"batched grounding pass ({what}): launches (attention, vision) {launches}, "
                f"want {want} = {layers} layers x {shards} shards x (1 prefix + {blocks} "
                f"blocks) and {v_layers} layers x vision batches; rows complete and finite: {ok}")
        n = sum(lengths)
        encoded = (hi - lo) * max(lengths)
        log(f"batched grounding pass ({what}): {BATCH_LANES} lanes in lockstep "
            f"{scorer.block_frames}-frame blocks, {n} frames in {t_stream:.3f} s = "
            f"{1e3 * t_stream / n:.3f} ms per frame, "
            f"{n / t_stream:.2f} frames/s aggregate (the padded lockstep blocks hold "
            f"{BATCH_LANES * max(lengths)} frames); vision {encoded} frames here "
            f"in {t_vision:.3f} s = {encoded / t_vision:.2f} frames/s; "
            f"launches (attention, vision) {launches} = {want}")
        out.update(rows=rows, grounding_ms_per_frame=1e3 * t_stream / n)
        out["counts"] = _kernel_counts()  # both passes; the path ends here
        mems["scorer"] = _mem(resident, scorer._graphs)
        del scorer, videos
        torch.cuda.empty_cache()
    out["mem"] = mems
    out["peak_gib"] = max(m["peak"] for m in mems.values()) / 2**30
    slots = cache_slots(_args().max_num_frames, cfg.frame_num_tokens)
    lane_gb = (2 * layers * cfg.text.num_kv_heads * slots
               * (cfg.text.head_dim + 4 if kv_cache_quant else 2 * cfg.text.head_dim) / 1e9)
    log(f"batched path ({what}): peak device memory {out['peak_gib']:.2f} GiB (the cache "
        f"holds {BATCH_LANES} lanes x {lane_gb:.3f} GB of {slots} slots)")
    return out


def time_vision_routes(cfg, params, log) -> None:
    """The vision tower on 64 frames with kernel D (True and auto, which
    must take kernel D on the card) and, for the comparison only, with the
    plain version put in the kernel's place from here: the package itself
    refuses the matmul route for CUDA tensors (False); then with the eager
    chains (`vision_fused`'s plain versions) in the fused passes' place."""
    px = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (64, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)).cuda()
    px = mmduet.normalize_pixels(cfg, px).to(torch.bfloat16)
    per_encode = 2 * (cfg.vision.num_layers - 1)
    rates, outs = {}, {}

    def tower(use_flash):
        return lambda: torch.cat([mmduet.visual_embed(params, cfg, px[i:i + 32],
                                                      vision_use_flash=use_flash)
                                  for i in (0, 32)])

    with torch.inference_mode():
        for use_flash in (True, None):
            before = attention.VISION_LAUNCHES
            outs[use_flash] = tower(use_flash)()
            if attention.VISION_LAUNCHES - before != per_encode:
                raise AssertionError(f"vision_use_flash={use_flash}: "
                                     f"{attention.VISION_LAUNCHES - before} launches of kernel D")
            rates[use_flash] = 64 / (_time_ms(tower(use_flash), 2, warmup=1) / 1e3)
        before = attention.VISION_LAUNCHES
        try:
            tower(False)()
        except attention.KernelRefused:
            pass
        else:
            raise AssertionError("vision_use_flash=False ran on CUDA tensors")
        kernel = siglip.flash_vision_attention
        siglip.flash_vision_attention = attention.flash_vision_attention_ref
        try:
            outs["plain"] = tower(True)()
            rates["plain"] = 64 / (_time_ms(tower(True), 2, warmup=1) / 1e3)
        finally:
            siglip.flash_vision_attention = kernel
        if attention.VISION_LAUNCHES != before:
            raise AssertionError("the refused and the plain tower launched kernel D")
        passes = {name: getattr(siglip, name)
                  for name in ("bias_add3", "bias_residual_layernorm", "bias_act")}
        for name in passes:  # the eager chains the passes replaced
            setattr(siglip, name, getattr(vision_fused, name + "_ref"))
        fused_before = vision_fused.LAUNCHES
        try:
            outs["eager"] = tower(True)()
            rates["eager"] = 64 / (_time_ms(tower(True), 2, warmup=1) / 1e3)
        finally:
            for name, fn in passes.items():
                setattr(siglip, name, fn)
        if vision_fused.LAUNCHES != fused_before:
            raise AssertionError("the tower with the eager chains launched a fused pass")
    eager = (outs[True].float() - outs["eager"].float()).abs().max().item()
    diff = (outs[True].float() - outs["plain"].float()).abs().max().item()
    scale = outs["plain"].float().abs().max().item()
    if (not torch.equal(outs[None], outs[True]) or not diff <= 0.05 * scale
            or not eager <= 0.05 * scale):
        raise AssertionError(f"vision routes: kernel D vs its plain version max|diff| {diff} "
                             f"(max|embedding| {scale}); auto equals kernel D: "
                             f"{torch.equal(outs[None], outs[True])}; the fused passes vs "
                             f"the eager chains max|diff| {eager}")
    log(f"vision tower + projector + pooling, 64 frames in batches of 32: "
        f"{rates[True]:.2f} frames/s with vision_use_flash=True (kernel D), {rates[None]:.2f} "
        f"with None (auto = kernel D), {rates['plain']:.2f} with the plain version in the "
        f"kernel's place (the matmul route; vision_use_flash=False is refused on the card); "
        f"embeddings max|diff| {diff:.4f} of max {scale:.2f}; {rates['eager']:.2f} frames/s "
        f"with the eager chains in the fused passes' place (max|diff| {eager:.4f})")


def check_small_batched(log) -> float:
    """A small model (hd = 128) through the batched engine on the card (bf16,
    kernels A and D) against the same engine on the CPU (f32, plain
    versions), grounding mode so that no trigger can diverge; and each lane
    of the card's batched run against a `LiveInferEngine` run of its session
    on the card. Scores within SMALL_TOL (bf16 products at other row counts
    round differently, so the lanes are not bit-equal to single streams)."""
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    cpu = torch.device("cpu")
    params = init_mmduet_params(cfg, torch.Generator(device=cpu).manual_seed(5), cpu)
    params = _tree_map(lambda t: t.to(torch.bfloat16).float(), params)
    card = _tree_map(lambda t: t.to("cuda", torch.bfloat16), params)
    r = np.random.RandomState(8)
    lengths = (12, 7, 9, 10, 5)
    sessions = [{"frames": r.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8), "fps": 2.0,
                 "conversation": [{"role": "user", "content": f"Q{i}?", "time": 0.5 * i}]}
                for i, n in enumerate(lengths)]
    args = _args(stream_end_prob_threshold=1.0, grounding_mode=True, max_num_frames=16)

    def serve(p):
        engine = BatchedStreamEngine(p, cfg, tok, args, n_streams=3, block_frames=4)
        return {i: [d["informative_score"] for d in debug]
                for i, _, debug in engine.serve(iter(sessions))}

    want = serve(params)
    before = attention.LAUNCHES, attention.VISION_LAUNCHES
    got = serve(card)
    if attention.LAUNCHES <= before[0] or attention.VISION_LAUNCHES <= before[1]:
        raise AssertionError("small batched input: kernels A and D were not both launched")
    err = max(float(np.abs(np.array(got[i]) - np.array(want[i])).max()) for i in want)
    single = LiveInferEngine(card, cfg, tok, args)
    err_single = 0.0
    for i, sess in enumerate(sessions):
        single.reset()
        single.input_video_stream(sess["frames"])
        single.input_query_stream(sess["conversation"])
        single.inference()
        scores = [d["informative_score"] for d in single.debug_data_list]
        if len(scores) != len(got[i]):
            raise AssertionError(f"small batched input: session {i} has {len(got[i])} rows, its "
                                 f"single-stream run {len(scores)}")
        err_single = max(err_single, float(np.abs(np.array(scores) - np.array(got[i])).max()))
    if sorted(got) != list(range(len(lengths))) or not max(err, err_single) <= SMALL_TOL:
        raise AssertionError(f"small batched input: card vs CPU scores max|diff| {err}, card "
                             f"batched vs card single-stream {err_single} > {SMALL_TOL}")
    log(f"small batched input (hd=128, 2 layers, 5 sessions through 3 lanes): card bf16 vs CPU "
        f"f32 scores max|diff| {err}; batched lanes vs single-stream runs on the card "
        f"max|diff| {err_single}; both <= {SMALL_TOL}")
    return err


def check_small_offline(log) -> float:
    """The offline baseline on a small model (hd = 128): the card (bf16,
    kernels A and D) against the CPU (f32, plain versions), on the same
    prompt: the K and V rows of the prompt in the cache agree within
    SMALL_TOL of their largest value, at every layer."""
    from mmduet_tpu_torch.eval.offline_baseline import OfflineBaselineRunner

    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    cpu = torch.device("cpu")
    params = init_mmduet_params(cfg, torch.Generator(device=cpu).manual_seed(6), cpu)
    params = _tree_map(lambda t: t.to(torch.bfloat16).float(), params)
    frames = np.random.RandomState(7).randint(0, 256, (70, 32, 32, 3), dtype=np.uint8)
    caches, texts = [], []
    for p in (params, _tree_map(lambda t: t.to("cuda", torch.bfloat16), params)):
        runner = OfflineBaselineRunner(p, cfg, tok, _args(max_new_tokens=8, max_num_frames=80))
        runner.set_fps(2.0)
        before = attention.LAUNCHES, attention.VISION_LAUNCHES
        texts.append(runner.answer(frames, "What is happening?"))
        ran = attention.LAUNCHES - before[0], attention.VISION_LAUNCHES - before[1]
        n = runner.state.cursor - runner.tokens_generated + 1  # the prompt's rows
        caches.append([kv_arr(c)[:, 0, :, :n].float().cpu()
                       for c in (runner.state.kv_cache.k, runner.state.kv_cache.v)])
    if ran[0] <= 0 or ran[1] <= 0:
        raise AssertionError(f"small offline baseline: launches of kernels A and D {ran}")
    err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(caches[1], caches[0]))
    if caches[0][0].shape != caches[1][0].shape or not err <= SMALL_TOL:
        raise AssertionError(f"small offline baseline: card vs CPU prompt cache relative "
                             f"max|diff| {err} > {SMALL_TOL}")
    log(f"small offline baseline (hd=128, 2 layers, 70 frames, {caches[0][0].shape[-2]} prompt "
        f"rows in 256-row chunks): card bf16 vs CPU f32 prompt K/V relative max|diff| "
        f"{err:.2e} <= {SMALL_TOL}; answers {'equal' if texts[0] == texts[1] else 'differ'}")
    return err


def check_small_cli_profile(log) -> None:
    """`--profile_dir` on the small model through the CLI (``--tiny_random``,
    ``--device cuda``, a stub dataset of one 6-frame sample): the Chrome
    trace exists, names kernel A, and the row is written."""
    from types import SimpleNamespace

    from mmduet_tpu_torch.eval import inference

    root = tempfile.mkdtemp(prefix="cli_profile.", dir=_build.BUILD_DIR)
    sample = SimpleNamespace(
        question_id="q0", frames=np.random.RandomState(0).randint(
            0, 256, (6, 32, 32, 3), dtype=np.uint8), fps=2.0, video_duration=3.0, error=None,
        conversation=[{"role": "user", "content": "query?", "time": 0}])
    make_dataset = inference._make_dataset
    inference._make_dataset = lambda args, resolution: [sample]
    try:
        inference.main(["--tiny_random", "--no_prefetch", "--test_fname", "x", "--input_dir", "x",
                        "--frame_fps", "2", "--stream_end_prob_threshold", "0.5",
                        "--max_new_tokens", "4", "--prewarm",
                        "--output_fname", os.path.join(root, "rows.jsonl"),
                        "--profile_dir", os.path.join(root, "prof")])
        spans = _kernel_intervals(os.path.join(root, "prof", "trace.json"))
        with open(os.path.join(root, "rows.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    finally:
        inference._make_dataset = make_dataset
        shutil.rmtree(root, ignore_errors=True)
    if not spans["A"] or len(rows) != 1 or len(rows[0]["debug_data"]) != 6:
        raise AssertionError(f"--profile_dir: {len(spans['A'])} kernel A events in the trace, "
                             f"{len(rows)} rows")
    log(f"CLI --prewarm --profile_dir (tiny random model, 6 frames): the Chrome trace names "
        f"kernel A in {len(spans['A'])} kernel events, D in {len(spans['D'])}; 1 row written")


def check_same_outputs(a: dict, b: dict, what: str) -> None:
    """Two batched runs gave the same responses, times and scores, exactly."""
    if a["results"] != b["results"] or a.get("rows") != b.get("rows"):
        raise AssertionError(f"batched path: {what} changed an output")


TRAIN_STEPS, TRAIN_ACCUM = 3, 2


def _train_flops(cfg, T: int, n_frames: int) -> float:
    """Model flop of one micro-batch, from shapes: the decoder's matmuls
    and LM head forward and input-gradient backward (the base is frozen, so
    no weight gradients; the LoRA terms are under 1 % and left out),
    causal attention (forward 2 T^2 hd nh per layer, backward twice that),
    and the frozen SigLIP tower and projector forward. The remat recompute
    is not model work and is not counted."""
    t, v = cfg.text, cfg.vision
    h, i = t.hidden_size, t.intermediate_size
    q_dim, kv_dim = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    layer = h * q_dim + 2 * h * kv_dim + q_dim * h + 3 * h * i
    dense = 2 * 2 * (t.num_layers * layer + h * t.vocab_size) * T
    attn = 3 * 2 * T * T * t.head_dim * t.num_heads * t.num_layers
    vis_layer = 4 * v.hidden_size ** 2 + 2 * v.hidden_size * v.intermediate_size
    tokens = n_frames * v.num_patches
    vision = 2 * tokens * ((v.num_layers - 1) * vis_layer + 3 * v.patch_size ** 2 * v.hidden_size
                           + v.hidden_size * h + h * h)
    return dense + attn + vision


def run_training(cfg, tok, params, log) -> tuple:
    """The 7B-width training path: TRAIN_STEPS steps of `make_train_step`,
    holding one `TrainState` and one step's batch on the card at a time, as
    the CLI's loop does. Returns kernel C's (forward, backward) launches
    over them, and the peak memory with the batches' frame slots and
    length."""
    dev = torch.device("cuda")
    resident = _resident(budget.tree_bytes(params))
    args = TrainArgs()  # LoRA r 16 / alpha 32, lr 2e-5 cosine, remat on
    tx, sched = make_optimizer(args, TRAIN_STEPS)
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), cfg.text,
                     rank=args.lora_r, device=dev)
    step = make_train_step(cfg, args, tx, sched)
    batches = duet_batches(tok, cfg, TRAIN_STEPS, TRAIN_ACCUM, "cpu")
    T = batches[0]["input_ids"].shape[-1]
    n_frames = batches[0]["frames"].shape[1]
    real = [int(b["attn_mask"].sum()) for b in batches]
    log(f"training batches: A={TRAIN_ACCUM} x B=1, T={T} bucket, {n_frames} frame slots "
        f"of 384 px, real tokens per step {real}")
    state = init_train_state(params, lora, tx)
    del lora  # the state holds the adapter, as in the CLI's loop
    step(state, params, _stage(batches[0], dev))  # warm-up, discarded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flat = [list(_flat_cpu(state.trainable).values())]  # the leaves after each step
    times, rows = [], []
    attention.FULL_FWD_LAUNCHES = attention.FULL_BWD_LAUNCHES = 0  # the path starts here
    for batch in batches:
        batch = _stage(batch, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del batch
        flat.append(list(_flat_cpu(state.trainable).values()))
        rows.append(metrics)
    launches = attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES  # and ends here

    layers = cfg.text.num_layers
    calls = layers * TRAIN_ACCUM * TRAIN_STEPS
    want = (2 * calls, len(attention.FULL_BWD_KERNELS) * calls)
    if launches != want:
        raise AssertionError(f"training: kernel C launches (forward, backward) {launches}, "
                             f"want {want} (the forward twice per layer under remat, four "
                             f"backward kernels per layer)")
    for i, m in enumerate(rows):
        if not all(math.isfinite(m[k]) for k in ("loss", "lm_loss", "video_loss", "grad_norm")):
            raise AssertionError(f"training step {i + 1}: non-finite metrics {m}")
        if m["skipped_nonfinite"] != 0.0:
            raise AssertionError(f"training step {i + 1} skipped its update")
    if not all(torch.equal(a, b) for a, b in zip(flat[0], flat[1])):
        raise AssertionError("training: step 1 (lr 0) changed the trainable leaves")
    if all(torch.equal(a, b) for a, b in zip(flat[1], flat[2])):
        raise AssertionError("training: step 2 left every trainable leaf unchanged")
    flops = _train_flops(cfg, T, n_frames) * TRAIN_ACCUM
    for i, (m, dt) in enumerate(zip(rows, times)):
        log(f"train step {i + 1}: {dt:.3f} s, {real[i] / dt:.1f} real tokens/s, loss "
            f"{m['loss']:.4f} (lm {m['lm_loss']:.4f}, video {m['video_loss']:.4f}), "
            f"grad_norm {m['grad_norm']:.4f}, lr {m['lr']:.3g}, model flop share of "
            f"989 TFLOP/s {100 * flops / dt / 989e12:.2f} %")
    sec = float(np.median(times))
    log(f"training: median {sec:.3f} s/step, {np.median(real) / sec:.1f} real tokens/s, "
        f"{flops / 1e12:.1f} TFLOP a step ({100 * flops / sec / 989e12:.2f} % of 989 "
        f"TFLOP/s), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"kernel C launches {launches[0]} forward / {launches[1]} backward")
    return launches, {"mem": {"steps": _mem(resident)}, "frames": n_frames, "seq": T}

# ---------------------------------------------------------------------------
# The user's journey around the serving loop: an HF checkpoint converted
# and served, live feeding with the vision tower on its own stream,
# prewarm, the offline baseline, the CLI's profiler
# ---------------------------------------------------------------------------

# Decoder and vision layers of the converted checkpoint. Every width is the
# published one (Qwen2-7B, SigLIP-so400m), ~3.2 GB written; all 28 + 27
# layers would write ~16 GB and read it twice, past this script's time.
CONVERT_LAYERS = 2
CONVERT_FRAMES = 16


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _same_leaves(got: dict, want: dict, what: str) -> None:
    flat_got, flat_want = dict(_flat(got)), dict(_flat(want))
    if set(flat_got) != set(flat_want):
        raise AssertionError(f"{what}: leaves {sorted(set(flat_got) ^ set(flat_want))} differ")
    for key, leaf in flat_want.items():
        if flat_got[key].dtype != leaf.dtype or not torch.equal(flat_got[key], leaf):
            raise AssertionError(f"{what}: leaf {key} is not bit-equal")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        yield from _flat(v, f"{prefix}/{k}") if isinstance(v, dict) else ((f"{prefix}/{k}", v),)


def run_conversion(log, dev=None, base=None) -> None:
    """An HF-format llava-OV directory at full width (CONVERT_LAYERS deep,
    random weights from seed 0, two shards and an index) through
    `python -m mmduet_tpu_torch.models.convert`, bf16 and ``--quantize
    int4``; `load_checkpoint` puts each on the card, every leaf is held
    bitwise against the HF tensors and the in-memory tree (int4: against
    `quantize_params(bits=4)` of the bf16 output), and 16 frames are served
    from each checkpoint (bf16 cache; int4 with the int8 cache) with the
    scores of the same weights built in memory."""
    from mmduet_tpu_torch.models import convert, io

    dev = dev or torch.device("cuda", torch.cuda.current_device())
    base = base or MMDuetConfig()
    cfg = base.replace(text=dataclasses.replace(base.text, num_layers=CONVERT_LAYERS),
                       vision=dataclasses.replace(base.vision, num_layers=CONVERT_LAYERS))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_mmduet_params(cfg, gen, dev, torch.bfloat16)
    # norms and biases start constant: perturb them, so that a leaf that
    # lands under another's key shows
    params = _tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=gen, device=dev,
                                                        dtype=t.dtype)
                       if bool((t == t.reshape(-1)[0]).all()) else t, params)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens, vocab_size=cfg.text.vocab_size)
    frames = np.random.RandomState(3).randint(
        0, 256, (CONVERT_FRAMES, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    root = tempfile.mkdtemp(prefix="convert_smoke.", dir=_build.BUILD_DIR)
    hf, dense_dir, int4_dir = (os.path.join(root, n) for n in ("hf", "bf16", "int4"))
    try:
        t0 = time.perf_counter()
        written = write_hf_dir(hf, params, cfg)
        t_write = time.perf_counter() - t0
        secs = {}
        for out, extra in ((dense_dir, []), (int4_dir, ["--quantize", "int4"])):
            t0 = time.perf_counter()
            convert.main(["--hf_dir", hf, "--output", out, "--device", str(dev)] + extra)
            torch.cuda.synchronize()
            secs[out] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense_cfg, dense, lora = io.load_checkpoint(dense_dir)  # no device: the card
        int4_cfg, int4, _ = io.load_checkpoint(int4_dir)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        want_cfg = cfg.replace(v_placeholder_id=cfg.text.vocab_size)
        if (lora is not None or dense_cfg != want_cfg or int4_cfg != want_cfg
                or not all(t.device == dev for _, t in _flat(dense))):
            raise AssertionError(f"converted checkpoint: config {dense_cfg} (want {want_cfg}), "
                                 f"lora {lora is not None}, leaves on "
                                 f"{ {t.device for _, t in _flat(dense)} }")
        hf_sd = convert.load_hf_state_dict(hf)
        back = hf_state_dict(dense, dense_cfg)
        if set(back) != set(hf_sd) or not all(
                torch.equal(back[k], hf_sd[k].to(dev)) for k in hf_sd):
            raise AssertionError("converted checkpoint: a leaf is not the HF tensor under the "
                                 "documented transposes")
        _same_leaves(dense, params, "converted bf16 checkpoint vs the tree in memory")
        _same_leaves(int4, quant.quantize_params(dense, bits=4),
                     "converted int4 checkpoint vs quantize_params(bits=4) of the bf16 one")
        rss = _peak_rss_gb()

        serve_cfg = dense_cfg.replace(v_placeholder_id=tok.v_placeholder_id,
                                      eos_token_id=tok.eos_token_id)
        args = _args(stream_end_prob_threshold=1.0, grounding_mode=True,
                     max_num_frames=CONVERT_FRAMES)

        def scores(p, kv_cache_quant=None):
            engine = LiveInferEngine(p, serve_cfg, tok, args, kv_cache_quant=kv_cache_quant)
            return _grounding_scores(engine, frames, QUERY)

        _zero_counts()  # the converted checkpoints' serving starts here
        got_dense = scores(dense)
        counts_dense = _kernel_counts()
        _zero_counts()
        got_int4 = scores(int4, "int8")
        counts_int4 = _kernel_counts()  # and ends here
        vision_per_encode = CONVERT_LAYERS - 1
        if (counts_dense["attention"] <= 0 or counts_dense["attention"] % CONVERT_LAYERS
                or counts_dense["attention_int8"] or counts_dense["int4_matmul"]
                or counts_int4["attention_int8"] != counts_int4["attention"]
                or counts_int4["int4_matmul"] != 7 * counts_int4["attention"]
                or counts_dense["vision"] != vision_per_encode
                or counts_int4["vision"] != vision_per_encode):
            raise AssertionError(f"converted checkpoints served: launches bf16 {counts_dense}, "
                                 f"int4 {counts_int4}")
        want_dense = scores(params)
        want_int4 = scores(quant.quantize_params(params, bits=4), "int8")
        if got_dense != want_dense or got_int4 != want_int4:
            raise AssertionError("converted checkpoints served: scores differ from those of the "
                                 "same weights built in memory")
        log(f"conversion ({CONVERT_LAYERS} decoder + {CONVERT_LAYERS} vision layers at 7B "
            f"widths): HF directory of {written / 1e9:.3f} GB (2 shards + index) written in "
            f"{t_write:.2f} s; convert bf16 {secs[dense_dir]:.2f} s (read {written / 1e9:.3f} "
            f"GB, wrote {_dir_bytes(dense_dir) / 1e9:.3f} GB), --quantize int4 "
            f"{secs[int4_dir]:.2f} s (read {written / 1e9:.3f} GB, wrote "
            f"{_dir_bytes(int4_dir) / 1e9:.3f} GB); load_checkpoint of both onto the card "
            f"{t_load:.2f} s; host peak RSS {rss:.2f} GB")
        log(f"converted checkpoints: every leaf bit-equal to the HF tensors and the tree in "
            f"memory (int4: to quantize_params(bits=4)); {CONVERT_FRAMES} frames served from "
            f"each, scores equal to the in-memory weights' exactly; launches bf16 "
            f"{counts_dense}, int4 + int8 cache {counts_int4}")
        check_parity_route(dense_dir, dev, log)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params, dense, int4
    torch.cuda.empty_cache()


# The parity gate's card route (bf16, kernels A and D) against its CPU route
# (f32, the plain versions) on the converted checkpoint: next-token logits,
# score probabilities, and the tower's features and the projector's output
# relative to the CPU's largest magnitude (bf16 activations through 2 + 2
# layers at the 7B widths)
PARITY_PROMPTS, PARITY_SEQ = 4, 64
PARITY_LOGITS_ATOL, PARITY_PROB_ATOL, PARITY_FEATURE_REL = 0.25, 0.02, 0.05


def check_parity_route(ckpt: str, dev, log) -> None:
    """`scripts/verify_checkpoint_parity_torch.py`'s port side on ``ckpt``
    twice: on the card (bf16, the kernels; their counts set to 0 just
    before and read just after) and on the CPU (f32, the plain versions),
    held together by the gate's `compare` within the PARITY_* tolerances;
    kernels A and D must have launched."""
    cfg = load_config(os.path.join(ckpt, "config.json"))
    prompts, pixels = parity.make_inputs(cfg.text.vocab_size, cfg.vision.image_size,
                                         PARITY_PROMPTS, PARITY_SEQ)
    t0 = time.perf_counter()
    _zero_counts()
    card = parity.port_outputs(ckpt, dev, prompts, pixels)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = parity.port_outputs(ckpt, "cpu", prompts, pixels)
    t_cpu = time.perf_counter() - t0
    if counts["attention"] <= 0 or counts["vision"] <= 0:
        raise AssertionError(f"parity route on the card: launches {counts}; want kernels A and D")
    scale = max(float(np.max(np.abs(cpu[k]))) for k in ("vision layer(-2) features",
                                                        "projector output"))
    text = {k: v for k, v in cpu.items() if k.startswith("prompt")}
    vision = {k: v for k, v in cpu.items() if not k.startswith("prompt")}
    diffs = {k: float(np.max(np.abs(np.asarray(card[k], np.float32)
                                    - np.asarray(v, np.float32))))
             for k, v in cpu.items() if not isinstance(card.get(k), str)}
    log(f"parity route, the port's side of the gate on the converted checkpoint ({PARITY_PROMPTS} "
        f"prompts of {PARITY_SEQ} tokens, 2 frames): card bf16 {t_card:.2f} s (launches "
        f"{counts}), CPU f32 {t_cpu:.2f} s; max|card - CPU| logits "
        f"{max(v for k, v in diffs.items() if 'logits' in k):.4f}, probabilities "
        f"{max(v for k, v in diffs.items() if '_prob' in k):.4f}, features "
        f"{diffs['vision layer(-2) features']:.4f}, projector {diffs['projector output']:.4f} "
        f"(CPU magnitude {scale:.3f})")
    failures = (parity.compare(card, text, PARITY_PROB_ATOL, PARITY_LOGITS_ATOL,
                               argmax_ties=2 * PARITY_LOGITS_ATOL)
                + parity.compare(card, vision, PARITY_FEATURE_REL * scale, 0.0))
    if failures:
        raise AssertionError(f"parity route: the card's bf16 outputs against the CPU's f32: "
                             f"{failures}")


LIVE_CHUNK = 16  # frames a stream_video chunk in the equality checks


def _live_pass(engine, frames, stream: bool, chunk: int = LIVE_CHUNK, upload_ahead=False):
    """One session: the query at t=0, then ``frames`` through
    `stream_video` or through `input_video_stream` + `inference()`. Returns
    (wall s, (responses, score rows, cursor))."""
    engine.reset()
    engine.input_query_stream([{"role": "user", "content": QUERY, "time": 0.0}])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if stream:
        out = engine.stream_video(frames, chunk_frames=chunk, upload_ahead=upload_ahead)
    else:
        engine.input_video_stream(frames)
        out = engine.inference()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(d["time"], d["informative_score"], d["relevance_score"])
            for d in engine.debug_data_list]
    # stream_video lists the user turns after the answers before its sort
    # by time, as the JAX engine does: a user turn and an answer at the same
    # time come in either order
    out = sorted(out, key=lambda r: (r["time"], r["role"], r["content"]))
    return wall, (out, rows, engine.state.cursor)


LIVE_TOL = 3e-2  # score probabilities where the chunks cut other blocks than
# the one-shot route: a 32-frame block and single steps round the bf16
# activations differently through 28 layers (chunks of 16 under 32-frame
# grounding blocks); where the chunks are a multiple of the block, bit-equal


def _live_diff(got, want, exact: bool, what: str) -> float:
    """Max |score difference| of two `_live_pass` results, which must have
    the same responses, times and cursor; 0 when ``exact`` demands it."""
    (g_out, g_rows, g_cur), (w_out, w_rows, w_cur) = got, want
    if (g_out != w_out or g_cur != w_cur or len(g_rows) != len(w_rows)
            or [r[0] for r in g_rows] != [r[0] for r in w_rows]):
        raise AssertionError(f"{what}: responses, times or cursor ({g_cur} vs {w_cur}) differ")
    diff = max((abs(a - b) for g, w in zip(g_rows, w_rows) for a, b in zip(g[1:], w[1:])),
               default=0.0)
    if (exact and diff != 0.0) or not diff <= LIVE_TOL:
        raise AssertionError(f"{what}: scores max|diff| {diff} (want "
                             f"{'0' if exact else f'<= {LIVE_TOL}'})")
    return diff


def _kernel_intervals(trace_path: str) -> dict:
    """Device intervals (µs) and streams of the kernels in a Chrome trace
    of `torch.profiler`: kernel A's ("A"), kernel D's ("D") and every
    kernel's ("all")."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {"A": [], "D": [], "all": []}
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        span = (e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
        out["all"].append(span)
        for key, name in (("A", "flash_decode_tc_kernel"), ("D", "flash_vision_kernel")):
            if name in e.get("name", ""):
                out[key].append(span)
    return out


def _union(spans, gap: float = 0.0) -> list:
    """The intervals merged where they overlap or lie within ``gap`` µs."""
    merged = []
    for a, b, *_ in sorted(spans):
        if merged and a <= merged[-1][1] + gap:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap_us(xs, ys) -> float:
    """Time (µs) that two sets of intervals are both busy."""
    xs, ys, i, j, total = _union(xs), _union(ys), 0, 0, 0.0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def run_live_feeding(cfg, tok, params, log) -> dict:
    """`stream_video` on the full-width, full-depth model, 64 frames in
    chunks of LIVE_CHUNK: generation and grounding mode, then grounding
    with ``upload_ahead``, then both modes in chunks of 32. Each equals
    `input_video_stream` + `inference()`: texts, times and cursor, and the
    scores bit for bit where the chunk is a multiple of the block (within
    LIVE_TOL where it is not: 16-frame chunks under 32-frame grounding
    blocks cut other blocks); both routes are timed; the launches of A and
    D are what the layers imply, and a profile shows D's kernels running
    beside A's on another stream."""
    from torch.profiler import ProfilerActivity, profile

    frames = np.random.RandomState(0).randint(
        0, 256, (N_FRAMES, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    engines = {mode: LiveInferEngine(params, cfg, tok, _args(
        max_new_tokens=8, stream_end_score_sum_threshold=1.0, grounding_mode=mode == "grounding"))
        for mode in ("generation", "grounding")}
    for engine in engines.values():  # the side stream's first encode (cuBLAS on a new stream)
        engine.prewarm(buckets=(), block=False, generate=False, vision=True)
    per_encode = cfg.vision.num_layers - 1
    walls, stats, vision_ahead, sequential = {}, {}, {}, {}
    _zero_counts()  # the live-feeding path starts here
    for name, mode, chunk, upload_ahead in (
            ("generation", "generation", LIVE_CHUNK, False),
            ("grounding", "grounding", LIVE_CHUNK, False),
            ("grounding, upload_ahead", "grounding", LIVE_CHUNK, True),
            ("grounding, chunks of 32", "grounding", 32, False),
            ("generation, chunks of 32", "generation", 32, False)):
        engine = engines[mode]
        if mode not in sequential:  # each mode's sequential route, once
            c0 = _kernel_counts()
            sequential[mode] = _live_pass(engine, frames, stream=False)
            sequential[mode] += (_kernel_counts()["attention"] - c0["attention"],)
        seq_wall, want, a_seq = sequential[mode]
        c1 = _kernel_counts()
        live_wall, got = _live_pass(engine, frames, stream=True, chunk=chunk,
                                    upload_ahead=upload_ahead)
        c2 = _kernel_counts()
        exact = chunk % engine.block_frames == 0
        diff = _live_diff(got, want, exact, f"stream_video ({name})")
        if upload_ahead:  # the vision-ahead route's blocks: bit-equal to it
            _live_diff(got, vision_ahead[mode], True, f"stream_video ({name}) vs vision ahead")
        elif chunk == LIVE_CHUNK:
            vision_ahead[mode] = got
        a_live, d_live = c2["attention"] - c1["attention"], c2["vision"] - c1["vision"]
        encodes = -(-N_FRAMES // chunk) * -(-chunk // 32)  # each chunk at the 32-frame shape
        if (a_live <= 0 or a_live % cfg.text.num_layers or (exact and a_live != a_seq)
                or d_live != encodes * per_encode):
            raise AssertionError(f"stream_video ({name}): {a_live} launches of kernel A (the "
                                 f"sequential route {a_seq}), {d_live} of kernel D (want "
                                 f"{encodes} encodes x {per_encode} layers)")
        walls[name] = (seq_wall, live_wall)
        stats[name] = dict(a=a_live, a_seq=a_seq, d=d_live, diff=diff, exact=exact, responses=sum(
            r["role"] == "assistant" for r in got[0]))
    counts = _kernel_counts()  # and ends here
    trace = os.path.join(tempfile.mkdtemp(prefix="live_trace.", dir=_build.BUILD_DIR),
                         "trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _live_pass(engines["generation"], frames, stream=True)
    prof.export_chrome_trace(trace)
    spans = _kernel_intervals(trace)
    shutil.rmtree(os.path.dirname(trace), ignore_errors=True)
    for name, (seq_wall, live_wall) in walls.items():
        st = stats[name]
        same = ("bit-equal" if st["exact"] else
                f"scores within {st['diff']:.3e} (<= {LIVE_TOL}; the chunks cut other blocks)")
        log(f"stream_video ({name}, 64 frames, each chunk encoded at 32): wall {live_wall:.3f} s "
            f"against {seq_wall:.3f} s for input_video_stream + inference(); responses, times "
            f"and cursor equal, {same}; launches A {st['a']} (sequential {st['a_seq']}), D "
            f"{st['d']}; {st['responses']} responses")
    d_streams = {s for *_, s in spans["D"]}
    a_streams = {s for *_, s in spans["A"]}
    side = [x for x in spans["all"] if x[2] in d_streams]  # the vision stream's kernels
    main = [x for x in spans["all"] if x[2] in a_streams]  # the decoder's
    # an encode's window: the vision stream's kernels merged across gaps of
    # up to 1 ms (the host's launches between its layers)
    windows = _union(side, gap=1e3)
    a_inside = sum(_overlap_us(windows, [a]) > 0 for a in spans["A"])
    main_inside = _overlap_us(windows, main)
    side_main, d_a = _overlap_us(side, main), _overlap_us(spans["D"], spans["A"])
    log(f"stream_video profile (generation, chunks of {LIVE_CHUNK}): {len(spans['D'])} kernel D "
        f"on stream(s) {sorted(d_streams)}, {len(spans['A'])} kernel A on {sorted(a_streams)}; "
        f"the vision stream busy {_overlap_us(side, side) / 1e3:.3f} ms in {len(windows)} "
        f"windows, the decoder's stream {_overlap_us(main, main) / 1e3:.3f} ms, "
        f"{main_inside / 1e3:.3f} ms of it inside the vision windows, {a_inside} launches of A "
        f"there; kernels of the two streams at the same instant {side_main / 1e3:.3f} ms, "
        f"kernel D beside kernel A {d_a / 1e3:.3f} ms; launches over the path {counts}")
    if (len(spans["D"]) != stats["generation"]["d"] or not spans["A"] or d_streams & a_streams
            or a_inside <= 0):
        raise AssertionError(f"stream_video profile: {len(spans['D'])} kernel D and "
                             f"{len(spans['A'])} kernel A on streams {d_streams} / {a_streams}; "
                             f"{a_inside} launches of A inside the vision stream's windows")
    return dict(counts, walls=walls)


def run_prewarm(cfg, tok, params, log) -> float:
    """`prewarm(vision=True)` on the full-width model, timed; a session
    after it equals one on a cold engine."""
    frames = np.random.RandomState(5).randint(
        0, 256, (LIVE_CHUNK, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    args = _args(max_new_tokens=8, stream_end_score_sum_threshold=1.0)
    warm = LiveInferEngine(params, cfg, tok, args)
    _zero_counts()  # prewarm's path starts here
    t0 = time.perf_counter()
    warm.prewarm(vision=True)
    dt = time.perf_counter() - t0
    counts = _kernel_counts()  # and ends here
    if (warm.state.cursor or warm.frame_embeds is not None or counts["attention"] <= 0
            or counts["attention"] % cfg.text.num_layers
            or counts["vision"] != 2 * (cfg.vision.num_layers - 1)
            or warm._graphs.kinds() != {"step": len(DEFAULT_BUCKETS) + 1, "frames_block": 1,
                                        "decode_step": 1}):
        raise AssertionError(f"prewarm: cursor {warm.state.cursor}, launches {counts}, "
                             f"graphs captured {warm._graphs.kinds()}")
    captured = len(warm._graphs)
    got = _live_pass(warm, frames, stream=True)[1]
    want = _live_pass(LiveInferEngine(params, cfg, tok, args), frames, stream=True)[1]
    if got != want or len(warm._graphs) != captured:
        raise AssertionError("prewarm: the session after it differs from a cold engine's, or "
                             f"captured more graphs ({len(warm._graphs)}, not {captured})")
    log(f"prewarm(vision=True): {dt:.3f} s (kernels built already; {len(DEFAULT_BUCKETS)} "
        f"buckets, the 8-frame block, an 8-token decode whose prompt and step it captured, "
        f"two 32-frame encodes: graphs {warm._graphs.kinds()}); launches "
        f"{counts}; a {LIVE_CHUNK}-frame session after it equals a cold engine's exactly and "
        f"captures nothing more")
    return dt


def run_offline_baseline(cfg, tok, params, log) -> float:
    """`OfflineBaselineRunner.answer` at full width: 64 frames and the
    question, prefilled in 256-row chunks, one greedy answer."""
    from mmduet_tpu_torch.eval.offline_baseline import OfflineBaselineRunner

    frames = np.random.RandomState(0).randint(
        0, 256, (N_FRAMES, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    runner = OfflineBaselineRunner(params, cfg, tok, _args(max_new_tokens=16))
    runner.set_fps(2.0)
    _zero_counts()  # the baseline's path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = runner.answer(frames, QUERY)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _kernel_counts()  # and ends here
    cursor = runner.state.cursor
    k = kv_arr(runner.state.kv_cache.k)[:, 0, :, :cursor]
    if (not isinstance(text, str) or runner.tokens_generated <= 0
            or not bool(torch.isfinite(k).all()) or counts["attention"] <= 0
            or counts["attention"] % cfg.text.num_layers
            or counts["vision"] != 2 * (cfg.vision.num_layers - 1)):
        raise AssertionError(f"offline baseline: answer {text!r}, cursor {cursor}, launches "
                             f"{counts}")
    log(f"offline baseline (64 frames + question, {cursor - runner.tokens_generated + 1} "
        f"prompt rows in 256-row chunks): {dt:.3f} s for one answer of "
        f"{runner.tokens_generated} tokens; launches {counts}")
    return dt


def _serving_frames(resolution: int) -> np.ndarray:
    return np.random.RandomState(0).randint(
        0, 256, (N_FRAMES, resolution, resolution, 3), dtype=np.uint8)


def _record_triggers(engine) -> list:
    """Wrap ``engine._threshold_triggered`` to record every decision."""
    seen, fn = [], engine._threshold_triggered

    def wrapped(score):
        seen.append(fn(score))
        return seen[-1]

    engine._threshold_triggered = wrapped
    return seen


def clip_config(cfg):
    """``cfg`` with CLIP-L/14-336 in place of the SigLIP tower."""
    return cfg.replace(vision=ClipConfig(), vision_arch="clip", frame_token_cls=True,
                       frame_token_pooled=(7, 7), frame_num_tokens=50, frame_resolution=336)


def clip_model(cfg, params):
    """The serving model with CLIP-L/14-336 (`ClipConfig()`: 336 px, patch
    14, 1024 wide, 4096 MLP, 24 layers, 16 heads) in place of the SigLIP
    tower: CLS + 7 x 7 adaptive-pooled patches = 50 tokens a frame, a
    1024 -> 3584 projector; the 7B decoder tree is shared. Random bf16
    weights from seed 0, on the decoder's device: (cfg, tok, params)."""
    dev = params["lm_head"].device
    tok = CharTokenizer(frame_num_tokens=50, vocab_size=cfg.text.vocab_size)
    ccfg = clip_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    vh, h = ccfg.vision.hidden_size, ccfg.text.hidden_size

    def dense(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype) / math.sqrt(shape[0])

    dtype = params["lm_head"].dtype
    projector = {"fc1": dense(vh, h), "fc1_bias": torch.zeros(h, device=dev, dtype=dtype),
                 "fc2": dense(h, h), "fc2_bias": torch.zeros(h, device=dev, dtype=dtype)}
    vision = init_clip_params(ccfg.vision, gen, dev, dtype)
    return ccfg, tok, dict(params, vision=vision, projector=projector)


CLIP_TOWER_REL = 0.05  # the tower's output, kernel D against the plain version:
# 24 layers of bf16 activations, as `time_vision_routes` holds SigLIP's


def run_clip_path(cfg, params, log) -> dict:
    """The CLIP arch at published widths: ViT-L/14-336 and the 7B decoder
    stream the serving cell's 64 frames (at 336 px) through
    `LiveInferEngine` in generation mode (8-frame blocks, a query at t = 0)
    and in grounding mode (32-frame blocks), after `prewarm(vision=True)`
    at 336 px. Counts are set to 0 just before the passes and read just
    after: kernel D 24 launches a tower call, kernel A a multiple of 28.
    Then every attention of one 32-frame tower call is held against the
    plain version on the same inputs within D's bound, and the tower's
    output against the plain version put in the kernel's place from here.
    Each pass's peak memory is measured on its own (``mem``)."""
    # earlier phases' engines (their caches) hold reference cycles; the
    # SigLIP tower and its projector are not part of this configuration
    resident = _resident(budget.tree_bytes(params) - budget.tree_bytes(params["vision"])
                         - budget.tree_bytes(params["projector"]))
    ccfg, tok, cparams = clip_model(cfg, params)
    frames = _serving_frames(ccfg.frame_resolution)
    query = [{"role": "user", "content": QUERY, "time": 0.0}]

    def engine_for(name):
        return LiveInferEngine(cparams, ccfg, tok, _args(
            stream_end_score_sum_threshold=1.0, grounding_mode=name == "grounding"))

    engines = {"generation": engine_for("generation")}
    t0 = time.perf_counter()
    engines["generation"].prewarm(vision=True)
    log(f"CLIP-L/14-336 model: prewarm(vision=True) at 336 px in "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    stats, mems = {}, {}
    _zero_counts()  # the CLIP path starts here
    for name in ("generation", "grounding"):
        if name == "grounding":
            # the SigLIP tree and the generation engine are resident here
            resident = _resident(budget.tree_bytes(cparams))
            engines[name] = engine_for(name)
        engine = engines[name]
        torch.cuda.reset_peak_memory_stats()
        before = attention.LAUNCHES
        t0 = time.perf_counter()
        engine.input_video_stream(frames)
        torch.cuda.synchronize()
        t_vision = time.perf_counter() - t0
        engine.input_query_stream(query)
        responses = engine.inference()
        torch.cuda.synchronize()
        lat = engine.frame_latencies_ms
        stats[name] = dict(launches=attention.LAUNCHES - before, responses=responses,
                           fps=N_FRAMES / t_vision, p50=float(np.percentile(lat, 50)),
                           p90=float(np.percentile(lat, 90)))
        _check_pass(engine, f"CLIP {name}", stats[name]["launches"], responses, QUERY)
        mems[name] = _mem(resident, engine._graphs)
    counts = _kernel_counts()  # and ends here
    peak_gib = max(m["peak"] for m in mems.values()) / 2**30
    layers = ccfg.vision.num_layers
    want_d = 2 * _vision_batches(N_FRAMES) * layers
    if (counts["vision"] != want_d or counts["attention"] <= 0
            or counts["attention"] % ccfg.text.num_layers or counts["attention_int8"]
            or counts["int4_matmul"]):
        raise AssertionError(f"CLIP path: launches {counts}; want kernel D {want_d} (2 passes "
                             f"x {_vision_batches(N_FRAMES)} encodes x {layers} layers) and "
                             f"kernel A a multiple of {ccfg.text.num_layers}")
    for name, st in stats.items():
        log(f"CLIP-L/14-336 + 7B, {name} pass ({engines[name].block_frames}-frame blocks, "
            f"{N_FRAMES} frames at 336 px): per frame p50 {st['p50']:.3f} ms, p90 "
            f"{st['p90']:.3f} ms; vision {st['fps']:.2f} frames/s; {st['launches']} launches "
            f"of A; {sum(r['role'] == 'assistant' for r in st['responses'])} responses")
    log(f"CLIP path launches {counts}; peak device memory {peak_gib:.2f} GiB")
    tower = _check_clip_tower(ccfg, cparams, frames[:32], log)
    return dict(counts, peak_gib=peak_gib, mem=mems, tower=tower,
                **{f"{n}_{k}": st[k] for n, st in stats.items() for k in ("p50", "p90", "fps")})


def _check_clip_tower(ccfg, cparams, frames, log) -> dict:
    """One 32-frame CLIP tower call: each layer's kernel D output against
    the plain version on the same q, k, v within D's bound, the call timed,
    and the tower's output against the plain version's in the kernel's
    place (patched in from here: the package refuses it on the card)."""
    from mmduet_tpu_torch.models import clip

    dev = cparams["lm_head"].device
    px = mmduet.normalize_pixels(ccfg, torch.from_numpy(frames).to(dev)).to(
        cparams["lm_head"].dtype)
    kernel, ratios = siglip.flash_vision_attention, []

    def held(q, k, v):
        out = kernel(q, k, v)
        want = attention.flash_vision_attention_ref(q.float(), k.float(), v.float())
        ratios.append(bounds.full_attention_ratio(out, want, bounds.vision_attention_rms(q, k, v)))
        return out

    def tower():
        return clip.standalone_encode(cparams["vision"], ccfg.vision, px, True, (7, 7))

    with torch.inference_mode():
        got = tower()
        ms = _time_ms(tower, 3, warmup=1)
        siglip.flash_vision_attention = held
        try:
            tower()
            siglip.flash_vision_attention = attention.flash_vision_attention_ref
            plain = tower()
        finally:
            siglip.flash_vision_attention = kernel
    worst = max(ratios)
    diff = (got.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    if (len(ratios) != ccfg.vision.num_layers or not math.isfinite(worst) or worst > 1.0
            or got.shape != (len(frames), ccfg.frame_num_tokens, ccfg.vision.hidden_size)
            or not diff <= CLIP_TOWER_REL * scale):
        raise AssertionError(f"CLIP tower: {len(ratios)} attentions, at most {worst} of D's "
                             f"bound; output {tuple(got.shape)} vs the plain version max|diff| "
                             f"{diff} (max {scale})")
    log(f"CLIP tower, 32 frames: {ccfg.vision.num_layers} attentions each within D's bound "
        f"(at most {worst:.3f} of it); the output (CLS + 7 x 7) against the plain version in "
        f"the kernel's place max|diff| {diff:.4f} of max {scale:.2f} (<= {CLIP_TOWER_REL}); "
        f"{ms:.3f} ms a call ({32e3 / ms:.2f} frames/s)")
    return {"ms": ms, "worst_ratio": worst}


FEATURE_TOL = SMALL_TOL  # grounding scores from features against pixels: the
# projector and pooling run at 64 frames where the pixel route runs 32


def run_extraction(cfg, params, log) -> dict:
    """Offline feature extraction at full width: the SigLIP-so400m tower of
    the bf16 model through `preprocess._encode_frames` on the 64 serving
    frames, 32 at a time. Bit-equal to the engine's tower output on the same
    32-frame batches; a grounding pass over `input_vision_feats` of them
    gives the pixel route's times and triggers, its scores within
    FEATURE_TOL; the ``--bf16`` file read back through `load_features`."""
    frames = _serving_frames(cfg.frame_resolution)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens, vocab_size=cfg.text.vocab_size)
    query = [{"role": "user", "content": QUERY, "time": 0.0}]
    args = _args(stream_end_score_sum_threshold=1.0, grounding_mode=True)
    pixel, feat = (LiveInferEngine(params, cfg, tok, args) for _ in range(2))
    triggers = [_record_triggers(e) for e in (pixel, feat)]

    towers, encode = [], siglip.siglip_encode

    def recorded(*a, **k):  # the engine's tower output, batch by batch
        towers.append(encode(*a, **k))
        return towers[-1]

    siglip.siglip_encode = recorded
    try:
        pixel.input_video_stream(frames)
    finally:
        siglip.siglip_encode = encode
    pixel.input_query_stream(query)
    pixel.inference()

    preprocess._encode_frames(frames[:32], params["vision"], cfg.vision)  # warm-up
    torch.cuda.synchronize()
    _zero_counts()  # the extraction path starts here
    t0 = time.perf_counter()
    feats = preprocess._encode_frames(frames, params["vision"], cfg.vision, batch_size=32)
    dt = time.perf_counter() - t0
    counts = _kernel_counts()  # and ends here
    want = torch.cat(towers).float().cpu().numpy()
    if (counts["vision"] != _vision_batches(N_FRAMES) * (cfg.vision.num_layers - 1)
            or feats.dtype != np.float32 or not np.array_equal(feats, want)):
        raise AssertionError(f"extraction: launches {counts}, features {feats.dtype} "
                             f"{feats.shape} bit-equal to the engine's tower: "
                             f"{np.array_equal(feats, want)}")
    feat.input_vision_feats(feats)
    feat.input_query_stream(query)
    feat.inference()
    times = [[d["time"] for d in e.debug_data_list] for e in (pixel, feat)]
    diff = max(abs(a[k] - b[k]) for a, b in zip(pixel.debug_data_list, feat.debug_data_list)
               for k in ("informative_score", "relevance_score"))
    if times[0] != times[1] or len(times[0]) != N_FRAMES or triggers[0] != triggers[1] \
            or not diff <= FEATURE_TOL:
        raise AssertionError(f"extraction: features route vs pixels: times equal "
                             f"{times[0] == times[1]}, triggers equal {triggers[0] == triggers[1]}"
                             f", scores max|diff| {diff}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="features.", dir=_build.BUILD_DIR)
    try:
        path = os.path.join(tmp, "video.npy")
        preprocess.write_bf16_npy(path, feats)
        size = os.path.getsize(path)
        back = preprocess.load_features(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the features of a bf16 tower are bf16 values: they come back exactly
    if not np.array_equal(back, torch.from_numpy(feats).bfloat16().float().numpy()):
        raise AssertionError("extraction: the bf16 file read back differs from the features")
    log(f"feature extraction (SigLIP-so400m, bf16 on the card, batches of 32): {N_FRAMES} "
        f"frames in {dt:.3f} s = {N_FRAMES / dt:.2f} frames/s, {feats.nbytes / 1e6:.1f} MB of "
        f"f32 features to the host; bit-equal to the engine's tower; launches {counts}; "
        f"grounding over input_vision_feats: times and {sum(triggers[1])} triggers of "
        f"{len(triggers[1])} equal, scores max|diff| {diff:.3e} (<= {FEATURE_TOL}); the --bf16 "
        f"file ({size / 1e6:.1f} MB) read back equal")
    return {"frames_per_s": N_FRAMES / dt, "diff": diff}


def run_demo(cfg, params, log) -> dict:
    """The live demo at full width: the 7B bf16 engine as
    `LiveInferForDemo` (as `demo/app.py` makes it), `prewarm(vision=True)`,
    then a `DemoState(realtime=False)` thread over the 64 serving frames
    behind `make_handler` on a local `ThreadingHTTPServer`. The loop pauses
    after frame 32; a query is sent through ``/query`` and ``/resume`` (so
    it reaches `encode_given_query` mid-stream), and ``/state`` is read
    until it reports the last frame."""
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens, vocab_size=cfg.text.vocab_size)
    engine = LiveInferEngine(params, cfg, tok, _args(max_new_tokens=8,
                                                     stream_end_score_sum_threshold=1.0))
    engine.__class__ = LiveInferForDemo
    engine.prewarm(vision=True)
    state = DemoState(engine, _serving_frames(cfg.frame_resolution), fps=2.0, realtime=False)
    step_ms, rows, one_frame = [], [], engine.input_one_frame

    def timed_frame():
        t0 = time.perf_counter()
        out = one_frame()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(out)
        if len(step_ms) == N_FRAMES // 2:
            state.pause_event.clear()  # as typing in the page's chat box does
        return out

    engine.input_one_frame = timed_frame
    failed = []

    def run():
        try:
            state.run()
        except BaseException as e:  # reported by the main thread below
            failed.append(e)
            state.done = True

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    threads = [threading.Thread(target=server.serve_forever, daemon=True),
               threading.Thread(target=run, daemon=True)]
    port = server.server_address[1]

    def get(path):
        return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                                 timeout=30).read())

    _zero_counts()  # the demo's path starts here
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        deadline, polls, asked = time.perf_counter() + 300, 0, False
        while True:
            snap = get("/state")
            polls += 1
            if failed or (snap["done"] and len(snap["informative"]) == N_FRAMES):
                break
            if not asked and snap["paused"] and len(snap["informative"]) == N_FRAMES // 2:
                get("/query?text=" + urllib.parse.quote(QUERY))
                get("/resume")
                asked = True
            if time.perf_counter() > deadline:
                raise AssertionError(f"demo: /state after 300 s: {len(snap['informative'])} "
                                     f"frames, paused {snap['paused']}")
            time.sleep(0.02)
        threads[1].join(timeout=60)
    finally:
        server.shutdown()
        server.server_close()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()  # and ends here
    if failed:
        raise failed[0]
    chat = snap["chat"]
    users = [m for m in chat if m["role"] == "user"]
    # the chat lists the non-empty answers (`DemoState.run`); the char
    # tokenizer decodes most of a random 7B model's tokens to nothing
    triggered = [r for r in rows[:N_FRAMES] if r["response"] is not None]
    answers = [{"role": "assistant", "content": r["response"], "time": r["time"]}
               for r in triggered if r["response"]]
    scores = snap["informative"] + snap["relevance"]
    if (threads[1].is_alive() or len(step_ms) != N_FRAMES + 1 or rows[-1] is not None
            or not asked
            or [r["frame_idx"] for r in rows[:N_FRAMES]] != list(range(1, N_FRAMES + 1))
            or users != [{"role": "user", "content": QUERY, "time": N_FRAMES // 2 / 2.0}]
            or [m for m in chat if m["role"] == "assistant"] != answers
            or not triggered or engine.tokens_generated <= 0
            or not all(math.isfinite(x) and 0 <= x <= 1 for x in scores)
            or counts["vision"] != _vision_batches(N_FRAMES) * (cfg.vision.num_layers - 1)
            or counts["attention"] <= 0 or counts["attention"] % cfg.text.num_layers):
        raise AssertionError(f"demo: {len(step_ms)} steps, query sent {asked}, chat {chat}, "
                             f"launches {counts}")
    frames_ms = step_ms[:N_FRAMES]
    log(f"demo (LiveInferForDemo, 7B bf16, {N_FRAMES} frames, paused at frame "
        f"{N_FRAMES // 2} for a query through /query + /resume): input_one_frame p50 "
        f"{np.percentile(frames_ms, 50):.3f} ms, p90 {np.percentile(frames_ms, 90):.3f} ms, "
        f"max {max(frames_ms):.3f} ms; {len(triggered)} triggers (at "
        f"{[r['time'] for r in triggered]} s), {engine.tokens_generated} tokens generated, "
        f"{len(answers)} non-empty answers in the chat; {polls} reads of /state over "
        f"{wall:.3f} s; launches {counts}")
    return {"p50": float(np.percentile(frames_ms, 50)),
            "p90": float(np.percentile(frames_ms, 90))}


def quantize_on_card(params, log):
    """The 7B-width tree's decoder, embedding and LM head to group-128 int4
    on the card, leaf by leaf (``donate``: each bf16 leaf is freed as it is
    converted, so the dense tree is gone afterwards)."""
    dense = quant.param_bytes(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = quant.quantize_params(params, bits=4, donate=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    torch.cuda.empty_cache()
    served = sum(quant.param_bytes(params[k]) for k in ("decoder", "lm_head"))
    log(f"quantize_params(bits=4) on the card in {dt:.1f} s: decoder + embedding + LM head "
        f"{served / 1e9:.3f} GB, the whole tree {quant.param_bytes(params) / 1e9:.3f} GB "
        f"(bf16: {dense / 1e9:.3f} GB); {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    if not 3.5e9 < served < 4.5e9:
        raise AssertionError(f"int4 decoder + embedding + LM head take {served} bytes")
    return params


# --- tensor-parallel serving: two ranks of a (1, 2) process mesh on the one
# card, over gloo (NCCL refuses two ranks on one device). They measure
# correctness and each rank's memory, not a speedup across cards.

TP_RANKS = 2
# kernel B at the shapes a rank of a (1, 2) mesh gives it (H, O): q_proj,
# k/v_proj, o_proj, gate/up_proj, down_proj, the LM head
TP_INT4_SHAPES = ((3584, 1792), (3584, 256), (1792, 3584), (3584, 9472), (9472, 3584),
                  (3584, 76032))
TP_INT4_ROWS = (1, 392, 1568)
TP_CACHE_LENS = (0, 2047, 2048, 24000)
# kernel D at a rank's 8 of 16 heads: SigLIP-so400m and CLIP-L/14-336
TP_VISION_SHAPES = ((32, 729, 8, 72), (32, 577, 8, 64))
TP_SCORE_TOL = 2e-2  # per-frame score probability, a rank against one process, bf16:
# the floor of the bound; the bound is the larger of it and twice the one
# process's own spread under a reordered sum (`spread_under_permuted_mlp`)
TP_MARGIN_TOL = 0.5  # a differing token is a near tie: the one process's top-2 logits
# were closer than this at the first token that differs
TP_BATCH_SESSIONS, TP_BATCH_FRAMES = 10, (16, 33)
# kernel C at a rank's 14 of 28 query heads over 2 of 4 kv heads, one sample
# of the 2944-token bucket (the training mesh's (2, 2) layout)
TP_FULL_CASES = ((2944, (2700,), "right"),)


def check_tp_kernels(log) -> dict:
    """Kernels A (bf16 and int8 cache), B, C and D held against their plain
    versions, and timed beside their bounds, at the shapes each rank of a
    (x, 2) mesh gives them: A and C at 14 query heads over 2 kv heads, B at
    the six local weight shapes, D at 8 of 16 heads; and A at a (1, 4)
    rank's 7 query heads over 1 kv head. Returns the numbers for the kernels
    line."""
    tp_log = lambda msg: log(f"rank-local shapes of a (1, {TP_RANKS}) mesh: {msg}")  # noqa: E731
    dec, dec_int8 = check_attention_kernel(tp_log, nh=14, kh=2, cache_lens=TP_CACHE_LENS)
    dec4, dec4_int8 = check_attention_kernel(
        lambda msg: log(f"rank-local shapes of a (1, 4) mesh: {msg}"), nh=7, kh=1,
        cache_lens=TP_CACHE_LENS)
    worst, worst_ratio, b_timed = check_int4_shapes(tp_log, TP_INT4_SHAPES, TP_INT4_ROWS, seed=13)
    tp_log(f"int4_matmul: {len(TP_INT4_SHAPES) * len(TP_INT4_ROWS)} cases within the bound "
           f"(max|diff| {worst}, at most {worst_ratio:.4f} of it)")
    d_worst, d_ratio, d_timed = check_vision_shapes(
        tp_log, TP_VISION_SHAPES, {TP_VISION_SHAPES[0]: "", TP_VISION_SHAPES[1]: "clip336_"},
        seed=16)
    tp_log(f"flash_vision: {len(TP_VISION_SHAPES)} shapes within the bound (max|diff| "
           f"{d_worst}, at most {d_ratio:.3f} of it)")
    c_fwd, c_bwd = check_full_attention_kernel(tp_log, nh=14, kh=2, cases=TP_FULL_CASES)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "full_fwd": {"heads": [14, 2], **{k: c_fwd[k] for k in keys}},
        "full_bwd": {"heads": [14, 2], **{k: c_bwd[k] for k in keys}},
        "attention": {"heads": [14, 2], **{k: dec[k] for k in keys}},
        "attention_int8": {"heads": [14, 2], **{k: dec_int8[k] for k in keys}},
        "attention_1x4": {"heads": [7, 1], **{k: dec4[k] for k in keys}},
        "attention_int8_1x4": {"heads": [7, 1], **{k: dec4_int8[k] for k in keys}},
        "int4_matmul": {"max_abs_err": worst, "shapes": [
            {"H": H, "O": O, "rows": R, **t} for ((H, O), R), t in b_timed.items()]},
        "vision": {"max_abs_err": d_worst, "shape": list(TP_VISION_SHAPES[0]), **d_timed},
    }


TP_LENGTHS = tuple(int(n) for n in
                   np.random.RandomState(9).randint(*TP_BATCH_FRAMES, TP_BATCH_SESSIONS))


def _tp_session(cfg, i: int) -> dict:
    """Session ``i`` of the TP batched pass: random post-projector frame
    embeddings from a seed (the tower runs in the streaming passes), one
    query at t = 0."""
    g = torch.Generator().manual_seed(200 + i)
    embeds = 0.05 * torch.randn((TP_LENGTHS[i], cfg.frame_num_tokens, cfg.text.hidden_size),
                                generator=g)
    return {"frame_embeds": embeds.to(torch.bfloat16), "fps": 2.0,
            "conversation": [{"role": "user", "content": QUERY, "time": 0.0}]}


def run_tp_batched(cfg, tok, params, log, mesh=None) -> dict:
    """`BatchedStreamEngine.serve()` of the `_tp_session`s through 8 lanes
    in generation mode: per session its scores and answers, with the pass's
    counts, wall time and peak memory. ``mesh``: this rank's process mesh;
    kernel A launches once a layer per decoder forward of its lanes, and
    each session is made on one rank and shared (`mesh_sessions`)."""
    resident = _resident(budget.tree_bytes(params))
    engine = BatchedStreamEngine(
        params, cfg, tok, _args(BATCH_MAX_NEW, stream_end_score_sum_threshold=2.0),
        n_streams=BATCH_LANES, mesh=mesh, gen_coalesce_rounds=1)
    lo, hi = lane_block(mesh, BATCH_LANES)
    made, held, shared = functools.partial(_tp_session, cfg), [], {}
    sessions = (mesh_sessions(made, TP_BATCH_SESSIONS, mesh, held, shared)
                if isinstance(mesh, ProcessMesh) else [made(i) for i in range(TP_BATCH_SESSIONS)])
    acc, fed = {}, []
    _timed(engine, "_dispatch_sched", acc)
    _timed(engine, "_generate_batch", acc)
    sched = engine._dispatch_sched
    engine._dispatch_sched = lambda chunks: (fed.append(sum(c[2] for c in chunks.values()))
                                             or sched(chunks))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with TokenRecorder(tok.eos_token_id, owners=lambda: engine._lane_sess[lo:hi]) as rec:
        results = {i: (resp, debug) for i, resp, debug in engine.serve(sessions)}
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    n_frames = sum(TP_LENGTHS)
    out = _session_rows(results, rec)
    if len(out) != TP_BATCH_SESSIONS or any(len(out[str(i)]["scores"]) != n
                                            for i, n in enumerate(TP_LENGTHS)):
        raise AssertionError("TP batched pass: a session retired without its score rows")
    if (counts["attention"] != cfg.text.num_layers * engine.forwards
            or counts["attention_sharded"] or counts["vision"]):
        raise AssertionError(f"batched serve (mesh {dict(mesh.shape) if mesh else None}, lanes "
                             f"{lo}-{hi - 1}): launches {counts}; want kernel A "
                             f"{cfg.text.num_layers} x {engine.forwards} decoder forwards, no "
                             "A' shards, no vision")
    if shared:
        record_shared(held, shared, f"TP batched pass, rank {mesh.coords}", log)
    log(f"batched serve at B={BATCH_LANES} (mesh {dict(mesh.shape) if mesh else None}, lanes "
        f"{lo}-{hi - 1}): {TP_BATCH_SESSIONS} sessions, {n_frames} frames in {wall:.3f} s = "
        f"{n_frames / wall:.2f} frames/s, {engine.tokens_generated} tokens; launches {counts} "
        f"= {cfg.text.num_layers} x {engine.forwards} forwards ({engine.dispatches} dispatches, "
        f"{engine.decodes} decodes of {engine.decode_lanes / max(engine.decodes, 1):.2f} lanes "
        "on average)")
    mem = _mem(resident, engine._graphs)
    numbers = {"frames_per_s": n_frames / wall, "peak_gib": mem["peak"] / 2**30,
               "mem": {"serve": mem},
               "dispatch_ms_per_frame": 1e3 * acc["_dispatch_sched"] / sum(fed),
               "decode_tokens_per_s": engine.tokens_generated / acc["_generate_batch"],
               "dispatches": engine.dispatches,
               "decode_lanes_mean": engine.decode_lanes / max(engine.decodes, 1),
               "forwards": engine.forwards, "shared": shared}
    for name in ("_dispatch_sched", "_generate_batch"):
        delattr(engine, name)
    del engine, sched
    torch.cuda.empty_cache()
    return {"sessions": out, "counts": counts, **numbers}


def spawn_ranks(target, world: int, out_dir: str, extra: tuple, timeout: float,
                what: str) -> list:
    """``world`` spawned processes of ``target(rank, port, out_dir,
    *extra)`` (one free port on 127.0.0.1 for their group), each writing
    ``out_dir/rank<r>.json``; their results in rank order. A rank that
    fails, or outlives ``timeout`` seconds, fails the phase; every rank is
    stopped at the end."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=target, args=(r, port, out_dir, *extra)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{what}: rank exit codes {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def tp_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of the TP phase (a spawned process): joins the gloo group,
    builds its shard of the 7B-width model (seed 0, the weights of the one
    process's run; the ranks build one after the other, each freeing the
    whole tree before the next builds it), runs the bf16 passes, the
    batched pass, then its shard quantized to int4 with an int8 cache, and
    writes its results to ``out_dir/rank<r>.json``."""
    from mmduet_tpu_torch.parallel import initialize_distributed, shard_params

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(TP_RANKS), LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(f"[TP rank {rank}/{TP_RANKS}] {msg}", flush=True)

    initialize_distributed("gloo")
    mesh = make_mesh((1, TP_RANKS), device="cuda:0")  # both ranks share the one card
    dist = torch.distributed
    cfg, tok = full_width_config()
    params = None
    for turn in range(TP_RANKS):
        if turn == rank:
            whole = init_mmduet_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                       torch.device("cuda"), torch.bfloat16)
            params = shard_params(whole, mesh)
            del whole
            torch.cuda.empty_cache()
        dist.barrier()
    log(f"local tree: {quant.param_bytes(params) / 1e9:.3f} GB on {mesh.device}")
    torch.cuda.reset_peak_memory_stats()
    dense = run_main_path(cfg, tok, params, log, mesh=mesh)
    batched = run_tp_batched(cfg, tok, params, log, mesh=mesh)
    params = quant.quantize_params(params, bits=4, donate=True)
    torch.cuda.empty_cache()
    quantized = run_main_path(cfg, tok, params, log, kv_cache_quant="int8", mesh=mesh)
    result = {"dense": dense, "quantized": quantized, "batched": batched}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()  # no rank leaves while another reads its last collective
    dist.destroy_process_group()


def compare_tp_pass(name: str, got: dict, want: dict, log, tol: float = TP_SCORE_TOL,
                    margin_tol: float = TP_MARGIN_TOL) -> float:
    """A rank's pass against the one process's: per-frame scores within
    ``tol`` up to the first answer that differs (after it the two streams
    hold different tokens). An answer may differ two ways: at another frame
    (a trigger: the scores up to it are held), or in its text, where the
    first greedy step that differs must be a near tie, the one process's
    top-2 logits closer than ``margin_tol`` (another order of an f32 sum
    can flip it). Returns the largest score difference."""
    upto, what = len(want["scores"]), "equal"
    pairs = list(zip(got["answers"], want["answers"]))
    index = next((i for i, (g, w) in enumerate(pairs) if g != w), None)
    if index is None and len(got["answers"]) != len(want["answers"]):
        index = len(pairs)
    if index is not None:
        times = [x[index][0] for x in (got["answers"], want["answers"]) if index < len(x)]
        upto = int(round(min(times) * 2.0)) + 1  # the frames up to the answer, at 2 fps
        if index < len(pairs) and pairs[index][0][0] == pairs[index][1][0]:
            steps = next((i for i, (g, w) in enumerate(zip(got["steps"], want["steps"]))
                          if g[0] != w[0]), None)
            if steps is None:
                raise AssertionError(f"TP {name}: answer {index} differs, no greedy step does")
            margin = want["steps"][steps][1]
            what = (f"answer {index} differs in its text ({pairs[index][0][1]!r} against "
                    f"{pairs[index][1][1]!r}); its first differing greedy step, {steps}, is "
                    f"where the one process's top-2 logits are {margin:.4f} apart (the rank's "
                    f"{got['steps'][steps][1]:.4f})")
            if margin > margin_tol:
                raise AssertionError(f"TP {name}: {what}, more than {margin_tol}")
        else:
            what = (f"answer {index} comes at another frame ("
                    f"{[x[index][0] if index < len(x) else None for x in (got['answers'], want['answers'])]}"
                    " s): a trigger, held through the scores before it")
    g, w = np.asarray(got["scores"][:upto]), np.asarray(want["scores"][:upto])
    if g.shape != w.shape:
        raise AssertionError(f"TP {name}: {g.shape} score rows against {w.shape}")
    worst = float(np.abs(g - w).max()) if g.size else 0.0
    log(f"TP {name}: {upto} frames' scores within {worst:.3g} of the one process's "
        f"(bound {tol:.3g}); answers {what}")
    if not worst <= tol:
        raise AssertionError(f"TP {name}: a per-frame score differs by {worst} > {tol}")
    return worst


class permuted_mlp:
    """While entered, the MLP's intermediate units of every layer are in
    another order (gate and up columns, down rows, by one seeded
    permutation): the same function, the down projection's sums over its
    inputs in another order. That is the kind of difference a rank's
    partial sums make, so the one process's scores under it measure how
    far bf16 rounding alone moves them at this width. With ``tower`` the
    vision tower's MLP units are permuted too (fc1 and its bias, fc2 rows;
    a permutation of their own), as a rank's partial sums reorder the
    tower's under tensor parallelism. ``perm`` / ``inv`` are the
    decoder's."""

    def __init__(self, params, seed: int = 5, tower: bool = False):
        stacks = [(params["decoder"]["layers"], ("gate_proj", "up_proj"), "down_proj")]
        if tower:
            stacks.append((params["vision"]["layers"], ("fc1", "fc1_bias"), "fc2"))
        self.stacks = []
        for i, (layers, cols, rows) in enumerate(stacks):
            n = layers[rows].shape[1]
            perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed + i)).to(
                layers[rows].device)
            self.stacks.append((layers, cols, rows, perm, torch.argsort(perm)))
        self.perm, self.inv = self.stacks[0][3:]

    def _apply(self, which: int):
        with torch.no_grad():
            for layers, cols, rows, *perms in self.stacks:
                perm = perms[which]
                for i in range(layers[rows].shape[0]):
                    for name in cols:
                        layers[name][i].copy_(layers[name][i][..., perm])
                    layers[rows][i].copy_(layers[rows][i][perm])

    def __enter__(self):
        self._apply(0)
        return self

    def __exit__(self, *exc):
        self._apply(1)


def spread_under_permuted_mlp(cfg, tok, params, log, dense: dict, batched: dict) -> float:
    """The one process's largest per-frame score difference between its
    runs (``dense``'s two passes, ``batched``) and the same runs under
    `permuted_mlp`: the rounding-only spread the TP bound is scaled by."""
    with permuted_mlp(params):
        again = run_main_path(cfg, tok, params, log)
        again_b = run_tp_batched(cfg, tok, params, log)
    unbounded = dict(tol=math.inf, margin_tol=math.inf)  # measured, not held
    worst = [compare_tp_pass(f"rounding spread, {p} (one process, MLP permuted)",
                             again["passes"][p], dense["passes"][p], log, **unbounded)
             for p in ("generation", "grounding")]
    worst += [compare_tp_pass(f"rounding spread, batched session {i} (one process, MLP "
                              "permuted)", again_b["sessions"][i], sess, log, **unbounded)
              for i, sess in batched["sessions"].items()]
    log(f"the one process's score spread under a permuted MLP: at most {max(worst):.4g}")
    return max(worst)


def run_tp_phase(log, dense: dict, quantized: dict, batched_ref: dict, spread: float) -> dict:
    """Two ranks on the one card, started here (spawned); each rank's
    passes against the one process's runs of this script (``dense``,
    ``quantized``, ``batched_ref``), with scores within the larger of
    TP_SCORE_TOL and twice the one process's own rounding ``spread``, and
    the ranks' rows against each other. A rank that fails fails the phase;
    both are stopped at the end."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="tp.", dir=_build.BUILD_DIR)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank, TP_RANKS, out_dir, (), TP_TIMEOUT_S, "TP phase")
    shutil.rmtree(out_dir)
    wall = time.perf_counter() - t0

    def rows(x):
        return {run: {p: {k: v for k, v in x[run]["passes"][p].items()
                          if k in ("scores", "answers", "steps")} for p in x[run]["passes"]}
                for run in ("dense", "quantized")} | {"batched": x["batched"]["sessions"]}

    if any(rows(x) != rows(ranks[0]) for x in ranks[1:]):
        raise AssertionError("TP phase: the ranks' rows differ")
    log(f"TP phase: {TP_RANKS} ranks in {wall:.1f} s; both ranks' scores, answers and greedy "
        "steps are the same bits")
    check_digests(ranks, "TP phase, batched pass", log, "batched", "shared")
    r0 = ranks[0]
    tol = max(TP_SCORE_TOL, 2 * spread)
    worst, failed = {}, []
    pairs = [(f"{run} {p}", r0[run]["passes"][p], ref["passes"][p])
             for run, ref in (("dense", dense), ("quantized", quantized))
             for p in ("generation", "grounding")]
    pairs += [(f"batched session {i}", r0["batched"]["sessions"][i], sess)
              for i, sess in batched_ref["sessions"].items()]
    for name, got, want in pairs:
        try:  # every comparison is printed before the first failure is raised
            worst[name] = compare_tp_pass(name, got, want, log, tol=tol)
        except AssertionError as e:
            failed.append(e)
    if failed:
        raise failed[0]
    layers, v_layers = 28, 26
    for r, x in enumerate(ranks):
        for run in ("dense", "quantized"):
            c = {k: x[run][k] for k in ("attention", "attention_int8", "attention_sharded",
                                        "vision", "int4_matmul")}
            if c["attention_sharded"] or c["vision"] != v_layers * 4 or c["attention"] % layers:
                raise AssertionError(f"TP rank {r} {run}: launches {c}; want kernel A launched "
                                     f"directly (no A' shards), {v_layers} x 4 of kernel D")
            log(f"TP rank {r} {run}: launches {c} (kernel A {c['attention'] // layers} times a "
                f"layer); generation p50 / p90 {x[run]['passes']['generation']['p50_ms']:.3f} / "
                f"{x[run]['passes']['generation']['p90_ms']:.3f} ms per frame, grounding "
                f"{x[run]['passes']['grounding']['p50_ms']:.3f} / "
                f"{x[run]['passes']['grounding']['p90_ms']:.3f}; decode "
                f"{x[run]['decode_tokens_per_s']:.2f} tokens/s; peak {x[run]['peak_gib']:.2f} GiB")
        sh = x["batched"]["shared"]
        log(f"TP rank {r} batched: {x['batched']['frames_per_s']:.2f} frames/s, peak "
            f"{x['batched']['peak_gib']:.2f} GiB, launches {x['batched']['counts']}; sessions "
            f"made here {sh['fetched']} of {TP_BATCH_SESSIONS}, shared bytes sent {sh['sent']}, "
            f"received {sh['received']}")
    return {"ranks": ranks, "worst": worst, "wall_s": wall, "tol": tol}


TP_TIMEOUT_S = 600


# --- the serving data axis: lanes over the data ranks of a process mesh on
# the one card, over gloo. Each data rank holds its block of the 8 lanes
# (its cache, frame buffer and penalty rows) and encodes its own lanes'
# frames; a dispatch's probabilities and a decode's rows are gathered over
# the host. The ranks measure correctness and memory a rank, not a speedup.

DP_MESH = (2, 1)  # all 28 layers: phase 6's sessions, bf16 and int8 caches, the scorer
DP_TP_MESH, DP_TP_LAYERS = (2, 2), 2  # four ranks at the 7B widths, the TP batched sessions
DP_TIMEOUT_S = 420


def dp_model(layers: int, dev):
    """(cfg, tok, params): the default MMDuetConfig cut to ``layers``
    decoder layers, random bf16 weights from seed 0 on ``dev``."""
    cfg, tok = full_width_config()
    if layers != cfg.text.num_layers:
        cfg = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=layers))
    return cfg, tok, init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                        torch.bfloat16)


def dp_rank(rank: int, port: int, out_dir: str, shape: tuple, layers: int) -> None:
    """One rank of the data-axis phase (a spawned process): joins the gloo
    group, builds the model of ``layers`` layers (seed 0; the ranks build
    one after the other, each freeing the whole tree before the next
    builds it) and keeps its ``shard_params(mode="replicate")`` tree; on
    DP_MESH runs the batched path with the bf16 cache (serve and the
    scorer) and with the int8 cache (serve), otherwise the TP batched
    pass; writes its results to ``out_dir/rank<r>.json``."""
    from mmduet_tpu_torch.parallel import initialize_distributed, shard_params

    world = shape[0] * shape[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(f"[DP rank {rank} of {shape}] {msg}", flush=True)

    initialize_distributed("gloo")
    mesh = make_mesh(shape, device="cuda:0")  # every rank shares the one card
    dist = torch.distributed
    params = None
    for turn in range(world):
        if turn == rank:
            cfg, tok, whole = dp_model(layers, torch.device("cuda"))
            params = shard_params(whole, mesh, mode="replicate")
            del whole
            torch.cuda.empty_cache()
        dist.barrier()
    log(f"local tree: {quant.param_bytes(params) / 1e9:.3f} GB on {mesh.device}, lanes "
        f"{lane_block(mesh, BATCH_LANES)}")
    t0 = time.perf_counter()
    if shape == DP_MESH:
        result = {"bf16": run_batched_path(cfg, tok, params, log, mesh=mesh),
                  "int8": run_batched_path(cfg, tok, params, log, mesh=mesh,
                                           kv_cache_quant="int8", grounding=False)}
        for run in result.values():
            del run["results"]  # its rows are in "sessions"
    else:
        result = {"batched": run_tp_batched(cfg, tok, params, log, mesh=mesh)}
    result.update(wall_s=time.perf_counter() - t0, coords=list(mesh.coords),
                  lanes=list(lane_block(mesh, BATCH_LANES)))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()  # no rank leaves while another reads its last collective
    dist.destroy_process_group()


def dp_launch(shape: tuple, layers: int) -> list:
    """The ranks of ``shape``, spawned on the one card; their results. A
    rank that fails fails the phase; all are stopped at the end."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="dp.", dir=_build.BUILD_DIR)
    torch.cuda.empty_cache()
    out = spawn_ranks(dp_rank, shape[0] * shape[1], out_dir, (shape, layers), DP_TIMEOUT_S,
                      f"data-axis phase {shape}")
    shutil.rmtree(out_dir)
    return out


def _dp_rows(ranks: list, runs: tuple, what: str) -> dict:
    """The rows every rank must hold bit for bit (each run's sessions'
    scores and answers, and the scorer's rows), with each session's greedy
    steps taken from the data rank whose lanes held it (a rank records
    the decodes of its own lanes only)."""
    def rows(x):
        return {run: ({i: {k: s[k] for k in ("scores", "answers")}
                       for i, s in x[run]["sessions"].items()}, x[run].get("rows"))
                for run in runs}

    if any(rows(x) != rows(ranks[0]) for x in ranks[1:]):
        raise AssertionError(f"data-axis phase {what}: the ranks' rows differ")
    out = {}
    for run in runs:
        out[run] = {i: dict(s, steps=[st for x in ranks if x["coords"][1] == 0
                                      for st in x[run]["sessions"][i]["steps"]])
                    for i, s in ranks[0][run]["sessions"].items()}
    return out


def _dp_compare(name: str, got: dict, want: dict, log, tol: float) -> float:
    """Every session of a rank's pass against the one process's
    (`compare_tp_pass`); every comparison is printed before the first
    failure is raised. Returns the largest score difference."""
    worst, failed = 0.0, []
    for i, sess in want.items():
        try:
            worst = max(worst, compare_tp_pass(f"{name} session {i}", got[i], sess, log,
                                               tol=tol))
        except AssertionError as e:
            failed.append(e)
    if failed:
        raise failed[0]
    return worst


def _dp_log_ranks(ranks: list, runs: tuple, log) -> None:
    for r, x in enumerate(ranks):
        for run in runs:
            y = x[run]
            log(f"DP rank {r} {tuple(x['coords'])} lanes {x['lanes'][0]}-{x['lanes'][1] - 1}, "
                f"{run}: peak {y['peak_gib']:.2f} GiB; {y['frames_per_s']:.2f} frames/s "
                f"aggregate, {y['dispatch_ms_per_frame']:.3f} ms per frame fed; decode "
                f"{y['decode_tokens_per_s']:.2f} tokens/s; {y['dispatches']} dispatches, "
                f"{y['forwards']} forwards here, {y['decode_lanes_mean']:.2f} lanes a decode; "
                f"launches {y['counts']}; sessions made here {y['shared']['fetched']}, shared "
                f"bytes sent {y['shared']['sent']}, received {y['shared']['received']}")


def run_dp_phase(log, ref: dict, tol: float) -> dict:
    """The serving data axis: DP_MESH's two ranks at full depth against
    the one process's batched runs of phase 6 (``ref``: bf16 sessions and
    scorer rows, int8 sessions), scores within ``tol`` (the TP phase's
    bound); then DP_TP_MESH's four ranks at DP_TP_LAYERS layers against
    the one process's TP batched pass on the same cut model, within the
    larger of TP_SCORE_TOL and twice its own spread under a permuted MLP.
    Each rank's launches were held by the passes themselves (kernel A a
    layer per forward of its lanes, no A' shards, kernel D per vision
    batch of its lanes' sessions)."""
    t0 = time.perf_counter()
    ranks = dp_launch(DP_MESH, MMDuetConfig().text.num_layers)
    got = _dp_rows(ranks, ("bf16", "int8"), str(DP_MESH))
    for path in (("bf16", "shared"), ("bf16", "shared_scorer"), ("int8", "shared")):
        check_digests(ranks, f"data-axis phase {DP_MESH}, {' '.join(path)}", log, *path)
    log(f"data-axis phase {DP_MESH}: {len(ranks)} ranks in {time.perf_counter() - t0:.1f} s; "
        "every rank's scores, answers and scorer rows are the same bits")
    worst = {run: _dp_compare(f"DP {DP_MESH} {run}", got[run], ref[run]["sessions"], log, tol)
             for run in ("bf16", "int8")}
    rows = ranks[0]["bf16"]["rows"]
    worst["grounding"] = max(compare_tp_pass(
        f"DP {DP_MESH} scorer lane {b}",
        {"scores": [[d["informative_score"], d["relevance_score"]] for d in g],
         "answers": [], "steps": []},
        {"scores": [[d["informative_score"], d["relevance_score"]] for d in w],
         "answers": [], "steps": []}, log, tol=tol)
        for b, (g, w) in enumerate(zip(rows, ref["bf16"]["rows"])))
    _dp_log_ranks(ranks, ("bf16", "int8"), log)

    t1 = time.perf_counter()
    cfg, tok, params = dp_model(DP_TP_LAYERS, torch.device("cuda"))
    log(f"data-axis phase {DP_TP_MESH}: the decoder cut to {DP_TP_LAYERS} of 28 layers at "
        "the 7B widths (four ranks share the card)")
    one = run_tp_batched(cfg, tok, params, log)
    with permuted_mlp(params):
        again = run_tp_batched(cfg, tok, params, log)
    spread = _dp_compare(f"rounding spread, {DP_TP_LAYERS} layers (one process, MLP permuted)",
                         again["sessions"], one["sessions"], log, tol=math.inf)
    del params
    torch.cuda.empty_cache()
    tol2 = max(TP_SCORE_TOL, 2 * spread)
    ranks2 = dp_launch(DP_TP_MESH, DP_TP_LAYERS)
    got2 = _dp_rows(ranks2, ("batched",), str(DP_TP_MESH))
    check_digests(ranks2, f"data-axis phase {DP_TP_MESH}", log, "batched", "shared")
    log(f"data-axis phase {DP_TP_MESH}: {len(ranks2)} ranks; every rank's scores and answers "
        "are the same bits")
    worst["tp"] = _dp_compare(f"DP {DP_TP_MESH}", got2["batched"], one["sessions"], log, tol2)
    _dp_log_ranks(ranks2, ("batched",), log)
    log(f"one process at {DP_TP_LAYERS} layers: {one['frames_per_s']:.2f} frames/s, peak "
        f"{one['peak_gib']:.2f} GiB, decode {one['decode_tokens_per_s']:.2f} tokens/s")
    wall = time.perf_counter() - t0
    log(f"data-axis phase in {wall:.1f} s ({DP_MESH}: {t1 - t0:.1f} s); worst score "
        f"differences {worst} against bounds {tol:.4g} / {tol2:.4g}")
    return {"ranks": ranks, "ranks2": ranks2, "wall_s": wall}


# --- the training mesh: LoRA training on process meshes whose ranks share
# the one card over gloo, (2, 1) replicate (ZeRO-2) and (2, 2) fsdp + TP +
# ZeRO-2, against the one process on the same weights and batches. Every
# collective crosses the host, so the ranks' times are gloo-bound: they
# measure correctness and memory a rank, not a speedup across cards.

TM_LAYERS = 2  # decoder layers at the 7B widths: up to four ranks share the card
TM_LAYOUTS = (((2, 1), "replicate"), ((2, 2), "fsdp"))
TM_STEPS, TM_ACCUM = 2, 2  # after a discarded warm-up step of one micro-batch
# the stream turns (frames each) of a micro-batch's two samples: the first
# pads the micro-batch to the 2944-token bucket, the second is shorter and
# holds an answer less (the global token mean is exercised)
TM_TURNS = ((8, 9, 9), (10, 8))
TM_T = 2944
TM_METRIC_FLOOR = 1e-3  # a metric's relative difference, a rank against the one process
TM_UPDATE_FLOOR = 1e-2  # the trainable tree's update (after the last step less before
# the first), the 2-norm of its difference over its own: Adam moves each element by
# about lr whatever the gradient's size, so an element whose gradient is near zero
# may move the other way in another summation order. Each bound is the larger of
# its floor and twice the one process's own spread under a permuted MLP (`tm_spread`)
TM_TIMEOUT_S = 480


def tm_model(dev):
    """The training mesh's model: the 7B widths (Qwen2-7B, SigLIP-so400m)
    cut to TM_LAYERS decoder layers, random bf16 weights from seed 0, and a
    LoRA r 16 adapter on the seven projections whose b is random too (a
    fresh b is 0, which leaves a's gradient 0)."""
    cfg, tok = full_width_config()
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=TM_LAYERS))
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), cfg.text, rank=16, device=dev)
    g = torch.Generator().manual_seed(2)
    for ab in lora.values():
        ab["b"] = (0.01 * torch.randn(ab["b"].shape, generator=g)).to(dev)
    return cfg, tok, params, lora


def tm_args() -> TrainArgs:
    """LoRA r 16 / alpha 32, remat on, a constant lr of 2e-5 (both measured
    steps move the leaves)."""
    return TrainArgs(lr_schedule="constant")


def tm_collator(cfg, tok):
    """The CLI's collator for a global micro-batch of 2 samples of up to
    100 frames (length and frame buckets)."""
    from mmduet_tpu_torch.data.collator import Collator
    from mmduet_tpu_torch.train.loop import parse_length_buckets

    return Collator(tok, seq_len=5924, max_frames=200, frame_size=cfg.frame_resolution,
                    buckets=parse_length_buckets("auto", 5924),
                    frame_buckets=parse_length_buckets("auto", 200, quantum=8))


def tm_batches(cfg, tok) -> list:
    """[warm-up, step 1, step 2]: micro-batches of the two TM_TURNS duet
    samples, collated as the CLI collates (`tm_collator`), as CPU tensors;
    the warm-up holds one micro-batch, the steps TM_ACCUM."""
    from mmduet_tpu_torch.data.collator import stack_accum
    from mmduet_tpu_torch.train.duet import duet_sample

    collator = tm_collator(cfg, tok)
    rng = np.random.RandomState(3)
    idx = iter(range(1000))

    def micro():
        return collator([duet_sample(tok, rng, next(idx), turns, cfg.frame_resolution)
                         for turns in TM_TURNS])

    out = []
    for n in [1] + [TM_ACCUM] * TM_STEPS:
        batch = stack_accum([micro() for _ in range(n)])
        out.append({k: torch.from_numpy(v) for k, v in batch.items()
                    if k not in ("sample_idxs", "num_frames", "n_real_tokens")})
    if any(b["input_ids"].shape[-1] != TM_T for b in out):
        raise AssertionError(f"training mesh: batches of {[b['input_ids'].shape for b in out]}, "
                             f"want the {TM_T}-token bucket")
    return out


def _flat_cpu(tree) -> dict:
    """{"lora/q_proj/a": f32 CPU copy, ...} of a trainable tree."""
    return {k.lstrip("/"): v.detach().float().cpu() for k, v in _flat(tree)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _stage(batch: dict, dev, cfg=None, mesh=None) -> dict:
    """One step's batch onto ``dev``, as the CLI's loop stages each step's:
    on a ``mesh``, only this rank's share (`rank_batch`, cut on the host;
    its frames one tensor a micro-batch)."""
    batch = rank_batch(batch, cfg, mesh)
    return {k: tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev)
            for k, v in batch.items()}


TM_HOST_KEYS = ("sample_idxs", "num_frames", "n_real_tokens")  # stripped before staging


class TmData:
    """The training mesh's samples as a dataset in memory: 2 x TM_ACCUM x
    TM_STEPS duet samples at full width, item ``i`` made from seed ``i``
    with the turns TM_TURNS[p % 2] of its position ``p`` in the loader's
    one shuffle (``random.Random(seed)``), so each micro-batch pairs the
    two kinds as `tm_batches` does; every index asked for is recorded."""

    def __init__(self, tok, frame_size: int, seed: int):
        self.order = list(range(2 * TM_ACCUM * TM_STEPS))
        random.Random(seed).shuffle(self.order)
        self.turns = {i: TM_TURNS[p % 2] for p, i in enumerate(self.order)}
        self.tok, self.frame_size, self.fetched = tok, frame_size, []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.order)

    def __getitem__(self, i: int) -> tuple:
        from mmduet_tpu_torch.train.duet import duet_sample

        with self._lock:
            self.fetched.append(i)
        return duet_sample(self.tok, np.random.RandomState(i), i, self.turns[i], self.frame_size)


def tm_loader(cfg, tok, mesh, dev) -> dict:
    """This rank's reading of `TmData` (`rank_real_batches`, its exchanges
    on ``dev``), each step staged as the CLI stages it and held bit for bit
    against `_stage`'s share of the step `real_batches` collates whole;
    the positions it fetched against its own (those of data rank d in the
    micro-batches i = m mod M). Its fetched samples, host batch bytes a
    step and bytes shared over ``model``, and the one process's."""
    from mmduet_tpu_torch.train.loop import _to_device, rank_real_batches, real_batches

    seed, collator, stats = 0, tm_collator(cfg, tok), {}
    mine, whole = TmData(tok, cfg.frame_resolution, seed), TmData(tok, cfg.frame_resolution, seed)
    got = list(rank_real_batches(mine, collator, 2, TM_ACCUM, 1, seed, 2, mesh=mesh, stats=stats))
    want = list(real_batches(whole, collator, 2, TM_ACCUM, 1, seed, 2))
    if len(got) != len(want) or len(want) != TM_STEPS:
        raise AssertionError(f"training mesh loader: {len(got)} steps, the one process "
                             f"{len(want)}, want {TM_STEPS}")
    host, one = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        g = _to_device({k: v for k, v in g.items() if k not in TM_HOST_KEYS}, dev)
        w = {k: torch.from_numpy(v) for k, v in w.items() if k not in TM_HOST_KEYS}
        host.append(budget.tree_bytes(g))  # the host arrays' bytes, staged as they are
        one.append(budget.tree_bytes(w))
        w = _stage(w, dev, cfg, mesh)
        if set(g) != set(w) or not all(
                all(map(torch.equal, g[k], w[k])) if isinstance(w[k], tuple)
                else torch.equal(g[k], w[k]) for k in w):
            raise AssertionError(f"training mesh loader: step {i + 1} differs from the rank's "
                                 "share of the whole step")
    (d, m), per = mesh.coords, 2 // mesh.shape[DATA_AXIS]
    own = sorted(i for p, i in enumerate(mine.order)
                 if p % 2 // per == d and p // 2 % mesh.shape[MODEL_AXIS] == m)
    if sorted(mine.fetched) != own:
        raise AssertionError(f"training mesh loader: fetched {sorted(mine.fetched)}, own {own}")
    return {"fetched": len(mine.fetched), "host_bytes": host, "one_fetched": len(whole.fetched),
            "one_bytes": one, "sent": stats.get("sent", 0), "received": stats.get("received", 0)}


def tm_one_process(cfg, params, lora, batches, dev) -> dict:
    """The one process's run on ``dev``: a discarded warm-up, then TM_STEPS
    steps, one state and one step's batch on the device at a time; each
    step's metrics and s, the trainable leaves before the first and after
    the last, the last state and the step."""
    args = tm_args()
    tx, sched = make_optimizer(args, TM_STEPS + 1)
    step = make_train_step(cfg, args, tx, sched)
    state = init_train_state(params, lora, tx)
    initial = _flat_cpu(state.trainable)
    step(state, params, _stage(batches[0], dev))  # warm-up, discarded
    metrics, times = [], []
    for batch in batches[1:]:
        batch = _stage(batch, dev)
        staged = budget.tree_bytes(batch)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, params, batch)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        metrics.append(m)
        del batch
    return {"metrics": metrics, "s": times, "trainable": _flat_cpu(state.trainable),
            "initial": initial, "state": state, "step": step, "staged": staged}


def tm_diff(got: dict, want: dict) -> tuple:
    """(the largest relative difference of a metric over the steps, the
    2-norm of the difference of the two runs' updates of the trainable
    tree over the 2-norm of ``want``'s update) between two runs from
    ``want["initial"]``."""
    metric = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got["metrics"], want["metrics"])
                 for k in ("loss", "lm_loss", "video_loss", "grad_norm"))
    diff = sum(float(((got["trainable"][k] - w) ** 2).sum()) for k, w in want["trainable"].items())
    moved = sum(float(((w - want["initial"][k]) ** 2).sum())
                for k, w in want["trainable"].items())
    return metric, math.sqrt(diff / moved)


def tm_spread(cfg, params, lora, batches, ref, dev, log) -> tuple:
    """The one process's own spread: the same run under `permuted_mlp`,
    the tower's MLP too (the adapters of gate / up / down permuted with the
    decoder's, and back after), against ``ref``. The rounding-only
    difference the bounds are scaled by."""
    perm_cols = {"gate_proj": "b", "up_proj": "b"}
    with permuted_mlp(params, tower=True) as pm:
        permuted = {n: dict(ab) for n, ab in lora.items()}
        for n, key in perm_cols.items():
            permuted[n]["b"] = permuted[n]["b"][..., pm.perm]
        permuted["down_proj"]["a"] = permuted["down_proj"]["a"][:, pm.perm]
        run = tm_one_process(cfg, params, permuted, batches, dev)
        inv = pm.inv.cpu()
    for n in perm_cols:
        run["trainable"][f"lora/{n}/b"] = run["trainable"][f"lora/{n}/b"][..., inv]
    run["trainable"]["lora/down_proj/a"] = run["trainable"]["lora/down_proj/a"][:, inv]
    spread = tm_diff(run, ref)
    log(f"training mesh: the one process's spread under permuted decoder and tower MLPs: "
        f"metrics "
        f"{spread[0]:.4g} relative, the trainable update {spread[1]:.4g} of its norm")
    return spread


def tm_rank(rank: int, port: int, out_dir: str, shape: tuple, mode: str, dev: str) -> None:
    """One rank of a training-mesh launch (a spawned process): joins the
    gloo group, builds its shard of `tm_model` (the ranks build one after
    the other), takes a warm-up and TM_STEPS steps of the batches in
    ``out_dir/inputs.pt`` (the (2, 2) ranks save the whole state after step
    1), reads the steps of `TmData` alone (`tm_loader`), and writes
    ``out_dir/rank<r>.json``; rank 0 also writes the gathered trainable
    leaves."""
    from mmduet_tpu_torch.parallel import initialize_distributed, shard_params, shard_train_state
    from mmduet_tpu_torch.parallel.sharding import gather_trainable
    from mmduet_tpu_torch.train.checkpoint import save_train_state

    world = shape[0] * shape[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed("gloo")
    mesh = make_mesh(shape, device=dev)  # every rank shares the one card
    dist = torch.distributed
    dev = mesh.device
    cuda = dev.type == "cuda"
    resident = _resident(0) if cuda else 0
    args = tm_args()
    tx, sched = make_optimizer(args, TM_STEPS + 1)
    for turn in range(world):
        if turn == rank:
            cfg, tok, whole, lora = tm_model(dev)
            params = shard_params(whole, mesh, mode=mode)
            state = shard_train_state(init_train_state(whole, lora, tx), mesh)
            del whole, lora
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    batches = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
    step = make_train_step(cfg, args, tx, sched, mesh=mesh)
    step(state, params, _stage(batches[0], dev, cfg, mesh))  # warm-up, discarded
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    attention.FULL_FWD_LAUNCHES = attention.FULL_BWD_LAUNCHES = attention.VISION_LAUNCHES = 0
    metrics, times = [], []
    for i, batch in enumerate(batches[1:]):
        batch = _stage(batch, dev, cfg, mesh)
        staged = budget.tree_bytes(batch)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, params, batch)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        metrics.append(m)
        del batch
        if i == 0 and mode == "fsdp":
            save_train_state(os.path.join(out_dir, "ckpt"), 1, state, mesh=mesh)
    launches = {"full_fwd": attention.FULL_FWD_LAUNCHES, "full_bwd": attention.FULL_BWD_LAUNCHES,
                "vision": attention.VISION_LAUNCHES}
    result = {"metrics": metrics, "s": times, "launches": launches,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
              "mem": {"steps": dict(_mem(resident), staged=staged)} if cuda else None,
              "staged": staged, "local_gb": quant.param_bytes(params) / 1e9,
              "loader": tm_loader(cfg, tok, mesh, dev)}
    trainable = _flat_cpu(gather_trainable(state.trainable, mesh, to="cpu"))
    if rank == 0:
        torch.save(trainable, os.path.join(out_dir, "trainable.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()  # no rank leaves while another reads its last collective
    dist.destroy_process_group()


def tm_launch(shape: tuple, mode: str, out_dir: str, dev: str) -> list:
    """The ranks of one layout, spawned on the one card; their results. A
    rank that fails fails the phase; all are stopped at the end."""
    out = spawn_ranks(tm_rank, shape[0] * shape[1], out_dir, (shape, mode, dev), TM_TIMEOUT_S,
                      f"training mesh {shape} {mode}")
    out[0]["trainable"] = torch.load(os.path.join(out_dir, "trainable.pt"), weights_only=True)
    return out


def run_train_mesh_phase(log, dev=torch.device("cuda")) -> tuple:
    """The training mesh at the 7B widths: the one process's run and its
    spread, then each of TM_LAYOUTS's ranks against it (every rank's
    metrics the same bits, each step's metrics and the gathered trainable
    leaves within the bound, kernel C's and D's launches a rank as the
    rank's shapes imply), and the (2, 2) ranks' checkpoint of step 1
    resumed in the one process to its uninterrupted step 2. Returns the
    (2, 2) rank 0's launches of kernels C and D, and the peaks: the one
    process's and each layout's ranks', with the batches' shapes."""
    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    resident = _resident(0) if cuda else 0
    cfg, tok, params, lora = tm_model(dev)
    batches = tm_batches(cfg, tok)
    real = [[int(x) for x in b["attn_mask"].sum(-1).flatten()] for b in batches[1:]]
    labels = [[int(x) for x in (b["labels"] != -100).sum(-1).flatten()] for b in batches[1:]]
    log(f"training mesh: {TM_LAYERS} decoder layers at the 7B widths, A={TM_ACCUM} x B=2, "
        f"T={TM_T}, frames per sample {[sum(t) for t in TM_TURNS]}, real tokens per sample "
        f"{real}, LM labels per sample {labels}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ref = tm_one_process(cfg, params, lora, batches, dev)
    mems = {"one process": {"steps": dict(_mem(resident), staged=ref["staged"])} if cuda else None,
            "frames": batches[1]["frames"].shape[1]}
    one_peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    log(f"training mesh, one process: {[round(t, 3) for t in ref['s']]} s/step, peak "
        f"{one_peak:.2f} GiB; " + "; ".join(
            f"step {i + 1} loss {m['loss']:.6f} lm {m['lm_loss']:.6f} video "
            f"{m['video_loss']:.6f} grad_norm {m['grad_norm']:.6f}"
            for i, m in enumerate(ref["metrics"])))
    spread = tm_spread(cfg, params, lora, batches, ref, dev, log)
    bound = (max(TM_METRIC_FLOOR, 2 * spread[0]), max(TM_UPDATE_FLOOR, 2 * spread[1]))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="tm.", dir=_build.BUILD_DIR)
    torch.save(batches, os.path.join(out_dir, "inputs.pt"))
    if cuda:
        torch.cuda.empty_cache()
    layers, v_layers = cfg.text.num_layers, cfg.vision.num_layers - 1
    calls = layers * TM_ACCUM * TM_STEPS
    want = {"full_fwd": 2 * calls, "full_bwd": len(attention.FULL_BWD_KERNELS) * calls,
            "vision": v_layers * TM_ACCUM * TM_STEPS}
    launches = None
    for shape, mode in TM_LAYOUTS:
        name = f"({shape[0]}, {shape[1]}) {mode}"
        run_dir = os.path.join(out_dir, f"{shape[0]}x{shape[1]}")
        os.makedirs(run_dir)
        os.link(os.path.join(out_dir, "inputs.pt"), os.path.join(run_dir, "inputs.pt"))
        t1 = time.perf_counter()
        # every rank on the one card ("cuda:0"; gloo: NCCL refuses two ranks on one device)
        ranks = tm_launch(shape, mode, run_dir, "cuda:0" if cuda else "cpu")
        wall = time.perf_counter() - t1
        if any(r["metrics"] != ranks[0]["metrics"] for r in ranks[1:]):
            raise AssertionError(f"training mesh {name}: the ranks' metrics differ")
        diff = tm_diff(ranks[0], ref)
        for r, x in enumerate(ranks):
            if x["launches"] != want:
                raise AssertionError(f"training mesh {name} rank {r}: launches "
                                     f"{x['launches']}, want {want} (kernel C twice a layer "
                                     f"forward under remat and four backward kernels, kernel D "
                                     f"{v_layers} times a micro-batch)")
            log(f"training mesh {name} rank {r}: {[round(t, 3) for t in x['s']]} s/step "
                f"(gloo-bound: every collective crosses the host; the one process "
                f"{[round(t, 3) for t in ref['s']]}), peak {x['peak_gib']:.2f} GiB (one process "
                f"{one_peak:.2f}), staged batch {x['staged']} bytes a step (one process "
                f"{ref['staged']}), local tree {x['local_gb']:.3f} GB, launches {x['launches']}")
            ld = x["loader"]
            log(f"training mesh {name} rank {r} loader: read {TM_STEPS} steps alone, bit-equal to "
                f"its share of the whole steps: fetched {ld['fetched']} samples (one process "
                f"{ld['one_fetched']}), host batch {ld['host_bytes']} bytes a step (one process "
                f"{ld['one_bytes']}), shared over model: sent {ld['sent']} bytes, received "
                f"{ld['received']}")
        log(f"training mesh {name}: {len(ranks)} ranks in {wall:.1f} s, every rank's metrics "
            f"the same bits; against the one process: metrics within {diff[0]:.4g} relative "
            f"(bound {bound[0]:.4g}), the trainable update within {diff[1]:.4g} of its norm "
            f"(bound {bound[1]:.4g}); " + "; ".join(
                f"step {i + 1} loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f}"
                for i, m in enumerate(ranks[0]["metrics"])))
        if not (diff[0] <= bound[0] and diff[1] <= bound[1]):
            raise AssertionError(f"training mesh {name}: {diff} against the bound {bound}")
        mems[(shape, mode)] = [x["mem"] for x in ranks]
        if mode == "fsdp":
            launches = ranks[0]["launches"]
            resume_dir = os.path.join(run_dir, "ckpt", "checkpoint-1")
    # the (2, 2) ranks' whole state of step 1, resumed in the one process
    from mmduet_tpu_torch.train.checkpoint import restore_train_state

    state = restore_train_state(resume_dir, ref["state"])
    if state.step != 1:
        raise AssertionError(f"training mesh: the checkpoint holds step {state.step}")
    state, m = ref["step"](state, params, _stage(batches[2], dev))
    resumed = tm_diff({"metrics": [ref["metrics"][0], m],
                       "trainable": _flat_cpu(state.trainable)}, ref)
    log(f"training mesh: the (2, 2) ranks' checkpoint of step 1, resumed in the one process: "
        f"step 2 within {resumed[0]:.4g} / {resumed[1]:.4g} of the uninterrupted one (bound "
        f"{bound[0]:.4g} / {bound[1]:.4g})")
    if not (resumed[0] <= bound[0] and resumed[1] <= bound[1]):
        raise AssertionError(f"training mesh: the resumed step 2 is {resumed} off")
    shutil.rmtree(out_dir)
    del params, lora, ref, state
    if cuda:
        torch.cuda.empty_cache()
    log(f"training mesh phase in {time.perf_counter() - t0:.1f} s")
    return launches, mems


# --- the training recipe: `scripts/train_torch.sh` in its synthetic mode on
# the card, in one process and on two gloo ranks sharing the card

RECIPE_RUNS = (("one process", {}), ("two gloo ranks", {"NPROC": "2", "DIST_BACKEND": "gloo",
                                                       "DEVICE": "cuda:0"}))
RECIPE_TIMEOUT_S = 300


def run_train_recipe(log) -> None:
    """``TINY_RANDOM=1 DEVICE=cuda bash scripts/train_torch.sh``, then with
    ``NPROC=2 DIST_BACKEND=gloo DEVICE=cuda:0``: each must return 0 and log
    finite losses. The recipe calls ``python``; a directory whose ``python``
    runs this interpreter goes first on its PATH. Kernel C takes every CUDA
    tensor of the training forward, so an exit code of 0 on the card means
    it ran."""
    bin_dir = os.path.join(_build.BUILD_DIR, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    with open(os.path.join(bin_dir, "python"), "w") as f:  # this interpreter, its venv kept
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bin_dir, "python"), 0o755)
    for name, extra in RECIPE_RUNS:
        out_dir = tempfile.mkdtemp(prefix="recipe.", dir=_build.BUILD_DIR)
        env = dict(os.environ, TINY_RANDOM="1", DEVICE="cuda", OUTPUT_DIR=out_dir,
                   PYTHONPATH=REPO, PATH=f"{bin_dir}:{os.environ.get('PATH', '')}")
        env.update(extra)
        t0 = time.perf_counter()
        proc = subprocess.run(["bash", os.path.join(REPO, "scripts", "train_torch.sh")],
                              cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=RECIPE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        rows = []
        if os.path.exists(os.path.join(out_dir, "log.jsonl")):
            with open(os.path.join(out_dir, "log.jsonl")) as f:
                rows = [json.loads(line) for line in f]
        shutil.rmtree(out_dir, ignore_errors=True)
        if proc.returncode != 0 or not rows or not all(
                math.isfinite(r[k]) for r in rows for k in ("loss", "lm_loss", "video_loss")):
            raise AssertionError(f"train_torch.sh ({name}): rc {proc.returncode}, log rows "
                                 f"{rows}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        log(f"train_torch.sh, TINY_RANDOM synthetic steps on the card ({name}): rc 0 in "
            f"{wall:.1f} s, step {rows[-1]['step']} loss {rows[-1]['loss']:.4f} (lm "
            f"{rows[-1]['lm_loss']:.4f}, video {rows[-1]['video_loss']:.4f})")


# --- the memory budget: `scripts/memory_budget_torch.py`'s estimate of every
# peak this script measured, from the configuration's shapes, held against
# the peak less what earlier phases left on the card


def tm_budget_config(cfg, shape: tuple, mode: str, rank: int, frames: int, params=None):
    """`memory_budget_torch`'s configuration of rank ``rank`` of a
    training-mesh layout (or of the one process, ``shape`` (1, 1)):
    ``frames`` slots a micro-batch, of which data rank d stages sample d's
    (`rank_batch`)."""
    return budget.Training(
        f"training mesh {shape} {mode}", cfg, mesh=shape, param_mode=mode, accum=TM_ACCUM,
        batch=2, seq=TM_T, frames=frames,
        rank_frames=sum(TM_TURNS[rank // shape[1]]) if shape[0] > 1 else None, params=params)


def memory_configs(cfg, train_mem: dict, tm_mems: dict) -> list:
    """[(label, key, configs(rank))]: each configuration whose peaks the
    phases measured (``key`` into `main`'s measurements), as
    `memory_budget_torch` builds it for rank ``rank`` of its mesh: a
    `Serving` or `Training` for each pass that was measured on its own
    (the live engine's generation and grounding passes, the batched
    engine's serve and the scorer, a training run's steps)."""
    def cut(layers):
        return cfg.replace(text=dataclasses.replace(cfg.text, num_layers=layers))

    ccfg = clip_config(cfg)
    trees = {"bf16": budget.model_params(cfg), "int4": budget.model_params(cfg, "int4"),
             "clip": budget.model_params(ccfg, clip=True)}
    trees.update({n: budget.model_params(cut(n)) for n in {TM_LAYERS, DP_TP_LAYERS}})
    S, T = budget.Serving, budget.Training

    def live(name, c=cfg, tree="bf16", **kw):  # `run_main_path`, `run_clip_path`
        return lambda r: {p: S(f"{name}, {p}", c, grounding=p == "grounding", frames=N_FRAMES,
                               max_new=_args().max_new_tokens, params=trees[tree], **kw)
                          for p in ("generation", "grounding")}

    def batched(name, mesh=(1, 1), kv=None, scorer=True, c=cfg, tree="bf16", pixels=True):
        def make(r):  # `run_batched_path`, `run_tp_batched`
            out = {"serve": S(f"{name}, serve", c, mesh=mesh, engine="batched",
                              lanes=BATCH_LANES, kv_cache_quant=kv, pixels=pixels,
                              max_new=BATCH_MAX_NEW, params=trees[tree])}
            if scorer:
                out["scorer"] = S(f"{name}, scorer", c, mesh=mesh, engine="scorer",
                                  lanes=BATCH_LANES, kv_cache_quant=kv,
                                  frames=max(BATCH_LENGTHS[:BATCH_LANES]), params=trees[tree])
            return out
        return make

    def tm(shape=(1, 1), mode="replicate"):
        return lambda r: {"steps": tm_budget_config(cut(TM_LAYERS), shape, mode, r,
                                                    tm_mems["frames"], trees[TM_LAYERS])}

    return [
        ("serving bf16, one stream", "dense", live("serving bf16")),
        ("serving int4 + int8 cache", "quantized",
         live("serving int4 + int8 cache", tree="int4", weights="int4", kv_cache_quant="int8")),
        ("batched bf16, 8 lanes", "batched", batched("batched bf16")),
        ("batched, (2, 2) one-device mesh", "meshed", batched("batched, (2, 2) mesh")),
        ("batched, int8 cache", "batched_int8", batched("batched int8", kv="int8", scorer=False)),
        ("training A=2 x 2944", "training", lambda r: {"steps": T(
            "training", cfg, accum=TRAIN_ACCUM, batch=1, seq=train_mem["seq"],
            frames=train_mem["frames"], params=trees["bf16"])}),
        ("CLIP-L/14-336 + 7B", "clip", live("CLIP path", c=ccfg, tree="clip", clip=True)),
        ("TP batched, one process", "tp_batched_ref",
         batched("TP batched", scorer=False, pixels=False)),
        ("TP rank (1, 2), bf16", ("tp", "dense"), live("TP rank bf16", mesh=(1, TP_RANKS))),
        ("TP rank (1, 2), int4 + int8 cache", ("tp", "quantized"), live(
            "TP rank int4", tree="int4", mesh=(1, TP_RANKS), weights="int4",
            kv_cache_quant="int8")),
        ("TP rank (1, 2), batched", ("tp", "batched"),
         batched("TP rank batched", mesh=(1, TP_RANKS), scorer=False, pixels=False)),
        ("data rank (2, 1), bf16", ("dp", "bf16"), batched("data rank bf16", mesh=DP_MESH)),
        ("data rank (2, 1), int8 cache", ("dp", "int8"),
         batched("data rank int8", mesh=DP_MESH, kv="int8", scorer=False)),
        ("data rank (2, 2), 2 layers", ("dp2", "batched"), batched(
            "data rank (2, 2)", mesh=DP_TP_MESH, c=cut(DP_TP_LAYERS), tree=DP_TP_LAYERS,
            scorer=False, pixels=False)),
        ("training mesh, one process", ("tm", "one process"), tm()),
    ] + [(f"training mesh {shape} {mode} rank", ("tm", (shape, mode)), tm(shape, mode))
         for shape, mode in TM_LAYOUTS]


def run_memory_budget(log, cfg, measured: dict, train_mem: dict, tm_mems: dict) -> None:
    """Every measured peak against `memory_budget_torch`'s estimate of its
    configuration: the estimate's persistent part at most the peak, the
    whole within max(10 %, 1 GiB) of the peak less the bytes earlier
    phases left resident; each term is printed. Then the reference
    recipe's three layouts against this card's memory (estimates)."""
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    held, missed = 0, []
    for label, key, configs in memory_configs(cfg, train_mem, tm_mems):
        ranks = measured[key]
        ranks = ranks if isinstance(ranks, list) else [ranks]
        for r, passes in enumerate(ranks):
            want = configs(r)
            if set(passes) != set(want):
                raise AssertionError(f"memory budget, {label}: measured passes {sorted(passes)}, "
                                     f"configurations of {sorted(want)}")
            for name, mem in passes.items():
                c = want[name]
                est = (budget.serving_budget(c) if isinstance(c, budget.Serving)
                       else budget.training_budget(c))
                label_r = f"{label}{f' {r}' if len(ranks) > 1 else ''}, {name}"
                ok, line = budget.check(est, mem["peak"], mem["resident"])
                if "staged" in mem:  # the batch bytes the rank really put on the card
                    term = next(b for n, b, _ in est.persistent if n == "staged batch")
                    ok = ok and term == mem["staged"]
                    line += f"; staged batch term {term} bytes, staged {mem['staged']}"
                moment = est.moments.get(est.peak_moment[0], [])
                log(f"memory budget, {label_r}: {line}; GiB persistent: " + ", ".join(
                    f"{n} {b / 2**30:.3f}" for n, b, _ in est.persistent)
                    + f"; '{est.peak_moment[0]}': " + ", ".join(
                    f"{n} {b / 2**30:.3f}" for n, b, _ in moment))
                held += ok
                if not ok:
                    missed.append(label_r)
    log(f"memory budget: {held} measured peaks held by their estimates, missed {missed}; the "
        f"card's total_memory {total} bytes ({total / 2**30:.2f} GiB)")
    for b in budget.recipe_budgets(budget.model_params(MMDuetConfig())):
        log(f"memory budget, the reference recipe (an estimate, not a measurement): {b.name}: "
            f"{b.total_bytes / 2**30:.2f} GiB a card (persistent "
            f"{b.persistent_bytes / 2**30:.2f} + '{b.peak_moment[0]}' "
            f"{b.peak_moment[1] / 2**30:.2f}) against {total / 2**30:.2f} GiB: "
            f"{'fits' if b.total_bytes <= total else 'does NOT fit'}")
    log(f"memory budget phase in {time.perf_counter() - t0:.1f} s")
    if missed or held < 12:
        raise AssertionError(f"memory budget: estimates missed {missed} ({held} held)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, then stop (no result line)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(card, flush=True)

    def log(msg):
        print(f"[{card}] {msg}", flush=True)

    t_start = time.perf_counter()
    _build.build()
    log(f"kernels built from csrc/ in {time.perf_counter() - t_start:.1f} s")
    dec, dec_int8 = check_attention_kernel(log)
    int4 = check_int4_kernel(log)
    full_fwd, full_bwd = check_full_attention_kernel(log)
    sharded = check_sharded_attention_kernel(log)
    vision = check_vision_attention_kernel(log)
    fused = check_vision_fused_kernels(log)
    tp_kernels = check_tp_kernels(log)
    if opts.kernels_only:
        log(f"kernels checked in {time.perf_counter() - t_start:.1f} s")
        return 0
    run_conversion(log)
    cfg, tok, params = full_width_model(log)
    dense = run_main_path(cfg, tok, params, log)
    dec["launches"] = dense["attention"]
    run_decode_graph(cfg, tok, params, log)
    run_frame_graph(cfg, tok, params, log)
    run_live_feeding(cfg, tok, params, log)
    run_prewarm(cfg, tok, params, log)
    run_offline_baseline(cfg, tok, params, log)
    t_new = time.perf_counter()
    run_extraction(cfg, params, log)
    run_demo(cfg, params, log)
    clip_path = run_clip_path(cfg, params, log)
    vision["clip_launches"] = clip_path["vision"]
    log(f"extraction, demo and CLIP phases in {time.perf_counter() - t_new:.1f} s")
    (full_fwd["launches"], full_bwd["launches"]), train_mem = run_training(cfg, tok, params, log)
    time_vision_routes(cfg, params, log)
    dev = torch.device("cuda", torch.cuda.current_device())
    batched = run_batched_path(cfg, tok, params, log)
    meshed = run_batched_path(cfg, tok, params, log, mesh=make_mesh((2, 2), devices=[dev] * 4))
    check_same_outputs(batched, meshed, "the (2, 2) one-device mesh")
    log("batched path: the (2, 2) one-device mesh gave the same responses, times and scores "
        "as no mesh, exactly")
    batched_int8 = run_batched_path(cfg, tok, params, log, kv_cache_quant="int8",
                                    grounding=False)
    sharded["launches"] = meshed["counts"]["attention_sharded"]
    vision["launches"] = batched["counts"]["vision"]
    fused["launches"] = batched["counts"]["vision_fused"]
    for key, what_ in (("frames_per_s", "generation pass aggregate frames/s"),
                       ("dispatch_ms_per_frame", "frame dispatches, ms per frame fed"),
                       ("decode_tokens_per_s", "decode tokens/s"),
                       ("peak_gib", "peak device memory GiB")):
        log(f"batched B={BATCH_LANES}, {what_}: no mesh {batched[key]:.3f}, (2, 2) mesh "
            f"{meshed[key]:.3f}, int8 cache {batched_int8[key]:.3f}")
    log(f"B={BATCH_LANES} against B=1 of this run: generation-mode ms per frame "
        f"{batched['dispatch_ms_per_frame']:.3f} vs p50 {dense['p50_ms']:.3f}; grounding-mode "
        f"{batched['grounding_ms_per_frame']:.3f} vs p50 {dense['grounding_p50_ms']:.3f}; decode "
        f"tokens/s {batched['decode_tokens_per_s']:.2f} vs {dense['decode_tokens_per_s']:.2f}")
    dp_ref = {"bf16": {k: batched[k] for k in ("sessions", "rows")},  # the data-axis phase's
              "int8": {"sessions": batched_int8["sessions"]}}
    measured = {"dense": dense["mem"], "clip": clip_path["mem"], "training": train_mem["mem"],
                "batched": batched["mem"], "meshed": meshed["mem"],
                "batched_int8": batched_int8["mem"]}
    del batched, meshed, batched_int8
    tp_batched_ref = run_tp_batched(cfg, tok, params, log)  # the TP phase's one process
    measured["tp_batched_ref"] = tp_batched_ref["mem"]
    tp_spread = spread_under_permuted_mlp(cfg, tok, params, log, dense, tp_batched_ref)
    params = quantize_on_card(params, log)
    quantized = run_main_path(cfg, tok, params, log, kv_cache_quant="int8")
    run_decode_graph(cfg, tok, params, log, kv_cache_quant="int8", batched=False)
    run_frame_graph(cfg, tok, params, log, kv_cache_quant="int8", batched=False)
    dec_int8["launches"], int4["launches"] = quantized["attention_int8"], quantized["int4_matmul"]
    measured["quantized"] = quantized["mem"]
    for key, what in (("p50_ms", "generation pass p50 per-frame ms"),
                      ("grounding_p50_ms", "grounding pass p50 per-frame ms"),
                      ("decode_tokens_per_s", "decode tokens/s"),
                      ("peak_gib", "peak device memory GiB")):
        log(f"int4 weights + int8 cache vs bf16, {what}: {quantized[key]:.3f} vs "
            f"{dense[key]:.3f}")
    del params
    torch.cuda.empty_cache()
    tp = run_tp_phase(log, dense, quantized, tp_batched_ref, tp_spread)
    r0 = tp["ranks"][0]
    for entry, key, run in ((dec, "attention", "dense"), (dec_int8, "attention_int8", "quantized"),
                            (int4, "int4_matmul", "quantized"), (vision, "vision", "dense")):
        # the rank-local shapes' numbers, and rank 0's launches on the TP path
        entry["tp_local"] = dict(tp_kernels[key], launches=r0[run][key]
                                 + (r0["quantized"]["vision"] if key == "vision" else 0))
    for entry, key in ((dec, "attention_1x4"), (dec_int8, "attention_int8_1x4")):
        # a (1, 4) rank's shapes, held and timed here; no (1, 4) mesh is served
        entry["tp_local_1x4"] = tp_kernels[key]
    sharded["process_mesh"] = {  # A' on a process mesh: kernel A once a rank and layer
        "launches": r0["dense"]["attention"], "layers": cfg.text.num_layers,
        **{k: tp_kernels["attention"][k] for k in ("ms", "bound_ms", "bound_by", "library_ms")},
        "rank_1x4": {k: tp_kernels["attention_1x4"][k]
                     for k in ("ms", "bound_ms", "bound_by", "library_ms")}}
    dp = run_dp_phase(log, dp_ref, tp["tol"])
    d0, d2 = dp["ranks"][0], dp["ranks2"][0]
    for entry, run, key in ((dec, "bf16", "attention"), (dec_int8, "int8", "attention_int8"),
                            (vision, None, "vision")):
        # rank 0's launches on the data-axis path: its 4 of the 8 lanes
        launches = (d0["bf16"]["counts"][key] + d0["int8"]["counts"][key] if run is None
                    else d0[run]["counts"][key])
        entry["data_axis"] = {"mesh": list(DP_MESH), "lanes": d0["lanes"], "launches": launches}
    dec["data_axis"]["mesh_2x2_launches"] = d2["batched"]["counts"]["attention"]
    tm_launches, tm_mems = run_train_mesh_phase(log)
    measured.update({("tp", run): [x[run]["mem"] for x in tp["ranks"]]
                     for run in ("dense", "quantized", "batched")})
    measured.update({("dp", run): [x[run]["mem"] for x in dp["ranks"]] for run in ("bf16", "int8")})
    measured[("dp2", "batched")] = [x["batched"]["mem"] for x in dp["ranks2"]]
    measured[("tm", "one process")] = tm_mems["one process"]
    measured.update({("tm", layout): tm_mems[layout] for layout in TM_LAYOUTS})
    run_train_recipe(log)
    run_memory_budget(log, cfg, measured, train_mem, tm_mems)
    for entry, key in ((full_fwd, "full_fwd"), (full_bwd, "full_bwd")):
        # the rank-local shape's numbers, and the (2, 2) rank 0's launches
        entry["tp_local"] = dict(tp_kernels[key], launches=tm_launches[key])
    vision["tp_local"]["train_mesh_launches"] = tm_launches["vision"]
    check_small_input(log)
    check_small_input(log, quantized=True)
    check_small_batched(log)
    check_small_offline(log)
    check_small_cli_profile(log)
    check_small_train(log)
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dec, dec_int8, sharded, int4, full_fwd, full_bwd, vision,
                                  fused]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
