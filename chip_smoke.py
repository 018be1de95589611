"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only]

Phases (any failure ends the run with a nonzero exit):

1. the card's name and power limit, from nvidia-smi;
2. every CUDA kernel of the paths, built from the sources in this checkout
   (one nvcc per source, all at once), held against its plain PyTorch
   version on the card at the shapes the paths give it, and timed beside
   it and beside its roofline bound (`ops/bounds.py`): kernel A (streaming
   attention) with a bf16 and with an int8 cache (timed at the decode step,
   cache_len 2048 and 24000, the frame step and the 8- and 32-frame blocks;
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
   one launch) and kernel D (the ViT tower's attention at 32 frames x 729
   patches x 16 heads of 72 and at small ragged shapes, beside
   `scaled_dot_product_attention`). Plain versions with one fault (a lost
   tile for kernels C and D, a lost split or key tile for kernel A; a
   dropped group scale or swapped nibble halves for kernel B) must fail the
   bounds, and so must shards of kernel A' that
   read another shard's cursors or kv heads. ``--kernels-only`` stops here
   (no result line);
3. the serving path at the full width of the default model (Qwen2-7B
   decoder, SigLIP-so400m tower, random bf16 weights from a seed, all 28
   layers): `LiveInferEngine` streams 64 frames with a query at t=0 and
   generates, then streams them again in grounding mode; kernel A's
   launches over that run must be positive;
4. the training path at the same width: `make_train_step` takes 3
   optimizer steps of A=2 collated duet micro-batches (pixel frames at 384
   px, padded to the 2944-token bucket), LoRA r 16 / alpha 32 on the seven
   projections, gradient checkpointing on; kernel C's launches must equal
   what 28 layers x A x steps predict (two forwards per layer under remat,
   four backward kernels);
5. the vision tower with kernel D (asked for and by auto) and, for the
   comparison, with the plain version put in the kernel's place from here
   (frames/s each; the package refuses that route for CUDA tensors), then
   the batched serving path at the same width:
   `BatchedStreamEngine.serve()` streams 12 sessions of 40-64 frames
   through 8 lanes (generation mode, 8-frame blocks, lanes retiring and
   admitting, batched decodes), and `BatchedStreamScorer` scores 8 sessions
   in lockstep 32-frame blocks; once without a mesh, once under a (2, 2)
   mesh laid on the one card, whose responses, times and scores must equal
   the first run's exactly, and once (generation mode) with an int8 cache.
   The launches of kernels A, A' and D must equal what the layers, the
   mesh's shards, the decoder forwards and the vision batches predict;
6. the quantized serving path at the same width: the decoder, embedding
   and LM head quantized to group-128 int4 on the card
   (`quantize_params(bits=4)`), `LiveInferEngine(kv_cache_quant="int8")`,
   the same two passes as in 3; kernel B's launches must equal seven per
   layer and decoder forward plus one per generated token (the LM head),
   and every attention launch must be of the int8 variant;
7. small-model checks, card (bf16, kernels) against CPU (f32, plain
   versions): grounding scores of the engine, dense and quantized (int4
   weights, int8 cache, a LoRA adapter), of the batched engine (also
   against single-stream runs on the card), and one train step's loss and
   gradient norm;
8. one JSON line for the seven kernels, then the result line
   ``{"ok": true, "device": {...}}``.

It needs `torch` with CUDA; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch

from mmduet_tpu_torch.config import MMDuetConfig, TestArgs, TrainArgs, tiny_config
from mmduet_tpu_torch.stream import CharTokenizer
from mmduet_tpu_torch.infer import BatchedStreamEngine, BatchedStreamScorer, LiveInferEngine
from mmduet_tpu_torch.models import init_lora, init_mmduet_params, mmduet, quant, siglip
from mmduet_tpu_torch.models.qwen2 import kv_arr, kv_quantized, quantize_kv_rows
from mmduet_tpu_torch.ops import _build, attention, bounds, quant_matmul
from mmduet_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, make_mesh
from mmduet_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from mmduet_tpu_torch.train.duet import QUERY, duet_batches


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


def check_attention_kernel(log) -> List[dict]:
    """flash_decode_attention (CUDA) vs flash_decode_attention_ref on the
    card, with a bf16 cache and with the int8 cache that `quantize_kv_rows`
    makes of it; returns the two kernels' JSON entries (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    nh, kh, hd, L, S = 28, 4, 128, 4, 24576

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    worst = {"bf16": [0.0, 0.0], "int8": [0.0, 0.0]}  # max|diff|, max ratio
    timed = {}
    cases = [(shape, cl, 1) for shape in ATTN_SHAPES for cl in CACHE_LENS]
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
            # on the live slots only (the others are masked); the bf16
            # cache's kernel rounds p, and its bound has the rms term
            live = slice(0, max(max(cl), 1))
            up = tuple(a[..., live, :] if i in (1, 2) else a for i, a in enumerate(args))
            up = tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
                       for a in up)
            cut = {k_: s[..., live] for k_, s in scales.items()}
            want = attention.flash_decode_attention_ref(*up, **cut)
            rms = bounds.decode_attention_rms(*up) if variant == "bf16" else None
            torch.cuda.synchronize()
            real = slice(0, t_real)
            err = (got[:, real].float() - want[:, real]).abs().max().item()
            ratio = bounds.row_ratio(got[:, real], want[:, real],
                                     None if rms is None else rms[:, real])
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(
                    f"flash_decode kernel ({variant} cache) vs plain: {name} B={B} "
                    f"cache_len={cl} layer={layer}: max|diff| {err}, {ratio} times the row "
                    f"bound {bounds.ROW_REL} * max|row| + {bounds.ROW_ABS}"
                    + (f" + 2^-9 {bounds.SIGMAS} rms" if rms is not None else ""))
            worst[variant] = [max(worst[variant][0], err), max(worst[variant][1], ratio)]
            timed_lens = TIMED_CACHE_LENS.get(name, (2048,)) if variant == "bf16" else (2048,)
            if B == 1 and cache_len == 2048 and variant == "bf16" and name in DROP:
                # the bound is tight: the plain version without one split (or
                # one key tile) fails it
                dropped = bounds.decode_attention_dropped(*up, drop=DROP[name])
                factor = bounds.row_ratio(got[:, real], dropped[:, real], rms[:, real])
                if not factor > 1.0:
                    raise AssertionError(f"flash_decode check: {name} without cache slots "
                                         f"{DROP[name]} passes the bound ({factor} of it)")
                log(f"flash_decode {name}: the plain version without the cache slots "
                    f"[{DROP[name].start}, {DROP[name].stop}) fails the bound by {factor:.1f}x")
                del dropped
            if B == 1 and cache_len in timed_lens:
                call = lambda: attention.flash_decode_attention(*args, **scales)  # noqa: E731
                ms = _graph_ms(call)
                eager_ms = _time_ms(call, 20)
                plain_ms = _time_ms(
                    lambda: attention.flash_decode_attention_ref(*args, **scales), 3)
                bound_ms, bound_by = bounds.decode_attention_bound(
                    B, T, nh, kh, hd, cache_len, t_real, q_off, int8=variant == "int8")
                timed[variant, name, cache_len] = (ms, plain_ms, bound_ms, bound_by)
                log(f"flash_decode {name}, {variant} cache: T={T} Tc={Tc} cache_len={cache_len} "
                    f"kernel {ms:.4f} ms (eager through the wrapper {eager_ms:.4f}), plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
                if name == "decode step" and cache_len == 2048:
                    log(f"flash_decode {name}, {variant} cache: the wrapper's host time "
                        f"{_host_us(call):.2f} us per call")
            del got, want, rms, up
        del q, k_cache, v_cache, ck, cv, kq, ks, vq, vs, variants
    entries = []
    for variant, label in (("bf16", "flash_decode_attention"),
                           ("int8", "flash_decode_attention (int8 cache)")):
        log(f"flash_decode, {variant} cache: {len(cases)} cases within {bounds.ROW_REL} * "
            f"max|row| + {bounds.ROW_ABS}" + (f" + 2^-9 {bounds.SIGMAS} rms" if variant == "bf16"
                                              else "")
            + f" (max|diff| {worst[variant][0]}, at most {worst[variant][1]} of the row bound)")
        ms, plain_ms, bound_ms, bound_by = timed[variant, "8-frame block", 2048]
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
            "library_ms": None,  # no single PyTorch call attends a cursor-bounded cache + chunk
        })
    return entries


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
            # the bf16 cache's kernel rounds p: its bound has the rms term
            rms = None if scales else bounds.decode_attention_rms(*up)
            rows = [(one[b, :int(tr[b])], want[b, :int(tr[b])],
                     None if rms is None else rms[b, :int(tr[b])]) for b in range(B)]
            ratio = max(bounds.row_ratio(g, w, r) for g, w, r in rows)
            worst = max(worst, max((g.float() - w).abs().max().item() for g, w, _ in rows))
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(f"flash_decode kernel at B={B} ({variant} cache, {name}) "
                                     f"vs plain: {ratio} times the row bound")
            del want, rows, rms
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
                timed = (ms, plain_ms, bound_ms, parts[-1][1])
                log(f"flash_decode sharded, {name}, B={B} lanes at cursors {SHARD_LANES}: the "
                    f"(2, 2) mesh's four launches {ms:.4f} ms, one launch {one_ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({parts[-1][1]})")
        del q, ck, cv
    log(f"flash_decode sharded: {n_equal} (mesh, cache, shape) cases bit-equal to one launch, "
        f"which is within the row bound of the plain version (max|diff| {worst}); wrong "
        f"cursors and wrong kv heads both fail")
    ms, plain_ms, bound_ms, bound_by = timed
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
        "library_ms": None,  # as kernel A: no single PyTorch call computes it
    }


# Kernel D: (N, T, nh, hd). The serving shape (VISION_BATCH frames of 729
# patches through SigLIP-so400m's 16 heads of 72), then small ragged ones.
VISION_SHAPES = ((32, 729, 16, 72), (1, 50, 16, 64), (2, 129, 3, 128), (3, 64, 2, 8),
                 (1, 1, 1, 40))
VISION_DROP = slice(64 * 5, 64 * 6)  # the key tile of the mutated plain version


def check_vision_attention_kernel(log) -> dict:
    """flash_vision_attention (CUDA) vs flash_vision_attention_ref on the
    card; returns kernel D's JSON entry (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = worst_ratio = 0.0
    for i, shape in enumerate(VISION_SHAPES):
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
        if i == 0:
            N, T, nh, hd = shape
            dropped = bounds.vision_attention_dropped(q, k, v, VISION_DROP)
            factor = bounds.full_attention_ratio(got, dropped, rms)
            if not factor > 1.0:
                raise AssertionError(f"flash_vision check: the plain version without one key "
                                     f"tile passes the bound ({factor} of it)")
            log(f"flash_vision: the plain version without the keys [{VISION_DROP.start}, "
                f"{VISION_DROP.stop}) fails the bound by {factor:.1f}x")
            del dropped
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
        del q, k, v, got, want, rms
        torch.cuda.empty_cache()
    log(f"flash_vision: {len(VISION_SHAPES)} shapes within 2^-8 |plain| + 2^-9 {bounds.SIGMAS} "
        f"rms + {bounds.FULL_ABS} (max|diff| {worst}, at most {worst_ratio:.3f} of the bound)")
    return {
        "name": "flash_vision_attention",
        "route": "cuda",
        "source": "mmduet_tpu_torch/ops/csrc/flash_vision.cu",
        "replaces": "mmduet_tpu/ops/attention.py:520",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


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
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = worst_ratio = 0.0
    entry = None
    for H, O in INT4_SHAPES:
        w = torch.randn((H, O), generator=gen, device=dev, dtype=torch.bfloat16) / math.sqrt(H)
        leaf = quant.quantize_weight_int4(w, 0)
        leaf8 = quant.quantize_weight(w, 0)
        qw4, qs = leaf["qw4"], leaf["qs"]
        # copies to rotate through while timing, so that a launch finds its
        # weight in device memory, not in the 50 MB L2, as a layer's does
        n_copies = max(1, min(8, -(-(120 << 20) // qw4.numel())))
        copies = [(qw4.clone(), qs.clone()) for _ in range(n_copies)]
        for R in INT4_ROWS:
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
            if (H, O) == INT4_SHAPES[3] and R in (1, 392):
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
                timed = time_int4(log, y, w, leaf8, qw4, qs, copies, want, mag)
                if ((H, O), R) == INT4_ENTRY:
                    entry = timed
            del y, got, want, mag
        del w, leaf, leaf8, qw4, qs, copies
        torch.cuda.empty_cache()
    n_cases = len(INT4_SHAPES) * len(INT4_ROWS)
    log(f"int4_matmul: {n_cases} cases within {bounds.B_REL} * sum|y||w| + {bounds.B_ABS} "
        f"(max|diff| {worst}, at most {worst_ratio:.4f} of the bound)")
    return {
        "name": "int4_matmul",
        "route": "cuda",
        "source": "mmduet_tpu_torch/ops/csrc/int4_matmul.cu",
        "replaces": "mmduet_tpu/ops/quant_matmul.py:108",
        "max_abs_err": worst,
        **entry,
    }


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


def check_full_attention_kernel(log) -> List[dict]:
    """flash_full_attention (CUDA, forward and backward) vs
    flash_full_attention_ref on the card; returns kernel C's two JSON
    entries (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    nh, kh, hd = 28, 4, 128
    worst = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}  # max|diff|, max ratio
    worst_lse = 0.0
    timed = library = None
    for T, n_real, side in FULL_CASES:
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
            log(f"flash_full T={T} ({side}-padded, nh 28, kh 4, hd 128, bf16): forward kernel "
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
    log(f"flash_full: {len(FULL_CASES)} cases, o within the bound at most "
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


def _args(max_new_tokens: int = 32, **kw) -> TestArgs:
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


N_FRAMES = 64


def full_width_model(log):
    """The default MMDuetConfig with random bf16 weights from seed 0 on the
    card, and the CharTokenizer at its vocabulary: (cfg, tok, params)."""
    dev = torch.device("cuda")
    tok = CharTokenizer(frame_num_tokens=49, vocab_size=152064)
    cfg = MMDuetConfig().replace(
        v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id
    )
    t0 = time.perf_counter()
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"params: {n_params / 1e9:.3f} B bf16 in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    return cfg, tok, params


def run_main_path(cfg, tok, params, log, kv_cache_quant=None) -> dict:
    """The 7B-width serving path: generation pass, then grounding pass.
    Every kernel count of the path is set to 0 just before the passes and
    read just after them; returns the counts and the passes' numbers."""
    frames = np.random.RandomState(0).randint(
        0, 256, (N_FRAMES, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    query = [{"role": "user", "content": QUERY, "time": 0.0}]

    gen = LiveInferEngine(params, cfg, tok, _args(stream_end_score_sum_threshold=1.0),
                          kv_cache_quant=kv_cache_quant)
    ground = LiveInferEngine(params, cfg, tok, _args(
        stream_end_score_sum_threshold=1.0, grounding_mode=True), kv_cache_quant=kv_cache_quant)
    gen.input_video_stream(frames[:32])  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    gen.reset()
    torch.cuda.reset_peak_memory_stats()

    stats = {}
    # the main path starts here
    attention.LAUNCHES = attention.INT8_LAUNCHES = quant_matmul.B_LAUNCHES = 0
    for name, engine in (("generation", gen), ("grounding", ground)):
        before = attention.LAUNCHES
        t0 = time.perf_counter()
        engine.input_video_stream(frames)
        torch.cuda.synchronize()
        t_vision = time.perf_counter() - t0
        engine.input_query_stream(query)
        t0 = time.perf_counter()
        responses = engine.inference()
        torch.cuda.synchronize()
        stats[name] = dict(
            launches=attention.LAUNCHES - before, responses=responses,
            vision_s=t_vision, stream_s=time.perf_counter() - t0,
            p50_ms=float(np.percentile(engine.frame_latencies_ms, 50)),
        )
        _check_pass(engine, name, stats[name]["launches"], responses, QUERY)
    counts = dict(attention=attention.LAUNCHES, attention_int8=attention.INT8_LAUNCHES,
                  int4_matmul=quant_matmul.B_LAUNCHES)  # the main path ends here
    _check_counts(params, cfg, counts, gen.tokens_generated + ground.tokens_generated,
                  kv_cache_quant)

    for (name, s), engine in zip(stats.items(), (gen, ground)):
        log(f"{name} pass: block {engine.block_frames}, "
            f"{N_FRAMES} frames, p50 per-frame {s['p50_ms']:.3f} ms, stream "
            f"{s['stream_s']:.3f} s, vision {N_FRAMES / s['vision_s']:.2f} frames/s, "
            f"{s['launches']} attention launches, "
            f"{sum(r['role'] == 'assistant' for r in s['responses'])} responses")
    log(f"kernel launches over the two passes: {counts}; {gen.tokens_generated} tokens "
        f"generated")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory (streaming passes): {peak_gib:.2f} GiB")
    return dict(counts, p50_ms=stats["generation"]["p50_ms"],
                grounding_p50_ms=stats["grounding"]["p50_ms"], peak_gib=peak_gib,
                decode_tokens_per_s=_time_decode(gen, cfg, log))


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


def _time_decode(engine, cfg, log) -> float:
    """Greedy decode of 32 tokens (EOS disabled) at the cache length the
    generation pass left, timed with a device sync after one untimed run;
    the median tokens per second of three runs (host-bound: they spread)."""
    n_new = 32
    embeds = engine._embed_ids(engine._gen_prompt_ids)[None]
    pen = torch.zeros((1, cfg.text.vocab_size), dtype=torch.bool, device="cuda")
    rates = []
    with torch.inference_mode():
        for run in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed, _, _ = mmduet.decode_loop(
                engine.params, cfg, embeds, engine.state.kv_cache,
                engine.state.cursor, embeds.shape[1], pen,
                max_new=n_new, eos_id=-1, rep=1.05,
            )
            n = int(packed[0, -2])
            dt = time.perf_counter() - t0
            if n != n_new:
                raise AssertionError(f"decode: {n} tokens, want {n_new}")
            if run:
                rates.append(n / dt)
    rate = float(np.median(rates))
    log(f"decode: {n_new} tokens at cache length {engine.state.cursor}: median {rate:.2f} "
        f"tokens/s of 3 runs (range {min(rates):.2f}-{max(rates):.2f}; prompt prefill included)")
    return rate


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


def _attention_counts() -> dict:
    return dict(attention=attention.LAUNCHES, attention_int8=attention.INT8_LAUNCHES,
                attention_sharded=attention.SHARDED_LAUNCHES, vision=attention.VISION_LAUNCHES)


def run_batched_path(cfg, tok, params, log, mesh=None, kv_cache_quant=None,
                     grounding: bool = True) -> dict:
    """The 7B-width batched path: `BatchedStreamEngine.serve()` streams
    BATCH_SESSIONS sessions through BATCH_LANES lanes in generation mode
    (8-frame blocks, continuous admission), then, with ``grounding``,
    `BatchedStreamScorer` scores the first BATCH_LANES sessions in lockstep
    32-frame blocks. Every kernel count of the path is set to 0 just before
    and read just after; the counts must equal what the dispatches, the
    mesh and the vision batches predict. Returns outputs and numbers."""
    shards = mesh.size if mesh is not None else 1
    layers, v_layers = cfg.text.num_layers, cfg.vision.num_layers - 1
    what = f"mesh {dict(mesh.shape) if mesh is not None else None}, cache {kv_cache_quant or 'bf16'}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    engine = BatchedStreamEngine(
        params, cfg, tok, _args(BATCH_MAX_NEW, stream_end_score_sum_threshold=2.0),
        n_streams=BATCH_LANES, block_frames=8, mesh=mesh, gen_coalesce_rounds=1,
        kv_cache_quant=kv_cache_quant)
    acc, fed = {}, []
    _timed(engine, "_dispatch_sched", acc)
    _timed(engine, "_generate_batch", acc)
    _timed(engine, "_admit", acc, sync=True)
    sched = engine._dispatch_sched
    engine._dispatch_sched = lambda chunks: (fed.append(sum(c[2] for c in chunks.values()))
                                             or sched(chunks))
    # the main path starts here
    attention.LAUNCHES = attention.INT8_LAUNCHES = attention.SHARDED_LAUNCHES = 0
    attention.VISION_LAUNCHES = 0
    t0 = time.perf_counter()
    results = {i: (resp, debug) for i, resp, debug in engine.serve(
        _batch_session(cfg, i) for i in range(BATCH_SESSIONS))}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _attention_counts()  # the generation pass ends here
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
    n_answers = sum(r["role"] == "assistant" for resp, _ in results.values() for r in resp)
    gens = len(engine.gen_lanes)
    forwards, rest = divmod(counts["attention"], layers * shards)
    full = engine.tokens_generated == BATCH_MAX_NEW * sum(engine.gen_lanes)
    lo, hi = engine.dispatches + gens, engine.dispatches + gens * BATCH_MAX_NEW
    want_vision = v_layers * sum(_vision_batches(n) for n in BATCH_LENGTHS)
    if (n_answers < 1 or rest or not lo <= forwards <= hi or (full and forwards != hi)
            or counts["attention_int8"] != (counts["attention"] if kv_cache_quant else 0)
            or counts["attention_sharded"] != (counts["attention"] if mesh is not None else 0)
            or counts["vision"] != want_vision):
        raise AssertionError(
            f"batched serve ({what}): {n_answers} answers, launches {counts}; want the "
            f"attention = {layers} layers x {shards} shards x decoder forwards, the forwards "
            f"in [{lo}, {hi}] ({engine.dispatches} dispatches + {gens} batched decodes of a "
            f"prefill and at most {BATCH_MAX_NEW - 1} steps; {hi} when every answer has "
            f"{BATCH_MAX_NEW} tokens: {full}), all of them int8 / sharded under an int8 cache / "
            f"a mesh, and the vision attention {want_vision} = {v_layers} layers x vision "
            f"batches")
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
        f"with {np.mean(engine.gen_lanes):.2f} lanes decoding together on average")
    log(f"batched generation pass ({what}): launches {counts} = {layers} x {shards} x "
        f"{forwards} decoder forwards ({engine.dispatches} dispatches + {gens} decodes x "
        f"{BATCH_MAX_NEW}: {full}); vision {v_layers} x "
        f"{want_vision // v_layers} batches")
    out.update(results=results, counts=counts, frames_per_s=n_frames / wall,
               dispatch_ms_per_frame=1e3 * t_sched / frames_fed,
               decode_tokens_per_s=engine.tokens_generated / t_gen,
               vision_frames_per_s=n_frames / acc["_admit"])
    # the wrappers hold the engine and the engine holds them: without them
    # its cache is freed here, before the next engine allocates its own
    for name in ("_dispatch_sched", "_generate_batch", "_admit"):
        delattr(engine, name)
    del engine, sched
    torch.cuda.empty_cache()

    if grounding:
        scorer = BatchedStreamScorer(
            params, cfg, tok, n_streams=BATCH_LANES, frame_fps=2.0, block_frames=32,
            mesh=mesh, kv_cache_quant=kv_cache_quant)
        videos = [_batch_session(cfg, i)["frames"] for i in range(BATCH_LANES)]
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
        blocks = -(-max(lengths) // 32)
        want = (layers * shards * (1 + blocks),
                v_layers * _vision_batches(BATCH_LANES * max(lengths)))
        ok = all(len(r) == n and all(math.isfinite(d["informative_score"]) for d in r)
                 for r, n in zip(rows, lengths))
        if launches != want or not ok:
            raise AssertionError(
                f"batched grounding pass ({what}): launches (attention, vision) {launches}, "
                f"want {want} = {layers} layers x {shards} shards x (1 prefix + {blocks} "
                f"blocks) and {v_layers} layers x vision batches; rows complete and finite: {ok}")
        n = sum(lengths)
        log(f"batched grounding pass ({what}): {BATCH_LANES} lanes in lockstep 32-frame "
            f"blocks, {n} frames in {t_stream:.3f} s = {1e3 * t_stream / n:.3f} ms per frame, "
            f"{n / t_stream:.2f} frames/s aggregate (the padded lockstep blocks hold "
            f"{BATCH_LANES * max(lengths)} frames); vision {BATCH_LANES * max(lengths)} frames "
            f"in {t_vision:.3f} s = {BATCH_LANES * max(lengths) / t_vision:.2f} frames/s; "
            f"launches (attention, vision) {launches} = {want}")
        out.update(rows=rows, grounding_ms_per_frame=1e3 * t_stream / n)
        out["counts"] = _attention_counts()  # both passes; the path ends here
        del scorer, videos
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    lane_gb = (2 * layers * cfg.text.num_kv_heads * 24576
               * (cfg.text.head_dim + 4 if kv_cache_quant else 2 * cfg.text.head_dim) / 1e9)
    log(f"batched path ({what}): peak device memory {out['peak_gib']:.2f} GiB (the cache "
        f"holds {BATCH_LANES} lanes x {lane_gb:.3f} GB of 24576 slots)")
    return out


def time_vision_routes(cfg, params, log) -> None:
    """The vision tower on 64 frames with kernel D (True and auto, which
    must take kernel D on the card) and, for the comparison only, with the
    plain version put in the kernel's place from here: the package itself
    refuses the matmul route for CUDA tensors (False)."""
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
    diff = (outs[True].float() - outs["plain"].float()).abs().max().item()
    scale = outs["plain"].float().abs().max().item()
    if not torch.equal(outs[None], outs[True]) or not diff <= 0.05 * scale:
        raise AssertionError(f"vision routes: kernel D vs its plain version max|diff| {diff} "
                             f"(max|embedding| {scale}); auto equals kernel D: "
                             f"{torch.equal(outs[None], outs[True])}")
    log(f"vision tower + projector + pooling, 64 frames in batches of 32: "
        f"{rates[True]:.2f} frames/s with vision_use_flash=True (kernel D), {rates[None]:.2f} "
        f"with None (auto = kernel D), {rates['plain']:.2f} with the plain version in the "
        f"kernel's place (the matmul route; vision_use_flash=False is refused on the card); "
        f"embeddings max|diff| {diff:.4f} of max {scale:.2f}")


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
    """The 7B-width training path: TRAIN_STEPS steps of `make_train_step`.
    Returns kernel C's (forward, backward) launches over them."""
    dev = torch.device("cuda")
    args = TrainArgs()  # LoRA r 16 / alpha 32, lr 2e-5 cosine, remat on
    tx, sched = make_optimizer(args, TRAIN_STEPS)
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), cfg.text,
                     rank=args.lora_r, device=dev)
    step = make_train_step(cfg, args, tx, sched)
    batches = duet_batches(tok, cfg, TRAIN_STEPS, TRAIN_ACCUM, dev)
    T = batches[0]["input_ids"].shape[-1]
    n_frames = batches[0]["frames"].shape[1]
    real = [int(b["attn_mask"].sum()) for b in batches]
    log(f"training batches: A={TRAIN_ACCUM} x B=1, T={T} bucket, {n_frames} frame slots "
        f"of 384 px, real tokens per step {real}")
    step(init_train_state(params, lora, tx), params, batches[0])  # warm-up, discarded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    states = [init_train_state(params, lora, tx)]
    times, rows = [], []
    attention.FULL_FWD_LAUNCHES = attention.FULL_BWD_LAUNCHES = 0  # the path starts here
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(states[-1], params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        states.append(state)
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
    flat = [list(_leaves(s.trainable)) for s in states]
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
    return launches

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
    if opts.kernels_only:
        log(f"kernels checked in {time.perf_counter() - t_start:.1f} s")
        return 0
    cfg, tok, params = full_width_model(log)
    dense = run_main_path(cfg, tok, params, log)
    dec["launches"] = dense["attention"]
    full_fwd["launches"], full_bwd["launches"] = run_training(cfg, tok, params, log)
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
    del batched, meshed, batched_int8
    params = quantize_on_card(params, log)
    quantized = run_main_path(cfg, tok, params, log, kv_cache_quant="int8")
    dec_int8["launches"], int4["launches"] = quantized["attention_int8"], quantized["int4_matmul"]
    for key, what in (("p50_ms", "generation pass p50 per-frame ms"),
                      ("grounding_p50_ms", "grounding pass p50 per-frame ms"),
                      ("decode_tokens_per_s", "decode tokens/s"),
                      ("peak_gib", "peak device memory GiB")):
        log(f"int4 weights + int8 cache vs bf16, {what}: {quantized[key]:.3f} vs "
            f"{dense[key]:.3f}")
    del params
    torch.cuda.empty_cache()
    check_small_input(log)
    check_small_input(log, quantized=True)
    check_small_batched(log)
    check_small_train(log)
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dec, dec_int8, sharded, int4, full_fwd, full_bwd, vision]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
