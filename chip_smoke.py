"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit):

1. the card's name and power limit, from nvidia-smi;
2. every CUDA kernel of the two paths, built from the sources in this
   checkout (one nvcc per source, all at once), held against its plain
   PyTorch version on the card at the shapes the paths give it, and timed
   beside it: kernel A (streaming attention) and kernel C (training
   attention, forward and the three input gradients); plain versions that
   lose one tile must fail kernel C's bounds;
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
   three backward kernels);
5. small-model checks, card (bf16, kernels) against CPU (f32, plain
   versions): grounding scores of the engine, and one train step's loss
   and gradient norm;
6. one JSON line for the kernels, then the result line
   ``{"ok": true, "device": {...}}``.

It needs `torch` with CUDA; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch

from mmduet_tpu.config import MMDuetConfig, TestArgs, TrainArgs, tiny_config
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import init_lora, init_mmduet_params, mmduet
from mmduet_tpu_torch.ops import _build, attention, bounds
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
TIMED_CACHE_LEN = 2048


def check_attention_kernel(log) -> dict:
    """flash_decode_attention (CUDA) vs flash_decode_attention_ref on the
    card; returns the kernel's JSON entry (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    nh, kh, hd, L, S = 28, 4, 128, 4, 24576

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    worst = worst_ratio = 0.0
    timed = {}
    cases = [(shape, cl, 1) for shape in ATTN_SHAPES for cl in CACHE_LENS]
    cases.append((ATTN_SHAPES[1], (2047, 9999), 2))  # B=2, two cursors
    for i, ((name, T, Tc, t_real, q_off), cache_len, B) in enumerate(cases):
        layer = 3 if i % 2 else 0
        q = randn(B, T, nh, hd)
        k_cache, v_cache = randn(L, B, kh, S, hd), randn(L, B, kh, S, hd)
        ck, cv = randn(B, kh, Tc, hd), randn(B, kh, Tc, hd)
        cl = cache_len if isinstance(cache_len, tuple) else (cache_len,) * B
        args = (q, k_cache, v_cache, ck, cv,
                torch.tensor(cl, dtype=torch.int32, device=dev),
                torch.tensor((t_real,) * B, dtype=torch.int32, device=dev),
                layer, torch.tensor((q_off,) * B, dtype=torch.int32, device=dev))
        got = attention.flash_decode_attention(*args)
        # the plain version on the same values in f32: the kernel's only
        # rounding is then its bf16 output
        want = attention.flash_decode_attention_ref(
            *(a.float() if torch.is_tensor(a) and a.is_floating_point() else a
              for a in args))
        torch.cuda.synchronize()
        err = (got[:, :t_real].float() - want[:, :t_real]).abs().max().item()
        ratio = bounds.row_ratio(got[:, :t_real], want[:, :t_real])
        if not math.isfinite(ratio) or ratio > 1.0:
            raise AssertionError(
                f"flash_decode kernel vs plain: {name} B={B} cache_len={cl} "
                f"layer={layer}: max|diff| {err}, {ratio} times the row bound "
                f"{bounds.ROW_REL} * max|row| + {bounds.ROW_ABS}"
            )
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        if B == 1 and cache_len == TIMED_CACHE_LEN:
            ms = _time_ms(lambda: attention.flash_decode_attention(*args), 20)
            plain_ms = _time_ms(lambda: attention.flash_decode_attention_ref(*args), 3)
            timed[name] = (ms, plain_ms)
            log(f"flash_decode {name}: T={T} Tc={Tc} cache_len={cache_len} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        del q, k_cache, v_cache, ck, cv, args, got, want
    log(f"flash_decode: {len(cases)} cases within {bounds.ROW_REL} * max|row| + {bounds.ROW_ABS} "
        f"(max|diff| {worst}, at most {worst_ratio} of the row bound)")
    ms, plain_ms = timed["8-frame block"]
    return {
        "name": "flash_decode_attention",
        "route": "cuda",
        "source": "mmduet_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "mmduet_tpu/ops/attention.py:218",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }


# Kernel C at the training shapes: B=1, 7B heads (nh 28, kh 4, hd 128),
# bf16. (T, real tokens, padding side): the three length buckets of
# parse_length_buckets("auto", 5924) right-padded as the collator pads, one
# left-padded case and one tiny T.
FULL_CASES = ((1536, 1400, "right"), (2944, 2700, "right"), (5924, 5500, "right"),
              (2944, 2000, "left"), (40, 29, "right"))
TIMED_T = 2944
DROP_TILE = 20  # the tile [64 * 20, 64 * 21) of the mutated plain versions


def check_full_attention_kernel(log) -> List[dict]:
    """flash_full_attention (CUDA, forward and backward) vs
    flash_full_attention_ref on the card; returns kernel C's two JSON
    entries (without launches)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    nh, kh, hd = 28, 4, 128
    worst = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}  # max|diff|, max ratio
    timed = {}
    for T, n_real, side in FULL_CASES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

        q, k, v, dout = randn(1, T, nh, hd), randn(1, T, kh, hd), randn(1, T, kh, hd), randn(1, T, nh, hd)
        mask = torch.zeros((1, T), dtype=torch.bool, device=dev)
        if side == "right":
            mask[:, :n_real] = True
        else:
            mask[:, T - n_real:] = True
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
            timed = _time_full(q, k, v, mask, dout)
            log(f"flash_full T={T} (nh 28, kh 4, hd 128, bf16): forward kernel "
                f"{timed['fwd'][0]:.4f} ms, plain {timed['fwd'][1]:.4f} ms; backward kernel "
                f"{timed['bwd'][0]:.4f} ms, plain {timed['bwd'][1]:.4f} ms; forward+backward "
                f"kernel {timed['fwd+bwd'][0]:.4f} ms, plain {timed['fwd+bwd'][1]:.4f} ms")
        elif T != 40:
            t = _time_full(q, k, v, mask, dout)
            log(f"flash_full T={T} ({side}-padded): forward kernel {t['fwd'][0]:.4f} ms, "
                f"plain {t['fwd'][1]:.4f} ms; forward+backward kernel "
                f"{t['fwd+bwd'][0]:.4f} ms, plain {t['fwd+bwd'][1]:.4f} ms")
        del q, k, v, dout, leaves, got, got_grads, want, want_grads, rms, outputs
        torch.cuda.empty_cache()
    log(f"flash_full: {len(FULL_CASES)} cases, o within the bound at most "
        f"{worst['fwd'][1]:.3f} of it (max|diff| {worst['fwd'][0]}); dq, dk, dv at most "
        f"{worst['bwd'][1]:.3f} of it (max|diff| {worst['bwd'][0]})")
    entry = {"route": "cuda", "source": "mmduet_tpu_torch/ops/csrc/flash_full.cu",
             "replaces": "mmduet_tpu/ops/attention.py:569"}
    return [
        dict(entry, name="flash_full_attention (forward)", max_abs_err=worst["fwd"][0],
             ms=timed["fwd"][0], plain_ms=timed["fwd"][1]),
        dict(entry, name="flash_full_attention (backward: preprocess, dK/dV, dQ; "
             "launches count each of the three)",
             max_abs_err=worst["bwd"][0], ms=timed["bwd"][0], plain_ms=timed["bwd"][1]),
    ]


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


def _args(**kw) -> TestArgs:
    return TestArgs(frame_fps=2.0, max_new_tokens=32, **kw)


def _grounding_scores(engine, frames, query) -> List[float]:
    engine.reset()
    engine.input_video_stream(frames)
    engine.input_query_stream([{"role": "user", "content": query, "time": 0.0}])
    engine.inference()
    return [d["informative_score"] for d in engine.debug_data_list]


SMALL_TOL = 3e-2  # score probabilities through 2 layers with bf16
# activations (8-bit mantissa) on the card vs f32 on the CPU, on the
# same bf16-valued weights


def check_small_input(log) -> float:
    """The card's bf16 engine (attention through the kernel) against the
    same engine on the CPU in f32 (the plain attention), on a small
    model whose head_dim is 128: grounding scores agree."""
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    cpu = torch.device("cpu")
    params = init_mmduet_params(cfg, torch.Generator(device=cpu).manual_seed(1), cpu)
    params = _tree_map(lambda t: t.to(torch.bfloat16).float(), params)
    frames = np.random.RandomState(1).randint(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    args = _args(stream_end_prob_threshold=1.0, grounding_mode=True, max_num_frames=16)
    want = _grounding_scores(LiveInferEngine(params, cfg, tok, args), frames, "Q?")
    on_card = _tree_map(lambda t: t.to("cuda", torch.bfloat16), params)
    got = _grounding_scores(LiveInferEngine(on_card, cfg, tok, args), frames, "Q?")
    err = float(np.abs(np.array(got) - np.array(want)).max())
    if len(got) != len(want) or not err <= SMALL_TOL:
        raise AssertionError(f"small input: card vs CPU scores max|diff| {err} > {SMALL_TOL}")
    log(f"small input (hd=128, 2 layers, 12 frames): card bf16 vs CPU f32 "
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


def run_main_path(cfg, tok, params, log) -> int:
    """The 7B-width serving path: generation pass, then grounding pass.
    Returns the attention kernel's launches over both passes."""
    frames = np.random.RandomState(0).randint(
        0, 256, (N_FRAMES, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    query = [{"role": "user", "content": QUERY, "time": 0.0}]

    gen = LiveInferEngine(params, cfg, tok, _args(stream_end_score_sum_threshold=1.0))
    ground = LiveInferEngine(params, cfg, tok, _args(
        stream_end_score_sum_threshold=1.0, grounding_mode=True))
    gen.input_video_stream(frames[:32])  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    gen.reset()
    torch.cuda.reset_peak_memory_stats()

    stats = {}
    attention.LAUNCHES = 0  # the main path starts here
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
    launches = attention.LAUNCHES  # the main path ends here

    for (name, s), engine in zip(stats.items(), (gen, ground)):
        log(f"{name} pass: block {engine.block_frames}, "
            f"{N_FRAMES} frames, p50 per-frame {s['p50_ms']:.3f} ms, stream "
            f"{s['stream_s']:.3f} s, vision {N_FRAMES / s['vision_s']:.2f} frames/s, "
            f"{s['launches']} attention launches, "
            f"{sum(r['role'] == 'assistant' for r in s['responses'])} responses")
    log(f"peak device memory (streaming passes): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _time_decode(gen, cfg, log)
    return launches


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
    k = engine.state.kv_cache.k
    margin = engine.block_frames * engine.cfg.frame_num_tokens + 256
    if not bool((k[:, 0, :, :cursor].abs().amax(dim=-1) > 0).all()):
        raise AssertionError(f"{name} pass: a committed cache slot is empty")
    if bool((k[:, 0, :, cursor + margin:] != 0).any()):
        raise AssertionError(f"{name} pass: cache written past the cursor")


def _time_decode(engine, cfg, log) -> None:
    """Greedy decode of 32 tokens (EOS disabled) at the cache length the
    generation pass left, timed with a device sync."""
    n_new = 32
    embeds = engine._embed_ids(engine._gen_prompt_ids)[None]
    pen = torch.zeros((1, cfg.text.vocab_size), dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        for timed in (False, True):
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
    log(f"decode: {n} tokens at cache length {engine.state.cursor} in {dt:.3f} s "
        f"= {n / dt:.2f} tokens/s (prompt prefill included)")


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
    want = (2 * calls, 3 * calls)
    if launches != want:
        raise AssertionError(f"training: kernel C launches (forward, backward) {launches}, "
                             f"want {want} (the forward twice per layer under remat, three "
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

def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(card, flush=True)

    def log(msg):
        print(f"[{card}] {msg}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built from csrc/ in {time.perf_counter() - t0:.1f} s")
    entry = check_attention_kernel(log)
    full_fwd, full_bwd = check_full_attention_kernel(log)
    cfg, tok, params = full_width_model(log)
    entry["launches"] = run_main_path(cfg, tok, params, log)
    full_fwd["launches"], full_bwd["launches"] = run_training(cfg, tok, params, log)
    del params
    torch.cuda.empty_cache()
    check_small_input(log)
    check_small_train(log)
    print(json.dumps({"kernels": [entry, full_fwd, full_bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
