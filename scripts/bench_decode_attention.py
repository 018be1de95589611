"""Kernels A (streaming attention) and D (the ViT attention) alone on the
card: time them.

Times kernel A with a bf16 cache at the main path's shapes (the decode step
at cache_len 2048 and 24000, the frame step, the 8- and 32-frame blocks;
nh 28, kh 4, hd 128, a 24576-slot cache), its int8-cache variant at the
decode step and the 8-frame block, the wrapper's host time per decode-step
call, and kernel D at (32, 729, 16, 72) beside
`scaled_dot_product_attention`; every time beside its roofline bound
(`ops/bounds.py`). A kernel's ms is its device time: calls captured in a
CUDA graph and replayed back to back. Checks nothing (`chip_smoke.py` and
`tests/test_torch_cuda.py` do). It uses only the package's public entry
points, so it times whichever tree is first on the path; from the
repository root:

    PYTHONPATH=. python scripts/bench_decode_attention.py [--tag NAME] [--ptxas]
        [--spans 512,1024] [--parent DIR]

``--ptxas`` also prints what `nvcc -Xptxas -v` says of the two sources
(registers, spills). ``--spans`` also times the frame step and the blocks
with the cache cut into spans of each number of slots (the split rule,
`attention.decode_split_span`, replaced for those timings). ``--parent DIR``
also times the wrapper's host time per decode-step call against the package
in DIR (another checkout, e.g. the parent commit's, unpacked with `git
archive`), both loaded in this process and called in turn, 20 runs of 200
calls each: on a shared host, runs in two processes spread more than the
difference. The last line is one JSON object of the times.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from mmduet_tpu_torch.models.qwen2 import quantize_kv_rows
from mmduet_tpu_torch.ops import _build, attention, bounds

NH, KH, HD, S = 28, 4, 128, 24576
# (name, T, Tc, t_real, q_offset, cache lens)
SHAPES = (("decode step", 1, 31, 11, 10, (2048, 24000)), ("frame step", 64, 64, 53, 0, (2048,)),
          ("8-frame block", 392, 392, 392, 0, (2048,)),
          ("32-frame block", 1568, 1568, 1568, 0, (2048,)))
INT8_TIMED = ("decode step", "8-frame block")
VISION = (32, 729, 16, 72)


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms of one call of ``fn``, from a CUDA graph of ``iters`` calls."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def host_us(fn, calls: int = 200, runs: int = 7) -> tuple:
    """Host microseconds per call over ``runs`` runs of ``calls``: (median,
    least). The host is shared, so noise only adds: the least is the
    wrapper's own cost, the median what a run meets."""
    per = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return sorted(per)[runs // 2], min(per)


def host_us_against(parent_dir: str, call_args, rounds: int = 20, calls: int = 200) -> tuple:
    """Host microseconds per call of this package's and ``parent_dir``'s
    `flash_decode_attention` on the same operands, in turn (the first of
    each round alternating): ({side: sorted per-run values}, the rounds in
    which the change took less)."""
    for name in [m for m in sys.modules if m.startswith("mmduet_tpu_torch")]:
        del sys.modules[name]  # this package's modules stay alive through `attention`
    sys.path.insert(0, parent_dir)
    try:
        parent = importlib.import_module("mmduet_tpu_torch.ops.attention")
    finally:
        sys.path.remove(parent_dir)
    if not Path(parent.__file__).resolve().is_relative_to(Path(parent_dir).resolve()):
        raise RuntimeError(f"{parent_dir} holds no mmduet_tpu_torch")
    sides = {"parent": parent.flash_decode_attention, "change": attention.flash_decode_attention}
    per = {side: [] for side in sides}
    for r in range(rounds):
        for side in (("parent", "change") if r % 2 == 0 else ("change", "parent")):
            fn = sides[side]
            for _ in range(20):
                fn(*call_args[0], **call_args[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*call_args[0], **call_args[1])
            per[side].append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
    wins = sum(c < p for c, p in zip(per["change"], per["parent"]))
    return {side: sorted(v) for side, v in per.items()}, wins


def ptxas_report(log) -> None:
    for name in ("flash_decode", "flash_vision"):
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "/dev/null",
             str(_build.CSRC / f"{name}.cu")], capture_output=True, text=True)
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"{name}: {line.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--spans", default="", help="comma-separated span lengths in slots")
    ap.add_argument("--parent", default=None, help="a checkout holding the package to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_decode_attention: no CUDA device", file=sys.stderr)
        return 1
    log = lambda msg: print(f"{args.tag} {msg}".strip(), flush=True)  # noqa: E731
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    _build.build("flash_decode", "flash_vision")
    if args.ptxas:
        ptxas_report(log)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    k_cache, v_cache = randn(1, 1, KH, S, HD), randn(1, 1, KH, S, HD)
    (kq, ks), (vq, vs) = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
    times = {}
    for name, T, Tc, t_real, q_off, lens in SHAPES:
        q, ck, cv = randn(1, T, NH, HD), randn(1, KH, Tc, HD), randn(1, KH, Tc, HD)
        tr, qo = (torch.tensor([x], dtype=torch.int32, device=dev) for x in (t_real, q_off))
        for cache_len in lens:
            cl = torch.tensor([cache_len], dtype=torch.int32, device=dev)
            call = lambda: attention.flash_decode_attention(  # noqa: E731
                q, k_cache, v_cache, ck, cv, cl, tr, 0, q_offset=qo)
            bound_ms, by = bounds.decode_attention_bound(1, T, NH, KH, HD, cache_len, t_real, q_off)
            key = f"A {name} {cache_len}"
            times[key] = graph_ms(call)
            log(f"kernel A, bf16 cache, {name}, cache_len {cache_len}: {times[key]:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({by})")
            if name in INT8_TIMED and cache_len == 2048:
                key = f"A-int8 {name} {cache_len}"
                times[key] = graph_ms(lambda: attention.flash_decode_attention(
                    q, kq, vq, ck, cv, cl, tr, 0, q_offset=qo, k_scale=ks, v_scale=vs))
                log(f"kernel A, int8 cache, {name}, cache_len {cache_len}: {times[key]:.4f} ms")
            if name != "decode step" and args.spans:
                rule = attention.decode_split_span
                for span in (int(x) for x in args.spans.split(",")):
                    attention.decode_split_span = lambda rows, S_, span=span: span
                    attention._split_memo.clear()
                    key = f"A {name} {cache_len} span {span}"
                    times[key] = graph_ms(call)
                    log(f"kernel A, bf16 cache, {name}, cache_len {cache_len}, the cache cut into "
                        f"spans of {span} slots: {times[key]:.4f} ms")
                attention.decode_split_span = rule
                attention._split_memo.clear()
            if name == "decode step" and cache_len == 2048:
                decode_args = ((q, k_cache, v_cache, ck, cv, cl, tr, 0), dict(q_offset=qo))
                med, least = host_us(call)
                times["A host us per call"], times["A host us per call, least"] = med, least
                log(f"kernel A's wrapper, {name}: {med:.2f} us of host time per call (median "
                    f"of 7 runs; least {least:.2f})")
        del q, ck, cv
    q, k, v = (randn(*VISION) for _ in range(3))
    times["D"] = graph_ms(lambda: attention.flash_vision_attention(q, k, v))
    qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))
    times["SDPA"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh_, vh))
    bound_ms, by = bounds.vision_attention_bound(*VISION)
    log(f"kernel D at {VISION}: {times['D']:.4f} ms, scaled_dot_product_attention "
        f"{times['SDPA']:.4f} ms, bound {bound_ms:.5f} ms ({by})")
    if args.parent:
        per, wins = host_us_against(args.parent, decode_args)
        for side, xs in per.items():
            n = len(xs)
            times[f"A host us per call, {side} in turn"] = xs[n // 2]
            log(f"kernel A's wrapper, decode step, {side} ({args.parent if side == 'parent' else '.'}"
                f"), called in turn: median {xs[n // 2]:.2f} us, least {xs[0]:.2f}, quartiles "
                f"{xs[n // 4]:.2f}-{xs[3 * n // 4]:.2f} ({n} runs of 200 calls)")
        log(f"kernel A's wrapper, decode step: the change below the parent in {wins} of "
            f"{len(per['change'])} rounds")
    print(json.dumps({"tag": args.tag, **{k_: round(v_, 5) for k_, v_ in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
