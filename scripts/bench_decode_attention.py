"""Kernels A (streaming attention) and D (the ViT attention) alone on the
card: time them, in turns with other builds of kernel A.

Times kernel A with a bf16 and with an int8 cache at the main path's
shapes (the decode step at cache_len 2048 and 24000, the frame step, the
8- and 32-frame blocks; nh 28, kh 4, hd 128, a 24576-slot cache), the
wrapper's host time per decode-step call, and kernel D beside
`scaled_dot_product_attention` at SigLIP-so400m's (32, 729, 16, 72),
CLIP-L/14-336's (32, 577, 16, 64) and (32, 576, 16, 64) (the same work
without the one-row last block of 192 query rows that 577 leaves); every
time beside its roofline bound (`ops/bounds.py`). A kernel's ms is its device time: calls captured
in a CUDA graph and replayed back to back, on one layer of the cache (what
`chip_smoke.py` times; it stays in L2) and, "cold", each call on the next
of 64 stacked layers (its cache from device memory, as a decoder's is).
Each build of kernel A is checked against the plain version within the row
bound and its rms term at every shape it is timed at (`chip_smoke.py` and
`tests/test_torch_cuda.py` check the rest). From the repository root:

    PYTHONPATH=. python scripts/bench_decode_attention.py [--tag NAME] [--ptxas]
        [--spans 512,1024] [--parent DIR] [--tree NAME DIR ...]
        [--variant NAME OLD NEW ...]

``--ptxas`` also prints what `nvcc -Xptxas -v` says of the two sources
(registers, spills). ``--spans`` also times every shape, with either
cache, with the cache cut into spans of each number of slots (the split
rule, `attention.decode_split_span`, replaced for those timings).
``--parent DIR`` also times the package in DIR (another checkout, e.g. the
parent commit's, unpacked with `git archive`) at every shape, and its
wrapper's host time per decode-step call against this one's (20 runs of
200 calls, in turn: on a shared host, runs in two processes spread more
than the difference). ``--tree NAME DIR`` also times the package in DIR at
every shape, under NAME. ``--variant NAME OLD NEW`` also times a build of
this tree's `csrc/flash_decode.cu` with the text OLD replaced by NEW (it
must occur), loaded in place of the kernel's library for its turns. Builds
are timed in two rounds at each shape, in turn, the second round in
reverse order. The last line is one JSON object of the times (each build's
mean of the two rounds).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
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
VISION = ((32, 729, 16, 72), (32, 577, 16, 64), (32, 576, 16, 64))
# Stacked layers of the cache: a call of the cold timings reads the next one,
# so that its cache comes from device memory (64 layers of int8 K and V at
# cache_len 2048 are 128 MB, against the 50 MB L2), as a decoder's layers do.
LAYERS = 64


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


def checkout_attention(parent_dir: str):
    """The `ops.attention` module of the checkout in ``parent_dir``, imported
    beside this one."""
    for name in [m for m in sys.modules if m.startswith("mmduet_tpu_torch")]:
        del sys.modules[name]  # this package's modules stay alive through `attention`
    sys.path.insert(0, parent_dir)
    try:
        parent = importlib.import_module("mmduet_tpu_torch.ops.attention")
    finally:
        sys.path.remove(parent_dir)
    if not Path(parent.__file__).resolve().is_relative_to(Path(parent_dir).resolve()):
        raise RuntimeError(f"{parent_dir} holds no mmduet_tpu_torch")
    return parent


def host_us_against(sides: dict, call_args, rounds: int = 20, calls: int = 200) -> tuple:
    """Host microseconds per call of the parent's and this package's
    `flash_decode_attention` on the same operands, in turn (the first of
    each round alternating): ({side: sorted per-run values}, the rounds in
    which the change took less)."""
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


def build_variant(name: str, old: str, new: str, into: Path) -> ctypes.CDLL:
    """This tree's kernel A source with ``old`` replaced by ``new``, built
    and loaded with the wrapper's argument types."""
    src = (_build.CSRC / "flash_decode.cu").read_text()
    if old not in src:
        raise SystemExit(f"variant {name}: the text to replace is not in flash_decode.cu")
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, into / header.name)
    (into / f"{name}.cu").write_text(src.replace(old, new))
    lib_path = into / f"{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(into / f"{name}.cu")], check=True)
    return attention.bind_decode_lib(ctypes.CDLL(str(lib_path)))


def ptxas_report(log) -> None:
    for name in ("flash_decode", "flash_vision"):
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "/dev/null",
             str(_build.CSRC / f"{name}.cu")], capture_output=True, text=True)
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line or "warning" in line or "error" in line \
                    or "Compiling entry" in line:
                log(f"{name}: {line.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--spans", default="", help="comma-separated span lengths in slots")
    ap.add_argument("--parent", default=None, help="a checkout holding the package to compare")
    ap.add_argument("--tree", nargs=2, action="append", default=[], metavar=("NAME", "DIR"),
                    help="another checkout to time")
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"), help="a build with OLD replaced by NEW")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_decode_attention: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log = lambda msg: print(f"{args.tag} [{card}] {msg}".strip(), flush=True)  # noqa: E731
    print(card, flush=True)
    _build.build("flash_decode", "flash_vision")
    if args.ptxas:
        ptxas_report(log)
    own = attention._kernel_lib()
    builds = {"change": (attention.flash_decode_attention, own)}
    tmp = Path(tempfile.mkdtemp(prefix="decode_variants_"))
    try:
        for name, old, new in args.variant:
            builds[name] = (attention.flash_decode_attention, build_variant(name, old, new, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, tree in args.tree:
        builds[name] = (checkout_attention(tree).flash_decode_attention, None)
    if args.parent:
        parent = checkout_attention(args.parent)
        builds["parent"] = (parent.flash_decode_attention, None)
    order = (["parent"] if args.parent else []) + [b for b in builds if b != "parent"]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    k_cache, v_cache = randn(LAYERS, 1, KH, S, HD), randn(LAYERS, 1, KH, S, HD)
    (kq, ks), (vq, vs) = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
    caches = {"bf16": (k_cache, v_cache, {}), "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}
    times, decode_args = {}, None
    for name, T, Tc, t_real, q_off, lens in SHAPES:
        q, ck, cv = randn(1, T, NH, HD), randn(1, KH, Tc, HD), randn(1, KH, Tc, HD)
        tr, qo = (torch.tensor([x], dtype=torch.int32, device=dev) for x in (t_real, q_off))
        for cache_len in lens:
            cl = torch.tensor([cache_len], dtype=torch.int32, device=dev)
            for cache, (kc, vc, scales) in caches.items():
                # the plain version on layer 0's live slots, in f32
                live = slice(0, cache_len)
                kv = (kc[:1, ..., live, :], vc[:1, ..., live, :])
                up = (q.float(), *(x.float() if cache == "bf16" else x for x in kv), ck.float(),
                      cv.float(), cl, tr, 0, qo)
                cut = {k_: v_[:1, ..., live] for k_, v_ in scales.items()}
                want = attention.flash_decode_attention_ref(*up, **cut)[:, :t_real]
                rms = bounds.decode_attention_rms(*up, **cut)[:, :t_real]
                bound_ms, by = bounds.decode_attention_bound(1, T, NH, KH, HD, cache_len, t_real,
                                                             q_off, int8=cache == "int8")
                label = f"{'A' if cache == 'bf16' else 'A-int8'} {name} {cache_len}"
                got_ms = {b: [] for b in order}
                cold_ms = {b: [] for b in order}
                for rnd in range(2):
                    for b in (order if rnd == 0 else order[::-1]):
                        fn, lib = builds[b]
                        if lib is not None:
                            attention._lib = lib
                        call = lambda fn=fn: fn(q, kc, vc, ck, cv, cl, tr, 0,  # noqa: E731
                                                q_offset=qo, **scales)
                        ratio = bounds.row_ratio(call()[:, :t_real], want, rms)
                        if not ratio <= 1.0:
                            raise AssertionError(f"{b}: {label} misses its bound ({ratio})")
                        got_ms[b].append(graph_ms(call))
                        turn = iter(range(10 ** 9))
                        cold_ms[b].append(graph_ms(
                            lambda fn=fn: fn(q, kc, vc, ck, cv, cl, tr, next(turn) % LAYERS,
                                             q_offset=qo, **scales), iters=LAYERS))
                attention._lib = own
                for what, per in (("", got_ms), (" cold", cold_ms)):
                    for b, ms in per.items():
                        times[label + what + ("" if b == "change" else f" {b}")] = sum(ms) / len(ms)
                    log(f"kernel A, {cache} cache, {name}, cache_len {cache_len}"
                        + (", a layer from device memory" if what else "") + ": "
                        + ", ".join(f"{b} {' '.join(f'{t:.4f}' for t in per[b])} ms"
                                    for b in order) + f"; bound {bound_ms:.5f} ms ({by})")
                del want, rms
                if args.spans:
                    rule = attention.decode_split_span
                    for span in (int(x) for x in args.spans.split(",")):
                        attention.decode_split_span = lambda rows, S_, span=span: span
                        attention._split_memo.clear()
                        turn = iter(range(10 ** 9))
                        got = [graph_ms(lambda: attention.flash_decode_attention(
                                   q, kc, vc, ck, cv, cl, tr, 0, q_offset=qo, **scales)),
                               graph_ms(lambda: attention.flash_decode_attention(
                                   q, kc, vc, ck, cv, cl, tr, next(turn) % LAYERS, q_offset=qo,
                                   **scales), iters=LAYERS)]
                        times[f"{label} span {span}"], times[f"{label} span {span} cold"] = got
                        log(f"kernel A, {cache} cache, {name}, cache_len {cache_len}, the cache "
                            f"cut into spans of {span} slots: {got[0]:.4f} ms, a layer from "
                            f"device memory {got[1]:.4f} ms")
                    attention.decode_split_span = rule
                    attention._split_memo.clear()
            if name == "decode step" and cache_len == 2048:
                decode_args = ((q, k_cache, v_cache, ck, cv, cl, tr, 0), dict(q_offset=qo))
                call = lambda: attention.flash_decode_attention(  # noqa: E731
                    *decode_args[0], **decode_args[1])
                med, least = host_us(call)
                times["A host us per call"], times["A host us per call, least"] = med, least
                log(f"kernel A's wrapper, {name}: {med:.2f} us of host time per call (median "
                    f"of 7 runs; least {least:.2f})")
        del q, ck, cv
    for i, shape in enumerate(VISION):
        q, k, v = (randn(*shape) for _ in range(3))
        key = "" if i == 0 else f" {shape}"  # SigLIP's keys keep their names
        times["D" + key] = graph_ms(lambda: attention.flash_vision_attention(q, k, v))
        qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))
        times["SDPA" + key] = graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh_, vh))
        bound_ms, by = bounds.vision_attention_bound(*shape)
        log(f"kernel D at {shape}: {times['D' + key]:.4f} ms, scaled_dot_product_attention "
            f"{times['SDPA' + key]:.4f} ms, bound {bound_ms:.5f} ms ({by})")
        del q, k, v, qh, kh_, vh
    if args.parent:
        sides = {"parent": parent.flash_decode_attention,
                 "change": attention.flash_decode_attention}
        per, wins = host_us_against(sides, decode_args)
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
