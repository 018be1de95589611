"""Kernels A (streaming attention) and D (the ViT attention) alone on the
card: time them, in turns with other builds of kernel A.

Times kernel A with a bf16 and with an int8 cache at the main path's
shapes (the decode step at cache_len 2048 and 24000, the frame step, the
8- and 32-frame blocks; hd 128, a 24576-slot cache) for each head count
of ``--heads`` (nh:kh, default the 7B's 28:4; 14:2 and 7:1 are a rank's
of a (1, 2) and a (1, 4) tensor-parallel mesh), beside
`scaled_dot_product_attention` on the same operands (bf16 cache: the cache
prefix and the chunk concatenated beforehand, an explicit mask,
``enable_gqa``), the wrapper's host time per decode-step call, and kernel D
beside `scaled_dot_product_attention` at SigLIP-so400m's (32, 729, 16, 72),
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
        [--heads 28:4,14:2,7:1] [--no-vision] [--sharded] [--parent DIR]
        [--tree NAME DIR ...] [--variant NAME OLD NEW ...] [--rule NAME SPEC ...]

``--ptxas`` also prints what `nvcc -Xptxas -v` says of the two sources
(registers, spills). ``--no-vision`` leaves kernel D out. ``--sharded``
also times kernel A' (`chip_smoke.py`'s case: the 8-frame block at 8
lanes with a cursor each on the (2, 2) one-device mesh, four launches, held
bit-equal to one launch) for every build. ``--parent DIR`` also times the package in DIR
(another checkout, e.g. the parent commit's, unpacked with `git archive`)
at every shape, and its wrapper's host time per decode-step call against
this one's (20 runs of 200 calls, in turn: on a shared host, runs in two
processes spread more than the difference). ``--tree NAME DIR`` also
times the package in DIR at every shape, under NAME. ``--variant NAME OLD
NEW`` also times a build of this tree's `csrc/flash_decode.cu` with the
text OLD replaced by NEW (it must occur), loaded in place of the kernel's
library for its turns. ``--rule NAME SPEC`` also times this build under
another split rule (`attention.SPLIT_RULE`), SPEC being its entries as
``tiles:span_min:most`` joined by commas. Builds are timed in two rounds
at each shape, in turn, the second round in reverse order. The last line
is one JSON object of the times (each build's mean of the two rounds).
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

HD, S = 128, 24576
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


def sdpa_decode_call(q, k_cache, v_cache, ck, cv, cache_len: int, t_real: int, q_off: int):
    """One `scaled_dot_product_attention` call computing kernel A's function
    with a bf16 cache on layer 0 (the library's yardstick; the port never
    calls it): the cache prefix and the chunk concatenated beforehand, an
    explicit boolean mask, ``enable_gqa``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    T, Tc, dev = q.shape[1], ck.shape[2], q.device
    k = torch.cat([k_cache[0, :, :, :cache_len], ck], dim=2)
    v = torch.cat([v_cache[0, :, :, :cache_len], cv], dim=2)
    row, col = torch.arange(T, device=dev)[:, None], torch.arange(Tc, device=dev)[None]
    mask = torch.cat([torch.ones((T, cache_len), dtype=torch.bool, device=dev),
                      (col <= q_off + row) & (col < t_real)], dim=1)
    qh = q.transpose(1, 2)
    return lambda: sdpa(qh, k, v, attn_mask=mask, enable_gqa=True)


# Kernel A' as `chip_smoke.py` times it: the 8-frame block at 8 lanes, one
# cursor each, on the (2, 2) one-device mesh (four launches), bf16 cache.
SHARD_LANES = (0, 1, 63, 700, 2047, 2048, 4999, 6000)


def time_sharded(builds, order, own, own_rule, use_rule, randn, dev, times, log) -> None:
    from mmduet_tpu_torch.parallel import make_mesh
    from mmduet_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    B, nh, kh, T = len(SHARD_LANES), 28, 4, 392
    kc, vc = randn(2, B, kh, S, HD), randn(2, B, kh, S, HD)
    q, ck, cv = randn(B, T, nh, HD), randn(B, kh, T, HD), randn(B, kh, T, HD)
    cl = torch.tensor(SHARD_LANES, dtype=torch.int32, device=dev)
    tr = torch.tensor([max(1, T - 3 * b) for b in range(B)], dtype=torch.int32, device=dev)
    qo = torch.zeros(B, dtype=torch.int32, device=dev)
    got = {b: [] for b in order}
    for rnd in range(2):
        for b in (order if rnd == 0 else order[::-1]):
            fn, lib, rule = builds[b]
            mod = fn.__globals__  # the build's own `ops.attention`
            ctx = mod["ShardCtx"](make_mesh((2, 2), devices=[dev] * 4), lane_axis=DATA_AXIS,
                                  head_axis=MODEL_AXIS)
            if lib is not None:
                attention._lib = lib
            use_rule(rule)
            one = fn(q, kc, vc, ck, cv, cl, tr, 0, q_offset=qo)
            call = lambda mod=mod, ctx=ctx: mod["flash_decode_attention_sharded"](  # noqa: E731
                q, kc, vc, ck, cv, cl, tr, 0, ctx, q_offset=qo)
            if not torch.equal(call(), one):
                raise AssertionError(f"{b}: kernel A' not bit-equal to one launch")
            got[b].append(graph_ms(call))
    attention._lib = own
    use_rule(own_rule)
    for b, ms in got.items():
        times["A' (2, 2) 8-frame block" + ("" if b == "change" else f" {b}")] = sum(ms) / len(ms)
    log("kernel A' on the (2, 2) one-device mesh, 8-frame block, 8 lanes at cursors "
        f"{SHARD_LANES}: " + ", ".join(f"{b} {' '.join(f'{t:.4f}' for t in got[b])} ms"
                                       for b in order))


def parse_rule(spec: str) -> tuple:
    return tuple(tuple(int(x) for x in entry.split(":")) for entry in spec.split(","))


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
    ap.add_argument("--heads", default="28:4", help="comma-separated nh:kh head counts")
    ap.add_argument("--no-vision", action="store_true", help="leave kernel D out")
    ap.add_argument("--sharded", action="store_true",
                    help="also time kernel A' on the (2, 2) one-device mesh")
    ap.add_argument("--rule", nargs=2, action="append", default=[], metavar=("NAME", "SPEC"),
                    help="this build under another split rule, tiles:span_min:most,...")
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
    own_rule = attention.SPLIT_RULE
    # name: (the wrapper, the library to load for its turns, the split rule)
    builds = {"change": (attention.flash_decode_attention, own, own_rule)}
    tmp = Path(tempfile.mkdtemp(prefix="decode_variants_"))
    try:
        for name, old, new in args.variant:
            builds[name] = (attention.flash_decode_attention,
                            build_variant(name, old, new, tmp), own_rule)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, spec in args.rule:  # a rule for this build, or for the variant of that name
        fn, lib, _ = builds.get(name, (attention.flash_decode_attention, own, None))
        builds[name] = (fn, lib, parse_rule(spec))
    for name, tree in args.tree:
        builds[name] = (checkout_attention(tree).flash_decode_attention, None, None)
    if args.parent:
        parent = checkout_attention(args.parent)
        builds["parent"] = (parent.flash_decode_attention, None, None)
    order = (["parent"] if args.parent else []) + [b for b in builds if b != "parent"]

    own_max = attention.SPLIT_MAX

    def use_rule(rule):
        """The split rule of a build's turns (None: the parent's, untouched)."""
        if rule is not None:
            attention.SPLIT_RULE = rule
            attention.SPLIT_MAX = max(own_max, *(most for _, _, most in rule))
            attention._split_memo.clear()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    times, decode_args = {}, None
    for heads in args.heads.split(","):
        NH, KH = (int(x) for x in heads.split(":"))
        # the 7B's keys keep their names; a rank's carry its head counts
        prefix = "" if (NH, KH) == (28, 4) else f"{NH}:{KH} "
        k_cache, v_cache = randn(LAYERS, 1, KH, S, HD), randn(LAYERS, 1, KH, S, HD)
        (kq, ks), (vq, vs) = quantize_kv_rows(k_cache), quantize_kv_rows(v_cache)
        caches = {"bf16": (k_cache, v_cache, {}),
                  "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}
        for name, T, Tc, t_real, q_off, lens in SHAPES:
            q, ck, cv = randn(1, T, NH, HD), randn(1, KH, Tc, HD), randn(1, KH, Tc, HD)
            tr, qo = (torch.tensor([x], dtype=torch.int32, device=dev) for x in (t_real, q_off))
            for cache_len in lens:
                cl = torch.tensor([cache_len], dtype=torch.int32, device=dev)
                for cache, (kc, vc, scales) in caches.items():
                    # the plain version on layer 0's live slots, in f32
                    live = slice(0, cache_len)
                    kv = (kc[:1, ..., live, :], vc[:1, ..., live, :])
                    up = (q.float(), *(x.float() if cache == "bf16" else x for x in kv),
                          ck.float(), cv.float(), cl, tr, 0, qo)
                    cut = {k_: v_[:1, ..., live] for k_, v_ in scales.items()}
                    want = attention.flash_decode_attention_ref(*up, **cut)[:, :t_real]
                    rms = bounds.decode_attention_rms(*up, **cut)[:, :t_real]
                    bound_ms, by = bounds.decode_attention_bound(
                        1, T, NH, KH, HD, cache_len, t_real, q_off, int8=cache == "int8")
                    label = f"{prefix}{'A' if cache == 'bf16' else 'A-int8'} {name} {cache_len}"
                    got_ms = {b: [] for b in order}
                    cold_ms = {b: [] for b in order}
                    for rnd in range(2):
                        for b in (order if rnd == 0 else order[::-1]):
                            fn, lib, rule = builds[b]
                            if lib is not None:
                                attention._lib = lib
                            use_rule(rule)
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
                    use_rule(own_rule)
                    for what, per in (("", got_ms), (" cold", cold_ms)):
                        for b, ms in per.items():
                            times[label + what + ("" if b == "change" else f" {b}")] = \
                                sum(ms) / len(ms)
                        log(f"kernel A, nh {NH} kh {KH}, {cache} cache, {name}, cache_len "
                            f"{cache_len}" + (", a layer from device memory" if what else "")
                            + ": " + ", ".join(f"{b} {' '.join(f'{t:.4f}' for t in per[b])} ms"
                                               for b in order)
                            + f"; bound {bound_ms:.5f} ms ({by})")
                    if cache == "bf16":
                        sdpa = sdpa_decode_call(q, kc, vc, ck, cv, cache_len, t_real, q_off)
                        ratio = bounds.row_ratio(sdpa().transpose(1, 2)[:, :t_real], want, rms)
                        if not ratio <= 1.0:
                            raise AssertionError(f"SDPA: {label} misses kernel A's bound ({ratio})")
                        times[f"{prefix}SDPA {name} {cache_len}"] = sdpa_ms = graph_ms(sdpa)
                        log(f"scaled_dot_product_attention, nh {NH} kh {KH}, {name}, cache_len "
                            f"{cache_len}: {sdpa_ms:.4f} ms ({ratio:.3f} of kernel A's row bound)")
                        del sdpa
                    del want, rms
                if name == "decode step" and cache_len == 2048 and decode_args is None:
                    decode_args = ((q, k_cache, v_cache, ck, cv, cl, tr, 0), dict(q_offset=qo))
                    call = lambda: attention.flash_decode_attention(  # noqa: E731
                        *decode_args[0], **decode_args[1])
                    med, least = host_us(call)
                    times["A host us per call"], times["A host us per call, least"] = med, least
                    log(f"kernel A's wrapper, {name}: {med:.2f} us of host time per call (median "
                        f"of 7 runs; least {least:.2f})")
            del q, ck, cv
        del k_cache, v_cache, kq, ks, vq, vs, caches
    if args.sharded:
        time_sharded(builds, order, own, own_rule, use_rule, randn, dev, times, log)
    for i, shape in enumerate(() if args.no_vision else VISION):
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
