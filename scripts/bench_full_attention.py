"""Kernel C (the training attention) alone on the card: check and time it.

Builds `mmduet_tpu_torch/ops/csrc/flash_full.cu`, holds the forward (O and
the row log-sum-exp) and the backward (dq, dk, dv) against the plain
versions at a list of shapes, and times forward, backward, each backward
kernel on its own and `scaled_dot_product_attention` at the training
buckets. Needs one CUDA device; run from the repository root:

    PYTHONPATH=. python scripts/bench_full_attention.py [--ptxas] [--quick]
        [--out outputs/full_attention.txt]

`--ptxas` also prints what `nvcc -Xptxas -v` says of every kernel
(registers, spills, shared memory); `--quick` checks the small shapes only
and times nothing.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

import torch

from mmduet_tpu_torch.ops import _build, attention, bounds

NH, KH, HD = 28, 4, 128
# (B, T, real tokens per lane, padding side, nh, kh)
SMALL_CASES = (
    (1, 128, (128,), "right", 1, 1),
    (1, 128, (128,), "right", 2, 1),
    (1, 256, (256,), "right", 2, 1),
    (1, 40, (29,), "right", 4, 2),
    (1, 65, (65,), "right", 4, 2),
    (1, 129, (100,), "left", 4, 2),
    (2, 200, (200, 131), "right", 4, 2),
    (2, 333, (300, 90), "left", NH, KH),
    (1, 640, (600,), "right", NH, KH),
)
BUCKETS = ((1, 1536, (1400,), "right", NH, KH), (1, 2944, (2700,), "right", NH, KH),
           (1, 5924, (5500,), "right", NH, KH), (1, 5924, (5000,), "left", NH, KH))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def make_case(case, gen):
    B, T, real, side, nh, kh = case
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    q, k, v, dout = randn(B, T, nh, HD), randn(B, T, kh, HD), randn(B, T, kh, HD), randn(B, T, nh, HD)
    mask = torch.zeros((B, T), dtype=torch.bool, device=dev)
    for b, n in enumerate(real):
        if side == "right":
            mask[b, :n] = True
        else:
            mask[b, T - n:] = True
    return q, k, v, dout, mask


def check_case(case, gen, log) -> bool:
    q, k, v, dout, mask = make_case(case, gen)
    B, T = mask.shape
    seg = attention._kernel_segments(mask, B, T, q.device)
    out, lse = attention._full_forward(q, k, v, seg)
    dq, dk, dv = attention._full_backward(q, k, v, seg, out, lse, dout)
    dq2, dk2, dv2 = attention._full_backward(q, k, v, seg, out, lse, dout)
    torch.cuda.synchronize()
    ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = attention.flash_full_attention_ref(*ref_leaves, mask)
    want.backward(dout.float())
    want_lse = attention.flash_full_lse_ref(q, k, seg[:, :T])
    rms = bounds.full_attention_rms(q, k, v, mask, dout, out)
    ratios = {}
    for name, g, w, r in zip(("o", "dq", "dk", "dv"), (out, dq, dk, dv),
                             [want.detach()] + [x.grad for x in ref_leaves], rms):
        ratios[name] = bounds.full_attention_ratio(g, w, r)
    lse_err = (lse - want_lse).abs().max().item()
    same = all(torch.equal(a, b) for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)))
    ok = all(math.isfinite(r) and r <= 1.0 for r in ratios.values()) and lse_err <= 1e-3 and same
    log(f"{'ok  ' if ok else 'FAIL'} B={B} T={T} real={case[2]} {case[3]} nh={case[4]} kh={case[5]}: "
        + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items())
        + f" of the bound; |lse - plain| {lse_err:.2e}; two backward runs equal: {same}")
    if not ok:
        # where it went wrong, per 64-row tile of T: the share of rows outside 10x the typical error
        for name, g, w in zip(("o", "dq", "dk", "dv"), (out, dq, dk, dv),
                              [want.detach()] + [x.grad for x in ref_leaves]):
            err = (g.float() - w).abs().amax(dim=(2, 3))  # (B, T)
            tiles = [f"{err[:, t0:t0 + 64].max().item():.2g}" for t0 in range(0, T, 64)]
            log(f"     {name} max|diff| per 64-row tile: " + " ".join(tiles[:24]))
            head = (g.float() - w).abs().amax(dim=(0, 1, 3))
            log(f"     {name} max|diff| per head: " + " ".join(f"{x:.2g}" for x in head.tolist()[:28]))
            cols = (g.float() - w).abs().amax(dim=(0, 1, 2)).reshape(16, 8).amax(1)
            log(f"     {name} max|diff| per 8-column block: " + " ".join(f"{x:.2g}" for x in cols.tolist()))
    return ok


def time_backward_kernels(q, k, v, seg, out, lse, dout, iters: int) -> dict:
    """ms of each backward launch on its own (the launches of
    `attention._full_backward`, in its order)."""
    plan = attention._full_backward_plan(q, k, v, seg, out, lse, dout)
    return {name: time_ms(lambda: attention._full_launch(name, *plan[1][name]), iters)
            for name in attention.FULL_BWD_KERNELS}


def time_sdpa(q, k, v, dout, iters: int) -> dict:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))
    try:
        sdpa(qh, kh_, vh, is_causal=True, enable_gqa=True)
        kw = dict(is_causal=True, enable_gqa=True)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        kh_, vh = (x.repeat_interleave(rep, dim=1) for x in (kh_, vh))
        kw = dict(is_causal=True)
    fwd = time_ms(lambda: sdpa(qh, kh_, vh, **kw), iters)
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh_, vh)]
    res = sdpa(*leaves, **kw)
    g = dout.transpose(1, 2)
    bwd = time_ms(lambda: res.backward(g, retain_graph=True), iters)
    return {"fwd": fwd, "bwd": bwd}


def time_case(case, gen, log, iters: int = 20) -> None:
    q, k, v, dout, mask = make_case(case, gen)
    B, T = mask.shape
    seg = attention._kernel_segments(mask, B, T, q.device)
    out, lse = attention._full_forward(q, k, v, seg)
    fwd = time_ms(lambda: attention._full_forward(q, k, v, seg), iters)
    bwd = time_ms(lambda: attention._full_backward(q, k, v, seg, out, lse, dout), iters)
    each = time_backward_kernels(q, k, v, seg, out, lse, dout, iters)
    lib = time_sdpa(q, k, v, dout, iters)
    fb, _ = bounds.full_attention_bound(B, T, case[4], case[5], HD, backward=False)
    bb, _ = bounds.full_attention_bound(B, T, case[4], case[5], HD, backward=True)
    log(f"T={T} {case[3]}-padded real={case[2]}: forward {fwd:.4f} ms (SDPA {lib['fwd']:.4f}, "
        f"bound {fb:.5f}), backward {bwd:.4f} ms (SDPA {lib['bwd']:.4f}, bound {bb:.5f}); "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in each.items()) + " ms")


def ptxas_report(log) -> None:
    src = _build.CSRC / "flash_full.cu"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "/dev/null", str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "error", "warning")):
            log("ptxas: " + line.strip())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_full_attention: no CUDA device", file=sys.stderr)
        return 1
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    if args.ptxas:
        ptxas_report(log)
    gen = torch.Generator(device="cuda").manual_seed(5)
    ok = True
    for case in SMALL_CASES + (() if args.quick else BUCKETS):
        ok = check_case(case, gen, log) and ok
        torch.cuda.empty_cache()
    if not args.quick:
        for case in BUCKETS:
            time_case(case, gen, log)
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
