"""Where the time of the PyTorch port's main path goes, on one NVIDIA GPU.

    PYTHONPATH=. python scripts/profile_torch.py [--out FILE]

At the default `MMDuetConfig` (Qwen2-7B decoder, SigLIP-so400m at 384 px,
random bf16 weights from seed 0, the engine's 24576-slot KV cache) it
profiles these calls of the main paths:

- vision encode of 32 frames (`mmduet.visual_embed`, one engine batch),
  with kernel D and with its plain version put in the kernel's place from
  this script (the matmul route, which the package refuses for CUDA
  tensors);
- an 8-frame block at cursor 2000 (`mmduet.frames_block_forward`);
- a 32-frame block at cursor 2000;
- a greedy decode of 8 tokens (EOS off) after an 8-token prompt at
  cursor 3000 (`mmduet.decode_loop`);
- the batched engine's calls at B = 8 lanes with cursors 500 to 4000: an
  8-frame block on every lane (`mmduet.chunk_scores_forward`, 3136 rows)
  and a greedy decode of 8 tokens on all lanes together;
- one training step (`train.make_train_step`: A=2 micro-batches of one
  collated duet sample each, 48 pixel frames at 384 px, padded to the
  2944-token bucket, LoRA r 16, gradient checkpointing on), with the
  batches of `chip_smoke.py`'s training phase (`train.duet.duet_batches`);
- the two blocks and the decode again on the quantized tree
  (`quantize_params(bits=4)` on the card: int4 decoder, embedding and LM
  head through kernel B) with an int8 KV cache (kernel A's int8 variant).

For each call: the wall time (host clock around a device sync, median of
3 after one warm-up, profiler off), the summed time of the device's own
events under `torch.profiler` (one more call), the device's idle share
(1 - device / wall), the shares of kernel A (flash_decode), kernel B
(int4_: the product, one launch a call), kernel C
(flash_full: forward, backward preprocess, dK/dV partials, their reduction,
dQ) and kernel D
(flash_vision), and the costliest
device kernels. Lines go to stdout and, with ``--out``, to FILE.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mmduet_tpu_torch.config import MMDuetConfig, TrainArgs
from mmduet_tpu_torch.stream import CharTokenizer
from mmduet_tpu_torch.models import (init_kv_cache, init_lora, init_mmduet_params, mmduet,
                                     quant, siglip)
from mmduet_tpu_torch.ops import attention
from mmduet_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from mmduet_tpu_torch.train.duet import duet_batches

KERNELS = {"kernel A": "flash_decode_", "kernel B": "int4_", "kernel C": "flash_full_",
           "kernel D": "flash_vision_"}


def _wall_ms(fn, reps: int = 3) -> float:
    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def _device_events(fn):
    """(name, count, device ms) of each device event key of one call."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total / 1000)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[2])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lines = [card]

    def log(msg: str) -> None:
        lines.append(msg)
        print(msg, flush=True)

    dev = torch.device("cuda")
    tok = CharTokenizer(frame_num_tokens=49, vocab_size=152064)
    cfg = MMDuetConfig().replace(v_placeholder_id=tok.v_placeholder_id,
                                 eos_token_id=tok.eos_token_id)
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    H, ft = cfg.text.hidden_size, cfg.frame_num_tokens
    cache = init_kv_cache(cfg.text, 1, 24576, torch.bfloat16, dev)
    pixels = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (32, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)).to(dev)

    def embeds(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02

    frames8, frames32, prompt = embeds(8, ft, H), embeds(32, ft, H), embeds(1, 8, H)
    pen = torch.zeros((1, cfg.text.vocab_size), dtype=torch.bool, device=dev)

    def decoder_calls(params, cache, tag=""):
        return {
            f"8-frame block at cursor 2000{tag}": lambda: mmduet.frames_block_forward(
                params, cfg, frames8, cache, 2000),
            f"32-frame block at cursor 2000{tag}": lambda: mmduet.frames_block_forward(
                params, cfg, frames32, cache, 2000),
            f"greedy decode, 8 tokens at cursor 3000{tag}": lambda: mmduet.decode_loop(
                params, cfg, prompt, cache, [3000], 8, pen, max_new=8, eos_id=-1, rep=1.05),
        }

    lanes = 8
    cursors = [500 * (b + 1) for b in range(lanes)]
    cache8 = init_kv_cache(cfg.text, lanes, 24576, torch.bfloat16, dev)
    block8, prompt8 = embeds(lanes, 8 * ft, H), embeds(lanes, 8, H)
    pen8 = torch.zeros((lanes, cfg.text.vocab_size), dtype=torch.bool, device=dev)

    def vision():
        return mmduet.visual_embed(
            params, cfg, mmduet.normalize_pixels(cfg, pixels).to(torch.bfloat16))

    def vision_plain():
        kernel = siglip.flash_vision_attention
        siglip.flash_vision_attention = attention.flash_vision_attention_ref
        try:
            return vision()
        finally:
            siglip.flash_vision_attention = kernel

    calls = {
        "vision encode, 32 frames, kernel D": vision,
        "vision encode, 32 frames, matmul route": vision_plain,
        **decoder_calls(params, cache),
        f"8-frame block on {lanes} lanes at cursors {cursors[0]}..{cursors[-1]}":
            lambda: mmduet.chunk_scores_forward(
                params, cfg, block8, cache8, cursors, 8 * ft,
                [(j + 1) * ft - 1 for j in range(8)]),
        f"greedy decode, 8 tokens on {lanes} lanes at cursors {cursors[0]}..{cursors[-1]}":
            lambda: mmduet.decode_loop(params, cfg, prompt8, cache8, cursors, 8, pen8,
                                       max_new=8, eos_id=-1, rep=1.05),
    }

    def report(name, fn):
        wall = _wall_ms(fn)
        rows = _device_events(fn)
        device = sum(r[2] for r in rows)
        shares = ", ".join(
            f"{label} {ms:.3f} ms ({100 * ms / wall:.1f} % of wall)"
            for label, ms in ((label, sum(r[2] for r in rows if pat in r[0]))
                              for label, pat in KERNELS.items()) if ms)
        log(f"== {name}: wall {wall:.3f} ms (median of 3), device {device:.3f} ms, "
            f"idle {100 * (1 - device / wall):.1f} %{', ' + shares if shares else ''}")
        for key, count, ms in rows[:8]:
            log(f"   {ms:9.3f} ms  n={count:5d}  {key[:90]}")

    with torch.inference_mode():
        for name, fn in calls.items():
            report(name, fn)

    train_args = TrainArgs()
    tx, sched = make_optimizer(train_args, 10)
    lora = init_lora(torch.Generator(device=dev).manual_seed(1), cfg.text,
                     rank=train_args.lora_r, device=dev)
    state = init_train_state(params, lora, tx)
    step = make_train_step(cfg, train_args, tx, sched)
    (batch,) = duet_batches(tok, cfg, 1, 2, dev)
    report("training step, A=2 x 2944-token bucket, 48 frames",
           lambda: step(state, params, batch))

    del state, step, batch, lora, cache, cache8, calls
    params = quant.quantize_params(params, bits=4, donate=True)
    torch.cuda.empty_cache()
    cache = init_kv_cache(cfg.text, 1, 24576, torch.bfloat16, dev, quant="int8")
    with torch.inference_mode():
        for name, fn in decoder_calls(params, cache, ", int4 weights, int8 cache").items():
            report(name, fn)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
