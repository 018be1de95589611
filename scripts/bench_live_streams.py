"""What `LiveInferEngine.stream_video`'s two streams buy on the card: the
decoder's work beside one chunk's vision encode.

At the default model's widths (Qwen2-7B decoder cut to ``--layers``,
SigLIP-so400m with all its layers, random bf16 weights from seed 0):

1. the host time to enqueue one 32-frame encode on the vision stream
   (upload, tower, projector, pooling), with the pooling's weights copied
   through pinned memory (the package) and, for the comparison, from
   pageable memory (the copy the package made before; a pageable copy
   waits for the whole queue of its stream, here the encode itself);
2. a decoder loop alone (``--feeds`` 64-row streaming steps, each ending in
   a host sync, as the engine's frame steps do) and beside one encode on
   the vision stream, with the decoder on the engine's decoder stream
   (priority -1) and on a stream of the vision stream's priority (0), in
   turns, ``--repeats`` times.

From the repository root:

    PYTHONPATH=. python scripts/bench_live_streams.py [--layers 6] [--feeds 30]
        [--repeats 3]

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from mmduet_tpu_torch.config import MMDuetConfig, TestArgs
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import init_mmduet_params, mmduet
from mmduet_tpu_torch.stream import CharTokenizer


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _pageable_pool(features, cfg):
    """`mmduet.spatial_pool`'s bilinear route with its weights copied from
    pageable memory."""
    N, P, C = features.shape
    side = int(round(np.sqrt(P)))
    out_side = -(-side // cfg.video_pooling_stride)
    w = torch.from_numpy(mmduet._bilinear_weights(side, out_side)).to(features.device)
    pooled = torch.einsum("nhwc,hi,wj->nijc", features.reshape(N, side, side, C).float(), w, w)
    return pooled.to(features.dtype).reshape(N, out_side * out_side, C)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=6, help="decoder layers (the tower keeps all)")
    p.add_argument("--feeds", type=int, default=30)
    p.add_argument("--repeats", type=int, default=3)
    opts = p.parse_args(argv)
    card = _card()
    dev = torch.device("cuda")
    tok = CharTokenizer(frame_num_tokens=49, vocab_size=152064)
    base = MMDuetConfig()
    cfg = base.replace(text=dataclasses.replace(base.text, num_layers=opts.layers),
                       v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
    engine = LiveInferEngine(params, cfg, tok, TestArgs(
        frame_fps=2.0, max_new_tokens=8, stream_end_score_sum_threshold=1.0))
    engine.prewarm(vision=True)
    decoder, vision = engine._streams()
    equal = torch.cuda.Stream(device=dev, priority=vision.priority)
    px = np.random.RandomState(0).randint(
        0, 256, (32, cfg.frame_resolution, cfg.frame_resolution, 3), dtype=np.uint8)
    chunk = torch.zeros((64, cfg.text.hidden_size), dtype=torch.bfloat16, device=dev)

    def encode():
        engine._encode_chunk(engine._upload(px))

    def feeds():
        for _ in range(opts.feeds):
            engine.state.cursor = 0
            engine._feed(chunk)[0].tolist()

    with torch.inference_mode():
        for name, pool in (("pinned (the package)", mmduet.spatial_pool),
                           ("pageable", _pageable_pool)):
            saved, mmduet.spatial_pool = mmduet.spatial_pool, pool
            try:
                times = []
                for _ in range(opts.repeats):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    encode()
                    times.append(time.perf_counter() - t0)
                    torch.cuda.synchronize()
            finally:
                mmduet.spatial_pool = saved
            print(f"[{card}] enqueue of one 32-frame encode on the vision stream, pooling "
                  f"weights {name}: host {', '.join(f'{t:.4f}' for t in times)} s", flush=True)
        for rep in range(opts.repeats):
            for name, stream in (("decoder stream, priority -1", decoder),
                                 ("a stream of priority 0", equal)):
                with torch.cuda.stream(stream):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    feeds()
                    alone = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    encode()
                    torch.cuda.synchronize()
                    enc = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    encode()
                    feeds()
                    both = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    last = time.perf_counter() - t0
                print(f"[{card}] round {rep + 1}, {opts.feeds} decoder steps on {name}: alone "
                      f"{alone:.4f} s, one encode alone {enc:.4f} s, the steps beside the encode "
                      f"{both:.4f} s (all done {last:.4f} s)", flush=True)


if __name__ == "__main__":
    main()
