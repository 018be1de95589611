"""The model step (`models/mmduet.py`, `qwen2.py`, `siglip.py`): the
operations that the window's traffic needs, counted from shapes
(`benchmark.flops`), over the seconds of the window before the traced
slice (where no sync and no profiler slow it) and the 989 TFLOP/s bf16
peak of one H100."""

from benchmark import flops
from benchmark.roofline import BF16_FLOP_PER_S


def read(run):
    s = run.shapes
    total = 0.0
    for c in run.unsliced():
        if c.kind == "encode":
            total += c.frames * flops.vision_frame(s)
            continue
        total += sum(flops.chunk(s, cache_len, t) for cache_len, t in c.lanes)
        total += c.lm_rows * flops.lm_head_row(s) + c.scored * flops.score_heads_frame(s)
    if not total or not run.untraced_s():
        return None
    return 100.0 * total / run.untraced_s() / BF16_FLOP_PER_S
