"""The model step (`models/mmduet.py`, its decoder and its tower): the
operations that the window's traffic needs, counted from shapes by the
configuration's architecture (``benchmark/arch/<architecture>.py``, see
`benchmark.spec.architecture`), over the seconds of the window before the
traced slice (where no sync and no profiler slow it) and the 989 TFLOP/s
bf16 peak of one H100."""

from benchmark.roofline import BF16_FLOP_PER_S


def read(run):
    s, a = run.shapes, run.arch
    total = 0.0
    for c in run.unsliced():
        if c.kind == "encode":
            total += c.frames * a.vision_frame(s)
            continue
        total += sum(a.chunk(s, cache_len, t) for cache_len, t in c.lanes)
        total += c.lm_rows * a.lm_head_row(s) + c.scored * a.score_heads_frame(s)
    if not total or not run.untraced_s():
        return None
    return 100.0 * total / run.untraced_s() / BF16_FLOP_PER_S
