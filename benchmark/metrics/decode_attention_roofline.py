"""Kernels A and A-int8 (`ops/attention.py`, `flash_decode_attention`):
the least time of the attention that every decoder forward of the traced
slice needs at its lanes' cursors (`benchmark.roofline.decode_attention`,
every layer, one bound a forward), over the profiler's device time of the
kernels named below."""

from benchmark import roofline

PATTERNS = ("flash_decode_tc_kernel",)


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.device_s(PATTERNS)
    s = run.shapes
    least = 0.0
    for c in run.sliced():
        if c.kind == "encode" or not c.lanes:
            continue
        b, f = roofline.decode_attention(c.lanes, s.heads, s.kv_heads, s.head_dim,
                                         int8=s.kv_quant == "int8")
        least += roofline.least_s((b * s.layers, f * s.layers))
    if not device_s or not least:
        return None
    return 100.0 * least / device_s
