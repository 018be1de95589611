"""Kernel D (`ops/attention.py`, `flash_vision_attention`): the least time
of the tower's attention for every encode of the traced slice
(`benchmark.roofline.vision_attention`, every layer that runs), over the
profiler's device time of the kernels named below."""

from benchmark import roofline

PATTERNS = ("flash_vision_kernel",)


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.device_s(PATTERNS)
    s = run.shapes
    least = 0.0
    for c in run.sliced():
        if c.kind != "encode":
            continue
        b, f = roofline.vision_attention(c.frames, s.v_patches, s.v_heads, s.v_head_dim)
        least += roofline.least_s((b * s.v_used_layers, f * s.v_used_layers))
    if not device_s or not least:
        return None
    return 100.0 * least / device_s
