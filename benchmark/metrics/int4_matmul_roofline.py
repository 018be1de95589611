"""Kernel B (`ops/quant_matmul.py`, `int4_matmul`): the least time of every
int4 product that the decoder forwards of the traced slice need (the
seven projections of each layer at the tokens fed, the LM head at the rows
read; `benchmark.roofline.int4_matmul`, one bound a forward), over the
profiler's device time of the kernels named below. Nothing to read where
the weights are not int4."""

from benchmark import roofline

PATTERNS = ("int4_gemv_kernel", "int4_wgmma_kernel")


def read(run):
    s = run.shapes
    if run.trace is None or s.weight_bits != 4:
        return None
    device_s = run.trace.device_s(PATTERNS)
    h, q, kv, mi = s.hidden, s.q_dim, s.kv_dim, s.intermediate
    products = ((h, q), (h, kv), (h, kv), (q, h), (h, mi), (h, mi), (mi, h))
    least = 0.0
    for c in run.sliced():
        if c.kind == "encode" or not c.lanes:
            continue
        R = sum(t for _, t in c.lanes)
        works = [roofline.int4_matmul(R, i, o, s.group) for i, o in products] * s.layers
        if c.lm_rows:
            works.append(roofline.int4_matmul(c.lm_rows, h, s.vocab, s.group))
        least += roofline.least_s(roofline.add(works))
    if not device_s or not least:
        return None
    return 100.0 * least / device_s
