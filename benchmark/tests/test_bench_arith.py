"""The benchmark's arithmetic against hand-worked shapes: the tail, the
rates, the operations (through the committed configurations' architecture),
the rooflines and the idle share."""


import pytest

from benchmark import harness, roofline, spec as specs
from benchmark.record import Call, Run
from benchmark.trace import Trace, breakdown, idle_gaps

QWEN = specs.architecture({"architectures": ["LlavaQwenForCausalLM"]})
S = QWEN.Shapes(vocab=10, hidden=4, intermediate=8, layers=1, heads=2, kv_heads=1,
           rope_theta=1e6, rms_eps=1e-6, v_image=4, patch=2, v_hidden=2,
           v_intermediate=4, v_layers=2, v_heads=1, v_eps=1e-6, select_layer=-2,
           frame_tokens=1, pool_stride=2, weights_seed=0, weight_bits=4, group=2,
           kv_quant="int8")


def test_p95_is_the_nearest_rank_over_all_answers():
    assert harness.percentile(list(range(1, 21)), 95) == 19
    assert harness.percentile(list(range(1, 201)), 95) == 190
    assert harness.percentile([5.0], 95) == 5.0
    assert harness.percentile([3, 1, 2], 50) == 2


def test_least_time_is_the_larger_bound():
    assert roofline.least_s((3.35e12, 0)) == pytest.approx(1.0)
    assert roofline.least_s((0, 989e12)) == pytest.approx(1.0)
    assert roofline.least_s((3.35e12, 2 * 989e12)) == pytest.approx(2.0)
    assert roofline.add([(1, 2), (3, 4)]) == (4, 6)


def test_int4_output_counts_two_bytes():
    # activations 2*256*2, packed weight 256*128/2, scales 2*128*2, bf16 output 2*128*2
    assert roofline.int4_matmul(2, 256, 128, 128) == (1024 + 16384 + 512 + 512, 131072.0)


def test_decode_attention_work():
    # q and o 2*2*4*8*2, cache 2*10*32, chunk K/V 2*2*8*2*2; pairs 2*10 + 3
    assert roofline.decode_attention([(10, 2)], 4, 2, 8) == (1024, 2944)
    assert roofline.decode_attention([(10, 2)], 4, 2, 8, int8=True) == (256 + 480 + 128, 2944)
    two = roofline.decode_attention([(10, 2), (0, 1)], 4, 2, 8)
    assert two[1] == 2944 + 4 * 8 * 4 * 1


def test_vision_attention_work():
    assert roofline.vision_attention(2, 3, 2, 4) == (384, 576.0)


def test_model_operations():
    # a layer: q 4*4, k and v 2*4*2, o 4*4, MLP 3*4*8 = 144; twice for a multiply-add
    assert QWEN.decoder_token(S) == 288
    assert QWEN.attention(S, 3, 2) == 4 * 2 * 2 * (2 * 3 + 3)
    assert QWEN.chunk(S, 3, 2) == 2 * 288 + 144
    assert QWEN.lm_head_row(S) == 80
    assert QWEN.score_heads_frame(S) == 32
    # tower: 4 patches of width 2, one layer runs; projector 2->4->4
    layer = 2 * 4 * (4 * 4 + 2 * 2 * 4) + 4 * 4 * 4 * 2
    assert QWEN.vision_frame(S) == layer + 2 * 4 * 12 * 2 + 2 * 4 * (8 + 16)


def _run(**kw):
    r = Run(S, QWEN, **kw)
    r.trace = Trace(kernels=[("flash_decode_tc_kernel<1>", 10, 20), ("int4_gemv_kernel", 15, 30),
                             ("flash_vision_kernel", 50, 60), ("other", 200, 300)],
                    spans=[("bench.slice", 0, 100), ("bench.round", 0, 100),
                           ("bench.dispatch", 25, 45)])
    return r


def test_idle_from_intervals():
    r = _run()
    assert r.trace.busy_s() == pytest.approx(30e-6)  # (10, 30) and (50, 60) in (0, 100)
    assert r.trace.window_s() == pytest.approx(100e-6)
    assert idle_gaps(r.trace) == [(0, 10), (30, 50), (60, 100)]
    assert specs.reader("idle_pct")(r) == pytest.approx(70.0)
    b = breakdown(r.trace)
    assert b["device_ops"][0] == ["int4_gemv_kernel", pytest.approx(15e-6)]
    # the gap (30, 50) lies in the dispatch span; the others only in the round
    assert dict(b["idle_gaps"]) == {"bench.round": pytest.approx(50e-6),
                                    "bench.dispatch": pytest.approx(20e-6)}


def test_rates_are_over_the_whole_window():
    r = _run(window_s=2.0, frames_scored=90, frames_fed=100, frames_admitted=60)
    r.calls = [Call("dispatch", [(0, 8)], scored=60, seconds=0.3),
               Call("dispatch", [(0, 8)], scored=40, seconds=0.2),
               Call("prefill", [(0, 2)] * 2, lm_rows=2, seconds=0.25),
               *[Call("step", [(3, 1)] * 2, lm_rows=2) for _ in range(23)],
               Call("encode", frames=40, seconds=0.2, in_slice=True),
               Call("encode", frames=20, seconds=0.1, in_slice=True)]
    assert specs.reader("dispatch_ms_per_frame")(r) == pytest.approx(5.0)
    assert specs.reader("frames_kept_pct")(r) == pytest.approx(90.0)
    assert specs.reader("decode_tok_s")(r) == pytest.approx(192.0)
    assert specs.reader("admit_ms_per_frame")(r) == pytest.approx(5.0)
    out = dict(run=r, window_s=2.0, peak=3 * 2 ** 30, setup_s=7.0,
               answers=[harness.check.Answer(0, 0, 0, [1], latency_s=x / 1e3)
                        for x in range(1, 21)])
    e2e = harness.end_to_end(out)
    assert e2e == {"frames_per_s": 45.0, "answer_ms_p95": pytest.approx(19.0),
                   "peak_gib": 3.0, "setup_s": 7.0}


def test_host_rates_leave_out_the_traced_slice():
    """Dispatches, decodes and the operations count before the profiler
    starts; admissions inside the slice, where each ends in a sync."""
    r = _run(window_s=4.0, slice_start_s=3.0)
    r.calls = [Call("dispatch", [(0, 2)], scored=2, seconds=0.01),
               Call("dispatch", [(0, 2)], scored=2, seconds=9.0, in_slice=True),
               Call("prefill", [(2, 1)], lm_rows=1, seconds=0.5),
               Call("prefill", [(2, 1)], lm_rows=1, seconds=9.0, in_slice=True),
               Call("encode", frames=2, seconds=9.0),
               Call("encode", frames=4, seconds=0.002, in_slice=True)]
    assert specs.reader("dispatch_ms_per_frame")(r) == pytest.approx(5.0)
    assert specs.reader("decode_tok_s")(r) == pytest.approx(2.0)
    assert specs.reader("admit_ms_per_frame")(r) == pytest.approx(0.5)
    total = (QWEN.chunk(S, 0, 2) + QWEN.score_heads_frame(S) * 2 + QWEN.chunk(S, 2, 1)
             + QWEN.lm_head_row(S) + 2 * QWEN.vision_frame(S))
    assert specs.reader("mfu")(r) == pytest.approx(100 * total / 3.0 / 989e12)


def test_mfu_counts_the_calls():
    r = _run(window_s=1e-9)
    r.calls = [Call("dispatch", [(3, 2)], scored=1), Call("step", [(5, 1)], lm_rows=1),
               Call("encode", frames=2)]
    total = (QWEN.chunk(S, 3, 2) + QWEN.score_heads_frame(S) + QWEN.chunk(S, 5, 1)
             + QWEN.lm_head_row(S) + 2 * QWEN.vision_frame(S))
    assert specs.reader("mfu")(r) == pytest.approx(100 * total / 1e-9 / 989e12)


def test_rooflines_read_the_slice():
    r = _run()
    r.calls = [Call("dispatch", [(10, 2)], in_slice=True), Call("dispatch", [(99, 9)]),
               Call("step", [(4, 1)], lm_rows=1, in_slice=True),
               Call("encode", frames=2, in_slice=True)]
    a = sum(roofline.least_s(tuple(x * S.layers for x in roofline.decode_attention(
        lanes, 2, 1, 2, int8=True))) for lanes in ([(10, 2)], [(4, 1)]))
    assert specs.reader("decode_attention_roofline")(r) == pytest.approx(100 * a / 10e-6)
    v = roofline.vision_attention(2, 4, 1, 2)
    assert specs.reader("vision_attention_roofline")(r) == pytest.approx(
        100 * roofline.least_s(v) / 10e-6)
    prods = ((4, 4), (4, 2), (4, 2), (4, 4), (4, 8), (4, 8), (8, 4))
    d = roofline.least_s(roofline.add(roofline.int4_matmul(2, i, o, 2) for i, o in prods))
    st = roofline.least_s(roofline.add([roofline.int4_matmul(1, i, o, 2) for i, o in prods]
                                       + [roofline.int4_matmul(1, 4, 10, 2)]))
    assert specs.reader("int4_matmul_roofline")(r) == pytest.approx(100 * (d + st) / 15e-6)


def test_readers_find_nothing_where_nothing_ran():
    r = Run(S, QWEN)
    for name in ("dispatch_ms_per_frame", "frames_kept_pct", "decode_tok_s",
                 "admit_ms_per_frame", "mfu", "decode_attention_roofline",
                 "vision_attention_roofline", "int4_matmul_roofline", "idle_pct"):
        assert specs.reader(name)(r) is None, name
    dense = Run(QWEN.Shapes(**{**S.__dict__, "weight_bits": None}), QWEN)
    dense.trace = _run().trace
    assert specs.reader("int4_matmul_roofline")(dense) is None


@pytest.mark.parametrize("thresholds", [{"stream_end_score_sum_threshold": 1.5},
                                        {"stream_end_prob_threshold": 0.6}],
                         ids=["sum", "prob"])
def test_policy_replay_triggers_where_the_port_does(thresholds):
    """The check's replay of the threshold policy against the port's own
    policy, frame by frame, on random scores of both heads."""
    import numpy as np

    from mmduet_tpu_torch.config import TestArgs
    from mmduet_tpu_torch.infer.state import ThresholdPolicy

    mix = {"score_heads": "informative_score,relevance_score",
           "stream_end_score_sum_threshold": None, "stream_end_prob_threshold": None,
           **thresholds}
    rows = [{"informative_score": float(a), "relevance_score": float(b)}
            for a, b in np.random.default_rng(3).random((200, 2)) * 0.5]
    policy = ThresholdPolicy(TestArgs(score_heads=mix["score_heads"], **thresholds))
    want = [i for i, r in enumerate(rows) if policy.triggered(sum(r.values()))]
    assert want and harness.check.replay_triggers(mix, rows) == want
