"""`benchmark.program_trace` on a hand-made Chrome trace: kernels with
their launches (one `cudaGraphLaunch` that carries two kernels, one
CUDA driver API launch, one kernel whose launch is missing, a gap inside a graph
launch that has not returned), a copy, the program's
``mmduet.*`` spans and the harness's ``bench.*`` ones. Each reading and the
idle time's three-way split come out as worked by hand, the split adds up
to the idle time, and the program's events leave `Trace`, `breakdown()`
and every reader of `BENCHMARK.json` where they were."""

import json

import pytest

from benchmark import program_trace, spec as specs
from benchmark.record import Call, Run
from benchmark.tests.test_bench_arith import QWEN, S
from benchmark.trace import breakdown, kernel_intervals


def event(cat, name, a, b, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "args": args}


def kernel(name, a, b, corr):
    return event("kernel", name, a, b, correlation=corr)


def launch(name, a, b, corr, cat="cuda_runtime"):
    return event(cat, name, a, b, correlation=corr)


def program(name, a, b):
    return event("user_annotation", "mmduet." + name, a, b)


HARNESS = [
    event("user_annotation", "bench.slice", 0, 1000),
    event("user_annotation", "bench.round", 0, 1000),
    event("user_annotation", "bench.dispatch", 40, 300),
    event("user_annotation", "bench.generate", 350, 880),
    event("gpu_user_annotation", "bench.slice", 0, 1000),
    kernel("flash_decode_tc_kernel<false>", 100, 200, 1),
    kernel("int4_gemv_kernel", 210, 300, 4),
    kernel("flash_vision_kernel", 420, 500, 2),
    kernel("other_kernel", 520, 600, 2),
    kernel("nvjet_gemm", 700, 800, 3),
    kernel("elementwise_kernel", 900, 950, 99),
]
PROGRAM = [
    launch("cudaLaunchKernel", 50, 60, 1),
    launch("cudaLaunchKernelExC", 150, 160, 4),
    launch("cudaGraphLaunch", 400, 510, 2),
    launch("cuLaunchKernelEx", 650, 660, 3, cat="cuda_driver"),
    launch("cudaStreamSynchronize", 610, 690, 7),
    event("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 640, correlation=8),
    program("engine.round", 0, 1000),
    program("engine.dispatch", 40, 300),
    program("model.forward", 45, 100),
    program("engine.generate", 350, 880),
    program("decode.step", 390, 515),
    program("decode.flag_read", 600, 690),
    program("decode.step", 645, 665),
    program("engine.admit", 880, 1000),
    event("gpu_user_annotation", "mmduet.engine.round", 0, 1000),
]
WINDOW = {"decode_rows_live": 30, "decode_rows_run": 120, "dispatch_rows_live": 30,
          "dispatch_rows_run": 200}
SLICE = {"frames_admitted": 7}


def write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.fixture
def traces(tmp_path):
    return program_trace.read(write(tmp_path, HARNESS + PROGRAM))


def test_split_by_hand(traces):
    """Gaps (µs): (0, 100) host in model.forward; (200, 210) queued (its
    kernel's launch returned at 160); (300, 420) host in engine.generate
    (the graph's launch began at 400); (500, 520) host in decode.step, in
    the launch (it returns at 510); (600, 700) a copy for 40, then host in
    decode.flag_read; (800, 900) host, the kernel's launch missing;
    (950, 1000) host in engine.admit."""
    t, p = traces
    block = program_trace.program_block(t, p, WINDOW, SLICE)
    idle = block["idle_s"]
    assert idle["total"] == pytest.approx(500e-6)
    assert idle["copy"] == pytest.approx(40e-6)
    assert idle["queued"] == pytest.approx(10e-6)
    assert idle["host"] == pytest.approx(450e-6)
    assert idle["host_in_launch"] == pytest.approx(20e-6)
    assert idle["copy"] + idle["queued"] + idle["host"] == pytest.approx(idle["total"])
    assert idle["total"] == pytest.approx(t.window_s() - t.busy_s())
    assert idle["host_by_span"] == {
        "engine.generate": pytest.approx(220e-6), "model.forward": pytest.approx(100e-6),
        "decode.flag_read": pytest.approx(60e-6), "engine.admit": pytest.approx(50e-6),
        "decode.step": pytest.approx(20e-6)}
    # the graph's two kernels go to the step that launched them
    assert block["device_s_by_span"] == {
        "decode.step": pytest.approx(260e-6), "model.forward": pytest.approx(100e-6),
        "engine.dispatch": pytest.approx(90e-6)}
    assert block["kernels_by_span"] == {"decode.step": 3, "model.forward": 1,
                                        "engine.dispatch": 1}
    assert block["device_ops_by_span"]["decode.step"] == [
        ["nvjet_gemm", pytest.approx(100e-6)], ["flash_vision_kernel", pytest.approx(80e-6)],
        ["other_kernel", pytest.approx(80e-6)]]
    assert block["launch_found_pct"] == pytest.approx(90.0)
    # the host in launch calls: the graph's (400, 510) and cuLaunchKernelEx's (650, 660)
    assert block["launch_s_by_span"] == {
        "decode.step": pytest.approx(120e-6), "model.forward": pytest.approx(10e-6),
        "engine.dispatch": pytest.approx(10e-6)}
    assert block["launches_by_span"] == {"decode.step": 2, "model.forward": 1,
                                         "engine.dispatch": 1}
    assert block["counters"] == WINDOW and block["slice_counters"] == SLICE


def test_readings_by_hand(traces):
    t, p = traces
    got = {name: f(t, p, WINDOW, SLICE) for name, f in program_trace.READINGS.items()}
    # idle inside engine.generate (350, 880): 70 + 20 + 100 + 80 µs over its two steps
    assert got["decode_idle_us_per_step"] == pytest.approx(135.0)
    # idle inside engine.admit (880, 1000): 20 + 50 µs over 7 frames
    assert got["admit_idle_ms_per_frame"] == pytest.approx(0.01)
    assert got["queued_idle_pct"] == pytest.approx(1.0)
    assert got["decode_live_rows_pct"] == pytest.approx(25.0)
    assert got["dispatch_live_rows_pct"] == pytest.approx(15.0)


def test_readings_without_the_program(tmp_path):
    """A trace with no ``mmduet.*`` span, and counters without the rows,
    as a program without them leaves: every reading is None."""
    t, p = program_trace.read(write(tmp_path, HARNESS))
    assert not p.spans
    assert all(f(t, p, {"dispatches": 3}, {}) is None for f in program_trace.READINGS.values())


def test_program_events_move_no_existing_reading(tmp_path):
    """`read` gives `kernel_intervals`' `Trace`, and the program's events
    change nothing of it, of `breakdown()` or of the accepted readers."""
    bare = kernel_intervals(write(tmp_path, HARNESS, "bare.json"))
    full_path = write(tmp_path, HARNESS + PROGRAM, "full.json")
    full = kernel_intervals(full_path)
    assert full.kernels == bare.kernels and full.spans == bare.spans
    assert program_trace.read(full_path)[0] == full
    assert breakdown(full) == breakdown(bare)
    readings = {}
    for trace in (bare, full):
        run = Run(S, QWEN, window_s=2.0, frames_scored=9, frames_fed=10, slice_start_s=1.0,
                  trace=trace)
        run.calls = [Call("dispatch", [(10, 2)], scored=2, seconds=0.1, in_slice=True),
                     Call("step", [(4, 1)], lm_rows=1, in_slice=True),
                     Call("encode", frames=2, seconds=0.2, in_slice=True),
                     Call("dispatch", [(10, 2)], scored=2, seconds=0.1)]
        names = [m["name"] for m in specs.load()["per_layer"]]
        readings[id(trace)] = {n: specs.reader(n)(run) for n in names}
    assert readings[id(bare)] == readings[id(full)]
    assert readings[id(full)]["idle_pct"] == pytest.approx(50.0)
