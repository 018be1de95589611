"""A run with the timed path broken underneath comes out not correct; so
does the control (the reference in the nearest lower precision, in the
program's place). At a tiny size on the CPU, past the harness's look for
a chip. The exchange between chips has no fault to plant: every cell runs
on one chip."""

import time

import pytest

from benchmark import harness
from benchmark.tests import tiny

SEED = 2 ** 31 + 977


def _half_the_batch(engine):
    """Half of the lanes' scores left out: each is the mean over the rest."""
    dispatch = engine._dispatch_sched

    def broken(chunks):
        probs = dispatch(chunks)
        half = probs.shape[0] // 2
        probs[half:] = probs[:half].mean(axis=0)
        return probs

    engine._dispatch_sched = broken


def _stale_policy(engine):
    """The threshold policy's sum not reset after a trigger."""
    from mmduet_tpu_torch.infer import state

    real = state.ThresholdPolicy.triggered

    def triggered(self, score):
        kept = self.score_sum
        out = real(self, score)
        if out:
            self.score_sum = kept + score - self.args.stream_end_score_sum_threshold
        return out

    state.ThresholdPolicy.triggered = triggered
    return lambda: setattr(state.ThresholdPolicy, "triggered", real)


def _patch(module: str, name: str, make):
    def plant(engine, monkeypatch):
        import importlib

        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    return plant


def _unchanged_decode_state(real):
    return lambda *a, **k: None  # a greedy step that leaves the loop state as it was


def _uncommitted_cache(real):
    return lambda *a, **k: None  # a frame forward whose K/V never reach the cache


def _altered_token(real):
    def outputs(s):
        packed, mask = real(s)
        packed[:, 1] = (packed[:, 1] + 1) % s.pen_mask.shape[1]
        return packed, mask
    return outputs


FAULTS = {
    "decode-step-unchanged": _patch("mmduet_tpu_torch.models.mmduet", "decode_step",
                                    _unchanged_decode_state),
    "cache-commit-unchanged": _patch("mmduet_tpu_torch.models.qwen2", "commit_rows",
                                     _uncommitted_cache),
    "token-altered": _patch("mmduet_tpu_torch.models.mmduet", "decode_outputs", _altered_token),
    "half-the-batch": lambda engine, mp: _half_the_batch(engine),
}


def _run(tmp_path, quant, faults=None, with_control=False, mix=None, trace=False):
    root, spec, cell = tiny.make_root(tmp_path, quant=quant, mix=mix)
    return harness.run_cell(spec, cell, SEED, 2.0, trace, "cpu", time.perf_counter(), root,
                            faults=faults, with_control=with_control)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w4kv8"])
def test_sound_run_is_correct(tmp_path, quant):
    r = _run(tmp_path, quant)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w4kv8"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(tmp_path, monkeypatch, quant, fault):
    r = _run(tmp_path, quant, faults=lambda engine: FAULTS[fault](engine, monkeypatch))
    assert not r["correct"], r["checks"]


def test_policy_fault_is_a_protocol_error(tmp_path):
    undo = []
    try:
        r = _run(tmp_path, False, faults=lambda engine: undo.append(_stale_policy(engine)))
    finally:
        for u in undo:
            u()
    assert not r["correct"]
    assert r["checks"]["protocol_errors"]["value"] > 0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w4kv8"])
def test_control_is_not_correct(tmp_path, quant):
    """The control, judged by the harness's own comparison at the
    configuration's limits, fails them; the program beside it passes."""
    r = _run(tmp_path, quant, with_control=True)
    assert r["correct"], r["checks"]
    assert r["window"]["control_correct"] is False, r["window"]["control"]


def test_grounding_run_is_correct(tmp_path):
    """A grounding mix: scores only, every scored frame of the sessions
    checked against the reference; no answer is due."""
    r = _run(tmp_path, False, mix=tiny.GROUNDING, with_control=True)
    assert r["correct"], r["checks"]
    assert r["window"]["answers"] == 0 and r["attempted"] > 0
    assert r["window"]["sessions_checked"] == 2
    assert r["window"]["control_correct"] is False
    assert "answer_ms_p95" not in r["metrics"]


def test_grounding_with_half_the_batch_is_not_correct(tmp_path):
    r = _run(tmp_path, False, mix=tiny.GROUNDING, faults=_half_the_batch)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["_dispatch_sched", "_admit", "_generate_batch",
                                  "_run_round"])
def test_a_hook_that_never_fires_fails_the_run(tmp_path, monkeypatch, name):
    """A change to the engine that routes its work past a hooked method
    leaves the harness's span empty: the run fails with no result. Here the
    hook's assignment is dropped, so the engine calls its own method."""
    from mmduet_tpu_torch.infer import BatchedStreamEngine

    real = getattr(BatchedStreamEngine, name)
    monkeypatch.setattr(BatchedStreamEngine, name,
                        property(lambda self: real.__get__(self), lambda self, value: None))
    monkeypatch.setattr(harness, "STALL_S", 1.0)
    root, spec, cell = tiny.make_root(tmp_path)
    with pytest.raises(harness.HookError):
        harness.run_cell(spec, cell, SEED, 2.0, False, "cpu", time.perf_counter(), root)


def test_a_missing_hook_fails_before_the_window(tmp_path, monkeypatch):
    from mmduet_tpu_torch.infer import BatchedStreamEngine

    monkeypatch.delattr(BatchedStreamEngine, "_admit")
    root, spec, cell = tiny.make_root(tmp_path)
    with pytest.raises(harness.HookError):
        harness.run_cell(spec, cell, SEED, 2.0, False, "cpu", time.perf_counter(), root)


def test_a_silent_metric_fails_the_run(tmp_path):
    """A per-layer metric of the cell that reads nothing (here a reader
    that finds nothing) fails the traced run."""
    root, spec, cell = tiny.make_root(tmp_path)
    (root / "benchmark" / "metrics" / "frames_kept_pct.py").write_text(
        "def read(run):\n    return None\n")
    with pytest.raises(harness.HookError, match="frames_kept_pct"):
        harness.run_cell(spec, cell, SEED, 2.0, True, "cpu", time.perf_counter(), root)


def test_traced_run_reads_its_slice(tmp_path):
    """``--trace 1`` on the CPU: the slice's spans are found and the
    harness's own readers report; no kernel ran, so nothing of the device.
    Sessions of one or two blocks, so that some are admitted in the slice,
    where the profiler slows each round."""
    mix = dict(tiny.MIX, frames={"min": 4, "max": 8})
    root, spec, cell = tiny.make_root(tmp_path, mix=mix)
    r = harness.run_cell(spec, cell, SEED, 4.0, True, "cpu", time.perf_counter(), root)
    assert r["correct"]
    assert {"dispatch_ms_per_frame", "frames_kept_pct", "decode_tok_s", "mfu",
            "admit_ms_per_frame"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps and all(name.startswith("bench.") or name == "host" for name, _ in gaps)
    assert sum(sec for _, sec in gaps) == pytest.approx(r["device"]["window_s"], rel=1e-6)
