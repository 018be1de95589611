"""The plain reference against the port's `serve()` outputs at a tiny size
on the CPU, bf16 and int4 weights with an int8 cache; a reference with
one thing left out must fail."""

import dataclasses
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import quant
from benchmark.tests import tiny

SEED = 2 ** 31 + 101


def _window(tmp_path, quant):
    root, spec, cell = tiny.make_root(tmp_path, quant=quant)
    from benchmark import spec as specs
    cfg = specs.config_of(spec, cell["config"], root)
    mix = specs.traffic_of(cell["traffic"], root)
    out = harness.serve_window(cfg, mix, SEED, 2.0, False, "cpu", time.perf_counter(), root)
    return cfg, out


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "w4kv8"])
def served(request, tmp_path_factory):
    return _window(tmp_path_factory.mktemp("w"), request.param)


def _check(served, precision=None, layers_left_out=0, sessions=None):
    cfg, out = served
    s = out["shapes"]
    if layers_left_out:
        s = dataclasses.replace(s, layers=s.layers - layers_left_out)
    ref = out["reference"]
    w = harness.weights.make(out["arch"].leaves(out["shapes"]), s.weights_seed, "cpu")
    picked = sessions if sessions is not None else harness.check.pick(out["served"], SEED)
    return harness.check.reference_readings(ref, out["served"], s, w,
                                            [precision or ref.served(s)], picked, "cpu")[0]


def test_the_window_served_answers(served):
    _, out = served
    assert len(out["answers"]) >= 4
    assert harness.check.protocol_errors(out["served"]) == 0
    assert out["captures"] == 0


def test_reference_agrees_with_serve(served):
    cfg, out = served
    got = _check(served)
    assert got["score_gap"] <= cfg["limits"]["score_gap"]
    assert got["token_gap"] <= cfg["limits"]["token_gap"]


def test_reference_without_a_decoder_layer_fails(served):
    cfg, _ = served
    got = _check(served, layers_left_out=1)
    assert got["score_gap"] > cfg["limits"]["score_gap"]


def test_reference_without_a_tower_layer_fails(served, monkeypatch):
    cfg, out = served
    s = out["shapes"]
    monkeypatch.setattr(type(s), "v_used_layers", property(lambda self: 1))
    got = _check(served)
    assert got["score_gap"] > cfg["limits"]["score_gap"]


def test_reference_without_the_quantization_fails(served):
    cfg, out = served
    s = out["shapes"]
    if s.weight_bits != 4:
        pytest.skip("bf16 weights: nothing quantized to leave out")
    got = _check(served, precision=out["reference"].Precision("bf16", s.kv_quant))
    assert max(got["score_gap"] / cfg["limits"]["score_gap"],
               got["token_gap"] / cfg["limits"]["token_gap"]) > 1


def test_reference_without_the_int8_scales_fails(served, monkeypatch):
    cfg, out = served
    s = out["shapes"]
    if s.kv_quant != "int8":
        pytest.skip("no int8 cache")
    # the cache read back as its int8 codes, its per-token scales left out
    monkeypatch.setattr(quant, "int8_kv_round_trip",
                        lambda x: torch.round(x / (x.abs().amax(-1, keepdim=True) / 127)))
    got = _check(served)
    assert got["score_gap"] > cfg["limits"]["score_gap"]


def _chunk_ends(triggers, n, block):
    """The last frame of the chunk each trigger fell in: chunks of
    ``block`` frames from frame 0, each trigger's next chunk starting
    after it."""
    start, ends = 0, []
    for f in sorted(triggers):
        while start + block <= f:
            start += block
        ends.append(min(start + block, n) - 1)
        start = f + 1
    return ends


def test_reference_without_the_rollback_fails(served):
    """A reference that keeps the frames after a trigger (no rollback), so
    that each answer follows the end of its trigger's chunk, disagrees with
    the served tokens."""
    cfg, out = served
    sv = out["served"]
    mix = sv.mix
    moved = []
    for idx, rows in sorted(sv.scores.items()):
        mine = sorted((a for a in sv.answers if a.session == idx), key=lambda a: a.frame)
        ends = _chunk_ends([a.frame for a in mine], len(rows), mix["block_frames"])
        moved += [dataclasses.replace(a, frame=e) for a, e in zip(mine, ends)]
    assert any(a.frame != b.frame for a, b in zip(moved, sorted(
        sv.answers, key=lambda a: (a.session, a.frame))))
    broken = dataclasses.replace(sv, answers=moved)
    changed = sorted({b.session for a, b in zip(sorted(sv.answers, key=lambda a: (
        a.session, a.frame)), moved) if a.frame != b.frame})
    got = _check((cfg, dict(out, served=broken)), sessions=changed)
    assert got["token_gap"] > cfg["limits"]["token_gap"] or \
        got["score_gap"] > cfg["limits"]["score_gap"]
