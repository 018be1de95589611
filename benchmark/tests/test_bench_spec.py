"""BENCHMARK.json against the rules it keeps, the validator against specs
that break it (on a tiny benchmark under a temporary root), and the
configurations and traffic mixes that the harness refuses to serve."""

import json

import pytest

from benchmark import spec as specs
from benchmark.model_shapes import UnsupportedConfig
from benchmark.reference import check
from benchmark.tests import tiny
from benchmark.tests.conftest import ROOT


@pytest.fixture(scope="module")
def spec():
    return specs.load()


def test_benchmark_json_validates(spec):
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert {c["name"] for c in spec["configs"]} == {w["config"] for w in spec["workloads"]}


def test_names_units_and_files(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert specs.NAME.match(m["name"]) and specs.UNIT.match(m["unit"])
        assert len(m["unit"]) <= 16
    for m in spec["per_layer"]:
        assert specs.metric_path(m["name"]).is_file()
    for w in spec["workloads"]:
        assert specs.traffic_path(w["traffic"]).is_file()


def test_moves_is_reported_by_each_cell(spec):
    for w in spec["workloads"]:
        e2e = specs.metrics_of(spec, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        per = specs.metrics_of(spec, w["name"], "per_layer")
        assert per
        for name in per:
            moves = next(m["moves"] for m in spec["per_layer"] if m["name"] == name)
            assert moves in e2e


def test_int4_roofline_only_in_the_quantized_cell(spec):
    assert "int4_matmul_roofline" in specs.metrics_of(spec, "mmduet-7b-w4kv8.dvc16", "per_layer")
    assert "int4_matmul_roofline" not in specs.metrics_of(spec, "mmduet-7b-bf16.dvc16",
                                                          "per_layer")


def _answers_in_no_cell(s, root):
    next(m for m in s["end_to_end"] if m["name"] == "answer_ms_p95")["workloads"] = []
    next(m for m in s["per_layer"] if m["name"] == "decode_tok_s")["workloads"] = [
        s["workloads"][0]["name"]]


def _config_names(key, value):
    """An edit of the configuration file: ``key`` names ``value``."""
    def edit(s, root):
        path = root / s["configs"][0]["file"]
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **{key: value})))
    return edit


@pytest.mark.parametrize("edit", [
    pytest.param(lambda s, root: s["end_to_end"][0].update(unit="frames per s"),
                 id="unit-space"),
    pytest.param(lambda s, root: s["end_to_end"][0].update(unit="x" * 17), id="unit-long"),
    pytest.param(lambda s, root: s["per_layer"][0].update(name="a/b"), id="name-slash"),
    pytest.param(lambda s, root: s["per_layer"][0].update(moves="nothing"), id="moves-unknown"),
    pytest.param(_answers_in_no_cell, id="moves-unreported"),
    pytest.param(lambda s, root: s["workloads"].pop(0), id="config-without-cell"),
    pytest.param(lambda s, root: s["workloads"][0].update(traffic="nothing"),
                 id="no-traffic-file"),
    pytest.param(lambda s, root: s["per_layer"][0].update(name="nothing"), id="no-reader"),
    pytest.param(lambda s, root: s["end_to_end"].append(dict(s["end_to_end"][0])),
                 id="name-twice"),
    pytest.param(_config_names("architectures", ["NoSuchForCausalLM"]),
                 id="no-architecture-file"),
    pytest.param(_config_names("reference", "benchmark/reference/nothing.py"),
                 id="no-reference-file"),
])
def test_validator_refuses(tmp_path, edit):
    root, s, _ = tiny.make_root(tmp_path)
    edit(s, root)
    with pytest.raises(specs.SpecError):
        specs.validate(s, root)


def test_readers_load(spec):
    for m in spec["per_layer"]:
        assert callable(specs.reader(m["name"]))


def _config(edit):
    cfg = json.loads((ROOT / "benchmark" / "configs" / "mmduet-7b-bf16.json").read_text())
    edit(cfg)
    return cfg


@pytest.mark.parametrize("edit", [
    pytest.param(lambda c: c.update(tie_word_embeddings=True), id="tied-head"),
    pytest.param(lambda c: c.update(architectures=["Qwen2ForCausalLM"]), id="architecture"),
    pytest.param(lambda c: c["mmduet"].update(spatial_pool_mode="average"), id="pool-mode"),
    pytest.param(lambda c: c.update(use_sliding_window=True), id="unknown-key"),
    pytest.param(lambda c: c["serving"].update(weight_bits=8), id="int8-weights"),
    pytest.param(lambda c: c["serving"].update(group_size=64), id="group-64"),
    pytest.param(lambda c: c["vision_config"].update(vision_use_head=True), id="vision-key"),
])
def test_a_config_the_harness_cannot_serve_is_refused(edit):
    """Refused by its architecture's ``shapes``, or where no file serves its
    architecture, before set-up."""
    cfg = _config(edit)
    with pytest.raises(UnsupportedConfig):
        specs.architecture(cfg).shapes(cfg)


def test_the_port_config_follows_the_file():
    file = _config(lambda c: None)
    arch = specs.architecture(file)
    cfg = arch.port_config(arch.shapes(file))
    assert (cfg.text.tie_word_embeddings, cfg.text.qkv_bias, cfg.spatial_pool_mode) == (
        False, True, "bilinear")
    assert cfg.text.num_layers == 28 and cfg.vision.num_layers == 27


@pytest.mark.parametrize("edit", [
    pytest.param({"query_time": 3.0}, id="late-query"),
    pytest.param({"repetition_penalty": 1.1}, id="penalty"),
    pytest.param({"remove_assistant_turns": False}, id="answers-kept"),
    pytest.param({"stream_end_prob_threshold": 0.5}, id="two-thresholds"),
    pytest.param({"frame_embeds": True}, id="unknown-key"),
    pytest.param({"mode": "live"}, id="mode"),
])
def test_a_mix_the_check_cannot_describe_is_refused(edit):
    mix = dict(specs.traffic_of("dvc16"), **edit)
    with pytest.raises(check.Unsupported):
        check.supported(mix)


def test_the_committed_mixes_are_served():
    for w in specs.load()["workloads"]:
        check.supported(specs.traffic_of(w["traffic"]))
