"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference, with each configuration's architecture, imports nothing of the
program."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run as run
from benchmark import harness, spec
s = spec.load()
for m in s["per_layer"]:
    spec.reader(m["name"])
for c in s["configs"]:
    cfg = spec.config_of(s, c["name"])
    spec.architecture(cfg).port_config(spec.architecture(cfg).shapes(cfg))
    spec.reference(cfg)
import mmduet_tpu_torch.infer.batch_engine, mmduet_tpu_torch.models.quant
import mmduet_tpu_torch.stream, mmduet_tpu_torch.infer.state
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.check, benchmark.reference.model, benchmark.weights
from benchmark import spec
s = spec.load()
for c in s["configs"]:
    cfg = spec.config_of(s, c["name"])
    spec.architecture(cfg).leaves(spec.architecture(cfg).shapes(cfg))
    spec.reference(cfg)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("mmduet_tpu_torch", "mmduet_tpu", "jax", "jaxlib", "flax"))))
"""


def _run(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_port_load_no_jax():
    assert _run(PROBE) == []


def test_reference_imports_nothing_of_the_program():
    assert _run(REFERENCE) == []


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import benchmark.run as run

    monkeypatch.setitem(sys.modules, "mmduet_tpu_torch_fake.x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "mmduet_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mmduet_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"mmduet_tpu", "jax"} <= set(run.forbidden_modules())
