"""The benchmark on the card: one short run of each cell through
`benchmark/run.py` as its docstring says to start it, and the control at
each cell's own configuration and load, judged by the harness's own
comparison at the cell's limits. Marked ``cuda``; skips without a card
(decided inside the test). Run ``python -m pytest benchmark/tests -q -m
cuda`` on a machine with one."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import spec as specs
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in specs.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483777", "--seconds", "12", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == set(specs.metrics_of(specs.load(), cell, "end_to_end"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cell_size(cell):
    """The reference in the nearest lower precision, in the program's place
    at the cell's configuration and load, fails the cell's limits; the
    program in the same run passes them."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import harness

    spec = specs.load()
    r = harness.run_cell(spec, specs.cell_of(spec, cell), 2147483791, 20, False,
                         torch.device("cuda", 0), time.perf_counter(), with_control=True)
    print(cell, json.dumps(r["window"]), json.dumps(r["checks"]))
    assert r["correct"], r["checks"]
    assert r["window"]["control_correct"] is False, r["window"]["control"]


def test_run_refuses_without_a_card(tmp_path):
    """No result and another exit code than 0 where the cell's cards are
    missing; on the chip the refusal is asked of more cards than there are."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is tested where there is none")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
