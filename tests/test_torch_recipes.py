"""The port's recipes, `scripts/train_torch.sh` and
`scripts/eval_{youcook2,magqa,charades,qvh}_torch.sh`, against the JAX
package's `scripts/train.sh` and `scripts/eval_*.sh`:

- each pair, run with a stand-in ``python`` that records its arguments,
  hands the same protocol flags and values to its CLIs (the port adds
  ``--device`` and, with ``NPROC`` > 1, `torch.distributed.run` and the
  mesh flags);
- `eval_charades_torch.sh` and `eval_youcook2_torch.sh` run for real with
  ``TINY_RANDOM=1 DEVICE=cpu`` on `scripts/make_smoke_fixtures.py`'s
  fixtures (skipped without ``cv2``, which decodes the mp4s) and write their
  rows and metrics;
- `train_torch.sh` runs for real in ``TINY_RANDOM`` synthetic mode with
  ``DEVICE=cpu``, in one process and on two gloo ranks."""

import json
import math
import os
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
EVALS = ("youcook2", "magqa", "charades", "qvh")


def _stub_python(tmp_path) -> str:
    """A bin dir whose ``python`` appends its argv, one JSON list a line,
    to ``$RECORD`` and exits 0."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text(f"#!{sys.executable}\nimport json, os, sys\n"
                    "with open(os.environ['RECORD'], 'a') as f:\n"
                    "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return str(bin_dir)


def _record(tmp_path, script: str, env: dict) -> list:
    """The argv lists of every ``python`` call ``script`` makes."""
    tag = f"{script}-{len(list(tmp_path.iterdir()))}"
    record = tmp_path / f"{tag}.jsonl"
    bin_dir = tmp_path / "bin"
    full = dict(os.environ, RECORD=str(record), OUTPUT_DIR=str(tmp_path / "out"), **env,
                PATH=f"{bin_dir if bin_dir.exists() else _stub_python(tmp_path)}:"
                     f"{os.environ['PATH']}")
    for k in ("NPROC", "DEVICE", "MESH_DATA", "MESH_MODEL", "PARAM_MODE", "DIST_BACKEND",
              "OPENAI_API_KEY"):
        if k not in env:
            full.pop(k, None)
    subprocess.run(["bash", os.path.join(SCRIPTS, script)], cwd=REPO, env=full, check=True,
                   capture_output=True, text=True)
    return [json.loads(line) for line in record.read_text().splitlines()]


def _flags(argv: list) -> tuple:
    """(module, {flag: value or True}) of one ``python [-u] [-m
    torch.distributed.run ...] -m module --flag value ...`` call."""
    i = len(argv) - 1 - argv[::-1].index("-m")
    module, rest = argv[i + 1], argv[i + 2:]
    out, j = {}, 0
    while j < len(rest):
        if j + 1 < len(rest) and not rest[j + 1].startswith("--"):
            out[rest[j]] = rest[j + 1]
            j += 2
        else:
            out[rest[j]] = True
            j += 1
    return module, out


def _launcher(argv: list) -> list:
    """The arguments before the CLI's module: ``-u``, and under NPROC the
    `torch.distributed.run` launch."""
    return argv[:len(argv) - 1 - argv[::-1].index("-m")]


@pytest.mark.parametrize("name", EVALS)
@pytest.mark.parametrize("mode", ["tiny", "checkpoint", "batched"])
def test_eval_recipe_protocol_flags(tmp_path, name, mode):
    """Every CLI call of `eval_<name>_torch.sh` carries the JAX recipe's
    flags and values, plus ``--device`` (default cuda) on the inference
    CLI; the evaluate calls are the same calls of the port's module."""
    env = {"INPUT_DIR": "/data/videos", "TEST_FNAME": "/data/anno.json",
           "GOLD_FILE": "/data/gold.jsonl", "JUDGE_LLM": "" if mode != "batched" else "judge"}
    env.update({"tiny": {"TINY_RANDOM": "1"}, "checkpoint": {"CHECKPOINT": "/ckpt"},
                "batched": {"CHECKPOINT": "/ckpt", "BATCH_STREAMS": "4", "PREWARM": "1"}}[mode])
    jax_calls = _record(tmp_path, f"eval_{name}.sh", env)
    port_calls = _record(tmp_path, f"eval_{name}_torch.sh", env)
    assert len(port_calls) == len(jax_calls) >= 1
    for jax_argv, port_argv in zip(jax_calls, port_calls):
        jmod, jflags = _flags(jax_argv)
        pmod, pflags = _flags(port_argv)
        assert pmod == jmod.replace("mmduet_tpu.", "mmduet_tpu_torch.", 1)
        if pmod.endswith("inference"):
            assert pflags.pop("--device") == "cuda"
        assert pflags == jflags, (name, mode, pmod)
        assert _launcher(port_argv) == _launcher(jax_argv)


@pytest.mark.parametrize("name", EVALS)
def test_eval_recipe_mesh_launch(tmp_path, name):
    """``NPROC`` > 1 starts the inference CLI under `torch.distributed.run`
    with the mesh flags (tensor parallelism by default, ``MESH_DATA`` for
    lanes over ranks); ``DEVICE`` reaches ``--device``."""
    env = {"TINY_RANDOM": "1", "INPUT_DIR": "/v", "TEST_FNAME": "/a.json", "NPROC": "4",
           "MESH_DATA": "2", "BATCH_STREAMS": "4", "DIST_BACKEND": "gloo", "DEVICE": "cpu"}
    infer = _record(tmp_path, f"eval_{name}_torch.sh", env)[0]
    assert _launcher(infer) == ["-u", "-m", "torch.distributed.run", "--standalone",
                                "--nproc_per_node", "4"]
    _, flags = _flags(infer)
    assert (flags["--mesh_data"], flags["--mesh_model"], flags["--dist_backend"],
            flags["--device"], flags["--batch_streams"]) == ("2", "2", "gloo", "cpu", "4")
    env.pop("MESH_DATA")
    _, flags = _flags(_record(tmp_path, f"eval_{name}_torch.sh", env)[0])
    assert (flags["--mesh_data"], flags["--mesh_model"]) == ("1", "4")


@pytest.mark.parametrize("mode", ["synthetic", "datasets", "checkpoint"])
def test_train_recipe_protocol_flags(tmp_path, mode):
    """`train_torch.sh` hands the training CLI the JAX recipe's knobs flag
    for flag (epochs, batch 1, accum 16, save and log steps, LR 2e-5 cosine
    with warmup 0.05, 2 fps, 100 frames, LoRA r 16 / alpha 32), plus
    ``--device``; with ``NPROC`` it runs under `torch.distributed.run` with
    ``--mesh_data NPROC / MESH_MODEL --param_mode replicate`` (ZeRO-2) by
    default."""
    env = {"synthetic": {"TINY_RANDOM": "1"},
           "datasets": {"TINY_RANDOM": "1", "DATASET_CONFIG": "/d.json", "RESUME": "/r"},
           "checkpoint": {"CHECKPOINT": "/ckpt", "EPOCHS": "2", "ACCUM": "8"}}[mode]
    (jax_argv,) = _record(tmp_path, "train.sh", env)
    (port_argv,) = _record(tmp_path, "train_torch.sh", env)
    jmod, jflags = _flags(jax_argv)
    pmod, pflags = _flags(port_argv)
    assert (jmod, pmod) == ("mmduet_tpu.train.loop", "mmduet_tpu_torch.train.loop")
    assert pflags.pop("--device") == "cuda"
    assert pflags == jflags
    assert _launcher(port_argv) == _launcher(jax_argv) == ["-u"]

    (mesh_argv,) = _record(tmp_path, "train_torch.sh", dict(env, NPROC="8"))
    _, mflags = _flags(mesh_argv)
    assert _launcher(mesh_argv) == ["-u", "-m", "torch.distributed.run", "--standalone",
                                    "--nproc_per_node", "8"]
    assert {k: mflags.pop(k) for k in ("--mesh_data", "--mesh_model", "--param_mode",
                                       "--dist_backend", "--device")} == {
        "--mesh_data": "8", "--mesh_model": "1", "--param_mode": "replicate",
        "--dist_backend": "nccl", "--device": "cuda"}
    assert mflags == jflags
    (tp_argv,) = _record(tmp_path, "train_torch.sh", dict(
        env, NPROC="8", MESH_MODEL="2", PARAM_MODE="fsdp", DIST_BACKEND="gloo", DEVICE="cpu"))
    _, tflags = _flags(tp_argv)
    assert (tflags["--mesh_data"], tflags["--mesh_model"], tflags["--param_mode"],
            tflags["--dist_backend"], tflags["--device"]) == ("4", "2", "fsdp", "gloo", "cpu")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    pytest.importorskip("cv2")  # the recipes decode their mp4s with it
    sys.path.insert(0, SCRIPTS)
    import make_smoke_fixtures

    d = str(tmp_path_factory.mktemp("fixtures"))
    make_smoke_fixtures.main(d)
    return d


def _run(script: str, env: dict, timeout: float = 240) -> subprocess.CompletedProcess:
    full = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **env)
    for k in ("NPROC", "BATCH_STREAMS", "PREWARM", "CHECKPOINT", "DATASET_CONFIG"):
        if k not in env:
            full.pop(k, None)
    proc = subprocess.run(["bash", os.path.join(SCRIPTS, script)], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


@pytest.mark.parametrize("name, gold, metric", [
    ("charades", "charades.json", "charades_test-random_prompt-eval.json"),
    ("youcook2", "youcook2.json", None),
])
def test_eval_recipe_runs_on_cpu(tmp_path, fixtures, name, gold, metric):
    """The recipe serves the fixtures with the tiny random model on the CPU
    and scores the rows: one JSONL row a sample, and the metrics."""
    out = tmp_path / "out"
    proc = _run(f"eval_{name}_torch.sh", {
        "TINY_RANDOM": "1", "DEVICE": "cpu", "OUTPUT_DIR": str(out),
        "INPUT_DIR": os.path.join(fixtures, "videos"),
        "TEST_FNAME": os.path.join(fixtures, gold)})
    samples = json.load(open(os.path.join(fixtures, gold)))
    (pred,) = [p for p in (out / "eval").iterdir() if p.name.endswith("-pred.json")]
    rows = [json.loads(line) for line in pred.read_text().splitlines()]
    assert len(rows) == len(samples)
    if metric is None:  # dense captioning prints its metrics
        assert '"F1"' in proc.stdout
    else:
        results = json.load(open(out / "eval" / metric))
        assert any(r["threshold"] == "oracle" for r in results)


@pytest.mark.parametrize("nproc", [1, 2])
def test_train_recipe_runs_on_cpu(tmp_path, nproc):
    """Synthetic steps through the recipe on the CPU, in one process and on
    two gloo ranks: rc 0, finite losses in ``log.jsonl``, ``final/``."""
    env = {"TINY_RANDOM": "1", "DEVICE": "cpu", "OUTPUT_DIR": str(tmp_path)}
    if nproc > 1:
        env.update(NPROC=str(nproc), DIST_BACKEND="gloo")
    _run("train_torch.sh", env)
    rows = [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert rows and rows[-1]["step"] == 3
    assert all(math.isfinite(r[k]) for r in rows for k in ("loss", "lm_loss", "video_loss"))
    assert (tmp_path / "final" / "params.pt").exists()
