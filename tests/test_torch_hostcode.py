"""The port owns its host code: every jax-free module it copied from the
JAX package equals its original (source text, modulo the package's name),
the helpers it copied out of modules that import jax behave as the
originals, and a fresh interpreter that imports the whole port holds
neither `jax` nor any module of `mmduet_tpu`."""

import dataclasses
import inspect
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import mmduet_tpu.eval.inference as jcli
import mmduet_tpu.infer.state as jstate
import mmduet_tpu_torch.eval.inference as tcli
from mmduet_tpu.config import TestArgs as JaxInferArgs, tiny_config
from mmduet_tpu.data import collator as jcollator
from mmduet_tpu.models import io as jio
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu.train import loop as jloop
from mmduet_tpu_torch.infer import state as tstate
from mmduet_tpu_torch.models import io as tio
from mmduet_tpu_torch.train import loop as tloop

REPO = Path(__file__).resolve().parents[1]
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)

COPIED_MODULES = [
    "config.py",
    "stream/__init__.py", "stream/template.py", "stream/tokenizer.py", "stream/labels.py",
    "data/__init__.py", "data/collator.py", "data/stream_dataset.py",
    "data/eval_dataset.py", "data/time_utils.py", "data/video.py",
]


def _renamed(text: str) -> str:
    return re.sub(r"\bmmduet_tpu\b", "mmduet_tpu_torch", text)


def _module_text(rel: str) -> None:
    original = (REPO / "mmduet_tpu" / rel).read_text()
    assert (REPO / "mmduet_tpu_torch" / rel).read_text() == _renamed(original)


def _cli_helpers() -> None:
    """The inference CLI's host helpers, function by function (the JAX
    module imports jax in other functions, so the file is not copied)."""
    for ours, theirs in (("round_floats", "round_floats"), ("_argparser", "build_argparser"),
                         ("_test_args", "_test_args"), ("_make_dataset", "_make_dataset")):
        got = inspect.getsource(getattr(tcli, ours))
        want = inspect.getsource(getattr(jcli, theirs)).replace(f"def {theirs}(", f"def {ours}(")
        assert got == want, ours
    argv = ["--test_fname", "t", "--input_dir", "i", "--output_fname", "o",
            "--kv_cache_quant", "int8", "--threshold_z", "0.5", "--grounding_mode", "true"]
    t_args, j_args = tcli.build_argparser().parse_args(argv), jcli.build_argparser().parse_args(argv)
    assert t_args.device == "cuda"
    assert {k: v for k, v in vars(t_args).items() if k != "device"} == vars(j_args)
    assert (dataclasses.asdict(tcli._test_args(t_args, CFG))
            == dataclasses.asdict(jcli._test_args(j_args, CFG)))


def make_args(**kw) -> JaxInferArgs:
    base = dict(system_prompt="sys", frame_fps=2.0, max_new_tokens=6,
                max_num_frames=16, stream_end_prob_threshold=None,
                stream_end_score_sum_threshold=None, threshold_z=None)
    base.update(kw)
    return JaxInferArgs(**base)


def _engine_host_policy() -> None:
    """`infer/state.py`'s host code (the JAX module imports jax)."""
    assert tstate.DEFAULT_BUCKETS == jstate.DEFAULT_BUCKETS
    for n in range(1, 3000):
        assert tstate.pick_bucket(n) == jstate.pick_bucket(n)
    rng = np.random.RandomState(0)
    start, opener = [1, 2, 3], [9, 8]
    for _ in range(200):
        call = (int(rng.randint(0, 3)), str(rng.choice(["system", "stream", "user", "assistant"])),
                list(rng.randint(0, 500, rng.randint(0, 3))), bool(rng.randint(2)), start, opener)
        assert tstate.frame_joiner_ids(*call) == jstate.frame_joiner_ids(*call)
    assert (tstate.build_prompt_fragments(TOK, "sys prompt")
            == jstate.build_prompt_fragments(TOK, "sys prompt"))
    for _ in range(60):
        mode = rng.randint(3)
        args = make_args(
            stream_end_prob_threshold=float(rng.uniform(0.2, 0.9)) if mode == 0 else None,
            stream_end_score_sum_threshold=float(rng.uniform(0.5, 3)) if mode == 1 else None,
            threshold_z=float(rng.uniform(-1, 2)) if mode == 2 else None,
            first_n_frames_no_generate=int(rng.randint(0, 5)),
            running_list_length=int(rng.randint(0, 8)),
        )
        tp, jp = tstate.ThresholdPolicy(args), jstate.ThresholdPolicy(args)
        for s in rng.uniform(0, 1.2, 40):
            assert tp.triggered(float(s)) == jp.triggered(float(s))
            assert tp.prob_list == jp.prob_list and tp.score_sum == jp.score_sum
    for bad in (make_args(), make_args(threshold_z=1.0, stream_end_prob_threshold=0.5)):
        with pytest.raises(ValueError):
            tstate.validate_threshold_args(bad)
        with pytest.raises(ValueError):
            jstate.validate_threshold_args(bad)


def _loop_helpers(tmp_path) -> None:
    """`train/loop.py`'s helpers and `models/io.py`'s config functions (the
    JAX modules import optax and jax)."""
    for spec, cap, quantum in (("auto", 5924, 128), ("auto", 800, 8), ("none", 99, 128),
                               ("1536,2560,5924", 5924, 128), ("AUTO", 300, 128)):
        assert (tloop.parse_length_buckets(spec, cap, quantum)
                == jloop.parse_length_buckets(spec, cap, quantum))
    for a, b in zip(tloop.synthetic_batches(CFG, 48, 4, 2, 3, 2, seed=5),
                    jloop.synthetic_batches(CFG, 48, 4, 2, 3, 2, seed=5)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with ThreadPoolExecutor(2) as pool:
        assert (list(tloop._prefetch_map(pool, lambda x: x * x, range(9), 2))
                == list(jloop._prefetch_map(pool, lambda x: x * x, range(9), 2)))

    def collate(samples):  # two lengths -> two bucket keys
        n = 4 if sum(samples) % 2 else 6
        return {"input_ids": np.full((len(samples), n), sum(samples))}

    samples = list(range(17))
    got = list(tloop._accumulate(iter(samples), collate, 2, 2, jcollator.stack_accum))
    want = list(jloop._accumulate(iter(samples), collate, 2, 2, jcollator.stack_accum))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])

    class Data:
        def __init__(self):
            self.epochs = []

        def __len__(self):
            return 11

        def set_epoch(self, e):
            self.epochs.append(e)

        def __getitem__(self, i):
            return i

    for workers, skip in ((0, 0), (2, 3)):
        dt, dj = Data(), Data()
        got = list(tloop.real_batches(dt, collate, 2, 2, 3, 7, workers, skip))
        want = list(jloop.real_batches(dj, collate, 2, 2, 3, 7, workers, skip))
        assert dt.epochs == dj.epochs
        assert [g["input_ids"].tolist() for g in got] == [w["input_ids"].tolist() for w in want]

    # config.json is one format: either package reads the other's file,
    # into its own classes
    cfg = CFG.replace(frame_token_pooled=(7, 7))
    tio.save_config(tio.config_from_dict(dataclasses.asdict(cfg)), str(tmp_path / "t.json"))
    jio.save_config(cfg, str(tmp_path / "j.json"))
    assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()
    t_cfg, j_cfg = tio.load_config(str(tmp_path / "j.json")), jio.load_config(str(tmp_path / "t.json"))
    assert type(t_cfg).__module__ == "mmduet_tpu_torch.config"
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)


@pytest.mark.parametrize(
    "case", COPIED_MODULES + ["eval/inference.py helpers", "infer/state.py host policy",
                              "train/loop.py and models/io.py helpers"])
def test_copied_host_code_equals_the_original(case, tmp_path):
    if case in COPIED_MODULES:
        _module_text(case)
    elif case.startswith("eval"):
        _cli_helpers()
    elif case.startswith("infer"):
        _engine_host_policy()
    else:
        _loop_helpers(tmp_path)


IMPORT_ALL = """
import importlib, pkgutil, sys
import mmduet_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(mmduet_tpu_torch.__path__, "mmduet_tpu_torch."):
    importlib.import_module(m.name)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "mmduet_tpu")))
"""


def test_importing_the_port_loads_nothing_of_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_port_source_names_the_jax_package_in_an_import():
    pattern = re.compile(r"^\s*(from|import)\s+mmduet_tpu(\.|\s|$)", re.M)
    files = list((REPO / "mmduet_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch.py"]
    assert len(files) > 30
    assert [str(f) for f in files if pattern.search(f.read_text())] == []
