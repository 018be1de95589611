"""`BENCHMARK.json`: read, validated, and resolved into the files that the
harness finds by name.

Everything of one configuration, one traffic mix or one per-layer metric
sits in a file of its own, found from its name alone:

- ``configs`` entries name their file (``benchmark/configs/<config>.json``);
- a workload's ``traffic`` is ``benchmark/traffic/<traffic>.json``;
- a per-layer metric ``<name>`` is read by ``benchmark/metrics/<name>.py``
  (a ``read(run)`` function, see `benchmark.record.Run`);
- a configuration file's decoder is ``benchmark/arch/<architecture>.py``,
  from its ``architectures[0]`` (`architecture`), and its plain reference
  the file its ``reference`` key names (`reference`).

So a cell, a configuration, a metric or a decoder architecture is added
with files and entries, never by editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, List, Optional

ROOT = Path(__file__).resolve().parents[1]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    pass


class UnsupportedConfig(SpecError):
    """A configuration file names what the benchmark cannot serve: an
    architecture or a reference with no file, or a key or a value that its
    architecture (`benchmark.model_shapes.common`) does not honour."""


def _name(s: Any, what: str) -> None:
    if not isinstance(s, str) or not NAME.match(s):
        raise SpecError(f"{what}: not a name: {s!r}")


def validate(spec: dict, root: Path = ROOT) -> None:
    """Raises `SpecError` where a name or a unit breaks its character set,
    where a per-layer metric ``moves`` an end-to-end metric that one of its
    cells does not report, where a configuration has no cell, or where a
    name finds no file (a configuration's file, its architecture's, its
    reference's). The rest of the contract is the driver's to check."""
    configs = {c["name"]: c for c in spec["configs"]}
    for c in configs.values():
        _name(c["name"], "config name")
        if not (root / c["file"]).is_file():
            raise SpecError(f"config {c['name']}: no file {c['file']}")
        cfg = config_of(spec, c["name"], root)
        try:
            arch_file(cfg, root)
            reference_file(cfg, root)
        except UnsupportedConfig as e:
            raise SpecError(f"config {c['name']}: {e}") from None
    cells = spec["workloads"]
    for w in cells:
        for key in ("name", "config", "traffic"):
            _name(w[key], f"workload {key}")
        if w["config"] not in configs:
            raise SpecError(f"workload {w['name']}: no configuration {w['config']}")
        if not traffic_path(w["traffic"], root).is_file():
            raise SpecError(f"workload {w['name']}: no traffic file {w['traffic']}")
    if {w["config"] for w in cells} != set(configs):
        raise SpecError("a configuration is used by no cell")
    cell_names = {w["name"] for w in cells}
    names = set()
    for m in spec["end_to_end"] + spec["per_layer"]:
        _name(m.get("name"), "metric name")
        if m["name"] in names:
            raise SpecError(f"metric {m['name']} appears twice")
        names.add(m["name"])
        if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
            raise SpecError(f"metric {m['name']}: unit {m.get('unit')!r}")
        for c in m.get("workloads", []):
            if c not in cell_names:
                raise SpecError(f"metric {m['name']}: no cell {c}")
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        if m["moves"] not in e2e:
            raise SpecError(f"metric {m['name']}: moves {m['moves']}, no end-to-end metric")
        for c in m.get("workloads", []):  # without the key: the cells that report `moves`
            if m["moves"] not in metrics_of(spec, c, "end_to_end"):
                raise SpecError(f"metric {m['name']}: cell {c} does not report {m['moves']}")
        if not metric_path(m["name"], root).is_file():
            raise SpecError(f"metric {m['name']}: no reader {metric_path(m['name'], root)}")


def metrics_of(spec: dict, cell: str, kind: str) -> List[str]:
    """The names of the ``kind`` ("end_to_end" or "per_layer") metrics that
    ``cell`` reports: those that list it, and those that list no cells
    (per-layer: those whose ``moves`` the cell reports)."""
    out = []
    e2e = None
    for m in spec[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m["name"])
            continue
        if kind == "per_layer":
            if e2e is None:
                e2e = metrics_of(spec, cell, "end_to_end")
            if m["moves"] not in e2e:
                continue
        out.append(m["name"])
    return out


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    validate(spec, root)
    return spec


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r}; the cells are "
                    f"{[w['name'] for w in spec['workloads']]}")


def config_of(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise SpecError(f"no configuration {name!r}")


def traffic_of(name: str, root: Path = ROOT) -> dict:
    with open(traffic_path(name, root)) as f:
        return json.load(f)


def arch_file(cfg: dict, root: Path = ROOT) -> Path:
    """``benchmark/arch/<architecture>.py`` of a configuration file's
    contents, from its ``architectures``, a list of one name."""
    names = cfg.get("architectures")
    if not (isinstance(names, list) and len(names) == 1 and isinstance(names[0], str)
            and NAME.match(names[0])):
        raise UnsupportedConfig(f"architectures {names!r}: not a list of one name")
    path = root / "benchmark" / "arch" / f"{names[0]}.py"
    if not path.is_file():
        raise UnsupportedConfig(f"architecture {names[0]}: no file benchmark/arch/{path.name}")
    return path


def reference_file(cfg: dict, root: Path = ROOT) -> Path:
    """The plain reference's file, which a configuration file's
    ``reference`` names relative to the root."""
    ref = cfg.get("reference")
    if (not isinstance(ref, str) or Path(ref).is_absolute() or ".." in Path(ref).parts
            or not (root / ref).is_file()):
        raise UnsupportedConfig(f"reference {ref!r}: no file under the root")
    return root / ref


def load_module(path: Path, name: str) -> ModuleType:
    """The file at ``path`` loaded anew as module ``name`` (registered, so
    that its dataclasses resolve their annotations); such a file imports
    the benchmark's own modules as ``benchmark.*``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def architecture(cfg: dict, root: Path = ROOT) -> ModuleType:
    """The decoder architecture of a configuration file's contents
    (``benchmark/arch/<architecture>.py``). It exports ``DECODER_KEYS`` and
    ``shapes(cfg)``, which raises `UnsupportedConfig` on what it cannot
    serve; ``leaves(s)`` (`benchmark.weights`); ``port_config(s)``, the
    port's ``MMDuetConfig``; and the operations (`benchmark.flops`) of a
    chunk of ``t`` tokens after ``cache_len`` slots, ``chunk(s, cache_len,
    t)``, of an LM-head row, ``lm_head_row(s)``, of a frame's score heads,
    ``score_heads_frame(s)``, and of a frame of the tower and projector,
    ``vision_frame(s)``."""
    path = arch_file(cfg, root)
    return load_module(path, f"benchmark_arch_{path.stem}")


def reference(cfg: dict, root: Path = ROOT) -> ModuleType:
    """The plain reference that a configuration file's ``reference`` names.
    It exports what `benchmark.reference.check` and
    `benchmark.harness.reference_check` call: ``no_tf32``, ``served(s)`` and
    ``control(s)`` (precisions), ``Branch``, ``frame_embeds``, ``embed_rows``
    and ``decoder``."""
    path = reference_file(cfg, root)
    return load_module(path, f"benchmark_reference_{path.stem}")


def reader(name: str, root: Path = ROOT):
    """The ``read(run) -> Optional[float]`` of ``benchmark/metrics/<name>.py``."""
    return load_module(metric_path(name, root), f"benchmark_metric_{name}").read


def unit_of(spec: dict, name: str) -> Optional[str]:
    return _metric(spec, name).get("unit")


def source_of(spec: dict, name: str) -> Optional[str]:
    return _metric(spec, name).get("source")


def _metric(spec: dict, name: str) -> dict:
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == name:
            return m
    return {}
