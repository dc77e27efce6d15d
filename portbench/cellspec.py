"""What ``BENCHMARK.json`` names, found as files by name.

A cell of ``workloads`` names a configuration (``configs`` entry, whose
``file`` holds the model's fields and names its plain reference module,
``reference``) and a traffic mix (``traffic/<traffic>.json``, whose
``kind`` names the loop ``kinds/<kind>.py`` that drives it); the limits
of its comparison are in ``cells/<cell>.json``; every metric is read by
``metrics/<metric>.py``.  So a cell, a mix, a loop, a model family's
reference or a metric is added by files and entries alone, and this
module is never edited for one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise SpecError(f"{what} {name!r} is not a name: 1 to 64 of letters, "
                        "digits, '_', '.', '-', not starting with '.' or '-'")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise SpecError(f"{what}: unit {unit!r} is not 1 to 16 of letters, "
                        "digits, '_', '/', '%', '.', '-'")
    return unit


@dataclass
class Cell:
    name: str
    config: dict          # the configs entry
    config_file: dict     # the configuration file's content
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # cells/<cell>.json "limits"
    chips: int
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    kind: object          # the loop module kinds/<traffic kind>.py
    reference: object     # the plain reference module the config names

    @property
    def model(self) -> dict:
        return self.config_file["model"]


def _read_json(path: Path, what: str) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{what}: no file {path}") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{what}: {path} is not JSON ({e})") from None


def load_benchmark(root: Path) -> dict:
    bench = _read_json(root / "BENCHMARK.json", "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench.get(key, []):
            check_name(entry.get("name"), f"{key} name")
    for entry in bench.get("workloads", []):
        check_name(entry.get("config"), "workload config")
        check_name(entry.get("traffic"), "workload traffic")
    for entry in bench.get("end_to_end", []) + bench.get("per_layer", []):
        check_unit(entry.get("unit"), entry["name"])
    return bench


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` with every file it needs, or SpecError."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"unknown workload {name!r}; BENCHMARK.json has "
                        f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name}: unknown config {w['config']!r}")
    config = configs[w["config"]]
    config_file = _read_json(root / config["file"], f"config {config['name']}")
    traffic = _read_json(root / HERE.name / "traffic" / f"{w['traffic']}.json",
                         f"traffic {w['traffic']}")
    limits = _read_json(root / HERE.name / "cells" / f"{name}.json",
                        f"cell {name}").get("limits", {})
    ref = config_file.get("reference")
    if not isinstance(ref, str) or not REF_PATH.fullmatch(ref):
        raise SpecError(f"config {config['name']}: 'reference' {ref!r} is "
                        f"not a path under {HERE.name}/reference/")
    return Cell(name=name, config=config, config_file=config_file,
                traffic=traffic, limits=limits, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                kind=load_kind(root, traffic.get("kind")),
                reference=_load(root / ref, f"reference {ref}",
                                ("make_weights",)))


#: A configuration's reference module, relative to the root.
REF_PATH = re.compile(rf"{HERE.name}/reference/[A-Za-z0-9_]+\.py")
_LOADED: dict = {}


def _load(path: Path, what: str, needs: tuple):
    """The module at ``path``, executed once a process, holding every
    callable of ``needs``."""
    path = path.resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise SpecError(f"{what}: no file {path}")
        tag = re.sub(r"\W", "_", str(path.relative_to(path.parents[2])))
        spec = importlib.util.spec_from_file_location(f"portbench_{tag}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    mod = _LOADED[path]
    for name in needs:
        if not callable(getattr(mod, name, None)):
            raise SpecError(f"{what}: {path} defines no {name}()")
    return mod


def load_kind(root: Path, kind):
    """The loop ``kinds/<kind>.py`` of a traffic mix: ``run(run, spans,
    hooks)``, the stand-ins ``FAULTS`` and a ``control``."""
    kind = check_name(kind, "traffic kind")
    return _load(root / HERE.name / "kinds" / f"{kind}.py", f"kind {kind}",
                 ("run",))


def load_reader(root: Path, metric: str):
    """The module ``metrics/<metric>.py``: ``read(run) -> float | None``
    and optionally ``SPANS`` ({span name: (module, attribute)})."""
    path = root / HERE.name / "metrics" / f"{check_name(metric, 'metric')}.py"
    return _load(path, f"metric {metric}", ("read",))
