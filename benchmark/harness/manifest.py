"""``BENCHMARK.json`` and the files it names: a cell's configuration,
its architecture's family, traffic mix and limits, and the per-layer
metrics' readers, each found by its name.

- a configuration: the ``file`` its ``configs`` entry gives, which names
  its family under the top-level key ``"family"``;
- a family: ``benchmark/families/<family>.py``, the module that turns the
  configuration into sizes, weights, the program's configs, the plain
  reference and the counts of operations and bytes;
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a cell's limits of the comparison: ``benchmark/limits/<cell>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, whose
  ``read(context)`` returns the number or None where it finds nothing."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(cells: {', '.join(w['name'] for w in bench['workloads'])})")


def config_file(bench: dict, root: Path, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config(path: Path) -> dict:
    """The configuration file at ``path``; it has to name its family."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no configuration at {path}")
    conf = json.loads(path.read_text())
    if not isinstance(conf.get("family"), str):
        raise ValueError(f"the configuration {path} names no family: it needs a top-level "
                         f"\"family\" key, the name of a module benchmark/families/<family>.py")
    return conf


def family(name: str, root: Path = HERE):
    """The module of family ``name`` (one import a path, kept in
    ``sys.modules`` so that its classes stay one)."""
    path = (Path(root) / "families" / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no family {name!r} at {path}")
    key = "benchmark_family_" + re.sub(r"\W", "_", str(path))
    module = sys.modules.get(key)
    if module is None:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return module


def limits(name: str, root: Path = HERE) -> dict:
    path = root / "limits" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits for cell {name!r} at {path}")
    return json.loads(path.read_text())


def metrics_for(bench: dict, cell_name: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that cell
    ``cell_name`` reports: those without a ``workloads`` key, and those
    that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, root: Path = HERE):
    """The ``read`` function of per-layer metric ``name``."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
