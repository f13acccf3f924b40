"""Finding what a cell is made of, by name, from files alone.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix. A configuration is the file its entry names
(``portbench/configs/<name>.yaml``), a mix is ``portbench/traffic/<name>.json``,
and a per-layer metric is a reader in ``portbench/metrics/<name>.py`` with a
function ``read(reading)``. Adding a cell, a configuration, a mix or a metric
adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

import yaml

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def config(bench: Dict[str, Any], name: str, root: str = ROOT) -> Dict[str, Any]:
    """The configuration file of ``name`` as its BENCHMARK.json entry names it."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return yaml.safe_load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict[str, Any]:
    with open(os.path.join(PKG_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def reports(metric: Dict[str, Any], cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: a metric without a
    ``workloads`` list is reported in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if reports(m, cell)]


def reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = os.path.join(PKG_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
