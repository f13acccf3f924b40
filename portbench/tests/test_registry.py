"""The harness finds cells, configurations, mixes and metrics by name, from
files alone, and BENCHMARK.json keeps to its format."""

import json
import os
import re

import pytest

from portbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cfg = cells.config(bench, w["config"])
        assert "config" in cfg and "source" in cfg and "reduced" in cfg and "assumed" in cfg
        tr = cells.traffic(w["traffic"])
        assert tr["scene"]["loop_frames"] < tr["scene"]["frames"]
        for kind in ("end_to_end", "per_layer"):
            assert cells.cell_metrics(bench, w["name"], kind)


def test_every_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    names = {m["name"] for m in bench["end_to_end"]}
    assert {"fps", "track_p90_ms", "peak_mem_gib", "setup_s"} <= names


def test_a_new_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "new_mix.json").write_text(json.dumps({"scene": {}}))
    (tmp_path / "metrics" / "new_metric.py").write_text("def read(r):\n    return 42.0\n")
    monkeypatch.setattr(cells, "PKG_DIR", str(tmp_path))
    assert cells.traffic("new_mix") == {"scene": {}}
    assert cells.reader("new_metric")({}) == 42.0


def test_benchmark_json_format(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["name"] not in names
        names.add(w["name"])
    cell_names = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert set(m.get("workloads", cell_names)) <= cell_names
        layers.add(m["layer"])
    for w in bench["workloads"]:
        assert cells.cell_metrics(bench, w["name"], "per_layer")


def test_each_cell_reports_what_its_layers_move(bench):
    """A per-layer metric's cells each report the end-to-end metric it
    moves, and each cell reports set-up and one more end-to-end metric."""
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cells.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in cells.cell_metrics(bench, w["name"], "per_layer"):
            assert m["moves"] in e2e, (w["name"], m["name"])
