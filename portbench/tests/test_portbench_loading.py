"""Every cell's configuration, traffic mix, system and metrics are found
by name from their own files, and BENCHMARK.json keeps to its contract's
shape."""

from __future__ import annotations

import json
import re

import pytest

from portbench.lib import harness
from portbench.lib.common import PORTBENCH, ROOT, load_named

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_parts_load_by_name(cell):
    config = load_named("configs", cell["config"])
    mix = load_named("traffic", cell["traffic"])
    system = load_named("systems", config["system"], ".py")
    assert callable(system.run)
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert mix["kind"] in ("video", "train")
    for trace in (False, True):
        metrics = harness.cell_metrics(BENCH, cell, trace)
        assert metrics, (cell["name"], trace)
        for m in metrics:
            assert callable(load_named("metrics", m["name"], ".py").read)
    names = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_names_its_file(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and path.parent == PORTBENCH / "configs"
    assert path.stem == entry["name"]
    config = json.loads(path.read_text())
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    names = ([c["name"] for c in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_missing_file_is_named():
    with pytest.raises(FileNotFoundError, match="portbench/traffic/no_such_mix.json"):
        load_named("traffic", "no_such_mix")
    with pytest.raises(KeyError):
        harness.find_cell("no_such.cell")
