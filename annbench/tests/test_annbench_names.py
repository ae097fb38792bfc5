"""Every configuration, traffic mix and metric of BENCHMARK.json loads by
name, and the file keeps the contract's shape."""
import json
import re
from pathlib import Path

import pytest

from annbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["annbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(wl):
    cell = harness.load_cell(wl)
    assert cell["config"]["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == wl)
    assert cell["traffic"]["kind"] in ("closed", "open")
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    every = [c["name"] for c in BENCH["configs"]] + list(cells) + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every))
    for name in every:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for wl in m["workloads"]:
            reported = [x for x in BENCH["end_to_end"]
                        if wl in x.get("workloads", [wl])]
            assert m["moves"] in {x["name"] for x in reported}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert cfg[key] != cfg["published_" + key]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
    with pytest.raises(KeyError):
        harness.reader("no_such_metric")
