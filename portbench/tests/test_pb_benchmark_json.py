"""``BENCHMARK.json`` within the characters and shapes its format allows, and
every name it gives found as a file of the harness."""
import json
import os
import re

import pytest

from portbench import harness

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
PATH = os.path.join(ROOT, "BENCHMARK.json")
with open(PATH) as _f:
    BENCH = json.load(_f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and not re.search(
        r"[\n\r\t]", s)


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert os.path.getsize(PATH) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs_and_cells():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for c in cfgs.values():
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(json.load(f)["reduced"]) == set(c["reduced"])
    assert len({c["file"] for c in cfgs.values()}) == len(cfgs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(cfgs)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        mix = os.path.join(PB, "traffic", w["traffic"] + ".json")
        with open(mix) as f:
            mode = json.load(f)["mode"]
        assert os.path.exists(os.path.join(PB, "modes", mode + ".py"))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = [m for m in BENCH["end_to_end"] if _reported(m, cell)]
    layer = [m for m in BENCH["per_layer"] if _reported(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e}
    assert len(e2e) >= 2 and layer
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", ())) <= cells


def test_moves_is_reported_in_each_cell_of_the_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert _reported(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(harness._reader(PB, m["name"]))
