"""The readers of the program's own spans and counters (``spec_wedges_s``,
``spec_supports_s``, ``spec_beindex_s``, ``fd_pack_s``, ``fd_host_syncs``,
``entry_s``, ``gc_s``): each reads a number in the traced run of every
cell that lists it, on the tests' tiny CPU copy, and reads nothing, and
raises nothing, from a program without those spans and counts."""
import json
import os

import pytest

from portbench import harness

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
READERS = ("spec_wedges_s", "spec_supports_s", "spec_beindex_s",
           "fd_pack_s", "fd_host_syncs", "entry_s", "gc_s")
LISTED = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
          if m["name"] in READERS}
CELLS = sorted({c for cells in LISTED.values() for c in cells})
SEED = 2**31 + 4099


def test_each_reader_is_declared_once():
    assert set(LISTED) == set(READERS)
    for name in READERS:
        assert callable(harness._reader(PB, name))


@pytest.mark.parametrize("cell", CELLS)
def test_readers_read_the_program(tiny_root, cell):
    root, pb = tiny_root
    out = harness.run_cell(cell, SEED, 0.3, True, device="cpu", root=root,
                           pb=pb)
    assert out["correct"] is True
    want = {name for name, cells in LISTED.items() if cell in cells}
    assert want <= set(out["metrics"])
    for name in want:
        value = out["metrics"][name]["value"]
        assert value >= 0, (name, value)
        if name != "gc_s":
            assert value > 0, (name, value)


def test_readers_read_nothing_from_a_program_without_them(monkeypatch):
    from repro_torch import obs

    # a decomposition's seconds as a program without the spans gives them
    rec = {"decomps": [{"seconds": {"peel": 2.0, "cd": 0.1, "fd": 0.6},
                        "total": 2.5, "launches": 768}]}
    monkeypatch.delattr(obs, "counts")
    for name in READERS:
        assert harness._reader(PB, name)(rec) is None, name
        assert harness._reader(PB, name)({}) is None, name
