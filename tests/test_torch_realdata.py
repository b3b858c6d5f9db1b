"""``chip_smoke.py``'s real-graph phase, rehearsed on the CPU.

The card's machine has no JAX, so ``chip_smoke.py`` rebuilds the
recorder's inputs with its own few lines of numpy and holds the port to
``tests/goldens/torch_realdata.json``.  Here, with the JAX package at
hand:

* its TSV writer gives the recorder's bytes (and the recorded sha256);
* its query generator gives the recorder's batch;
* its CLI step and artifact-serving step pass on southern_women, with
  the port on the CPU (the plain versions of the kernels).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


@pytest.fixture(scope="module")
def recorder():
    return _load("record_torch_realdata", os.path.join(
        ROOT, "tests", "goldens", "record_torch_realdata.py"))


@pytest.fixture(scope="module")
def realdata():
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_realdata.json")) as f:
        return json.load(f)


def test_tsv_bytes_equal_the_recorders(smoke, recorder, realdata, tmp_path):
    path = smoke.write_tsv(realdata, "wing-60k", str(tmp_path))
    recipe = realdata["wing-60k"]["graph"]
    assert recipe == recorder.G_60K
    from repro.core.graph import powerlaw_bipartite

    ref = str(tmp_path / "ref.tsv")
    recorder.write_tsv(ref, powerlaw_bipartite(**recipe).edges)
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("n_ent,n_nodes", [(89, 8), (7910, 259)])
def test_query_batch_equals_the_recorders(smoke, recorder, n_ent, n_nodes):
    for a, b in zip(smoke.query_batch_inputs(n_ent, n_nodes, 4096, 0),
                    recorder.query_batch_inputs(n_ent, n_nodes)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_recorded_runs_cover_every_step(realdata, recorder):
    assert set(realdata) == set(recorder.RUNS)
    for name, want in realdata.items():
        assert set(want["hierarchy"]["arrays"]) == set(
            recorder._ARRAY_FIELDS)
        assert want["queries"]["n"] == 4096, name


@pytest.mark.parametrize("kind", ["wing", "tip"])
def test_real_graph_phase_on_southern_women(smoke, realdata, tmp_path, kind):
    name = f"southern_women-{kind}"
    launches, seconds = {}, {}
    counts, out, art = smoke.real_cli(
        realdata, name, os.path.join(ROOT, "datasets", "southern_women.tsv"),
        ["--use-pallas"], "cpu", str(tmp_path), launches, seconds)
    assert counts == {k: 0 for k in counts}   # plain versions on the CPU
    assert {"ingest", "tiled_init", "peel", "hierarchy_labels",
            "hierarchy_assembly"} <= set(seconds[name])
    smoke.serve_artifact(realdata, name, art, "cpu", seconds)
    assert "serving" in seconds[name]
    # a wrong recorded value is caught
    bad = json.loads(json.dumps(realdata))
    bad[name]["queries"]["answers_sha256"] = "0" * 64
    with pytest.raises(AssertionError, match="served answers"):
        smoke.serve_artifact(bad, name, art, "cpu", {})
