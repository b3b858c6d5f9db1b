"""On the card only (``-m cuda``; skipped elsewhere): one short traced
run of every cell through ``portbench/run.py``, each correct, its result
line in the benchmark's format, and every share of a roofline
inside (0, 105]."""
import json
import os
import subprocess
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_on_the_card(cuda_card, cell):
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 4099), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    declared = {m["name"] for m in BENCH["per_layer"]
                if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == declared
    for name, m in out["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105
    assert r.stderr.strip().splitlines()[-1].startswith("[portbench] check")
