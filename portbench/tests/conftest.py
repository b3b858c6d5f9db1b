"""Tests of the benchmark itself (run on the CPU from the checkout's
root: ``python -m pytest -q portbench/tests``).

Registers the ``cuda`` marker: those tests need an NVIDIA card, look for
it inside the ``cuda_card`` fixture and skip where there is none.  On a
machine with a card::

    python -m pytest -q -m cuda portbench/tests
"""
import json
import os
import shutil
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# every configuration cut to a size a test run holds on the CPU
TINY_GRAPHS = {
    "bcl-56k": dict(n_u=400, n_v=300, m=3000),
    "bcl-943": dict(n_u=200, n_v=150, m=9000, keep_users=150),
}
TINY_MIXES = {"query": dict(batch=256, pool_batches=6, warmup_batches=2)}
# the query cell, out of BENCHMARK.json until its host noise fits a bound
# (PERF.md), with its metrics: the tests add it to their copy, so that
# its mode, reference and readers stay tested for the PR that brings it
QUERY_CELL = "bcl-56k.query"
QUERY_ENTRIES = {
    "workloads": [{"name": QUERY_CELL, "config": "bcl-56k",
                   "traffic": "query", "chips": 1, "why": "a test"}],
    "end_to_end": [{"name": "query_qps", "unit": "queries/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": [QUERY_CELL]}],
    "per_layer": [
        {"name": "batch_p95_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "service", "moves": "query_qps",
         "workloads": [QUERY_CELL]},
        {"name": "device_idle_pct.query", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "query_qps", "workloads": [QUERY_CELL]}],
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skipped where "
        "torch.cuda.is_available() is False)")


@pytest.fixture
def cuda_card():
    """Skip unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() "
                    "is False)")
    return torch.device("cuda")


def _shrink(path, **sizes):
    with open(path) as f:
        cfg = json.load(f)
    target = cfg["generate"] if "generate" in cfg else cfg
    target.update(sizes)
    with open(path, "w") as f:
        json.dump(cfg, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the checkout's benchmark (``BENCHMARK.json`` and
    ``portbench/``) with every configuration and mix cut to a tiny size,
    and the query cell added.
    Returns (root, harness folder)."""
    root = tmp_path / "checkout"
    pb = root / "portbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    for section, entries in QUERY_ENTRIES.items():
        bench[section] += entries
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    for c in bench["configs"]:
        _shrink(root / c["file"], **TINY_GRAPHS[c["name"]])
    for mix, sizes in TINY_MIXES.items():
        _shrink(pb / "traffic" / f"{mix}.json", **sizes)
    return str(root), str(pb)
