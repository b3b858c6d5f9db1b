"""The harness on the CPU at tiny sizes: every cell runs and is correct;
a new configuration and mix are new files; nothing of the JAX stack is
loaded; the control and each fault the cells can have make ``correct``
false."""
import hashlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench import harness
from portbench.control import control_checks

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
# the benchmark's cells and the query cell that the tests' copy adds
CELLS = [w["name"] for w in BENCH["workloads"]] + ["bcl-56k.query"]
SEED = 2**31 + 977


def _run(tiny_root, cell, trace=0, seed=SEED, seconds=0.3):
    root, pb = tiny_root
    return harness.run_cell(cell, seed, seconds, bool(trace), device="cpu",
                            root=root, pb=pb)


def _declared(tiny_root, cell, section):
    with open(os.path.join(tiny_root[0], "BENCHMARK.json")) as f:
        bench = json.load(f)
    return {m["name"] for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_root, cell, trace):
    out = _run(tiny_root, cell, trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    if trace:
        # the readers of device numbers find nothing to read on the CPU
        got = set(out["metrics"])
        assert got <= _declared(tiny_root, cell, "per_layer")
        assert got >= _declared(tiny_root, cell, "per_layer") - {
            "fd_round_tip_roofline", "device_idle_pct.decompose",
            "device_idle_pct.query"}
        assert {"device_ops", "idle_gaps"} <= set(out["breakdown"])
    else:
        assert set(out["metrics"]) == _declared(tiny_root, cell, "end_to_end")
        assert all(m["value"] > 0 for m in out["metrics"].values())
    json.dumps(out)


def _digest(folder):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(folder)):
        if "__pycache__" in d:
            continue
        for name in sorted(files):
            with open(os.path.join(d, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def test_new_configuration_and_mix_are_new_files(tiny_root):
    root, pb = tiny_root
    before = _digest(pb)
    cfg = {
        "name": "tiny-v", "source": "https://example.org/tiny-v",
        "generate": {"generator": "powerlaw_bipartite", "n_u": 200,
                     "n_v": 300, "m": 2500, "alpha": 0.8, "graph_seed": 3},
        "decomposition": "tip", "side": "v",
        "flags": ["--kind", "tip", "--side", "v", "--parts", "8"],
        "reduced": []}
    mix = {"mode": "query", "batch": 512, "pool_batches": 3,
           "warmup_batches": 1}
    with open(os.path.join(pb, "configs", "tiny-v.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "query-b512.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-v", "source": cfg["source"],
                             "file": "portbench/configs/tiny-v.json",
                             "reduced": [], "why": "a test"})
    for traffic in ("decompose", "query-b512"):
        bench["workloads"].append({"name": f"tiny-v.{traffic}",
                                   "config": "tiny-v", "traffic": traffic,
                                   "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for cell in ("decompose", "query"):
            if f"bcl-56k.{cell}" in m.get("workloads", ()):
                m["workloads"].append(
                    "tiny-v." + ("decompose" if cell == "decompose"
                                 else "query-b512"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    added = {os.path.join(pb, "configs", "tiny-v.json"),
             os.path.join(pb, "traffic", "query-b512.json")}
    for cell in ("tiny-v.decompose", "tiny-v.query-b512"):
        out = _run(tiny_root, cell)
        assert out["correct"] is True, out
    for path in added:
        os.unlink(path)
    assert _digest(pb) == before


def test_no_jax_and_no_jax_package_after_a_dry_run(tiny_root):
    for cell in CELLS:
        _run(tiny_root, cell, seconds=0.05)
    assert harness.forbidden_modules() == []
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "flax", "repro")
                   for n in sys.modules)


def test_import_guard_compares_whole_top_level_names(tiny_root,
                                                     monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchx", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro"]
    with pytest.raises(harness.ForbiddenImport):
        _run(tiny_root, "bcl-56k.decompose", seconds=0.05)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; "
            "import portbench.reference, portbench.graphgen; "
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)") % ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bcl-56k.decompose", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    root, pb = tiny_root
    checks = control_checks(cell, SEED, 8, root, pb)
    assert any(v > lim for _, v, lim in checks), checks
    # float32 supports are exact at these sizes: the check passes them
    assert all(v <= lim for _, v, lim in control_checks(cell, SEED, 24,
                                                        root, pb))


def _theta_altered(monkeypatch):
    from repro_torch.launch import peel

    orig = peel.run

    def run(args, g=None):
        out = orig(args, g)
        out["result"].theta[0] += 1
        return out
    monkeypatch.setattr(peel, "run", run)


def _state_unchanged(monkeypatch):
    from repro_torch.core import peelspec

    monkeypatch.setattr(peelspec, "run_fd", lambda *a, **k: None)


def _half_the_partitions(monkeypatch):
    from repro_torch.core import peelspec

    orig = peelspec.run_fd

    def run_fd(spec, part, sup_init, theta, n_parts, stats,
               fd_driver="device", **k):
        return orig(spec, part, sup_init, theta, n_parts, stats,
                    fd_driver=fd_driver, only=np.arange(n_parts // 2))
    monkeypatch.setattr(peelspec, "run_fd", run_fd)


def _answer_altered(monkeypatch):
    from repro_torch.hierarchy.serve import HierarchyService

    orig = HierarchyService._dispatch

    def dispatch(self, ops, a, b):
        out = orig(self, ops, a, b)
        out[7] += 1
        return out
    monkeypatch.setattr(HierarchyService, "_dispatch", dispatch)


def _half_the_batch(monkeypatch):
    from repro_torch.hierarchy.serve import HierarchyService

    orig = HierarchyService._dispatch

    def dispatch(self, ops, a, b):
        h = ops.size // 2
        out = np.full(ops.size, -1, dtype=np.int32)
        out[:h] = orig(self, ops[:h], a[:h], b[:h])
        return out
    monkeypatch.setattr(HierarchyService, "_dispatch", dispatch)


FAULTS = [
    ("bcl-56k.decompose", _theta_altered),
    ("bcl-56k.decompose", _state_unchanged),
    ("bcl-56k.decompose", _half_the_partitions),
    ("bcl-943.decompose", _theta_altered),
    ("bcl-943.decompose", _state_unchanged),
    ("bcl-943.decompose", _half_the_partitions),
    ("bcl-56k.query", _theta_altered),
    ("bcl-56k.query", _answer_altered),
    ("bcl-56k.query", _half_the_batch),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_makes_correct_false(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(tiny_root, cell, seconds=0.05)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
