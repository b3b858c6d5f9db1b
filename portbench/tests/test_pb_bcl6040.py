"""The ``bcl-6040`` configuration (MovieLens 1M's sizes on the dense
engine): its edges held to fixed digests, as ``test_pb_inputs.py`` holds
the other configurations'; the reader of its ``spec.pairs`` span and the
operations and bytes of its ``vertex_count`` roofline; and its mix's
check (``modes/decompose_exact.py``), which holds the supports to the
reference where theta alone is blind to float32."""
import json
import os

import numpy as np
import pytest

from portbench import graphgen, harness
from portbench.reference import reference_theta, tip
from portbench.reference.rounding import round_significand

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "bcl-6040.decompose"
SEED = 2**31 + 4099

EDGES = ((6040, 3706, 1000209, 0.6, 0),
         "5fc33fe48b8b49f012495a806cb7d43721a87223ce5a861db0cb80592a115860")
# the configuration's edges for the run seed 2**31 + 11
RUN = (6040, 3706, 1000209,
       "ed4501f6881ce0322211e09d97cdc9affd83b3b38628c90b729515962d15c510")


def test_powerlaw_edges_digest():
    args, digest = EDGES
    e = graphgen.powerlaw_edges(*args)
    assert e.shape == (args[2], 2)
    assert graphgen.edges_digest(e) == digest


def test_configuration_graph_digest():
    with open(os.path.join(PB, "configs", "bcl-6040.json")) as f:
        cfg = json.load(f)
    assert cfg["flags"][-2:] == ["--engine", "dense"]
    n_u, n_v, e = graphgen.make_graph(cfg, 2**31 + 11)
    assert (n_u, n_v, e.shape[0]) == RUN[:3]
    assert graphgen.edges_digest(e) == RUN[3]


def test_spec_pairs_s_reads_the_program(tiny_root):
    root, pb = tiny_root
    out = harness.run_cell(CELL, SEED, 0.3, True, device="cpu", root=root,
                           pb=pb)
    assert out["correct"] is True
    assert out["metrics"]["spec_pairs_s"]["value"] > 0
    # a device number: nothing to read on the CPU
    assert "vertex_count_roofline" not in out["metrics"]


def test_spec_pairs_s_reads_nothing_without_the_span():
    read = harness._reader(PB, "spec_pairs_s")
    assert read({}) is None
    assert read({"decomps": [{"seconds": {"peel": 2.0, "cd": 0.1,
                                          "fd": 0.6}}]}) is None
    assert read({"decomps": [{"seconds": {"spec.pairs": 0.25}},
                             {"seconds": {"spec.pairs": 0.75}}]}) == 0.5


def test_vertex_count_roofline_counts_the_triangle():
    import torch

    roof = harness.load_file(os.path.join(PB, "rooflines",
                                          "vertex_count.py"))
    calls = roof.Calls()
    calls.on_call(torch.zeros((10, 7)))
    calls.on_call(torch.zeros((6040, 3706)), bm=128)
    # n(n - 1)k operations; n·k int8 bytes read, 8n bytes of counts
    assert calls.totals() == (10 * 9 * 7 + 6040 * 6039 * 3706,
                              10 * 7 + 80 + 6040 * 3706 + 8 * 6040)
    assert roof.TARGET == ("repro_torch.kernels.ops", "vertex_butterflies")


@pytest.mark.parametrize("bits,bad", [(8, True), (24, False)])
def test_control_on_the_full_graph_is_blind_to_float32(bits, bad):
    """On the full graph, supports rounded to float32 give theta equal
    to the exact one: the cell's theta check alone cannot see float32
    arithmetic, and the program's tests hold exactness instead
    (``tests/test_torch_dense_exact.py``).  bfloat16 it sees."""
    from portbench.control import control_checks

    root = os.path.dirname(PB)
    (_, value, limit), = control_checks(CELL, 11, bits, root, PB)
    assert (value > limit) is bad


def _mode():
    return harness.load_file(os.path.join(PB, "modes",
                                          "decompose_exact.py"))


def test_the_cell_runs_the_exact_check():
    with open(os.path.join(os.path.dirname(PB), "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, = [w for w in bench["workloads"] if w["name"] == CELL]
    with open(os.path.join(PB, "traffic", cell["traffic"] + ".json")) as f:
        assert json.load(f)["mode"] == "decompose_exact"


@pytest.mark.parametrize("bits,join_bad", [(0, 0), (24, 7)])
def test_float32_supports_fail_the_exact_check_on_the_full_graph(
        bits, join_bad):
    """The control of the supports: the reference peel with its supports
    held in a float of ``bits`` significand bits, as one partition (its
    FD initial supports are its join-init).  float32 gives the exact
    theta and 7 join-init entries that differ (the odd counts past
    2**24): the check finds it."""
    with open(os.path.join(PB, "configs", "bcl-6040.json")) as f:
        cfg = json.load(f)
    seed = 11
    n_u, n_v, edges = graphgen.make_graph(cfg, seed)
    join = np.asarray(tip.pair_butterflies(n_u, n_v, edges).sum(axis=1),
                      dtype=np.int64).ravel()
    sup = round_significand(join, bits)
    state = dict(n_u=n_u, n_v=n_v, edges=edges,
                 thetas=[reference_theta(cfg, n_u, n_v, edges,
                                         significand_bits=bits)],
                 supports=[(sup, sup, np.zeros(n_u, dtype=np.int64))])
    ctx = harness.Context(config=cfg, traffic={}, seed=seed, seconds=0.0,
                          device="cpu")
    checks, failed = _mode().check(ctx, state, {})
    got = {name: value for name, value, _ in checks}
    assert got == {"theta_mismatch": 0, "join_init_mismatch": join_bad,
                   "support_init_mismatch": join_bad}
    assert failed == (1 if join_bad else 0)


# a dense graph of the configuration's kind that the CPU peels in a
# moment: 200 x 800, 111 402 edges, 83 users past 2**24 (33 of them odd);
# the reference peel with float32 supports gives the exact theta on it
DENSE = dict(n_u=200, n_v=800, m=120000)


@pytest.fixture
def dense_root(tiny_root):
    root, pb = tiny_root
    path = os.path.join(pb, "configs", "bcl-6040.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["generate"].update(DENSE)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, pb


def _counts_in_float32(monkeypatch):
    import torch
    from repro_torch.core import counting

    orig = counting.vertex_butterflies
    monkeypatch.setattr(counting, "vertex_butterflies", lambda *a, **k: (
        orig(*a, **k).to(torch.float32).to(torch.int64)))


def _support_init_altered(monkeypatch):
    from repro_torch.launch import peel

    orig = peel.run

    def run(*a, **k):
        out = orig(*a, **k)
        out["result"].support_init[0] += 1
        return out
    monkeypatch.setattr(peel, "run", run)


def test_exact_check_passes_the_program_past_2_24(dense_root):
    out = harness.run_cell(CELL, SEED, 0.05, False, device="cpu",
                           root=dense_root[0], pb=dense_root[1])
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"theta_mismatch", "join_init_mismatch",
                                  "support_init_mismatch"}


@pytest.mark.parametrize("fault", [_counts_in_float32,
                                   _support_init_altered],
                         ids=["counts_in_float32", "support_init_altered"])
def test_fault_past_2_24_makes_correct_false(dense_root, monkeypatch,
                                             fault):
    """Counts held in float32 past 2**24, or one support off by one,
    make ``correct`` false where theta alone does not show it."""
    fault(monkeypatch)
    out = harness.run_cell(CELL, SEED, 0.05, False, device="cpu",
                           root=dense_root[0], pb=dense_root[1])
    assert out["correct"] is False and out["failed"] > 0
    assert out["checks"]["theta_mismatch"]["value"] == 0
