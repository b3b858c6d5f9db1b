"""The PyTorch port's package boundary and its copy of the graph module.

* ``import repro_torch`` must not pull in JAX;
* no file of the port (nor ``chip_smoke.py``) imports ``jax`` or any
  module of the JAX package ``repro`` — the port keeps its own copies;
* ``repro_torch.core.graph`` is array-equal to ``repro.core.graph``:
  same generators on the same seeds, same CSR views.
"""
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro_torch.core import graph as tgraph

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BANNED = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s]|$)", re.M)


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.launch.peel, "
            "repro_torch.kernels.ops, repro_torch.hierarchy, "
            "repro_torch.data, repro_torch.models, repro_torch.serve, "
            "repro_torch.launch.serve, repro_torch.configs; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro'))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out == "[]", out


def test_port_sources_import_neither_jax_nor_repro():
    files = glob.glob(os.path.join(ROOT, "src", "repro_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 10, files
    bad = [f for f in files if _BANNED.search(open(f).read())]
    assert not bad, bad


def test_banned_import_pattern():
    """The scan's pattern: catches both packages, spares ``repro_torch``."""
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import csr", "import repro",
                 "  from repro import obs"):
        assert _BANNED.search(line), line
    for line in ("from repro_torch.core import csr", "import repro_torch",
                 "# the JAX package repro", "from .graph import x"):
        assert not _BANNED.search(line), line


def _assert_graph_equal(a, b):
    assert (a.n_u, a.n_v) == (b.n_u, b.n_v)
    np.testing.assert_array_equal(a.edges, b.edges)
    assert a.edges.dtype == b.edges.dtype


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_generators_match_reference(seed):
    _assert_graph_equal(tgraph.random_bipartite(40, 30, 200, seed=seed),
                        jgraph.random_bipartite(40, 30, 200, seed=seed))
    _assert_graph_equal(
        tgraph.powerlaw_bipartite(60, 50, 300, alpha=0.6, seed=seed),
        jgraph.powerlaw_bipartite(60, 50, 300, alpha=0.6, seed=seed))
    _assert_graph_equal(tgraph.powerlaw_bipartite(80, 40, 350, seed=seed),
                        jgraph.powerlaw_bipartite(80, 40, 350, seed=seed))


@pytest.mark.parametrize("name", sorted(tgraph.PAPER_PROXIES))
def test_paper_proxies_match_reference(name):
    assert tgraph.PAPER_PROXIES[name] == jgraph.PAPER_PROXIES[name]
    _assert_graph_equal(tgraph.paper_proxy_dataset(name),
                        jgraph.paper_proxy_dataset(name))


def test_graph_methods_match_reference():
    t = tgraph.powerlaw_bipartite(50, 30, 260, seed=4)
    j = jgraph.powerlaw_bipartite(50, 30, 260, seed=4)
    for a, b in zip(t.degrees(), j.degrees()):
        np.testing.assert_array_equal(a, b)
    for meth in ("csr_u", "csr_v"):
        for a, b in zip(getattr(t, meth)(), getattr(j, meth)()):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    np.testing.assert_array_equal(t.adjacency(), j.adjacency())
    _assert_graph_equal(t.transpose(), j.transpose())
    raw = np.random.default_rng(5).integers(0, 20, size=(90, 2))
    _assert_graph_equal(tgraph.BipartiteGraph.from_edges(20, 20, raw),
                        jgraph.BipartiteGraph.from_edges(20, 20, raw))
    assert (t.m, t.n) == (j.m, j.n)


def test_from_tsv_matches_reference():
    path = os.path.join(ROOT, "datasets", "southern_women.tsv")
    _assert_graph_equal(tgraph.from_tsv(path), jgraph.from_tsv(path))


def test_golden_loader_reads_peel_goldens():
    with open(os.path.join(ROOT, "tests", "goldens",
                           "peel_goldens.json")) as f:
        goldens = json.load(f)
    csr_cells = [k for k in goldens if "csr" in k.split(".")]
    assert len(csr_cells) == 72
    assert sum(k.startswith("tip.") for k in csr_cells) == 48
