"""Tiny sizes, for the tests' CPU copy of the benchmark, of the
configurations that came after ``tests/conftest.py``'s table.

``tests/conftest.py`` cuts every configuration of ``BENCHMARK.json`` to
the size its ``TINY_GRAPHS`` gives by name.  This file adds an entry for
each configuration that table lacks, as each tests' conftest module is
registered, so that the fixture finds every configuration's size.
It goes once the table has these entries: then the sizes have one
place again.
"""
import os

TESTS_CONFTEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "conftest.py")
# dense enough that the dense tip engine has butterflies to peel, small
# enough for a CPU test run
MORE_TINY_GRAPHS = {
    "bcl-6040": dict(n_u=300, n_v=200, m=6000),
}


def pytest_plugin_registered(plugin, manager):
    path = getattr(plugin, "__file__", None)
    if path and os.path.abspath(path) == TESTS_CONFTEST:
        for name, sizes in MORE_TINY_GRAPHS.items():
            plugin.TINY_GRAPHS.setdefault(name, sizes)
