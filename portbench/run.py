#!/usr/bin/env python3
"""One run of one benchmark cell on the card, from the checkout's root::

    python3 portbench/run.py --workload bcl-56k.decompose --seed 7 \\
        --seconds 45 --trace 0

Prints the result as the last line of standard output (one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``, each compared
number beside its limit), and the compared numbers as the last lines of
standard error.  Exits non-zero, printing no result, where there is no
CUDA card, where the cell asks for more cards than there are, or where
anything of the JAX stack or the JAX package ``repro`` was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]

from portbench import harness  # noqa: E402

for _key, _path in harness.cache_dirs(ROOT).items():
    os.environ[_key] = _path
    os.makedirs(_path, exist_ok=True)

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
