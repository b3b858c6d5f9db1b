"""The port's CLI against the JAX package's, digest for digest.

Both CLIs print ``[peel] theta: ... sha256=<θ digest>``; at the CLI's
default graph they must print the same line for ``--kind tip`` and for
``--kind wing --engine csr`` (the port with ``--device cpu``).  Also: the
port's CLI rejects what the JAX CLI rejects, with the same text.
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(module, *flags):
    # one intra-op thread: the suite runs in parallel worker processes
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *flags], env=env,
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)


def _theta_line(out):
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[peel] theta:")]
    assert len(lines) == 1, out.stdout + out.stderr
    assert re.search(r"sha256=[0-9a-f]{64}$", lines[0]), lines[0]
    return lines[0]


@pytest.mark.parametrize("flags", [("--kind", "tip"),
                                   ("--kind", "wing", "--engine", "csr")])
def test_port_cli_prints_the_reference_digest(flags):
    ref = _cli("repro.launch.peel", *flags)
    port = _cli("repro_torch.launch.peel", *flags, "--device", "cpu")
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert _theta_line(port) == _theta_line(ref)


@pytest.mark.parametrize("flags,text", [
    (("--kind", "tip", "--engine", "beindex"), "no BE-Index tip engine"),
    (("--kind", "wing", "--engine", "csr", "--fd-driver", "host",
      "--fused-fd"), "the host driver has no device round body"),
])
def test_port_cli_rejects_like_the_reference(flags, text):
    from repro_torch.launch import peel as tcli

    with pytest.raises(SystemExit, match=text) as e:
        tcli.main([*flags, "--device", "cpu"])
    assert isinstance(e.value, tcli.LaunchError)


def test_port_cli_names_the_roadmap_item_of_unported_engines():
    from repro_torch.launch import peel as tcli

    with pytest.raises(tcli.LaunchError, match="ROADMAP queue 1, item 8"):
        tcli.main(["--kind", "wing", "--device", "cpu"])
    with pytest.raises(tcli.LaunchError, match="ROADMAP queue 1, item 9"):
        tcli.main(["--kind", "tip", "--engine", "dense", "--device", "cpu"])
