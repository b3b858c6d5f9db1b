"""The port's CLI against the JAX package's, digest for digest.

Both CLIs print ``[peel] theta: ... sha256=<θ digest>``; at the CLI's
default graph they must print the same line for ``--kind tip`` and
``--kind wing`` (the beindex default) and for each explicit engine (the
port with ``--device cpu``), and on
``--edges datasets/southern_women.tsv --emit-hierarchy`` the same
ingest, tiled-init and θ lines and equal artifacts.  Also: the port's
CLI rejects what the JAX CLI rejects, with the same text.
"""
import os
import re
import subprocess
import sys

import numpy as np
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
                                   ("--kind", "wing", "--engine", "csr"),
                                   ("--kind", "wing"),
                                   ("--kind", "wing", "--engine", "dense"),
                                   ("--kind", "tip", "--engine", "dense")])
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


def test_port_cli_names_the_roadmap_item_of_unported_engines(capsys):
    """No engine is left unported: the wing default resolves to beindex
    and ``--engine dense`` runs for both kinds, where both once exited
    naming their ROADMAP item; the non-csr engines refuse the csr-only
    flags with the JAX CLI's texts."""
    from repro_torch.launch import peel as tcli

    for argv, engine in ((["--kind", "wing"], "beindex"),
                         (["--kind", "tip", "--engine", "dense"], "dense"),
                         (["--kind", "wing", "--engine", "dense"], "dense")):
        args = tcli.build_parser().parse_args(
            [*argv, "--n-u", "40", "--n-v", "30", "--m", "200",
             "--device", "cpu"])
        out = tcli.run(args)
        assert args.engine == out["engine"] == engine
        assert args.fused_fd is False and out["fd_driver"] == "host"
        assert "ROADMAP" not in capsys.readouterr().out
    for flag, text in (("--use-pallas", "pass --engine csr"),
                       ("--fused-fd", "fused csr FD round kernel"),
                       ("--fd-driver=vmapped", "single-dispatch Phase 2")):
        with pytest.raises(tcli.LaunchError, match=text):
            tcli.main(["--kind", "wing", flag, "--device", "cpu"])


DATASET = os.path.join(ROOT, "datasets", "southern_women.tsv")


@pytest.mark.parametrize("flags", [("--kind", "wing"),
                                   ("--kind", "tip", "--side", "v")])
def test_port_cli_edges_and_hierarchy_match_the_reference(tmp_path, flags):
    from repro.hierarchy import load_hierarchy as jload
    from repro_torch.hierarchy import load_hierarchy as tload
    from repro_torch.hierarchy.serialize import _ARRAY_FIELDS

    common = ("--edges", DATASET, "--tile-wedges", "64")
    ref = _cli("repro.launch.peel", *flags, *common,
               "--ingest-dir", str(tmp_path / "j.ingest"),
               "--emit-hierarchy", str(tmp_path / "j.npz"))
    port = _cli("repro_torch.launch.peel", *flags, *common, "--use-pallas",
                "--ingest-dir", str(tmp_path / "t.ingest"),
                "--emit-hierarchy", str(tmp_path / "t.npz"),
                "--device", "cpu")
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert _theta_line(port) == _theta_line(ref)
    for prefix in ("[peel] ingested", "[peel] tiled init", "[peel] graph"):
        lines = [[ln for ln in out.stdout.splitlines()
                  if ln.startswith(prefix)] for out in (port, ref)]
        assert lines[0] == lines[1] and len(lines[0]) == 1, prefix
    # the ingest caches went where they were sent, none beside the dataset
    assert os.path.exists(tmp_path / "t.ingest" / "meta.json")
    assert not os.path.exists(DATASET + ".ingest")
    t, j = tload(str(tmp_path / "t.npz")), jload(str(tmp_path / "j.npz"))
    for f in _ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    assert t.meta["stats"]["rho_cd"] == j.meta["stats"]["rho_cd"]


def test_port_cli_rejects_edges_with_dataset():
    from repro_torch.launch import peel as tcli

    with pytest.raises(tcli.LaunchError, match="exclusive graph sources"):
        tcli.main(["--edges", DATASET, "--dataset", "fr", "--device", "cpu"])
