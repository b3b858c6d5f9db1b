"""The port's roofline (``launch/roofline.py``) and the dry-run's counts
(``launch/hlo_analysis.py``) against the JAX package's formulas and
against counts derived by hand.

* ``model_flops_per_chip`` equals the JAX package's MODEL_FLOPS formula
  (``roofline.py``: 6·N·D to train, 2·N·D otherwise, N the active
  non-embedding parameters of JAX's own config) for every applicable
  cell of one pod.
* TinyLlama train_4k on 16×16: the counted FLOPs a chip are at least
  the model FLOPs and equal, exactly, the count derived below from the
  shapes each chip multiplies (remat ``full`` runs the forward twice;
  attention counts visible pairs, its backward a block of 512 query
  rows against every key the block's last row sees).
* The L1/L2 extrapolation equals a direct count at a third depth.
* ``collective_bytes`` of hand-made redistributions of known shape: an
  all-gather's, an all-reduce's and an all-to-all's result bytes; the
  (1, 1) mesh counts no collective byte.
* The record has JAX's keys, the H100's peaks and the named link
  assumption; the CLI writes it.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import repro.models as JM
from repro.configs import ARCHS, get_config as jget
from repro_torch.configs import get_config
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import dryrun_cell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_model_flops(arch, shape, n_dev):
    """The JAX package's MODEL_FLOPS a chip (its ``roofline_cell``, the
    lines after ``bottleneck``), on its own config."""
    cfg = jget(arch)
    info = JM.SHAPE_SETS[shape]
    n_active = cfg.active_param_count()
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_eff = max(n_active - embed, 1)
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    mult = 6 if info["kind"] == "train" else 2
    return mult * n_eff * tokens / n_dev


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_per_chip_equals_jax(arch):
    """Every applicable shape set of ``arch`` on one pod (256 chips):
    the port's ``model_flops_per_chip`` is JAX's number exactly."""
    cfg = get_config(arch)
    for shape in JM.SHAPE_SETS:
        if not JM.shape_applicable(jget(arch), shape)[0]:
            continue
        assert roofline.model_flops_per_chip(cfg, shape, 256) == \
            _jax_model_flops(arch, shape, 256), shape


def test_train_flops_equal_the_derived_count():
    """TinyLlama-1.1B train_4k on 16×16 (b 256 × 4 096: 16 rows a chip,
    65 536 tokens; heads, mlp and vocab over the 16-way ``"model"`` axis;
    its 4 KV heads whole on every chip, so each of a chip's 2 query heads
    reads its own KV head): per layer the GEMMs of the 44 040 192 matrix
    parameters run 4 times (forward, remat's recompute, the two products
    of the backward) on a sixteenth of their columns or rows; the
    unembedding ([65 536, 2 048] by a [2 048, 2 000] vocab shard) 3
    times; attention's forward 2·(D + Dv) a visible pair and head, twice;
    its backward 5 products a 512-row block over the block's keys.  The
    roofline's extrapolated count equals that sum, and is ≥ the model
    FLOPs (6·N·D)."""
    rec = roofline.roofline_cell("tinyllama_1_1b", "train_4k")
    T, L, n = 16 * 4096, 22, 16
    N = 2048 * 2048 * 2 + 2048 * 256 * 2 + 3 * 2048 * 5632
    gemm = 8 * T * N / n * L
    unembed = 3 * 2 * T * 2048 * 2000
    rows, heads = 16, 2
    fwd = 2 * rows * heads * (4096 * 4097 // 2) * 128 * 2 * L
    bwd = sum(2 * 512 * r1 * (3 * 64 + 2 * 64)
              for r1 in range(512, 4097, 512)) * rows * heads * L
    assert rec["flops_per_chip"] == pytest.approx(gemm + unembed + fwd + bwd,
                                                  rel=1e-12)
    assert rec["flops_per_chip"] >= rec["model_flops_per_chip"]
    assert rec["model_flops_per_chip"] == _jax_model_flops(
        "tinyllama_1_1b", "train_4k", 256)


@pytest.mark.parametrize("arch,shape", [("tinyllama_1_1b", "prefill_32k"),
                                        ("dbrx_132b", "decode_32k")])
def test_extrapolation_equals_a_direct_count(arch, shape):
    """Counts at 1 and 2 layers extrapolated to 3 equal the count at 3
    layers: FLOPs exactly, bytes and every collective kind to 1e-6
    (DBRX decode's bytes move by 2 304 of 9.7·10⁹: a few small ops are
    not the same at every depth)."""
    recs = {L: dryrun_cell(arch, shape, verbose=False,
                           cfg_overrides=dict(n_layers=L)) for L in (1, 2, 3)}
    for key, rel in (("flops", 1e-12), ("bytes_accessed", 1e-6)):
        got = roofline.extrapolate(recs[1][key], recs[2][key], 1, 2, 3)
        assert got == pytest.approx(recs[3][key], rel=rel), key
    for kind, b3 in recs[3]["collective_bytes"].items():
        got = roofline.extrapolate(recs[1]["collective_bytes"].get(kind, 0),
                                   recs[2]["collective_bytes"].get(kind, 0),
                                   1, 2, 3)
        assert got == pytest.approx(b3, rel=1e-6), kind


def test_collective_bytes_of_known_redistributions():
    """On a fake (2, 2) group, meta [8, 16] f32: Shard(0)→Replicate over
    ``"data"`` is an all-gather of the whole tensor (512 bytes);
    Partial→Replicate an all-reduce of it (512); Shard(0)→Shard(1) an
    all-to-all whose result is the new shard (256)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.hlo_analysis import (collective_bytes,
                                                 count_costs)
    from repro_torch.launch.mesh import fake_group, make_local_mesh
    from repro_torch.sharding import Sharding, distribute

    x = torch.empty(8, 16, device="meta")
    with fake_group(4):
        mesh = make_local_mesh(device="cpu")   # (2, 2)
        d = distribute(x, Sharding(mesh, ("data",)))
        cases = [(d, [Replicate(), Replicate()], {"all-gather": 512}),
                 (d, [Shard(1), Replicate()], {"all-to-all": 256}),
                 (DTensor.from_local(x, mesh, [Partial(), Replicate()],
                                     run_check=False),
                  [Replicate(), Replicate()], {"all-reduce": 512})]
        for src, dst, want in cases:
            with count_costs() as cost:
                src.redistribute(mesh, dst)
            assert collective_bytes(cost.trace) == want, (src.placements,
                                                          dst)


def test_one_by_one_mesh_counts_no_collective():
    """The world-1 step's shape on the (1, 1) mesh: FLOPs, no collective
    byte."""
    rec = dryrun_cell("tinyllama_1_1b", "train_4k", verbose=False,
                      mesh_shape=((1, 1), ("data", "model")), batch=1,
                      seq=64, cfg_overrides=dict(n_layers=1))
    assert rec["n_devices"] == 1 and rec["flops"] > 0
    assert rec["collective_bytes"] == {}


def _jax_record_keys() -> set:
    """The keys of the record JAX's ``roofline_cell`` returns (the
    ``return dict(...)`` that ends it), read from its source."""
    path = os.path.join(ROOT, "src", "repro", "launch", "roofline.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "roofline_cell")
    ret = fn.body[-1]
    assert isinstance(ret, ast.Return)
    keys = {k.arg for k in ret.value.keywords}
    assert {"flops_per_chip", "bottleneck", "compile_s"} <= keys
    return keys


def test_roofline_cli_record(tmp_path):
    """``python -m repro_torch.launch.roofline --arch --shape --out``:
    one record with JAX's keys, the H100 peaks (989 TFLOP/s bf16, 3.35
    TB/s) and the named link assumption; its terms are the counts over
    those rates; a skipped cell says why."""
    out = tmp_path / "r.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--arch",
         "tinyllama_1_1b", "--shape", "decode_32k", "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "[roofline] tinyllama_1_1b" in p.stdout
    (rec,) = json.loads(out.read_text())
    assert _jax_record_keys() <= set(rec)
    assert rec["peaks"] == dict(flops_per_s=989e12, hbm_bytes_per_s=3.35e12)
    assert rec["link_bw_assumed"]["bytes_per_s"] == 50e9
    assert rec["t_compute_s"] == rec["flops_per_chip"] / 989e12
    assert rec["t_memory_s"] == rec["bytes_per_chip"] / 3.35e12
    assert rec["t_collective_s"] == rec["collective_total"] / 50e9
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    skipped = roofline.roofline_cell("tinyllama_1_1b", "long_500k")
    assert skipped["status"] == "skipped" and skipped["reason"]
