#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. setup — build the ten CUDA kernels from the six sources in
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the card.
2. kernels — each kernel against its plain PyTorch version on the card,
   at the main path's shapes: ``fd_round_wing``/``fd_round_tip`` on the
   packed wing-60k / tip-1m partition stacks, round by round to the
   fixed point, every output compared; ``support_update`` and
   ``wedge_count`` on the wing-60k slot matrices; ``wedge_count_tile``
   on the slot matrix of tip-1m's largest wedge tile, built on the card
   from the ingested TSV.  All comparisons are ``torch.equal`` (every
   output is an exact integer).  Times each, and the one PyTorch call
   that computes the same function where there is one.
3. goldens — every cell of ``tests/goldens/peel_goldens.json``: the 72
   csr cells (fused kernels on for the device/vmapped drivers), the 8
   beindex and 24 dense cells, plus kernel-route reruns
   (``use_pallas``) of one wing and one tip graph.
4. tip-1m and 5. wing-60k — the CLI's main path (``repro_torch.launch.
   peel``: the fused device driver, then vmapped and ``--use-pallas``),
   θ and PeelStats held to the JAX package's values in
   ``tests/goldens/torch_fullsize.json``.
6. fd-drivers — from one CD per graph, Phase 2 under every FD driver
   (fused and unfused device/vmapped, and the kernel-free host driver),
   each held to the same JAX values and timed.
7. real-graphs — the ``--edges ... --emit-hierarchy`` path of the CLI:
   ``datasets/southern_women.tsv`` (wing and tip, ``--use-pallas``), the
   tip-1m graph written as a TSV (host tiled init, fused FD, hierarchy
   on the card), the tiled init of tip-1m through ``wedge_count_tile``
   (``tiled_butterfly_init(use_pallas=True)``), the 60k graph as wing
   and tip with ``--use-pallas``; then every artifact loaded back and a
   seeded batch of queries served through ``HierarchyService`` on the
   card.  Every step is held to ``tests/goldens/torch_realdata.json``
   (recorded by ``tests/goldens/record_torch_realdata.py``) and
   ``tests/goldens/real_graphs.json``.
8. engines — the dense and beindex engines and the four butterfly
   kernels at full size, held to ``tests/goldens/torch_engines.json``
   (recorded by ``tests/goldens/record_torch_engines.py``) and
   ``torch_fullsize.json``: dense-16k (16 384² adjacency) through
   ``--kind tip --engine dense``, then ``ops.vertex_butterflies``,
   ``ops.vertex_butterflies_tiled`` and ``ops.edge_wedge_matrix`` on its
   adjacency (``vertex_count``, ``vertex_count_tile``, ``matmul``), each
   held ``torch.equal`` to its plain version (for the whole-graph counts,
   the route ``core.counting`` itself takes) and to the JAX counts;
   wing-60k through ``--kind wing`` (beindex, the default) and
   ``--engine dense``; its BE-Index through ``ops.bloom_update`` round by
   round over seeded peel sets, held to the plain version and to the
   engine's own update every round.
9. lm — the dense-family LM serving path and the ``flash_attention``
   kernel: the kernel against its plain version at ChatGLM3-6B's prefill
   shape (f32 and bf16), D = 64 (GQA), D = 256 (MQA), a ragged non-causal
   and an offset case, timed beside the plain version and SDPA; ChatGLM3-6B
   at full width and depth (random weights from a ``torch.Generator``):
   ``prefill`` at b=4, s=2048 (28 kernel launches a call), its logits and
   ``forward``'s at 513 positions held to teacher-forced ``serve_step``;
   ``ContinuousBatcher`` serving 8 requests through 4 slots, then again
   with an EOS; the depth-2 model on ``numpy_params`` held to the JAX
   package's logits in ``tests/goldens/torch_lm.json`` (recorded by
   ``tests/goldens/record_torch_lm.py``); and ``python -m
   repro_torch.launch.serve --arch chatglm3_6b`` in its own process.

Launch counts are set to 0 before each main-path run and read after it.
The last lines are the ``kernels`` JSON, the card's name and power limit
as nvidia-smi prints them, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate at the full 700 W

FP32_FLOP_PER_S = 67e12      # H100 SXM FP32 CUDA-core peak (dense)
INT8_OP_PER_S = 1979e12      # H100 SXM int8 tensor-core peak (dense)

KERNEL_INFO = {
    "fd_round_wing": ("src/repro_torch/kernels/csrc/fd_round.cu",
                      "src/repro/kernels/fd_round.py:111"),
    "fd_round_tip": ("src/repro_torch/kernels/csrc/fd_round.cu",
                     "src/repro/kernels/fd_round.py:172"),
    "support_update": ("src/repro_torch/kernels/csrc/support_update.cu",
                       "src/repro/kernels/support_update.py:82"),
    "wedge_count": ("src/repro_torch/kernels/csrc/wedge_count.cu",
                    "src/repro/kernels/wedge_count.py:89"),
    "wedge_count_tile": ("src/repro_torch/kernels/csrc/wedge_count.cu",
                         "src/repro/kernels/wedge_count.py:59"),
    "bloom_update": ("src/repro_torch/kernels/csrc/bloom_update.cu",
                     "src/repro/kernels/bloom_update.py:47"),
    "vertex_count": ("src/repro_torch/kernels/csrc/butterfly_count.cu",
                     "src/repro/kernels/butterfly_count.py:54"),
    "vertex_count_tile": ("src/repro_torch/kernels/csrc/butterfly_count.cu",
                          "src/repro/kernels/butterfly_count.py:98"),
    "matmul": ("src/repro_torch/kernels/csrc/butterfly_count.cu",
               "src/repro/kernels/butterfly_count.py:149"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:65"),
}
STAT_FIELDS = ("rho_cd", "rho_fd_total", "rho_fd_max", "updates",
               "recounts", "p_effective")
INGEST_FILES = ("edges", "off_u", "off_v", "nbr_v", "eid_v")
TILE_FIELDS = ("n_tiles", "n_wedges", "n_pairs", "peak_tile_wedges")
GOLDEN_FIELDS = ("theta", "part", "ranges", "support_init") + STAT_FIELDS


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's seconds when it ends; a failure propagates."""

    seconds: dict = {}

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[smoke] phase {self.name} ...")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        Phase.seconds[self.name] = round(dt, 3)
        if exc_type is None:
            log(f"[smoke] phase {self.name}: ok in {dt:.1f} s")
        return False


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def require_equal(kernel: str, got, want, where: str) -> None:
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            err = (a.double() - b.double()).abs().max().item()
            raise AssertionError(
                f"{kernel}: output {i} differs from the plain version "
                f"{where} (max abs err {err})")


# ---------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------
def check_fd_round(name, state0, statics, step_kernel, step_plain,
                   round_bytes):
    """Iterate kernel and plain version to the fixed point from the same
    state, comparing all outputs every round; then time both over the
    whole cascade.  Returns the kernel's row of the kernels line."""
    import torch

    sk = tuple(t.clone() for t in state0)
    sp = tuple(t.clone() for t in state0)
    rounds, nbytes = 0, 0
    while bool(sk[1].any()):
        nbytes += round_bytes(sk)
        want = step_plain(*sp, *statics)
        step_kernel(*sk, *statics)
        require_equal(name, sk, want, f"at round {rounds}")
        sp = want
        rounds += 1
        if rounds > 100_000:
            raise AssertionError(f"{name}: cascade did not drain")
    require_equal(name, sk, sp, "after the last round")

    def cascade(step, functional):
        s = tuple(t.clone() for t in state0)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(rounds):
            out = step(*s, *statics)
            if functional:
                s = out
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / rounds

    ms = cascade(step_kernel, False)
    plain_ms = cascade(step_plain, True)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=nbytes / rounds
               / HBM_BYTES_PER_S * 1e3, bytes_per_call=nbytes / rounds,
               calls_checked=rounds, max_abs_err=0.0)
    log(f"[smoke]   {name}: {rounds} rounds equal to the plain version; "
        f"kernel {ms:.4f} ms/round, plain {plain_ms:.4f} ms/round, "
        f"{row['bytes_per_call'] / 1e6:.1f} MB/round -> bound "
        f"{row['bound_ms']:.4f} ms")
    return row


def check_rows_kernel(name, kernel, plain, inputs, nbytes, reps=20,
                      library=None):
    """One call of a row-parallel kernel against its plain version, then
    both timed over ``reps`` calls, and ``library`` (one PyTorch call
    computing the same function) where there is one."""
    got = kernel(*inputs)
    want = plain(*inputs)
    require_equal(name, got, want, "on the main path's slot matrix")
    ms = cuda_ms(lambda: kernel(*inputs), reps)
    plain_ms = cuda_ms(lambda: plain(*inputs), reps)
    library_ms = (None if library is None
                  else cuda_ms(lambda: library(*inputs), reps))
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bytes_per_call=nbytes, calls_checked=1, max_abs_err=0.0)
    log(f"[smoke]   {name}: equal to the plain version on "
        f"{tuple(inputs[0].shape)}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms} ms, {nbytes / 1e6:.1f} MB "
        f"-> bound {row['bound_ms']:.4f} ms")
    return row


def prepare(fullsize, name, dev, cache: dict) -> dict:
    """Graph, wedge list and one CD run of a full-size graph, built once
    and shared by the phases that need them (kernel inputs, FD drivers)."""
    if name not in cache:
        from repro_torch.core import csr, peel, peelspec
        from repro_torch.core.graph import powerlaw_bipartite

        want = fullsize[name]
        g = powerlaw_bipartite(**want["graph"])
        if cli_sha(g) != want["edges_sha256"]:
            raise AssertionError(f"{name}: the generator gave other edges "
                                 "than the JAX package's")
        wed = csr.build_wedges(g)
        stats = peelspec.PeelStats()
        spec = peel.build_peel_spec(g, want["kind"], stats, engine="csr",
                                    wed=wed, device=dev)
        part, sup_init, _, n_parts = peelspec.cd_loop(spec, want["P"], stats)
        cache[name] = dict(g=g, wed=wed, sup0=spec.sup0, part=part,
                           sup_init=sup_init, n_parts=n_parts,
                           cd_updates=stats.updates)
    return cache[name]


def phase_kernels(fullsize, realdata, dev, cache, tmp):
    import numpy as np
    import torch

    from repro_torch.core import csr, peel
    from repro_torch.core.distributed import (pack_fd_partitions_csr,
                                              pack_fd_partitions_tip_csr)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.support_update import support_update
    from repro_torch.kernels.wedge_count import wedge_count

    rows = {}
    i32, f32 = torch.int32, torch.float32

    # fd_round_wing on the wing-60k vmapped stack
    pw = prepare(fullsize, "wing-60k", dev, cache)
    g, wed = pw["g"], pw["wed"]
    part, sup_init, n_parts = pw["part"], pw["sup_init"], pw["n_parts"]
    p = pack_fd_partitions_csr(wed, part, sup_init, n_parts, bucket=True,
                               slots=True)
    st = ops.state_from_numpy(
        {k: p[k] for k in ("slot_e1", "slot_e2", "slot_valid", "mine",
                           "sup0")}, dev)
    B, R, K = st["slot_e1"].shape
    E = st["sup0"].shape[1]
    log(f"[smoke]   wing-60k stack: B={B} E={E} R={R} K={K} "
        f"({R * K / 1e6:.1f} M slots per partition)")
    state0 = (*peel._fused_state(st["mine"], st["sup0"], 3),
              st["slot_valid"].to(i32),
              torch.from_numpy(peel._w_rows(p, n_parts)).to(dev, f32))
    del p

    def wing_bytes(s):
        return 4 * (5 * B * E + B * R * K + 2 * int(s[6].sum()) + 2 * B * R)

    rows["fd_round_wing"] = check_fd_round(
        "fd_round_wing", state0, (st["slot_e1"], st["slot_e2"]),
        ops.fd_round_wing, ref.fd_round_wing_ref, wing_bytes)
    del state0, st
    torch.cuda.empty_cache()

    # support_update on the wing-60k CD slot matrix, a seeded peel mask
    rng = np.random.default_rng(0)
    slots = csr.pack_update_slots(wed)
    peeled = torch.from_numpy(rng.random(g.m) < 0.05).to(dev)
    pe = torch.cat([peeled, peeled.new_zeros((1,))])
    e1 = torch.from_numpy(slots["e1"]).to(dev)
    e2 = torch.from_numpy(slots["e2"]).to(dev)
    W_rows = torch.zeros(e1.shape[0], dtype=f32, device=dev)
    W_rows[:wed.n_pairs] = torch.from_numpy(wed.W0).to(dev, f32)
    su_in = (ops._pad2(pe[e1], 128, 128), ops._pad2(pe[e2], 128, 128),
             ops._pad2(torch.from_numpy(slots["valid"]).to(dev), 128, 128),
             ops._pad_to(W_rows, 128, 0).contiguous())
    n, K = su_in[0].shape
    del slots, e1, e2
    rows["support_update"] = check_rows_kernel(
        "support_update", support_update, ref.support_update_ref, su_in,
        4 * (5 * n * K + 2 * n))
    del su_in

    # wedge_count on the vertex-major tip slots of the same graph
    bf0 = wed.pair_butterflies0()
    tslots = csr.pack_tip_slots(wed, bf0)
    peeled_u = torch.from_numpy(rng.random(g.n_u) < 0.05).to(dev)
    pu = torch.cat([peeled_u, peeled_u.new_zeros((1,))])
    vals = torch.where(pu[torch.from_numpy(tslots["partner"]).to(dev)],
                       torch.from_numpy(tslots["bf"]).to(dev), 0)
    wc_in = (ops._pad2(vals, 128, 128),)
    n, K = wc_in[0].shape
    rows["wedge_count"] = check_rows_kernel(
        "wedge_count", wedge_count, ref.pair_wedge_counts_ref, wc_in,
        4 * n * K + 8 * n)
    del wc_in, vals
    torch.cuda.empty_cache()

    # fd_round_tip on the tip-1m vmapped stack
    pt = prepare(fullsize, "tip-1m", dev, cache)
    wed = pt["wed"]
    part, sup_init, n_parts = pt["part"], pt["sup_init"], pt["n_parts"]
    p = pack_fd_partitions_tip_csr(wed, wed.pair_butterflies0(), part,
                                   sup_init, n_parts, bucket=True,
                                   stacked=True)
    st = ops.state_from_numpy(
        {k: p[k] for k in ("st_pa", "st_pb", "st_bf", "mine", "sup0")}, dev)
    B, L = st["st_pa"].shape
    E = st["sup0"].shape[1]
    log(f"[smoke]   tip-1m stack: B={B} E={E} L={L}")
    state0 = peel._fused_state(st["mine"], st["sup0"], 2)
    rows["fd_round_tip"] = check_fd_round(
        "fd_round_tip", state0, (st["st_pa"], st["st_pb"], st["st_bf"]),
        ops.fd_round_tip, ref.fd_round_tip_ref,
        lambda s: 4 * (5 * B * E + 3 * B * L))
    del state0, st
    torch.cuda.empty_cache()

    rows["wedge_count_tile"] = check_tile_kernel(realdata, dev, tmp)
    return rows


def check_tile_kernel(realdata, dev, tmp):
    """``wedge_count_tile`` on the slot matrix of tip-1m's largest wedge
    tile (from the ingested TSV), built on the card as the tiled init
    builds it; timed beside its plain version and ``torch.sum``."""
    import torch

    from repro_torch.core import csr
    from repro_torch.data import ingest_edges
    from repro_torch.kernels import ref
    from repro_torch.kernels.wedge_count import wedge_count_tile

    want = realdata["tip-1m"]
    ig = ingest_edges(write_tsv(realdata, "tip-1m", tmp),
                      out_dir=os.path.join(tmp, "tile-check.ingest"))
    a = b = None
    for ta, tb, _, _ in csr.iter_wedge_tiles(ig, want["tile_wedges"]):
        if a is None or ta.size > a.size:
            a, b = ta, tb
    if a.size != want["tiled_init"]["peak_tile_wedges"]:
        raise AssertionError(f"tip-1m peak tile has {a.size} wedges, JAX "
                             f"{want['tiled_init']['peak_tile_wedges']}")
    lay = csr.tile_layout(a, b, ig.n_u, 512, dev)
    slots = csr.tile_slot_matrix(lay)
    n, width = lay.n_rows, slots.shape[1]
    log(f"[smoke]   tip-1m peak tile: {a.size} wedges, {n} slot rows x "
        f"{width} ({slots.shape[0]} rows after the bucket)")
    row = check_rows_kernel(
        "wedge_count_tile", lambda s: (wedge_count_tile(s, n),),
        lambda s: (ref.tile_row_counts_ref(s[:n]),), (slots,),
        4 * n * width + 4 * n,
        library=lambda s: s[:n].sum(1, dtype=torch.int32))
    del slots, lay
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------
# phase 3: the csr golden cells
# ---------------------------------------------------------------------
GOLDEN_GRAPHS = {
    "rb30": ("random_bipartite", (30, 24, 140), dict(seed=0)),
    "rb25": ("random_bipartite", (25, 20, 100), dict(seed=1)),
    "pl80": ("powerlaw_bipartite", (80, 40, 350), dict(seed=2)),
    "pl60": ("powerlaw_bipartite", (60, 50, 300), dict(seed=3)),
}


def snapshot(res) -> dict:
    import numpy as np

    s = res.stats
    out = dict(theta=np.asarray(res.theta).tolist(),
               part=np.asarray(res.part).tolist(),
               ranges=np.asarray(res.ranges).tolist(),
               support_init=np.asarray(res.support_init).tolist())
    out.update({f: int(getattr(s, f)) for f in STAT_FIELDS})
    return out


def phase_goldens(dev):
    import repro_torch.core.graph as G
    from repro_torch.core.peel import tip_decomposition, wing_decomposition

    with open(os.path.join(ROOT, "tests", "goldens",
                           "peel_goldens.json")) as f:
        goldens = json.load(f)
    graphs = {k: getattr(G, fn)(*a, **kw)
              for k, (fn, a, kw) in GOLDEN_GRAPHS.items()}

    def run(key, use_pallas=False, fused=None):
        parts = key.split(".")
        g, engine, fd = graphs[parts[1]], parts[-2], parts[-1]
        P = int(parts[2][1:])
        if fused is None:
            fused = engine == "csr" and fd != "host"
        kw = dict(P=P, engine=engine, fd_driver=fd, fused=fused,
                  use_pallas=use_pallas, device=dev)
        if parts[0] == "wing":
            res = wing_decomposition(g, **kw)
        else:
            res = tip_decomposition(g, side=parts[3], **kw)
        got = snapshot(res)
        bad = [f for f in GOLDEN_FIELDS if got[f] != goldens[key][f]]
        if bad:
            raise AssertionError(f"golden cell {key} (use_pallas="
                                 f"{use_pallas}, fused={fused}): {bad}")

    cells = sorted(k for k in goldens if "csr" in k.split("."))
    others = sorted(k for k in goldens if "csr" not in k.split("."))
    n_be = sum("beindex" in k.split(".") for k in others)
    if (len(cells), n_be, len(others) - n_be) != (72, 8, 24):
        raise AssertionError(f"expected 72 csr, 8 beindex and 24 dense "
                             f"golden cells, found {len(cells)}, {n_be} "
                             f"and {len(others) - n_be}")
    for key in cells + others:
        run(key)
    # kernel-route reruns: CD through support_update / wedge_count, and the
    # unfused vmapped wing FD with support_update inside the loop
    extra = [k for k in cells if k.split(".")[1] == "pl80"]
    for key in extra:
        run(key, use_pallas=True, fused=False)
    log(f"[smoke]   {len(cells)} csr golden cells equal field for field "
        f"(fused on for device/vmapped), and {len(others)} beindex and "
        f"dense cells; {len(extra)} pl80 cells again with use_pallas")


# ---------------------------------------------------------------------
# phases 4-5: the main path at full size
# ---------------------------------------------------------------------
def cli_peel(g, argv, dev):
    """One CLI run on ``g``.  Launch counts are zeroed just before and
    read just after.  Returns (digests, launch counts, seconds, output)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import peel as cli

    args = cli.build_parser().parse_args([*argv, "--device", dev])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.run(args, g=g)
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = out["result"]
    got = dict(theta_sha256=out["theta_sha256"],
               part_sha256=cli.sha256_int64(res.part),
               support_init_sha256=cli.sha256_int64(res.support_init),
               ranges=[int(x) for x in res.ranges],
               stats={f: int(out[f]) for f in STAT_FIELDS})
    return got, counts, dt, out


def hold(label, got, want, stats=STAT_FIELDS) -> None:
    """θ, partition, ⋈init and ranges equal to the recorded JAX run, and
    the ``stats`` fields of its PeelStats."""
    for key in ("theta_sha256", "part_sha256", "support_init_sha256",
                "ranges"):
        expect(label, key, got[key], want[key])
    expect(label, "stats", {f: got["stats"][f] for f in stats},
           {f: want["stats"][f] for f in stats})


def main_path(fullsize, name, g, flags, launches, dev):
    """One CLI run on ``g``; held to the recorded JAX values."""
    want = fullsize[name]
    got, counts, dt, _ = cli_peel(
        g, ["--kind", want["kind"], "--parts", str(want["P"]), *flags], dev)
    hold(f"{name} {flags}", got, want)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    log(f"[smoke]   {name} {' '.join(flags) or '(defaults)'}: matches the "
        f"JAX package in {dt:.1f} s; launches {counts}")
    return counts, dt


# ---------------------------------------------------------------------
# phase 8: the dense and beindex engines and the butterfly kernels
# ---------------------------------------------------------------------
# PeelStats fields that do not depend on the engine (the csr recording
# holds them for the dense and beindex runs; updates/recounts do depend)
ENGINE_FREE_STATS = ("rho_cd", "rho_fd_total", "rho_fd_max", "p_effective")


def check_compute_kernel(name, kernel, plain, inputs, ops_count, nbytes,
                         peak, reps, library=None, fp32_bound=False):
    """One call of a compute-bound kernel against its plain version, then
    kernel, plain version and ``library`` timed over ``reps`` calls.  The
    bound is the larger of ``ops_count`` at ``peak`` and ``nbytes`` at
    the memory rate; with ``fp32_bound`` the row also carries the bound at
    the FP32 CUDA-core peak this kernel's design runs at."""
    got = kernel(*inputs)
    want = plain(*inputs)
    require_equal(name, got, want, "at the main path's shapes")
    del got, want
    ms = cuda_ms(lambda: kernel(*inputs), reps)
    plain_ms = cuda_ms(lambda: plain(*inputs), reps)
    library_ms = (None if library is None
                  else cuda_ms(lambda: library(*inputs), reps))
    bound_ms = max(ops_count / peak, nbytes / HBM_BYTES_PER_S) * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by="operations",
               ops_per_call=ops_count, bytes_per_call=nbytes,
               calls_checked=1, max_abs_err=0.0)
    if fp32_bound:
        row["bound_fp32_ms"] = ops_count / FP32_FLOP_PER_S * 1e3
    log(f"[smoke]   {name}: equal to the plain version on "
        f"{[tuple(t.shape) for t in inputs]}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {library_ms} ms; "
        f"{ops_count / 1e12:.3f} T ops -> bound {bound_ms:.3f} ms"
        + (f" (FP32 {row['bound_fp32_ms']:.1f} ms)" if fp32_bound else ""))
    return row


def engines_cli(label, g, argv, engine, wants, dev, launches, seconds):
    """A CLI run of the dense or beindex engine; θ, partition, ⋈init,
    ranges and the engine-independent stats held to ``wants[0]``, every
    stat to ``wants[1]`` (the JAX run of the same engine) where given."""
    got, counts, dt, out = cli_peel(g, argv, dev)
    expect(label, "engine", out["engine"], engine)
    hold(label, got, wants[0], stats=ENGINE_FREE_STATS)
    if wants[1] is not None:
        hold(label, got, wants[1])
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    seconds[label] = {k: round(v, 3) for k, v in out["seconds"].items()}
    log(f"[smoke]   {label}: θ, partition, ⋈init, ranges and stats match "
        f"the JAX package in {dt:.1f} s ({seconds[label]}); stats "
        f"{got['stats']}")


def phase_engines(engines, fullsize, dev, launches):
    """Phase 8; returns (kernel rows, seconds)."""
    import numpy as np
    import torch

    from repro_torch.core import counting
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.butterfly_count import (matmul, vertex_count,
                                                     vertex_count_tile)
    from repro_torch.launch.peel import sha256_int64

    rows, seconds = {}, {}
    i64 = torch.int64

    # ---- dense-16k: the dense tip engine through the CLI
    want = engines["dense-16k"]
    g = powerlaw_bipartite(**want["graph"])
    expect("dense-16k", "edges sha256", sha256_int64(g.edges),
           want["edges_sha256"])
    engines_cli("dense-16k --kind tip --engine dense", g,
                ["--kind", "tip", "--side", want["side"], "--engine",
                 "dense", "--parts", str(want["P"])], "dense",
                (want["csr"], want.get("dense")), dev, launches, seconds)

    # the kernels' main path: the public ops entry points on its adjacency
    A = torch.from_numpy(g.adjacency()).to(dev)
    edges = torch.from_numpy(g.edges).to(dev, i64)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vb = ops.vertex_butterflies(A)
    vt = ops.vertex_butterflies_tiled(A, tile_rows=1024)
    M = ops.edge_wedge_matrix(A)
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    n, k = A.shape
    on_card = torch.device(dev).type == "cuda"
    expect("dense-16k ops", "launches",
           {key: counts[key] for key in ("vertex_count", "vertex_count_tile",
                                         "matmul")},
           dict(vertex_count=int(on_card),
                vertex_count_tile=-(-n // 1024) * on_card,
                matmul=2 * on_card))
    for key, v in counts.items():
        launches[key] = launches.get(key, 0) + v
    seconds["dense-16k ops (vertex_butterflies, _tiled, edge_wedge_matrix)"] \
        = round(dt, 3)
    exact_v = torch.round(vb.double()).to(i64)
    require_equal("vertex_count_tile", (vt,), (exact_v,),
                  "as ops.vertex_butterflies_tiled vs ops.vertex_butterflies")
    expect("dense-16k", "vertex butterflies sha256",
           sha256_int64(vt.cpu().numpy()), want["vertex_butterflies_sha256"])
    du = A.sum(dim=1)
    u, v = edges[:, 0], edges[:, 1]
    per_edge = M[u, v] - (du[u] - 1.0)
    del M
    require_equal("matmul", (per_edge,), (counting.edge_butterflies(A, edges),),
                  "as ops.edge_wedge_matrix vs core.counting")
    expect("dense-16k", "edge butterflies sha256",
           sha256_int64(np.rint(per_edge.cpu().numpy())),
           want["edge_butterflies_sha256"])
    log(f"[smoke]   dense-16k ops: vertex_butterflies equals _tiled (16 "
        f"strips) and edge_wedge_matrix core.counting; both counts equal the "
        f"JAX ones; {dt:.2f} s, launches {counts}")
    del vb, vt, exact_v, per_edge
    torch.cuda.empty_cache()

    # each kernel against its plain version at these shapes, timed.  The
    # plain vertex count is core.counting's dense route (no single
    # library call); W = A·Aᵀ is symmetric, so its function needs only
    # the n(n−1)/2 off-diagonal pairs: n(n−1)k operations, not 2n²k.
    rows["vertex_count"] = check_compute_kernel(
        "vertex_count", lambda a: (vertex_count(a),),
        lambda a: (ref.vertex_butterflies_ref(a),), (A,),
        float(n * (n - 1) * k), 4 * n * k + 4 * n, INT8_OP_PER_S, 3,
        fp32_bound=True)
    rows["vertex_count"]["library"] = \
        "none (no single call; the plain version is core.counting's route)"
    strip = A[:1024]
    rows["vertex_count_tile"] = check_compute_kernel(
        "vertex_count_tile", lambda s, a: (vertex_count_tile(s, a),),
        lambda s, a: (ref.vertex_count_tile_ref(s, a),), (strip, A),
        2.0 * 1024 * n * k, 4 * (1024 + n) * k + 4 * 1024, INT8_OP_PER_S, 5,
        fp32_bound=True)
    row = check_compute_kernel(
        "matmul", lambda a, b: (matmul(a, b, trans_b=True),),
        lambda a, b: (ref.matmul_ref(a, b, True),), (A, A),
        2.0 * n * n * k, 4 * (2 * n * k + n * n), FP32_FLOP_PER_S, 3,
        library=lambda a, b: (torch.matmul(a, b.T),))
    W = matmul(A, A, trans_b=True)
    row2 = check_compute_kernel(
        "matmul", lambda w, a: (matmul(w, a),),
        lambda w, a: (ref.matmul_ref(w, a),), (W, A), 2.0 * n * n * k,
        4 * (n * n + 2 * n * k), FP32_FLOP_PER_S, 3,
        library=lambda w, a: (torch.matmul(w, a),))
    row.update(ms=(row["ms"] + row2["ms"]) / 2,
               plain_ms=(row["plain_ms"] + row2["plain_ms"]) / 2,
               library_ms=(row["library_ms"] + row2["library_ms"]) / 2,
               calls_checked=2, library="torch.matmul, TF32 off")
    rows["matmul"] = row
    del A, W, strip, edges
    torch.cuda.empty_cache()

    # ---- wing-60k: the beindex (default) and dense wing engines
    wf, we = fullsize["wing-60k"], engines["wing-60k"]
    g = powerlaw_bipartite(**wf["graph"])
    for argv, engine in ((["--kind", "wing"], "beindex"),
                         (["--kind", "wing", "--engine", "dense"], "dense")):
        engines_cli(f"wing-60k {' '.join(argv)}", g,
                    [*argv, "--parts", str(wf["P"])], engine,
                    (wf, we.get(engine)), dev, launches, seconds)
    rows["bloom_update"] = check_bloom_rounds(we, g, dev, launches, seconds)
    return rows, seconds


def check_bloom_rounds(we, g, dev, launches, seconds):
    """The BE-Index of wing-60k (held to the JAX index), then
    ``ops.bloom_update`` round by round over seeded peel sets at the
    fractions 0, 1/6, 1/2 and 1 of the edges, carrying the alive pairs
    and bloom numbers; every round ``sup − loss`` and the bloom numbers
    equal the engine's own update (``core.peel._wing_update``), and the
    kernel equals its plain version on each round's inputs."""
    import numpy as np
    import torch

    from repro_torch.core import peel
    from repro_torch.core.beindex import build_beindex
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bloom_update import bloom_update

    t0 = time.perf_counter()
    be = build_beindex(g)
    seconds["wing-60k build_beindex"] = round(time.perf_counter() - t0, 3)
    got = dict(nb=be.nb, n_links=be.n_links, max_pairs=int(be.bloom_k.max()))
    got.update({f"{k}_sha256": sha_bytes(getattr(be, k))
                for k in ("bloom_k", "link_edge", "link_twin", "link_bloom")})
    expect("wing-60k", "BE-Index", got, we["index"])
    m, nb = g.m, be.nb
    p = ops.pack_blooms(be.link_edge, be.link_twin, be.link_bloom, nb)
    le, lt, valid, canon = (torch.from_numpy(p[key]).to(dev)
                            for key in ("le", "lt", "valid", "canon"))
    nb_pad, K = le.shape
    k_alive = torch.zeros(nb_pad, dtype=torch.float32, device=dev)
    k_alive[:nb] = torch.from_numpy(be.bloom_k).to(dev, torch.float32)
    alive_pair = valid
    links = [torch.from_numpy(x).to(dev) for x in
             (be.link_edge, be.link_twin, be.link_bloom)]
    eng = (torch.ones(be.n_links, dtype=torch.bool, device=dev),
           torch.from_numpy(be.bloom_k).to(dev),
           torch.from_numpy(be.edge_support(m).astype(np.int32)).to(dev))
    sup = eng[2].clone()
    perm = np.random.default_rng(0).permutation(m)
    cuts = [0, 0, m // 6, m // 2, m]   # fractions 0, 1/6, 1/2, 1
    saved = []
    ops.reset_launch_counts()
    for r in range(4):
        peeled = torch.zeros(m + 1, dtype=torch.bool, device=dev)
        peeled[torch.from_numpy(perm[cuts[r]:cuts[r + 1]]).to(dev)] = True
        saved.append((peeled, alive_pair, k_alive))
        loss, c, alive_pair = ops.bloom_update(peeled, alive_pair, k_alive,
                                               le, lt, canon)
        k_alive = k_alive - c
        sup = sup - loss.to(torch.int32)
        alive_l, k_l, sup_l, _ = peel._wing_update(
            peeled[:m], *eng, *links, max(nb, 1), m)
        eng = (alive_l, k_l, sup_l)
        require_equal("bloom_update", (sup, k_alive[:nb].to(torch.int32)),
                      (sup_l, k_l), f"(sup − loss, k) vs the engine update "
                      f"at round {r}")
    sync(dev)
    counts = ops.launch_counts()
    expect("wing-60k bloom rounds", "bloom_update launches",
           counts["bloom_update"], 4 * (torch.device(dev).type == "cuda"))
    for key, v in counts.items():
        launches[key] = launches.get(key, 0) + v
    sent = m
    lei = torch.where(le < 0, sent, le)
    lti = torch.where(lt < 0, sent, lt)

    def flags(peeled, alive, kk):
        return (ops._u8(peeled[lei]), ops._u8(peeled[lti]), ops._u8(alive),
                ops._u8(canon), kk)

    for r, state in enumerate(saved):
        inputs = flags(*state)
        require_equal("bloom_update", bloom_update(*inputs),
                      ref.bloom_update_ref(*inputs), f"at round {r}")
    nbytes = 8 * nb_pad * K + 8 * nb_pad
    row = check_rows_kernel("bloom_update", bloom_update,
                            ref.bloom_update_ref, flags(*saved[2]), nbytes,
                            reps=50)
    row.update(calls_checked=4, bound_by="bytes")
    log(f"[smoke]   wing-60k BE-Index: {nb} blooms, {be.n_links} links, "
        f"K={K}, {nb_pad} rows; 4 bloom_update rounds equal the engine "
        f"update and the plain version")
    return row


# ---------------------------------------------------------------------
# phase 7: real graphs — edge list → ingest → tiled init → peel →
# hierarchy → served queries
# ---------------------------------------------------------------------
def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sha_bytes(a) -> str:
    """sha256 of an array's raw bytes in its own dtype."""
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def sha_int64(a) -> str:
    import numpy as np

    return sha_bytes(np.asarray(a, dtype=np.int64))


def write_tsv(realdata, name, tmp) -> str:
    """A recorded graph's edge list as a KONECT-style TSV (a header, then
    1-based ``u<TAB>v`` rows), byte for byte the recorder's file."""
    import numpy as np

    from repro_torch.core.graph import powerlaw_bipartite

    path = os.path.join(tmp, f"{name}.tsv")
    if not os.path.exists(path):
        edges = powerlaw_bipartite(**realdata[name]["graph"]).edges
        with open(path, "w") as f:
            f.write("% bip unweighted\n")
            np.savetxt(f, np.asarray(edges, dtype=np.int64) + 1, fmt="%d",
                       delimiter="\t")
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    expect(name, "TSV sha256", sha, realdata[name]["tsv_sha256"])
    return path


def query_batch_inputs(n_entities, n_nodes, n, seed):
    """The recorder's seeded batch of mixed ``HierarchyService`` queries:
    op codes 0..4, entity ids (node ids for op 4) and second entity ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 5, size=n)
    a_ent = rng.integers(0, n_entities, size=n)
    a_node = rng.integers(0, n_nodes, size=n)
    b = rng.integers(0, n_entities, size=n)
    a = np.where(ops == 4, a_node, a_ent)
    return ops.astype(np.int32), a.astype(np.int32), b.astype(np.int32)


def expect(name, what, got, want) -> None:
    if got != want:
        raise AssertionError(f"{name}: {what} {got} != JAX {want}")


def check_ingest(name, want, ingest_dir) -> None:
    from repro_torch.data import load_ingested

    ig = load_ingested(ingest_dir)
    got = dict(n_u=ig.n_u, n_v=ig.n_v, m=ig.m)
    got.update({f"{k}_sha256": sha_bytes(getattr(ig, k))
                for k in INGEST_FILES})
    expect(name, "ingest", got, want["ingest"])


def check_tiled(name, want, total, ts, sup_e=None, sup_u=None) -> None:
    w = want["tiled_init"]
    got = dict(total=int(total), **{f: getattr(ts, f) for f in TILE_FIELDS})
    expect(name, "tiled init", got, {k: w[k] for k in got})
    for key, arr in (("sup_e", sup_e), ("sup_u", sup_u)):
        if arr is not None:
            expect(name, f"{key} sha256", sha_int64(arr), w[f"{key}_sha256"])


def check_hierarchy(name, want, h) -> None:
    import numpy as np

    from repro_torch.hierarchy.query import depth_and_up
    from repro_torch.hierarchy.serialize import _ARRAY_FIELDS

    depth, up = depth_and_up(np.asarray(h.parent))
    got = dict(n_nodes=h.n_nodes, n_levels=int(h.levels.size),
               arrays={f: sha_bytes(getattr(h, f)) for f in _ARRAY_FIELDS},
               pack_depth_sha256=sha_bytes(depth),
               pack_up_sha256=sha_bytes(up))
    expect(name, "hierarchy", got, want["hierarchy"])


def real_cli(realdata, name, tsv, flags, dev, tmp, launches, seconds):
    """One ``--edges ... --emit-hierarchy`` CLI run, every step held to
    the recorded JAX values.  Launch counts are zeroed just before and
    read just after.  Returns (launch counts, CLI output, artifact)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import peel as cli

    want = realdata[name]
    ingest_dir = os.path.join(tmp, f"{name}.ingest")
    art = os.path.join(tmp, f"{name}.npz")
    args = cli.build_parser().parse_args(
        ["--kind", want["kind"], "--side", want["side"], "--parts",
         str(want["P"]), "--tile-wedges", str(want["tile_wedges"]),
         "--edges", tsv, "--ingest-dir", ingest_dir, "--emit-hierarchy", art,
         "--device", dev, *flags])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.run(args)
    sync(dev)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    res, ti = out["result"], out["tiled_init"]
    check_ingest(name, want, ingest_dir)
    sup = {("sup_e" if want["kind"] == "wing" else "sup_u"): ti["sup0"]}
    check_tiled(name, want, ti["butterflies"], ti["stats"], **sup)
    got = dict(theta_sha256=out["theta_sha256"],
               part_sha256=sha_int64(res.part),
               support_init_sha256=sha_int64(res.support_init),
               ranges=[int(x) for x in res.ranges],
               stats={f: int(out[f]) for f in STAT_FIELDS})
    expect(name, "peel", got, {k: want[k] for k in got})
    check_hierarchy(name, want, out["hierarchy"])
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    seconds[name] = {k: round(v, 3) for k, v in out["seconds"].items()}
    log(f"[smoke]   {name} --edges {' '.join(flags)}: ingest, tiled init, "
        f"θ, stats and hierarchy match the JAX package in {dt:.1f} s; "
        f"seconds {seconds[name]}; launches {counts}")
    return counts, out, art


def serve_artifact(realdata, name, art, dev, seconds) -> None:
    """Load an artifact back and serve the recorded query batch on
    ``dev``; the arrays and the answers must equal the JAX package's."""
    from repro_torch.hierarchy import HierarchyService, load_hierarchy

    want = realdata[name]
    h = load_hierarchy(art)
    check_hierarchy(f"{name} (loaded)", want, h)
    for key in ("pack_depth", "pack_up"):
        expect(name, f"loaded {key}", sha_bytes(h.meta[key]),
               want["hierarchy"][f"{key}_sha256"])
    svc = HierarchyService(h, device=dev)
    q = want["queries"]
    ops, a, b = query_batch_inputs(h.n_entities, h.n_nodes, q["n"], q["seed"])
    t0 = time.perf_counter()
    ans = svc.query_batch(ops, a, b)
    dt = time.perf_counter() - t0
    expect(name, "served answers sha256", sha_int64(ans),
           q["answers_sha256"])
    seconds.setdefault(name, {})["serving"] = round(dt, 4)
    log(f"[smoke]   {name}: artifact loads back equal; {q['n']} mixed "
        f"queries served in {dt * 1e3:.1f} ms, answers equal")


def phase_real_graphs(realdata, dev, tmp, launches) -> dict:
    """Phase 7; returns the seconds of each step per run."""
    from repro_torch.core import csr
    from repro_torch.data import load_ingested
    from repro_torch.kernels import ops

    seconds: dict = {}
    arts = {}
    with open(os.path.join(ROOT, "tests", "goldens",
                           "real_graphs.json")) as f:
        sw = json.load(f)["southern_women"]
    sw_tsv = os.path.join(ROOT, "datasets", "southern_women.tsv")
    for kind, key in (("wing", "theta_wing_sha256"),
                      ("tip", "theta_tip_u_sha256")):
        name = f"southern_women-{kind}"
        _, out, arts[name] = real_cli(realdata, name, sw_tsv, ["--use-pallas"],
                                      dev, tmp, launches, seconds)
        expect(name, "θ sha256 (real_graphs.json)", out["theta_sha256"],
               sw[key])
        expect(name, "butterflies (real_graphs.json)",
               out["tiled_init"]["butterflies"], sw["total_butterflies"])

    # tip-1m from its TSV: host tiled init, fused FD, hierarchy on the card
    c, _, arts["tip-1m"] = real_cli(
        realdata, "tip-1m", write_tsv(realdata, "tip-1m", tmp), [], dev, tmp,
        launches, seconds)
    if c["fd_round_tip"] == 0:
        raise AssertionError("tip-1m --edges launched no fd_round_tip")

    # tip-1m's tiled init through wedge_count_tile, at full size
    want = realdata["tip-1m"]
    ig = load_ingested(os.path.join(tmp, "tip-1m.ingest"))
    t0 = time.perf_counter()
    for _ in csr.iter_wedge_tiles(ig, want["tile_wedges"]):
        pass
    host_tiles = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sup_e, sup_u, total, ts = csr.tiled_butterfly_init(
        ig, tile_wedges=want["tile_wedges"], use_pallas=True, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0
    c = ops.launch_counts()
    check_tiled("tip-1m tiled init (use_pallas)", want, total, ts,
                sup_e=sup_e, sup_u=sup_u)
    if c["wedge_count_tile"] != ts.n_tiles:
        raise AssertionError(f"tiled init launched wedge_count_tile "
                             f"{c['wedge_count_tile']} times for "
                             f"{ts.n_tiles} tiles")
    for k, v in c.items():
        launches[k] = launches.get(k, 0) + v
    seconds["tip-1m tiled init, use_pallas"] = dict(
        total=round(dt, 3), host_tile_generation=round(host_tiles, 3))
    log(f"[smoke]   tip-1m tiled_butterfly_init(use_pallas=True): "
        f"{ts.n_tiles} tiles through wedge_count_tile, sup_e/sup_u equal "
        f"to the JAX package in {dt:.2f} s, of which generating the tiles "
        f"on the host alone takes {host_tiles:.2f} s (peak slot matrix "
        f"{ts.peak_slot_bytes / 1e9:.2f} GB)")

    # the 60k graph through the kernel routes of the CLI
    for name, cd_kernel in (("wing-60k", "support_update"),
                            ("tip-60k", "wedge_count")):
        c, _, arts[name] = real_cli(
            realdata, name, write_tsv(realdata, name, tmp), ["--use-pallas"],
            dev, tmp, launches, seconds)
        for k in ("wedge_count_tile", cd_kernel):
            if c[k] == 0:
                raise AssertionError(f"{name} --edges --use-pallas launched "
                                     f"no {k}")

    for name, art in arts.items():
        serve_artifact(realdata, name, art, dev, seconds)
    return seconds


# ---------------------------------------------------------------------
# phase 9: the LM serving path (dense family) and the flash_attention
# kernel
# ---------------------------------------------------------------------
BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 tensor-core peak (dense)
LOGIT_ATOL = 2e-3  # f32 logits of two routes: rounding only (module docstring)
ATTN_ATOL = {"float32": 2e-3, "bfloat16": 3e-2}  # the JAX package's kernel tolerances

# (label, q shape, kv shape, causal, offset, dtype); the first is the row
# of the kernels line: ChatGLM3-6B's prefill attention, f32
LM = dict(
    arch="chatglm3_6b", batch=4, seq=2048, stride=4,
    kernel_cases=(
        ("chatglm3-6b prefill f32", (4, 32, 2048, 128), (4, 2, 2048, 128),
         True, None, "float32"),
        ("chatglm3-6b prefill bf16", (4, 32, 2048, 128), (4, 2, 2048, 128),
         True, None, "bfloat16"),
        ("D=64 GQA 32/4", (4, 32, 2048, 64), (4, 4, 2048, 64), True, None,
         "float32"),
        ("D=256 MQA 8/1", (4, 8, 2048, 256), (4, 1, 2048, 256), True, None,
         "float32"),
        ("ragged non-causal S=1500", (2, 16, 1500, 128), (2, 16, 1500, 128),
         False, None, "float32"),
        ("offset sq=128 < sk=384", (4, 32, 128, 128), (4, 2, 384, 128), True,
         None, "float32"),
    ),
    serve=dict(slots=4, requests=8, prompt=(16, 128), max_new=32, max_seq=256,
               eos_request=1, eos_index=7),
    cli=["--arch", "chatglm3_6b", "--batch", "4", "--prompt-len", "16",
         "--gen", "16"],
)


def attention_case(case, dev, gen):
    """A kernel case's inputs, drawn on ``dev`` from ``gen``."""
    import torch

    _, qs, ks, causal, offset, dt = case
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in (qs, ks, ks))
    return q, k, v, causal, offset


def attention_work(q, k, causal, offset):
    """(operations, bytes) the function needs on these inputs: two
    multiply-adds per visible (query, key) pair and head dim, q/k/v read
    and the output written once."""
    B, H, sq, D = q.shape
    KVH, sk = k.shape[1], k.shape[2]
    off = sk - sq if offset is None else offset
    if causal:
        seen = sum(max(0, min(sk, i + off + 1)) for i in range(sq))
    else:
        seen = sq * sk
    ops_count = 4.0 * B * H * D * seen
    nbytes = q.element_size() * (2 * B * H * sq * D + 2 * B * KVH * sk * D)
    return ops_count, nbytes


def defined_rows(q, k, causal, offset):
    """Query rows that see at least one key (the JAX oracle leaves the
    others NaN)."""
    import torch

    sq, sk = q.shape[2], k.shape[2]
    off = sk - sq if offset is None else offset
    rows = torch.arange(sq, device=q.device)
    return rows + off >= 0 if causal else rows >= 0


def check_attention(cases, dev, reps):
    """Each case through ``ops.flash_attention`` against its plain
    version on the same inputs, timed with the plain version and, where
    sq == sk and the mask is causal, SDPA (top-left aligned, so only
    there the same function).  Returns the kernels-line row (the first
    case) with every case's numbers under ``cases``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for case in cases:
        label, dt = case[0], case[5]
        q, k, v, causal, offset = attention_case(case, dev, gen)
        got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
        want = ref.flash_attention_ref(q, k, v, causal=causal, offset=offset)
        rows = defined_rows(q, k, causal, offset)
        err = (got[:, :, rows].float() - want[:, :, rows].float()).abs().max().item()
        if not err <= ATTN_ATOL[dt]:
            raise AssertionError(f"flash_attention {label}: max abs err {err} "
                                 f"> {ATTN_ATOL[dt]} against the plain version")
        del got, want
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                 offset=offset), reps)
        plain_ms = cuda_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, offset=offset), max(1, reps // 4))
        library_ms = None
        if causal and q.shape[2] == k.shape[2]:
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps)
        ops_count, nbytes = attention_work(q, k, causal, offset)
        fp32 = ops_count / FP32_FLOP_PER_S * 1e3
        bf16 = ops_count / BF16_FLOP_PER_S * 1e3
        mem = nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(case=label, shape_q=list(q.shape), shape_kv=list(k.shape),
                   dtype=dt, causal=causal, offset=offset, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_fp32_ms=max(fp32, mem), bound_bf16_ms=max(bf16, mem),
                   ops_per_call=ops_count, bytes_per_call=nbytes)
        log(f"[smoke]   flash_attention {label}: max abs err {err:.2e} (tol "
            f"{ATTN_ATOL[dt]}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"SDPA {library_ms} ms; {ops_count / 1e9:.1f} G ops, "
            f"{nbytes / 1e6:.1f} MB -> bound {row['bound_fp32_ms']:.3f} ms "
            f"FP32, {row['bound_bf16_ms']:.3f} ms bf16 tensor cores")
        out.append(row)
        del q, k, v
    first = out[0]
    bound = first["bound_fp32_ms" if first["dtype"] == "float32"
                  else "bound_bf16_ms"]
    return dict(ms=first["ms"], plain_ms=first["plain_ms"],
                library_ms=first["library_ms"], bound_ms=bound,
                bound_by="operations", max_abs_err=max(r["max_abs_err"]
                                                      for r in out),
                bound_fp32_ms=first["bound_fp32_ms"],
                bound_bf16_ms=first["bound_bf16_ms"],
                ops_per_call=first["ops_per_call"],
                bytes_per_call=first["bytes_per_call"],
                library="torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True, enable_gqa=True), sq == sk only",
                calls_checked=len(out), cases=out)


def close_logits(label, got, want, atol=LOGIT_ATOL) -> float:
    err = (got.double() - want.double()).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{label}: logits differ by {err} > {atol}")
    return err


def hold_golden(label, logits, want, ids) -> float:
    """``logits`` [b, len(positions), V] held to a recorded summary:
    the subset logits and logsumexp within ``LOGIT_ATOL``, the argmax
    where the recorded top-2 gap exceeds twice that."""
    import numpy as np
    import torch

    x = logits.double().cpu()
    err = close_logits(f"{label} subset", x[..., ids],
                       torch.tensor(want["subset"], dtype=torch.float64))
    lse = torch.logsumexp(x, dim=-1)
    err = max(err, close_logits(f"{label} logsumexp", lse,
                                torch.tensor(want["logsumexp"],
                                             dtype=torch.float64)))
    gap = np.asarray(want["top2_gap"])
    amax = x.argmax(dim=-1).numpy()
    sure = gap > 2 * LOGIT_ATOL
    if not np.array_equal(amax[sure], np.asarray(want["argmax"])[sure]):
        raise AssertionError(f"{label}: argmax {amax.tolist()} != JAX "
                             f"{want['argmax']} (gaps {gap.tolist()})")
    return err


def teacher_forced(model, tokens, positions, dev):
    """Logits [b, len(positions), V] of ``serve_step`` fed ``tokens`` one
    position at a time (no attention kernel on this route)."""
    import torch

    from repro_torch.models import init_cache

    b, s = tokens.shape
    cache = init_cache(model.cfg, b, s, dev, torch.float32)
    want = set(positions)
    out = []
    with torch.no_grad():
        for i in range(max(positions) + 1):
            logits, cache = model.serve_step(cache, tokens[:, i], i)
            if i in want:
                out.append(logits)
    return torch.stack(out, dim=1)


def profile_decode(model, tokens, seq, dev, steps=8) -> dict:
    """Device time of ``steps`` decode steps against a ``seq``-slot cache
    by kernel class (``torch.profiler``, CUDA activity only), beside the
    window's host-clock time; None where the profiler saw no device time
    (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache

    if torch.device(dev).type != "cuda":  # a CPU rehearsal has no kernels
        return dict(device_ms_per_step=None)
    cache = init_cache(model.cfg, tokens.shape[0], seq, dev, torch.float32)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model.serve_step(cache, tokens[:, i], i)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0:
        log("[smoke]   decode profile: the profiler saw no device time "
            "(not measured)")
        return dict(device_ms_per_step=None)
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower()) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(device_ms_per_step=device_ms / steps,
               gemm_ms_per_step=gemm_ms / steps,
               wall_ms_per_step=wall_ms / steps,
               busy_share=device_ms / wall_ms,
               top_kernels={e.key[:60]: e.self_device_time_total / 1e3 / steps
                            for e in top})
    log(f"[smoke]   decode profile ({steps} steps, cache {seq}): device "
        f"{out['device_ms_per_step']:.2f} ms/step, of it GEMM "
        f"{out['gemm_ms_per_step']:.2f}; host clock "
        f"{out['wall_ms_per_step']:.2f} ms/step under the profiler (busy "
        f"share {out['busy_share']:.3f}); top kernels ms/step "
        f"{out['top_kernels']}")
    return out


def lm_golden_phase(golden, cfg, dev) -> dict:
    """Depth-2 ChatGLM3-6B at full width on ``numpy_params``: forward and
    teacher-forced decode held to the JAX package's recorded logits."""
    import numpy as np
    import torch

    from repro_torch.models import DenseLM
    from repro_torch.models.convert import numpy_params, params_from_numpy

    t0 = time.perf_counter()
    tree = numpy_params(cfg, seed=golden["seed"])
    for path, want in golden["param_check"].items():
        node = tree
        for p in path.split("."):
            node = node[p]
        first = [float(x) for x in node.reshape(-1)[:4]]
        total = float(node.sum(dtype=np.float64))
        # the float64 sum's order may differ between numpy builds
        if first != want["first"] or abs(total - want["sum"]) > 1e-6 * (
                1 + abs(want["sum"])):
            got = dict(first=first, sum=total)
            raise AssertionError(f"numpy_params {path}: {got} != the "
                                 f"recorder's {want} (another numpy stream)")
    model = DenseLM(cfg, params_from_numpy(tree, cfg, dev))
    del tree
    gen_s = time.perf_counter() - t0
    tokens = torch.tensor(golden["tokens"], device=dev)
    pos, ids = golden["positions"], golden["ids"]
    with torch.no_grad():
        fwd = model(tokens)[:, pos]
    dec = teacher_forced(model, tokens, pos, dev)
    errs = dict(forward=hold_golden("golden forward", fwd, golden["forward"], ids),
                decode=hold_golden("golden decode", dec, golden["decode"], ids),
                forward_vs_decode=close_logits("golden forward vs decode",
                                               fwd, dec))
    log(f"[smoke]   golden (depth {cfg.n_layers}, full width): forward and "
        f"serve_step held to the JAX package's logits, max abs errs {errs}; "
        f"weights made in {gen_s:.1f} s")
    return errs


def serve_requests(cfg, params, spec, dev, vocab):
    """``ContinuousBatcher`` serving ``spec['requests']`` seeded prompts
    through ``spec['slots']`` slots; then the first batch again with an
    EOS on one request, which must stop at its first generated EOS while
    the others repeat their tokens."""
    import numpy as np

    from repro_torch.serve import ContinuousBatcher, Request

    rng = np.random.default_rng(3)
    lo, hi = spec["prompt"]
    prompts = [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(spec["requests"])]

    def run(reqs):
        eng = ContinuousBatcher(cfg, params, n_slots=spec["slots"],
                                max_seq=spec["max_seq"], device=dev)
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        done = eng.run()
        sync(dev)
        return done, time.perf_counter() - t0, eng.steps

    done, dt, steps = run([Request(uid=i, prompt=p, max_new=spec["max_new"])
                           for i, p in enumerate(prompts)])
    if [r.uid for r in done] != list(range(len(prompts))) or any(
            len(r.output) != spec["max_new"] for r in done):
        raise AssertionError(f"serving: {len(done)} of {len(prompts)} "
                             "requests completed with max_new tokens")
    e, k = spec["eos_request"], spec["eos_index"]
    eos = done[e].output[k]
    stop = done[e].output.index(eos)
    again, dt2, steps2 = run([
        Request(uid=i, prompt=prompts[i], max_new=spec["max_new"],
                eos=eos if i == e else None) for i in range(spec["slots"])])
    for r in again:
        want = done[r.uid].output[:stop + 1] if r.uid == e else done[r.uid].output
        if r.output != want:
            raise AssertionError(f"serving with EOS: request {r.uid} gave "
                                 f"{r.output}, expected {want}")
    tokens = sum(len(p) + spec["max_new"] for p in prompts)
    log(f"[smoke]   serving: {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}) through {spec['slots']} slots in "
        f"{steps} steps, {dt:.2f} s ({tokens / dt:.1f} tok/s incl. prompts); "
        f"EOS rerun of the first batch: request {e} stopped after "
        f"{stop + 1} tokens, {steps2} steps, {dt2:.2f} s")
    return dict(requests=len(prompts), steps=steps, seconds=dt,
                tokens_per_s=tokens / dt, eos_steps=steps2, eos_seconds=dt2)


def phase_lm(golden, dev, launches, cfg=None, golden_cfg=None, lm=LM,
             reps=10) -> tuple:
    """Phase 9; returns (the flash_attention row, the LM numbers)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import DenseLM, init_params

    on_card = torch.device(dev).type == "cuda"
    row = check_attention(lm["kernel_cases"], dev, reps)
    info = {}

    # ---- the full-width model: prefill and forward against the decode path
    cfg = cfg or get_config(lm["arch"])
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev, torch.float32)
    model = DenseLM(cfg, params)
    sync(dev)
    info["init_s"] = time.perf_counter() - t0
    b, s = lm["batch"], lm["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    prefill_s = []
    with torch.no_grad():
        for _ in range(2):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            last = model.prefill(tokens)
            sync(dev)
            prefill_s.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            expect("prefill", "kernel launches", counts,
                   {k: (cfg.n_layers * on_card if k == "flash_attention" else 0)
                    for k in ops.KERNELS})
            launches["flash_attention"] = (launches.get("flash_attention", 0)
                                           + counts["flash_attention"])
        pos = sorted(set(range(0, s, lm["stride"])) | {s - 1})
        fwd = model(tokens)[:, pos]
    t0 = time.perf_counter()
    dec = teacher_forced(model, tokens, pos, dev)
    sync(dev)
    decode_s = time.perf_counter() - t0
    info.update(
        prefill_s=prefill_s, prefill_tok_s=[b * s / t for t in prefill_s],
        decode_s=decode_s, decode_tok_s=b * s / decode_s,
        positions_compared=len(pos),
        prefill_vs_decode=close_logits("prefill vs teacher-forced decode",
                                       last, dec[:, -1]),
        forward_vs_decode=close_logits("forward vs teacher-forced decode",
                                       fwd, dec))
    del fwd, dec, last
    log(f"[smoke]   {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads): prefill b={b} s={s} in "
        f"{prefill_s} s ({info['prefill_tok_s']} tok/s), {cfg.n_layers} "
        f"flash_attention launches each; {s} teacher-forced decode steps in "
        f"{decode_s:.2f} s ({info['decode_tok_s']:.1f} tok/s); prefill and "
        f"forward ({len(pos)} positions) vs decode max abs err "
        f"{info['prefill_vs_decode']:.2e} / {info['forward_vs_decode']:.2e} "
        f"(atol {LOGIT_ATOL})")

    info["serve"] = serve_requests(cfg, params, lm["serve"], dev, cfg.vocab)
    info["decode_profile"] = profile_decode(model, tokens, s, dev)
    del model, params
    torch.cuda.empty_cache()

    # ---- the recorded depth-2 golden
    golden_cfg = golden_cfg or dataclasses.replace(
        get_config(golden["arch"]), n_layers=golden["n_layers"])
    info["golden"] = lm_golden_phase(golden, golden_cfg, dev)
    torch.cuda.empty_cache()

    # ---- the CLI, in its own process
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *lm["cli"],
           "--device", str(dev)]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0 or "[serve] sample:" not in proc.stdout:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    info["cli_s"] = time.perf_counter() - t0
    info["cli"] = proc.stdout.strip().splitlines()
    log(f"[smoke]   {' '.join(cmd[1:])}: exit 0 in {info['cli_s']:.1f} s: "
        f"{info['cli']}")
    return row, info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("[smoke] src/repro_torch not found beside chip_smoke.py; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_fullsize.json")) as f:
        fullsize = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_realdata.json")) as f:
        realdata = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_engines.json")) as f:
        engines = json.load(f)
    with open(os.path.join(ROOT, "tests", "goldens", "torch_lm.json")) as f:
        lm_golden = json.load(f)
    smi = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        return run_phases(fullsize, realdata, engines, lm_golden, dev, smi,
                          tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(fullsize, realdata, engines, lm_golden, dev, smi, tmp) -> int:
    import torch

    with Phase("1-setup"):
        from repro_torch.kernels import _build, ops

        t0 = time.perf_counter()
        _build.build_all()
        log(f"[smoke]   built {len(_build.SOURCES)} kernel libraries in "
            f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
        for name in _build.SOURCES:
            path = os.path.join(_build.BUILD_DIR, f"{name}.log")
            if os.path.exists(path):
                for line in open(path):
                    if "registers" in line or "spill" in line:
                        log(f"[smoke]   ptxas {name}: {line.strip()}")
        log(f"[smoke]   torch {torch.__version__} cuda {torch.version.cuda} "
            f"on {torch.cuda.get_device_name(0)} ({smi})")

    with Phase("2-kernels"):
        cache: dict = {}
        rows = phase_kernels(fullsize, realdata, dev, cache, tmp)

    with Phase("3-goldens"):
        phase_goldens(dev)

    launches: dict = {}
    with Phase("4-tip-1m"):
        g = prepare(fullsize, "tip-1m", dev, cache)["g"]
        c, _ = main_path(fullsize, "tip-1m", g, [], launches, dev)
        if c["fd_round_tip"] == 0:
            raise AssertionError("tip-1m default path launched no "
                                 "fd_round_tip")
        main_path(fullsize, "tip-1m", g, ["--fd-driver", "vmapped"],
                  launches, dev)

    with Phase("5-wing-60k"):
        g = prepare(fullsize, "wing-60k", dev, cache)["g"]
        c, _ = main_path(fullsize, "wing-60k", g, ["--engine", "csr"],
                         launches, dev)
        if c["fd_round_wing"] == 0:
            raise AssertionError("wing-60k default path launched no "
                                 "fd_round_wing")
        main_path(fullsize, "wing-60k", g,
                  ["--engine", "csr", "--fd-driver", "vmapped"], launches,
                  dev)
        c, _ = main_path(fullsize, "wing-60k", g,
                         ["--engine", "csr", "--use-pallas"], launches, dev)
        if c["support_update"] == 0:
            raise AssertionError("--use-pallas wing launched no "
                                 "support_update")
        c, _ = main_path(fullsize, "tip-60k", g, ["--use-pallas"], launches,
                         dev)
        if c["wedge_count"] == 0:
            raise AssertionError("--use-pallas tip launched no wedge_count")

    with Phase("6-fd-drivers"):
        fd_times = phase_fd_drivers(fullsize, dev, cache)
    cache.clear()

    with Phase("7-real-graphs"):
        real_seconds = phase_real_graphs(realdata, dev, tmp, launches)

    with Phase("8-engines"):
        engine_rows, engine_seconds = phase_engines(engines, fullsize, dev,
                                                    launches)
        rows.update(engine_rows)

    with Phase("9-lm"):
        rows["flash_attention"], lm_info = phase_lm(lm_golden, dev, launches)

    missing = [k for k in KERNEL_INFO if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=int(launches[name]), max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r.get("bound_by", "bytes"),
            library_ms=r.get("library_ms"),
            **{key: r[key] for key in ("bytes_per_call", "ops_per_call",
                                       "bound_fp32_ms", "bound_bf16_ms",
                                       "library")
               if key in r}))
    log(json.dumps(dict(phase_seconds=Phase.seconds, fd_driver_seconds=fd_times,
                        real_graph_seconds=real_seconds,
                        engine_seconds=engine_seconds, lm=lm_info)))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cli_sha(g) -> str:
    from repro_torch.launch.peel import sha256_int64

    return sha256_int64(g.edges)


def phase_fd_drivers(fullsize, dev, cache) -> dict:
    """Phase 2 of each full-size graph under every FD driver, from one CD
    run: θ, the FD round counts and the update count must equal the JAX
    package's; returns the FD seconds (host clock, synchronized, packing
    included) per graph and driver."""
    import numpy as np
    import torch

    from repro_torch.core import peel, peelspec
    from repro_torch.launch.peel import sha256_int64

    drivers = (("device", True), ("device", False), ("vmapped", True),
               ("vmapped", False), ("host", False))
    out = {}
    for name, kind in (("wing-60k", "wing"), ("tip-1m", "tip")):
        want = fullsize[name]
        pre = prepare(fullsize, name, dev, cache)
        times = {}
        for fd, fused in drivers:
            stats = peelspec.PeelStats()
            spec = peel.build_peel_spec(
                pre["g"], kind, stats, engine="csr", fd_driver=fd,
                fused=fused, sup0=pre["sup0"], wed=pre["wed"], device=dev)
            theta = np.zeros(spec.n, dtype=np.int64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            peelspec.run_fd(spec, pre["part"], pre["sup_init"], theta,
                            pre["n_parts"], stats, fd_driver=fd)
            torch.cuda.synchronize()
            key = f"{fd}{'+fused' if fused else ''}"
            times[key] = round(time.perf_counter() - t0, 4)
            got = (sha256_int64(theta), stats.rho_fd_total, stats.rho_fd_max,
                   pre["cd_updates"] + stats.updates)
            exp = (want["theta_sha256"], want["stats"]["rho_fd_total"],
                   want["stats"]["rho_fd_max"], want["stats"]["updates"])
            if got != exp:
                raise AssertionError(f"{name} FD driver {key}: (θ sha, "
                                     f"ρ_fd_total, ρ_fd_max, updates) {got} "
                                     f"!= JAX {exp}")
        out[name] = times
        log(f"[smoke]   {name}: every FD driver matches the JAX package; "
            f"FD seconds by driver: {times}")
    return out


if __name__ == "__main__":
    sys.exit(main())
