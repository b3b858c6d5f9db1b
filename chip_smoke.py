#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. setup — build the ten CUDA kernels from the six sources in
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel), print each kernel's registers, shared memory and spills
   (``-Xptxas=-v``, and any warning that it serialised a kernel's
   ``wgmma`` instructions), the warpgroup MMA instructions of each
   tensor-core kernel (``cuobjdump -sass``: HGMMA in ``matmul`` and the
   bf16 and 3xTF32 ``flash_attention`` kernels, IGMMA in the int8
   vertex counts; none fails), and the card.
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
   ``tests/goldens/torch_fullsize.json``.  tip-1m's default run again
   with ``--trace`` (and ``--emit-hierarchy``): θ, stats and launch
   counts equal to the untraced run, ``cd.round`` spans == ρ_cd and
   ``fd.round`` events == ρ_fd_total, the seconds of each span category
   and the peel's seconds traced against untraced.
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
   adjacency (``vertex_count``, ``vertex_count_tile`` — int8 on the
   tensor cores, timed through the f32 interface, on pre-packed int8
   operands, the pack alone, the 16-strip tiled count, and
   ``torch._int_mm`` as a yardstick of the int8 product — and
   ``matmul``, 3xTF32 on the tensor cores, its bound beside the 3xTF32
   and exact-f32 ones), each
   held ``torch.equal`` to its plain version (for the whole-graph counts,
   the route ``core.counting`` itself takes) and to the JAX counts;
   wing-60k through ``--kind wing`` (beindex, the default) and
   ``--engine dense``; its BE-Index through ``ops.bloom_update`` round by
   round over seeded peel sets, held to the plain version and to the
   engine's own update every round.
9. lm — the dense-family LM serving path and the ``flash_attention``
   kernel: the kernel against its plain version at ChatGLM3-6B's prefill
   shape, D = 64 (GQA), D = 256 (MQA), a ragged non-causal and an offset
   case, each in bf16 (tensor cores) and f32 (3xTF32 on the tensor
   cores; its ``split_kv`` pre-pass also timed alone, and the call held
   against its 1xTF32, 3xTF32, FP32 and memory bounds), timed beside
   the plain version and SDPA; ChatGLM3-6B at full width and depth
   (random weights from a ``torch.Generator``), f32: ``prefill`` at b=4,
   s=2048 (28 kernel launches a call), its logits and ``forward``'s at
   513 positions held to teacher-forced ``serve_step``;
   ``ContinuousBatcher`` serving 8 requests through 4 slots, then again
   with an EOS; the same model in bf16 (12.5 GB): ``prefill`` at b=4,
   s=2048 timed twice (28 launches each), and at 256 positions its
   logits and ``forward``'s held to a bf16 teacher-forced decode within
   relative 3e-2; the depth-2 model on ``numpy_params`` held to the JAX
   package's logits in ``tests/goldens/torch_lm.json`` (recorded by
   ``tests/goldens/record_torch_lm.py``); and ``python -m
   repro_torch.launch.serve --arch chatglm3_6b`` in its own process.
10. stream — the streaming updater (``repro_torch.streaming``): the 60k
   graph as wing (csr, device FD driver) and as tip (the same, CD through
   ``wedge_count``, which must launch in every epoch), 4 epochs of 512
   random events each, every epoch (and the initial peel) held to a
   from-scratch re-peel and rebuild on the card — θ, partition, ⋈init,
   ranges, PeelStats and the 15 packed-forest arrays, density allclose —
   and to the JAX package's digests in ``tests/goldens/torch_stream.json``
   (recorded by ``tests/goldens/record_torch_stream.py``); tip-1m for
   ``STREAM_1M["epochs"]`` epochs of 2 048 events, θ and stats held every
   epoch, the forest at the last, each epoch's report beside the
   re-peel's seconds; then ``python -m repro_torch.launch.stream
   --dryrun`` in its own process.

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
TF32_FLOP_PER_S = 495e12     # H100 SXM TF32 tensor-core peak (dense)
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


def ptxas_resources(log_text: str) -> list:
    """(kernel, "N registers, ... spill ...") for each entry function in an
    ``nvcc -Xptxas=-v`` log.  A kernel that raises its register count with
    ``setmaxnreg`` reports the count it launches with."""
    out, fn, res = [], None, []
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn, res = line.split("'")[1], []
        elif fn and ("spill" in line or "Used" in line):
            res.append(line.split(":", 1)[-1].strip() if "Used" in line
                       else line.strip())
            if "Used" in line:
                out.append((fn, "; ".join(res)))
                fn = None
    return out


# (source, kernel name fragment, instruction): each kernel of the
# tensor-core designs and the warpgroup MMA its machine code must hold —
# HGMMA accumulates in f32 (matmul's TF32, flash_attention's bf16 and
# TF32), IGMMA in s32 (the int8 vertex counts)
TENSOR_CORE_KERNELS = (("butterfly_count", "matmul_tf32x3_kernel", "HGMMA"),
                       ("butterfly_count", "vertex_count_kernel", "IGMMA"),
                       ("flash_attention", "flash_tc_kernel", "HGMMA"),
                       ("flash_attention", "flash_tf32_kernel", "HGMMA"))


def tensor_core_sass(paths: dict) -> dict:
    """The warpgroup MMA instructions (HGMMA, IGMMA, ...) of each kernel
    in the machine code of the tensor-core sources, from ``cuobjdump
    -sass``, as {source: {kernel: {instruction: count}}}; fails if a
    kernel of ``TENSOR_CORE_KERNELS`` has none of its instruction (the
    tensor cores would go unused).  Where the toolkit has no
    ``cuobjdump`` the counts are not measured (None)."""
    import re

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for name in sorted({src for src, _, _ in TENSOR_CORE_KERNELS}):
        if not os.path.exists(tool):
            counts[name] = None
            continue
        sass = subprocess.run([tool, "-sass", paths[name]], check=True,
                              capture_output=True, text=True).stdout
        fns, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = fns.setdefault(m.group(1), {})
            elif fn is not None:
                for op in re.findall(r"\b([A-Z]*GMMA)\b", line):
                    fn[op] = fn.get(op, 0) + 1
        counts[name] = {f: c for f, c in fns.items() if c}
        for src, frag, op in TENSOR_CORE_KERNELS:
            if src != name:
                continue
            found = [f for f in fns if frag in f]
            if not found or any(fns[f].get(op, 0) == 0 for f in found):
                raise AssertionError(
                    f"{name}: no {op} instruction in the SASS of {frag} "
                    f"({ {f: fns[f] for f in found} })")
    log(f"[smoke]   warpgroup MMA instructions (cuobjdump -sass): {counts}")
    return counts


def serialized_wgmma(log_text: str) -> list:
    """ptxas's warnings that it serialised a kernel's wgmmas (C75xx): the
    kernel stays right but loses the overlap its design relies on."""
    return [line.strip() for line in log_text.splitlines()
            if "wgmma" in line and "serialized" in line]


def smem_bytes() -> dict:
    """Dynamic shared memory of the tensor-core kernels' blocks (and of
    the CUDA-core attention kernel that D 32 takes), from the constants
    the launch functions use."""
    import ctypes

    from repro_torch.kernels import _build

    mm, fa = _build.lib("butterfly_count"), _build.lib("flash_attention")
    for fn in (mm.matmul_smem_bytes, mm.vertex_count_smem_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_longlong
    fa.flash_attention_smem_bytes.restype = ctypes.c_longlong
    fa.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    out = {"matmul": int(mm.matmul_smem_bytes()),
           "vertex_count / vertex_count_tile": int(
               mm.vertex_count_smem_bytes())}
    for d in (64, 128, 256):
        out[f"flash_attention bf16 D={d}"] = int(
            fa.flash_attention_smem_bytes(d, 1))
    for d in (32, 64, 128, 256):
        out[f"flash_attention f32 D={d}"] = int(
            fa.flash_attention_smem_bytes(d, 0))
    return out


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
    """One CLI run on ``g``; held to the recorded JAX values.  Returns
    (launch counts, seconds, the CLI's stats row)."""
    want = fullsize[name]
    got, counts, dt, out = cli_peel(
        g, ["--kind", want["kind"], "--parts", str(want["P"]), *flags], dev)
    hold(f"{name} {flags}", got, want)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    log(f"[smoke]   {name} {' '.join(flags) or '(defaults)'}: matches the "
        f"JAX package in {dt:.1f} s; launches {counts}")
    return counts, dt, out


# span categories whose seconds split a traced peel run (nested: peel ⊃
# cd ⊃ cd.round, peel ⊃ fd ⊃ fd.launch); the hierarchy spans are split
# by name (hierarchy.build ⊃ hierarchy.labels, hierarchy.node_stats)
SPAN_CATS = ("peel", "cd", "cd.round", "fd", "fd.launch")


def traced_main_path(fullsize, name, g, untraced, launches, dev, tmp):
    """The CLI's default run of ``name`` again with ``--trace`` (and
    ``--emit-hierarchy``, for the ``hierarchy.*`` spans): θ and stats
    equal to the golden (so to the untraced run), the same kernel
    launches, ``cd.round`` spans == ρ_cd and ``fd.round`` events ==
    ρ_fd_total.  ``untraced`` is ``main_path``'s return for the same
    flags.  Returns the seconds of each span category, by span name
    under ``hierarchy``, and the peel's seconds traced and untraced."""
    want = fullsize[name]
    path = os.path.join(tmp, f"{name}.trace.json")
    art = os.path.join(tmp, f"{name}.traced.npz")
    got, counts, dt, out = cli_peel(
        g, ["--kind", want["kind"], "--parts", str(want["P"]), "--trace",
            path, "--emit-hierarchy", art], dev)
    hold(f"{name} --trace", got, want)
    expect(f"{name} --trace", "launches", counts, untraced[0])
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    s = out["result"].stats
    tracer = out["trace"]
    tl = out["result"].timeline
    spans = (tracer.count("cd.round", ph="X"), tracer.count("fd.round",
                                                            ph="i"))
    expect(f"{name} --trace", "(cd.round spans, fd.round events)", spans,
           (s.rho_cd, s.rho_fd_total))
    expect(f"{name} --trace", "timeline (cd, fd) rounds",
           (tl.cd_rounds, tl.fd_rounds_total()), spans)
    secs = {cat: round(sum(e["dur"] for e in tracer.spans(cat, ph="X"))
                       / 1e6, 4) for cat in SPAN_CATS}
    for e in tracer.spans("hierarchy", ph="X"):
        key = e["name"]
        secs[key] = round(secs.get(key, 0.0) + e["dur"] / 1e6, 4)
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    info = dict(span_seconds=secs, events=n_events,
                timeline=tl.summary(), seconds_traced=dt,
                peel_traced=out["seconds"]["peel"],
                peel_untraced=untraced[2]["seconds"]["peel"],
                untraced=untraced[1])
    log(f"[smoke]   {name} --trace --emit-hierarchy: matches the JAX "
        f"package and the untraced run (launches {counts}); "
        f"{n_events} trace events, cd.round {spans[0]} = rho_cd, fd.round "
        f"{spans[1]} = rho_fd_total; seconds by span category {secs}; "
        f"peel {info['peel_traced']:.3f} s traced against "
        f"{info['peel_untraced']:.3f} s untraced (whole run {dt:.1f} s "
        f"with the hierarchy, {untraced[1]:.1f} s untraced without)")
    return info


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


# (m, n, k) of the random-f32 accuracy check of matmul
MATMUL_ERR_SHAPES = ((1000, 777, 1333), (512, 512, 16384))


def matmul_random_error(dev) -> dict:
    """‖C − C₆₄‖ / ‖C₆₄‖ of ``matmul`` on seeded N(0, 1) f32 inputs, each
    layout, against an f64 product, beside the plain (full-f32)
    version's, and the kernel's worst max |C − C₆₄| / Σ_k |a||b| in units
    of 2⁻²³ (what ``tests/test_torch_cuda.py::tf32x3_bound`` allows is
    6 + 108 + ⌈K/32⌉/2 of those).  The graph products are exact; this is
    the error on general f32 data (3xTF32 drops lo·lo and rounds on the
    tensor cores)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.butterfly_count import matmul

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for m, n, k in MATMUL_ERR_SHAPES:
        for trans_b in (False, True):
            a = torch.randn((m, k), generator=gen, device=dev)
            b = torch.randn((n, k) if trans_b else (k, n), generator=gen,
                            device=dev)
            b_kn = b.double().T if trans_b else b.double()
            exact = a.double() @ b_kn
            delta = matmul(a, b, trans_b).double() - exact
            errs = [(d.norm() / exact.norm()).item() for d in (
                delta, ref.matmul_ref(a, b, trans_b).double() - exact)]
            worst = (delta.abs() / (a.double().abs() @ b_kn.abs())).max()
            out[f"{m}x{n}x{k}{' trans_b' if trans_b else ''}"] = dict(
                kernel=errs[0], plain=errs[1],
                kernel_max_vs_sum_abs_ulp23=worst.item() * 2.0 ** 23)
            del delta, exact
    log(f"[smoke]   matmul on random f32, relative error (kernel, plain "
        f"full f32): {out}")
    return out


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
    from repro_torch.kernels.butterfly_count import (matmul, pack_s8,
                                                     vertex_count,
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
    # The bound prices the f32 interface (pack included); beside it the
    # kernels on pre-packed int8 operands, the pack alone, and
    # torch._int_mm of the packed operands (the whole int8 product, a
    # yardstick only: it does not compute these functions).
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
    A8 = pack_s8(A)
    require_equal("pack_s8", (A8,), (ref.pack_s8_ref(A)[0],),
                  "as pack_s8")
    pack_ms = cuda_ms(lambda: (pack_s8(A),), 10)
    for name, kernel, plain, args, reps, int_mm in (
            ("vertex_count", vertex_count, ref.vertex_butterflies_ref,
             (A8,), 5, lambda: (torch._int_mm(A8, A8.T),)),
            ("vertex_count_tile", vertex_count_tile,
             ref.vertex_count_tile_ref, (A8[:1024], A8), 10,
             lambda: (torch._int_mm(A8[:1024], A8.T),))):
        want = plain(*(x.float() for x in args))
        require_equal(name, (kernel(*args),), (want,),
                      "on pre-packed int8 operands")
        del want
        row = rows[name]
        row.update(ms_packed=cuda_ms(lambda: (kernel(*args),), reps),
                   pack_ms=pack_ms)
        try:
            row["int_mm_ms"] = cuda_ms(int_mm, 3)
        except RuntimeError as exc:  # not on every PyTorch build
            row["int_mm_ms"] = f"not measured: {exc}"[:200]
    rows["vertex_count_tile"]["tiled_e2e_ms"] = cuda_ms(
        lambda: (ops.vertex_butterflies_tiled(A, tile_rows=1024),), 3)
    for name in ("vertex_count", "vertex_count_tile"):
        row = rows[name]
        log(f"[smoke]   {name}: f32 interface {row['ms']:.3f} ms, on "
            f"pre-packed int8 {row['ms_packed']:.3f} ms, pack_s8 alone "
            f"{row['pack_ms']:.3f} ms, torch._int_mm of the packed "
            f"operands {row['int_mm_ms']} ms"
            + (f", ops.vertex_butterflies_tiled (16 strips) "
               f"{row['tiled_e2e_ms']:.3f} ms" if "tiled_e2e_ms" in row
               else ""))
    del A8, args, int_mm
    # matmul's two products, each bound by its 2n²k operations at the
    # peak of the operands' tensor-core type: int8 for A·Aᵀ (both 0/1, as
    # vertex_count's row counts), TF32 for W·A (W's counts overflow
    # int8).  Beside them: the kernel's own work, three TF32 products
    # (it skips a lo plane of zeros, so it runs one for A·Aᵀ and two for
    # W·A), and the exact-f32 product at the FP32 CUDA-core peak.
    flops = 2.0 * n * n * k
    row = check_compute_kernel(
        "matmul", lambda a, b: (matmul(a, b, trans_b=True),),
        lambda a, b: (ref.matmul_ref(a, b, True),), (A, A),
        flops, 4 * (2 * n * k + n * n), INT8_OP_PER_S, 3,
        library=lambda a, b: (torch.matmul(a, b.T),))
    W = matmul(A, A, trans_b=True)
    row2 = check_compute_kernel(
        "matmul", lambda w, a: (matmul(w, a),),
        lambda w, a: (ref.matmul_ref(w, a),), (W, A), flops,
        4 * (n * n + 2 * n * k), TF32_FLOP_PER_S, 3,
        library=lambda w, a: (torch.matmul(w, a),))
    row.update(ms=(row["ms"] + row2["ms"]) / 2,
               plain_ms=(row["plain_ms"] + row2["plain_ms"]) / 2,
               library_ms=(row["library_ms"] + row2["library_ms"]) / 2,
               bound_ms=(row["bound_ms"] + row2["bound_ms"]) / 2,
               ms_by_product=dict(a_at=row["ms"], w_a=row2["ms"]),
               bound_by_product=dict(a_at=row["bound_ms"],
                                     w_a=row2["bound_ms"]),
               bound_3xtf32_ms=3 * flops / TF32_FLOP_PER_S * 1e3,
               bound_fp32_ms=flops / FP32_FLOP_PER_S * 1e3,
               ops_per_call=flops, calls_checked=2,
               library="torch.matmul, TF32 off")
    row["random_f32_rel_err"] = matmul_random_error(dev)
    log(f"[smoke]   matmul: {row['ms']:.3f} ms a product (A·Aᵀ "
        f"{row['ms_by_product']['a_at']:.3f}, W·A "
        f"{row['ms_by_product']['w_a']:.3f}); bound {row['bound_ms']:.2f} ms "
        f"(int8 {row['bound_by_product']['a_at']:.2f}, TF32 "
        f"{row['bound_by_product']['w_a']:.2f}), 3xTF32 "
        f"{row['bound_3xtf32_ms']:.1f} ms, exact f32 at the FP32 peak "
        f"{row['bound_fp32_ms']:.1f} ms; torch.matmul "
        f"{row['library_ms']:.3f} ms")
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
# and beside it, every output row's ‖Δ‖/‖ref‖: a row's typical value
# shrinks as it sees more keys (≈ sqrt(1/keys) on these N(0, 1) inputs),
# so the absolute tolerance alone would pass a wrong late row.  bf16
# rounds P and the output once each (2⁻⁹ relative): 1e-2 is five of those;
# f32 rounds at 2⁻²⁴.
ATTN_ROW_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}

BF16_LOGIT_RTOL = 3e-2  # bf16 logits of two routes: ‖Δ‖/‖ref‖ (issue 15's gate)

# (label, q shape, kv shape, causal, offset, dtype); the first is the row
# of the kernels line (ChatGLM3-6B's prefill attention in bf16, on the
# tensor cores), the f32 case of the same shapes beside it.  Gemma-2B's
# shape at the configs' max_seq holds the D 256 f32 route's longest P·V
# chains; the reduced presets' prefill (D 32) holds the CUDA-core kernel.
_ATTN_SHAPES = (
    ("chatglm3-6b prefill", (4, 32, 2048, 128), (4, 2, 2048, 128), True, None),
    ("D=64 GQA 32/4", (4, 32, 2048, 64), (4, 4, 2048, 64), True, None),
    ("D=256 MQA 8/1", (4, 8, 2048, 256), (4, 1, 2048, 256), True, None),
    ("gemma-2b D=256 S=4096", (1, 8, 4096, 256), (1, 1, 4096, 256), True,
     None),
    ("reduced prefill D=32", (4, 4, 128, 32), (4, 2, 128, 32), True, None),
    ("ragged non-causal S=1500", (2, 16, 1500, 128), (2, 16, 1500, 128),
     False, None),
    ("offset sq=128 < sk=384", (4, 32, 128, 128), (4, 2, 384, 128), True,
     None),
)
LM = dict(
    arch="chatglm3_6b", batch=4, seq=2048, stride=4, bf16_check_seq=256,
    kernel_cases=tuple((f"{label} {tag}", qs, ks, causal, offset, dt)
                       for label, qs, ks, causal, offset in _ATTN_SHAPES
                       for tag, dt in (("bf16", "bfloat16"),
                                       ("f32", "float32"))),
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
    there the same function).  An f32 case (3xTF32 on the tensor cores)
    also times its ``split_kv`` pre-pass alone and carries the bounds of
    one and of three TF32 products, of the FP32 CUDA cores and of memory.
    Returns the kernels-line row (the first case) with every case's
    numbers under ``cases``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for case in cases:
        label, dt = case[0], case[5]
        q, k, v, causal, offset = attention_case(case, dev, gen)
        got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
        want = ref.flash_attention_ref(q, k, v, causal=causal, offset=offset)
        rows = defined_rows(q, k, causal, offset)
        delta = got[:, :, rows].float() - want[:, :, rows].float()
        err = delta.abs().max().item()
        row_err = (delta.norm(dim=-1)
                   / want[:, :, rows].float().norm(dim=-1)).max().item()
        if not (err <= ATTN_ATOL[dt] and row_err <= ATTN_ROW_RTOL[dt]):
            raise AssertionError(
                f"flash_attention {label}: max abs err {err} (limit "
                f"{ATTN_ATOL[dt]}), worst row's relative err {row_err} "
                f"(limit {ATTN_ROW_RTOL[dt]}) against the plain version")
        del got, want, delta
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
        tf32 = ops_count / TF32_FLOP_PER_S * 1e3
        mem = nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(case=label, shape_q=list(q.shape), shape_kv=list(k.shape),
                   dtype=dt, route=(fa.route(q.dtype, q.shape[-1])
                                    if q.is_cuda else "plain version"),
                   causal=causal, offset=offset, max_abs_err=err,
                   row_rel_err=row_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_fp32_ms=max(fp32, mem), bound_bf16_ms=max(bf16, mem),
                   bound_hbm_ms=mem, ops_per_call=ops_count, bytes_per_call=nbytes)
        if row["route"] == fa.ROUTES[2]:
            # the split pass: k and v read once, their four planes written
            split_ms = cuda_ms(lambda: fa.split_kv(k, v), reps)
            row.update(bound_1xtf32_ms=max(tf32, mem),
                       bound_3xtf32_ms=max(3 * tf32, mem), split_ms=split_ms,
                       split_bytes=3 * 2 * k.numel() * k.element_size())
        log(f"[smoke]   flash_attention {label} ({row['route']}): max abs err "
            f"{err:.2e} (tol {ATTN_ATOL[dt]}), worst row {row_err:.2e} "
            f"relative (tol {ATTN_ROW_RTOL[dt]}); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, SDPA {library_ms} ms; {ops_count / 1e9:.1f} "
            f"G ops, {nbytes / 1e6:.1f} MB -> bound {row['bound_fp32_ms']:.3f} "
            f"ms FP32, {row['bound_bf16_ms']:.3f} ms bf16 tensor cores, "
            f"{mem:.3f} ms memory"
            + (f"; 1xTF32 {row['bound_1xtf32_ms']:.3f} ms, 3xTF32 "
               f"{row['bound_3xtf32_ms']:.3f} ms; split_kv {split_ms:.4f} ms "
               f"({row['split_bytes'] / 1e6:.1f} MB)"
               if "split_ms" in row else ""))
        out.append(row)
        del q, k, v
    first = out[0]
    bound = _design_bound(first)
    # the first case's shapes in each dtype (bf16 and 3xTF32 on the tensor
    # cores), each with the bound of its design, and the rest beside it
    by_dtype = {r["dtype"]: dict(
        ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
        max_abs_err=r["max_abs_err"], row_rel_err=r["row_rel_err"],
        route=r["route"], bound_ms=_design_bound(r),
        **{k: r[k] for k in ("bound_1xtf32_ms", "bound_3xtf32_ms",
                             "bound_fp32_ms", "bound_bf16_ms", "bound_hbm_ms",
                             "split_ms", "split_bytes") if k in r})
        for r in out if (r["shape_q"], r["shape_kv"], r["causal"],
                         r["offset"]) == (first["shape_q"],
                                          first["shape_kv"],
                                          first["causal"], first["offset"])}
    return dict(ms=first["ms"], plain_ms=first["plain_ms"], by_dtype=by_dtype,
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


def _design_bound(row) -> float:
    """The bound of the units an attention case runs on, by its route:
    three TF32 products for the f32 tensor-core kernel, the bf16 tensor
    cores for the bf16 one, the FP32 CUDA cores for D 32 in either
    dtype."""
    return row[{"3xtf32 tensor cores": "bound_3xtf32_ms",
                "bf16 tensor cores": "bound_bf16_ms"}.get(row["route"],
                                                          "bound_fp32_ms")]


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


def teacher_forced(model, tokens, positions, dev, dtype=None):
    """Logits [b, len(positions), V] of ``serve_step`` fed ``tokens`` one
    position at a time (no attention kernel on this route), with a cache
    of ``dtype`` (default f32)."""
    import torch

    from repro_torch.models import init_cache

    b, s = tokens.shape
    cache = init_cache(model.cfg, b, s, dev, dtype or torch.float32)
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


def bf16_model(cfg, lm, dev, launches) -> dict:
    """``cfg`` at full width in bf16 (random weights from a seeded
    ``torch.Generator``): prefill at (batch, seq) twice, timed, with one
    ``flash_attention`` launch a layer; then at ``bf16_check_seq``
    positions the forward's logits (every position) and the prefill's
    (the last) held to a bf16 teacher-forced decode of the same tokens
    (plain decode attention, bf16 cache) within ``BF16_LOGIT_RTOL``,
    relative in the 2-norm."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import DenseLM, init_params

    on_card = torch.device(dev).type == "cuda"
    want = {k: (cfg.n_layers * on_card if k == "flash_attention" else 0)
            for k in ops.KERNELS}

    def counted(label, fn):
        ops.reset_launch_counts()
        out = fn()
        sync(dev)
        counts = ops.launch_counts()
        expect(label, "kernel launches", counts, want)
        launches["flash_attention"] = (launches.get("flash_attention", 0)
                                       + counts["flash_attention"])
        return out

    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.bfloat16))
    sync(dev)
    info = dict(init_s=time.perf_counter() - t0, weights_gb=sum(
        p.numel() * p.element_size() for p in model.parameters()) / 1e9)
    b, s = lm["batch"], lm["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    prefill_s = []
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            counted("bf16 prefill", lambda: model.prefill(tokens))
            prefill_s.append(time.perf_counter() - t0)
        n = min(lm["bf16_check_seq"], s)
        ids = tokens[:, :n].contiguous()
        fwd = counted("bf16 forward", lambda: model(ids)).float()
        last = counted("bf16 prefill (check)",
                       lambda: model.prefill(ids)).float()
    t0 = time.perf_counter()
    dec = teacher_forced(model, ids, list(range(n)), dev,
                         torch.bfloat16).float()
    sync(dev)
    decode_s = time.perf_counter() - t0

    def rel(label, got, ref):
        err = ((got - ref).norm() / ref.norm()).item()
        if not err <= BF16_LOGIT_RTOL:
            raise AssertionError(f"{label}: relative logit error {err} > "
                                 f"{BF16_LOGIT_RTOL}")
        return err

    info.update(
        prefill_s=prefill_s, prefill_tok_s=[b * s / t for t in prefill_s],
        check_positions=n, decode_s=decode_s,
        forward_vs_decode_rel=rel("bf16 forward vs teacher-forced decode",
                                  fwd, dec),
        prefill_vs_decode_rel=rel("bf16 prefill vs teacher-forced decode",
                                  last, dec[:, -1]))
    log(f"[smoke]   {cfg.name} bf16 ({info['weights_gb']:.2f} GB): prefill "
        f"b={b} s={s} in {prefill_s} s ({info['prefill_tok_s']} tok/s), "
        f"{cfg.n_layers} flash_attention launches each; at {n} positions "
        f"forward / prefill vs bf16 teacher-forced decode ({decode_s:.1f} s) "
        f"relative error {info['forward_vs_decode_rel']:.3e} / "
        f"{info['prefill_vs_decode_rel']:.3e} (rtol {BF16_LOGIT_RTOL})")
    del model
    return info


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

    # ---- the same architecture in bf16: prefill on the tensor-core kernel
    info["bf16"] = bf16_model(cfg, lm, dev, launches)
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
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_stream.json")) as f:
        streams = json.load(f)
    smi = nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        return run_phases(fullsize, realdata, engines, lm_golden, streams, dev,
                          smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(fullsize, realdata, engines, lm_golden, streams, dev, smi,
               tmp) -> int:
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
                with open(path) as f:
                    text = f.read()
                for fn, res in ptxas_resources(text):
                    log(f"[smoke]   ptxas {name}: {fn}: {res}")
                for line in serialized_wgmma(text):
                    log(f"[smoke]   ptxas {name} WARNING: {line}")
        gmma = tensor_core_sass(_build.build_all())
        log(f"[smoke]   dynamic shared memory a block: {smem_bytes()}")
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
        base = main_path(fullsize, "tip-1m", g, [], launches, dev)
        if base[0]["fd_round_tip"] == 0:
            raise AssertionError("tip-1m default path launched no "
                                 "fd_round_tip")
        main_path(fullsize, "tip-1m", g, ["--fd-driver", "vmapped"],
                  launches, dev)
        trace_info = traced_main_path(fullsize, "tip-1m", g, base, launches,
                                      dev, tmp)

    with Phase("5-wing-60k"):
        g = prepare(fullsize, "wing-60k", dev, cache)["g"]
        c, _, _ = main_path(fullsize, "wing-60k", g, ["--engine", "csr"],
                            launches, dev)
        if c["fd_round_wing"] == 0:
            raise AssertionError("wing-60k default path launched no "
                                 "fd_round_wing")
        main_path(fullsize, "wing-60k", g,
                  ["--engine", "csr", "--fd-driver", "vmapped"], launches,
                  dev)
        c, _, _ = main_path(fullsize, "wing-60k", g,
                            ["--engine", "csr", "--use-pallas"], launches,
                            dev)
        if c["support_update"] == 0:
            raise AssertionError("--use-pallas wing launched no "
                                 "support_update")
        c, _, _ = main_path(fullsize, "tip-60k", g, ["--use-pallas"],
                            launches, dev)
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

    with Phase("10-stream"):
        stream_info = phase_stream(streams, fullsize, dev, launches)

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
                                       "by_dtype", "ms_by_product",
                                       "bound_by_product", "bound_3xtf32_ms",
                                       "random_f32_rel_err", "library",
                                       "ms_packed", "pack_ms", "int_mm_ms",
                                       "tiled_e2e_ms")
               if key in r}))
    log(json.dumps(dict(phase_seconds=Phase.seconds, gmma=gmma,
                        fd_driver_seconds=fd_times,
                        real_graph_seconds=real_seconds,
                        engine_seconds=engine_seconds, lm=lm_info,
                        traced_tip_1m=trace_info, stream=stream_info)))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------
# phase 10: the streaming updater
# ---------------------------------------------------------------------
# the packed-forest arrays an incremental epoch must reproduce
FOREST_FIELDS = ("node_level", "parent", "entity_node", "member_off",
                 "member_ids", "child_off", "child_ids", "tin", "tout",
                 "ent_order", "estart", "eend", "node_m", "node_nu",
                 "node_nv")
# tip-1m's stream: epochs, events an epoch, seed of epoch 0's events (one
# epoch: an initial peel, an epoch and their re-peels take ~160 s)
STREAM_1M = dict(epochs=1, batch=2048, event_seed=2000)


def sha16(a) -> str:
    """The stream goldens' digest: sha256 of the int64 bytes, 16 hex."""
    return sha_int64(a)[:16]


def forest_sha(h) -> str:
    """The stream goldens' forest digest (every packed-forest array)."""
    import numpy as np

    hsh = hashlib.sha256()
    for f in FOREST_FIELDS:
        hsh.update(f.encode())
        hsh.update(np.ascontiguousarray(getattr(h, f)).astype(
            np.int64, copy=False).tobytes())
    return hsh.hexdigest()[:16]


def stream_record(st, rep) -> dict:
    """One epoch's digests, in the format of ``torch_stream.json``."""
    return dict(
        epoch=rep.epoch, net=[rep.n_inserts, rep.n_deletes], m=int(st.g.m),
        theta_sha=sha16(st.result.theta), part_sha=sha16(st.result.part),
        sup_init_sha=sha16(st.result.support_init),
        stats=st.result.stats.as_dict(), forest_sha=forest_sha(st.hierarchy),
        partitions_dirty=rep.partitions_dirty, levels_dirty=rep.levels_dirty)


def scratch_peel(g, cfg, dev):
    """The from-scratch re-peel of the materialized graph that a stream
    epoch is held to: the same engine, FD driver and kernel route."""
    from repro_torch.core.peel import tip_decomposition, wing_decomposition

    kw = dict(P=cfg.P, engine=cfg.engine, fd_driver=cfg.fd_driver,
              use_pallas=cfg.use_pallas, device=dev)
    if cfg.kind == "wing":
        return wing_decomposition(g, **kw)
    return tip_decomposition(g, side=cfg.side, **kw)


def hold_scratch(label, st, ref, h_ref=None) -> None:
    """θ, partition, ⋈init, ranges and the PeelStats row equal to the
    re-peel; with ``h_ref`` every forest array too (density allclose)."""
    import numpy as np

    res = st.result
    for f in ("theta", "part", "support_init", "ranges"):
        if not np.array_equal(getattr(res, f), getattr(ref, f)):
            raise AssertionError(f"{label}: {f} differs from the "
                                 "from-scratch re-peel")
    expect(label, "stats", res.stats.as_dict(), ref.stats.as_dict())
    if h_ref is not None:
        h = st.hierarchy
        bad = [f for f in FOREST_FIELDS
               if not np.array_equal(getattr(h, f), getattr(h_ref, f))]
        if bad or not np.allclose(h.density, h_ref.density):
            raise AssertionError(f"{label}: forest fields {bad} (or "
                                 "density) differ from the rebuild")


def span_ms(fn):
    """Run ``fn()`` with the obs layer on; returns (its result, the
    milliseconds of its spans by name, ``fd.partition[i]`` summed as
    ``fd.launch``)."""
    from repro_torch import obs

    tracer = obs.enable()
    try:
        res = fn()
    finally:
        obs.disable()
    ms: dict = {}
    for e in tracer.spans(ph="X"):
        key = "fd.launch" if e["cat"] == "fd.launch" else e["name"]
        ms[key] = round(ms.get(key, 0.0) + e["dur"] / 1e3, 1)
    return res, ms


def stream_case(label, g, cfg, epochs, batch, event_seed, dev, launches,
                want=None, kernel=None, forest_every=True) -> dict:
    """A stream of ``epochs`` micro-epochs of ``batch`` random events on
    ``g``.  Launch counts are zeroed before each epoch and read after it;
    every epoch (and, with ``forest_every``, the initial peel) is held to
    a from-scratch re-peel on the card, its forest too where
    ``forest_every`` or at the last epoch, and to the JAX package's
    digests ``want``; ``kernel`` must launch in every epoch.  The stream's
    own epochs run with the obs layer on (a few spans an epoch; no FD
    rings, since the stream installs no timeline collector), the
    re-peels with it off.  Returns the seconds, the per-epoch reports and
    their span milliseconds."""
    from repro_torch.hierarchy import build_hierarchy
    from repro_torch.kernels import ops
    from repro_torch.streaming import StreamState, make_random_events

    def rebuild(st, ref):
        return build_hierarchy(st.g, ref, kind=cfg.kind, side=cfg.side,
                               device=dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st, ms = span_ms(lambda: StreamState.initial(g, cfg, device=dev))
    sync(dev)
    out = dict(initial_s=round(time.perf_counter() - t0, 3), initial_ms=ms,
               epochs=[])
    counts = ops.launch_counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    if forest_every:
        ref = scratch_peel(st.g, cfg, dev)
        hold_scratch(f"{label} initial", st, ref, rebuild(st, ref))
    log(f"[smoke]   {label} stream initial peel + forest in "
        f"{out['initial_s']:.2f} s ({st.hierarchy.n_nodes} nodes, "
        f"{int(st.hierarchy.levels.size)} levels); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for e in range(epochs):
        events = make_random_events(st.g, batch, seed=event_seed + e)
        ops.reset_launch_counts()
        rep, ms = span_ms(lambda: st.apply_epoch(events))
        sync(dev)
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if kernel is not None and counts[kernel] == 0:
            raise AssertionError(f"{label} epoch {rep.epoch} launched no "
                                 f"{kernel}")
        t1 = time.perf_counter()
        ref = scratch_peel(st.g, cfg, dev)
        sync(dev)
        scratch_s = time.perf_counter() - t1
        forest = forest_every or e == epochs - 1
        hold_scratch(f"{label} epoch {rep.epoch}", st, ref,
                     rebuild(st, ref) if forest else None)
        if want is not None:
            expect(label, f"epoch {rep.epoch} digests", stream_record(st, rep),
                   want[e])
        row = dict(rep.as_dict(), scratch_peel_s=round(scratch_s, 3),
                   forest_held=forest, span_ms=ms,
                   launches={k: v for k, v in counts.items() if v})
        out["epochs"].append(row)
        log(f"[smoke]   {label} epoch {rep.epoch}: net +{rep.n_inserts}/"
            f"-{rep.n_deletes}, dirty {rep.partitions_dirty}/{rep.p_eff} "
            f"partitions, {rep.levels_dirty}/{rep.levels_total} levels; "
            f"repair {rep.repair_ms:.1f} ms, epoch {rep.epoch_ms:.1f} ms, "
            f"scratch re-peel {scratch_s * 1e3:.1f} ms; equal to the "
            f"re-peel (θ, stats{', forest' if forest else ''})"
            f"{' and the JAX digests' if want is not None else ''}; "
            f"launches {row['launches']}; span ms {ms}")
    return out


def stream_dryrun(dev) -> float:
    """``python -m repro_torch.launch.stream --dryrun`` in its own
    process; returns its seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", "--dryrun",
         "--device", dev], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    dt = time.perf_counter() - t0
    if (out.returncode != 0 or "incremental maintenance = from-scratch"
            not in out.stdout):
        raise AssertionError(f"launch.stream --dryrun failed "
                             f"(rc {out.returncode}): {out.stdout[-2000:]}"
                             f"{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        log(f"[smoke]   {line}")
    return round(dt, 3)


def phase_stream(streams, fullsize, dev, launches) -> dict:
    """The streaming updater on the card: the 60k graph as wing and as
    tip (``wedge_count`` in every epoch), each epoch held to a re-peel
    and to ``torch_stream.json``; tip-1m; then ``--dryrun``."""
    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.streaming import StreamConfig

    info = {}
    g = powerlaw_bipartite(**streams["graph"])
    expect("stream 60k", "edges sha256", cli_sha(g),
           fullsize["wing-60k"]["edges_sha256"])
    for name, conf in streams["config"].items():
        cfg = StreamConfig(kind=conf["kind"], engine="csr", P=streams["P"],
                           fd_driver="device", use_pallas=conf["use_pallas"])
        info[name] = stream_case(
            name, g, cfg, streams["epochs"], streams["batch"],
            streams["event_seed"], dev, launches,
            want=streams["cases"][name],
            kernel="wedge_count" if cfg.kind == "tip" else None)
    want = fullsize["tip-1m"]
    g = powerlaw_bipartite(**want["graph"])
    cfg = StreamConfig(kind="tip", engine="csr", P=want["P"],
                       fd_driver="device")
    info["tip-1m"] = stream_case("tip-1m", g, cfg, STREAM_1M["epochs"],
                                 STREAM_1M["batch"], STREAM_1M["event_seed"],
                                 dev, launches, forest_every=False)
    info["dryrun_s"] = stream_dryrun(dev)
    return info


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
