#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. setup — build the four CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) and print the card.
2. kernels — each kernel against its plain PyTorch version on the card,
   at the main path's shapes: ``fd_round_wing``/``fd_round_tip`` on the
   packed wing-60k / tip-1m partition stacks, round by round to the
   fixed point, every output compared; ``support_update`` and
   ``wedge_count`` on the wing-60k slot matrices.  All comparisons are
   ``torch.equal`` (every output is an exact integer).  Times each.
3. goldens — every csr cell of ``tests/goldens/peel_goldens.json``
   (fused kernels on for the device/vmapped drivers), plus kernel-route
   reruns (``use_pallas``) of one wing and one tip graph.
4. tip-1m and 5. wing-60k — the CLI's main path (``repro_torch.launch.
   peel``: the fused device driver, then vmapped and ``--use-pallas``),
   θ and PeelStats held to the JAX package's values in
   ``tests/goldens/torch_fullsize.json``.
6. fd-drivers — from one CD per graph, Phase 2 under every FD driver
   (fused and unfused device/vmapped, and the kernel-free host driver),
   each held to the same JAX values and timed.

Launch counts are set to 0 before each main-path run and read after it.
The last lines are the ``kernels`` JSON, the card's name and power limit
as nvidia-smi prints them, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate at the full 700 W

KERNEL_INFO = {
    "fd_round_wing": ("src/repro_torch/kernels/csrc/fd_round.cu",
                      "src/repro/kernels/fd_round.py:111"),
    "fd_round_tip": ("src/repro_torch/kernels/csrc/fd_round.cu",
                     "src/repro/kernels/fd_round.py:172"),
    "support_update": ("src/repro_torch/kernels/csrc/support_update.cu",
                       "src/repro/kernels/support_update.py:82"),
    "wedge_count": ("src/repro_torch/kernels/csrc/wedge_count.cu",
                    "src/repro/kernels/wedge_count.py:89"),
}
STAT_FIELDS = ("rho_cd", "rho_fd_total", "rho_fd_max", "updates",
               "recounts", "p_effective")
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


def check_rows_kernel(name, kernel, plain, inputs, nbytes, reps=20):
    """One call of a row-parallel kernel against its plain version, then
    both timed over ``reps`` calls."""
    got = kernel(*inputs)
    want = plain(*inputs)
    require_equal(name, got, want, "on the main path's slot matrix")
    ms = cuda_ms(lambda: kernel(*inputs), reps)
    plain_ms = cuda_ms(lambda: plain(*inputs), reps)
    row = dict(ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bytes_per_call=nbytes, calls_checked=1, max_abs_err=0.0)
    log(f"[smoke]   {name}: equal to the plain version on "
        f"{tuple(inputs[0].shape)}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {nbytes / 1e6:.1f} MB -> bound "
        f"{row['bound_ms']:.4f} ms")
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


def phase_kernels(fullsize, dev, cache):
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
    torch.cuda.empty_cache()
    return rows


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
        g, fd = graphs[parts[1]], parts[-1]
        P = int(parts[2][1:])
        if fused is None:
            fused = fd != "host"
        kw = dict(P=P, engine="csr", fd_driver=fd, fused=fused,
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
    if len(cells) != 72:
        raise AssertionError(f"expected 72 csr golden cells, found "
                             f"{len(cells)}")
    for key in cells:
        run(key)
    # kernel-route reruns: CD through support_update / wedge_count, and the
    # unfused vmapped wing FD with support_update inside the loop
    extra = [k for k in cells if k.split(".")[1] == "pl80"]
    for key in extra:
        run(key, use_pallas=True, fused=False)
    log(f"[smoke]   {len(cells)} csr golden cells equal field for field "
        f"(fused on for device/vmapped); {len(extra)} pl80 cells again "
        f"with use_pallas")


# ---------------------------------------------------------------------
# phases 4-5: the main path at full size
# ---------------------------------------------------------------------
def main_path(fullsize, name, g, flags, launches, dev):
    """One CLI run on ``g``; held to the recorded JAX values.  Launch
    counts are zeroed just before and read just after."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import peel as cli

    want = fullsize[name]
    args = cli.build_parser().parse_args(
        ["--kind", want["kind"], "--parts", str(want["P"]),
         "--device", dev, *flags])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.run(args, g=g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    res = out["result"]
    got = dict(theta_sha256=out["theta_sha256"],
               part_sha256=cli.sha256_int64(res.part),
               support_init_sha256=cli.sha256_int64(res.support_init),
               ranges=[int(x) for x in res.ranges],
               stats={f: int(out[f]) for f in STAT_FIELDS})
    for key, val in got.items():
        if val != want[key]:
            raise AssertionError(f"{name} {flags}: {key} {val} != JAX "
                                 f"{want[key]}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    log(f"[smoke]   {name} {' '.join(flags) or '(defaults)'}: matches the "
        f"JAX package in {dt:.1f} s; launches {counts}")
    return counts, dt


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
    smi = nvidia_smi()

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
        rows = phase_kernels(fullsize, dev, cache)

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
            bound_by="bytes", library_ms=None,
            bytes_per_call=r["bytes_per_call"]))
    log(json.dumps(dict(phase_seconds=Phase.seconds, fd_driver_seconds=fd_times)))
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
