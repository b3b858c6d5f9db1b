"""Roofline analysis on the H100 — the port of the JAX package's
``launch/roofline.py``.

The dry-run (``launch.dryrun.dryrun_cell``) counts one step of a cell on
its production mesh (per device: FLOPs, bytes, collective bytes).  As in
the JAX package, two shallow variants (L1 and L2 layers, in the unit the
family repeats) are counted on the SAME mesh and extrapolated linearly
to the full depth:

    metric(L) = a + b·L  ->  total = m(L1) + b · (L_full − L1)

The variants carry the JAX package's overrides (``_overrides``: its
unrolling and block-size knobs, which change nothing in the port's
eager step, and the SSM chunk of 512).  The sLSTM time loop: JAX's
program hides it in a scan its cost analysis counts once, so JAX adds
``_slstm_correction_flops``; the port's step runs that loop eagerly and
the dry-run counts every one of its steps, so nothing is added here.

Hardware model: NVIDIA H100 SXM, the peaks ``PERF.md`` §6 bounds the
kernels by — bf16 dense 989 TFLOP/s, HBM3 3.35 TB/s.  The link rate is
an assumption, not a measurement (``LINK_BW_ASSUMED``, also in every
record): 50 GB/s a card, the 400 Gb/s NIC of a card across nodes — the
16-way ``"model"`` and ``"data"`` groups of the 16×16 mesh span more than
one 8-card NVLink 4 domain (450 GB/s a direction inside it), so the
slower link bounds their collectives.  Counts are per device, so each
term is one chip's time.

    python -m repro_torch.launch.roofline --arch tinyllama_1_1b \\
        --shape train_4k [--multi-pod] [--out results.json]

Runs on the CPU and needs no card; nothing runs at import.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

PEAK_FLOPS = 989e12      # bf16 dense / chip (H100 SXM)
HBM_BW = 3.35e12         # B/s / chip (HBM3)
LINK_BW = 50e9           # B/s / chip, assumed (see LINK_BW_ASSUMED)
LINK_BW_ASSUMED = dict(
    bytes_per_s=LINK_BW,
    link="inter-node: 400 Gb/s InfiniBand NIC a card",
    nvlink4_bytes_per_s=450e9,
    why="a 16-rank mesh axis spans more than one 8-card NVLink 4 domain")

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "roofline")


def _variant_layers(cfg) -> tuple:
    """(L1, L2, L_full) in the unit the family repeats over."""
    if cfg.family == "ssm":
        return cfg.slstm_every, 2 * cfg.slstm_every, cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every, cfg.n_layers
    return 1, 2, cfg.n_layers


def _overrides(cfg, L: int, shape: str) -> Dict:
    from ..models import SHAPE_SETS

    ov = dict(n_layers=L, unroll_layers=True,
              attn_block_q=2048, attn_block_k=2048, ssm_chunk=512)
    if cfg.family == "audio":
        ov["encoder_layers"] = L
    seq = SHAPE_SETS[shape]["seq"]
    ov["attn_block_q"] = min(2048, seq)
    ov["attn_block_k"] = min(2048, seq)
    if cfg.family in ("ssm", "hybrid"):
        ov["ssm_chunk"] = min(512, seq)
    return ov


def extrapolate(m1: float, m2: float, L1: int, L2: int, L: int) -> float:
    """The line through (L1, m1) and (L2, m2) at L, floored at 0."""
    return max(m1 + (m2 - m1) / (L2 - L1) * (L - L1), 0.0)


def model_flops_per_chip(cfg, shape: str, n_dev: int) -> float:
    """MODEL_FLOPS a chip: 6·N·D to train, 2·N·D otherwise, N the active
    non-embedding parameters, D the step's tokens (one a row to decode),
    split over ``n_dev`` chips — the JAX package's formula."""
    from ..models import SHAPE_SETS

    info = SHAPE_SETS[shape]
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_eff = max(cfg.active_param_count() - embed, 1)
    tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    mult = 6 if info["kind"] == "train" else 2
    return mult * n_eff * tokens / n_dev


def roofline_cell(arch: str, shape: str, multi_pod: bool = False,
                  use_cache: Optional[dict] = None,
                  mb: int = 1,
                  extra_overrides: Optional[Dict] = None,
                  tag: str = "") -> Dict:
    from ..configs import get_config
    from .. import models as M
    from .dryrun import dryrun_cell

    cfg = get_config(arch)
    ok, why = M.shape_applicable(cfg, shape)
    if not ok:
        return dict(arch=arch, shape=shape, status="skipped", reason=why)

    L1, L2, Lf = _variant_layers(cfg)
    recs = {}
    for L in (L1, L2):
        key = f"{arch}/{shape}/{multi_pod}/L{L}/mb{mb}/{tag}"
        if use_cache and key in use_cache:
            recs[L] = use_cache[key]
            continue
        ov = dict(_overrides(cfg, L, shape))
        if extra_overrides:
            ov.update(extra_overrides)
        r = dryrun_cell(arch, shape, multi_pod=multi_pod, microbatches=mb,
                        cfg_overrides=ov, verbose=False)
        if r["status"] != "ok":
            return dict(arch=arch, shape=shape, status="error",
                        at=f"L{L}", detail=r)
        recs[L] = r
        if use_cache is not None:
            use_cache[key] = r

    def total(field):
        return extrapolate(float(recs[L1][field]), float(recs[L2][field]),
                           L1, L2, Lf)

    flops = total("flops")
    bytes_acc = total("bytes_accessed")
    coll = {}
    for kind in set(recs[L1]["collective_bytes"]) | set(
            recs[L2]["collective_bytes"]):
        coll[kind] = extrapolate(recs[L1]["collective_bytes"].get(kind, 0),
                                 recs[L2]["collective_bytes"].get(kind, 0),
                                 L1, L2, Lf)
    coll_total = sum(coll.values())

    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = coll_total / LINK_BW
    terms = dict(compute=t_compute, memory=t_memory, collective=t_coll)
    bottleneck = max(terms, key=terms.get)

    info = M.SHAPE_SETS[shape]
    n_dev = recs[L1]["n_devices"]
    model_flops = model_flops_per_chip(cfg, shape, n_dev)

    return dict(
        arch=arch, shape=shape, multi_pod=multi_pod, status="ok",
        tag=tag,
        kind=info["kind"], n_devices=n_dev, mb=mb,
        flops_per_chip=flops, bytes_per_chip=bytes_acc,
        collective_bytes_per_chip=coll, collective_total=coll_total,
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
        bottleneck=bottleneck,
        model_flops_per_chip=model_flops,
        useful_flop_ratio=model_flops / max(flops, 1.0),
        roofline_fraction=t_compute / max(t_compute, t_memory, t_coll),
        mem=recs[L2].get("mem"),
        # seconds the two counts took (the port compiles nothing)
        compile_s=(recs[L1]["time_count_s"], recs[L2]["time_count_s"]),
        peaks=dict(flops_per_s=PEAK_FLOPS, hbm_bytes_per_s=HBM_BW),
        link_bw_assumed=LINK_BW_ASSUMED,
    )


def run_all(out_path: str, archs=None, shapes=None, multi_pod=False,
            resume=True):
    from ..configs import ARCHS
    from ..models import SHAPE_SETS

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results = []
    done = set()
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r.get("multi_pod", False))
                for r in results}
    cache_path = out_path + ".cache.json"
    cache = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            cache = json.load(f)
    for arch in (archs or ARCHS):
        for shape in (shapes or list(SHAPE_SETS)):
            if (arch, shape, multi_pod) in done:
                continue
            try:
                rec = roofline_cell(arch, shape, multi_pod=multi_pod,
                                    use_cache=cache)
            except Exception as e:  # noqa: BLE001 — record, go on
                import traceback
                traceback.print_exc()
                rec = dict(arch=arch, shape=shape, multi_pod=multi_pod,
                           status="error", error=str(e)[-2000:])
            results.append(rec)
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
            with open(cache_path, "w") as f:
                json.dump(cache, f)
            if rec["status"] == "ok":
                print(f"[roofline] {arch:18s} {shape:12s} "
                      f"{'2pod' if multi_pod else '1pod'} "
                      f"bottleneck={rec['bottleneck']:10s} "
                      f"comp={rec['t_compute_s']:.2e}s "
                      f"mem={rec['t_memory_s']:.2e}s "
                      f"coll={rec['t_collective_s']:.2e}s "
                      f"useful={rec['useful_flop_ratio']:.2f}", flush=True)
            else:
                print(f"[roofline] {arch} {shape} "
                      f"{'2pod' if multi_pod else '1pod'} {rec['status']}",
                      flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or os.path.abspath(
        os.path.join(RESULTS_DIR, "torch_results.json"))
    run_all(out,
            archs=[args.arch] if args.arch else None,
            shapes=[args.shape] if args.shape else None,
            multi_pod=args.multi_pod)


if __name__ == "__main__":
    main()
