"""The LM dry-run: place every (architecture × shape × mesh) cell's
state on a fake process group of 256 or 512 ranks, count what each
device holds, and run the cell's step there to count what each device
does — the LM half of the JAX package's ``launch/dryrun.py`` (the peel
dry-run is ``launch.peel --dryrun``).

A cell resolves the sharding rules (``sharding.partition``) on the
production mesh (``launch.mesh.make_production_mesh``) and places, as
``DTensor``s of meta tensors (nothing allocated): the bf16 parameters
(``models.abstract_params``) under ``param_shardings``; for ``train``
AdamW's f32 moments under the same and its replicated ``step``, and the
batch (``models.input_specs``) under ``batch_shardings``; for
``prefill`` the batch; for ``decode`` the cache under
``cache_shardings``, the token over the batch axes and the replicated
length.  ``mem.argument_bytes`` is the exact per-device bytes of all of
it, summed over rank 0's local shards (every rank's are alike: the rules
shard only dims that divide).

Then the cell's step runs on those meta ``DTensor``s inside
``sharding.use_mesh`` — ``make_train_step``'s step for ``train`` (the
bf16 parameters, f32 moments), ``prefill``, or one ``serve_step`` at
position 0 for ``decode`` — under ``hlo_analysis.count_costs``, which
records rank 0's local ops: ``flops`` (matrix products and attention,
per device), ``bytes_accessed`` (every op's inputs and outputs: an
unfused upper bound, where JAX's is of a fused program),
``collective_bytes`` by kind (result-shape bytes per device) and
``mem.output_bytes`` (this rank's share of the step's outputs), with
``time_count_s``.  What JAX reads from the compiled program and the port
cannot measure — temporaries, code bytes — is absent, as are the
per-operand ``bytes accessed`` keys.

    python -m repro_torch.launch.dryrun --arch tinyllama_1_1b \\
        --shape train_4k [--multi-pod]

Runs on the CPU and needs no card; nothing runs at import.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun")


def _place(tree, shardings):
    """``tree`` with every leaf placed under its sharding (leaf by leaf),
    and the bytes of this rank's local shards."""
    from ..sharding import distribute
    from ..train.tree import tree_leaves, tree_unflatten

    placed, total = [], 0
    for x, sh in zip(tree_leaves(tree), tree_leaves(shardings), strict=True):
        d = distribute(x, sh)
        local = d.to_local()
        if tuple(local.shape) != sh.shard_shape(x.shape):
            raise AssertionError(f"{tuple(x.shape)} under {sh.spec}: local "
                                 f"{tuple(local.shape)}, expected "
                                 f"{sh.shard_shape(x.shape)}")
        total += local.numel() * local.element_size()
        placed.append(d)
    return tree_unflatten(tree, placed), total


def _local_bytes(tree) -> int:
    """Bytes of this rank's share of ``tree``'s tensors."""
    import torch
    from torch.distributed.tensor import DTensor

    out = 0
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            out += x.numel() * x.element_size()
    return out


def _run_cell(cfg, kind: str, microbatches: int, args):
    """The cell's step on placed meta ``DTensor``s: the train step,
    prefill or one decode step; returns its outputs."""
    from .. import models as M
    from ..train import TrainConfig, make_train_step

    if kind == "train":
        params, opt, batch = args
        return make_train_step(cfg, TrainConfig(microbatches=microbatches))(
            params, opt, batch)
    if kind == "prefill":
        params, batch = args
        return M.prefill(params, batch["tokens"], cfg,
                         positions=batch.get("positions"),
                         frames=batch.get("frames"))
    params, cache, token = args
    return M.serve_step(params, cache, token["token"], 0, cfg)


def dryrun_cell(arch: str, shape: str, multi_pod: bool = False,
                microbatches: int = 1, verbose: bool = True,
                extra_tags: str = "",
                cfg_overrides: Optional[Dict] = None,
                count: bool = True, mesh_shape=None,
                batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict:
    """Place one cell and (``count``) run its step; returns its record.
    ``microbatches`` splits the train step's batch.  ``count=False``
    places the arguments only (``mem.argument_bytes``).  ``mesh_shape``
    ((dims, names)), ``batch`` and ``seq`` replace the production mesh
    and the shape set's batch and sequence (a one-card step:
    ``(((1, 1), ("data", "model")))``)."""
    import torch

    from .. import models as M
    from ..configs import get_config
    from ..sharding import (Sharding, batch_shardings, cache_shardings,
                            param_shardings, use_mesh)
    from ..train.optimizer import OptState, abstract_opt_state
    from .hlo_analysis import collective_bytes, count_costs
    from .mesh import (PRODUCTION_MESHES, _mesh, fake_group,
                       make_production_mesh)

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, why = M.shape_applicable(cfg, shape)
    if not ok:
        return dict(arch=arch, shape=shape, multi_pod=multi_pod,
                    status="skipped", reason=why)
    kind = M.SHAPE_SETS[shape]["kind"]
    dims, names = mesh_shape or PRODUCTION_MESHES[multi_pod]
    n = math.prod(dims)
    t0 = time.time()
    with fake_group(n):
        mesh = (_mesh("cpu", tuple(dims), tuple(names)) if mesh_shape
                else make_production_mesh(multi_pod=multi_pod, device="cpu"))
        pabs = M.abstract_params(cfg, torch.bfloat16)
        p_sh = param_shardings(M.logical_axes(cfg), pabs, mesh)
        placed = [(pabs, p_sh)]
        spec = M.input_specs(cfg, shape, batch=batch, seq=seq)
        if kind == "train":
            placed.append((abstract_opt_state(pabs), OptState(
                mu=p_sh, nu=p_sh, step=Sharding(mesh, ()))))
        if kind in ("train", "prefill"):
            placed.append((spec, batch_shardings(spec, mesh)))
        else:  # decode
            token = dict(token=spec["token"])
            placed += [
                (spec["cache"], cache_shardings(spec["cache"], mesh, cfg)),
                (token, batch_shardings(token, mesh)),
                (spec["length"], Sharding(mesh, ()))]
        args, sizes = zip(*(_place(t, sh) for t, sh in placed))
        arg_bytes = sum(sizes)
        counted = None
        if count:
            t1 = time.time()
            with use_mesh(mesh), count_costs() as cost:
                out = _run_cell(cfg, kind, microbatches, args[:3])
            counted = dict(flops=float(cost.flops),
                           bytes_accessed=float(cost.bytes_accessed),
                           collective_bytes=collective_bytes(cost.trace),
                           time_count_s=round(time.time() - t1, 1))
            out_bytes = _local_bytes(out)
    rec = dict(arch=arch, shape=shape, multi_pod=multi_pod, status="ok",
               kind=kind, n_devices=n)
    if counted:
        rec.update(counted)
    rec.update(tags=extra_tags, mem=dict(argument_bytes=arg_bytes))
    if counted:
        rec["mem"]["output_bytes"] = out_bytes
    if verbose:
        more = (f"flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                f"coll={sum(rec['collective_bytes'].values()):.3e}B "
                if counted else "")
        print(f"[dryrun] {arch:18s} {shape:12s} "
              f"{'2pod' if multi_pod else '1pod'} OK {more}"
              f"argument_bytes={arg_bytes} a device of {n} "
              f"({time.time() - t0:.1f} s)", flush=True)
    return rec


def run_all(out_path: str, multi_pod_values=(False, True),
            archs=None, shapes=None, resume=True,
            microbatches: int = 1, count: bool = True):
    from ..configs import ARCHS
    from ..models import SHAPE_SETS

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results = []
    done = set()
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["multi_pod"],
                 r.get("tags", "")) for r in results}
    tags = f"mb{microbatches}" if microbatches > 1 else ""
    for arch in (archs or ARCHS):
        for shape in (shapes or list(SHAPE_SETS)):
            for mp in multi_pod_values:
                key = (arch, shape, mp, tags)
                if key in done:
                    continue
                try:
                    rec = dryrun_cell(arch, shape, multi_pod=mp,
                                      microbatches=microbatches,
                                      extra_tags=tags, count=count)
                except Exception as e:  # noqa: BLE001 — record, go on
                    traceback.print_exc()
                    rec = dict(arch=arch, shape=shape, multi_pod=mp,
                               status="error", error=str(e)[-2000:],
                               tags=tags)
                    print(f"[dryrun] {arch} {shape} mp={mp} FAILED: "
                          f"{type(e).__name__}", flush=True)
                results.append(rec)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-count", action="store_true",
                    help="place the arguments only (no step, no counts)")
    args = ap.parse_args(argv)

    out = args.out or os.path.abspath(
        os.path.join(RESULTS_DIR, "torch_results.json"))
    if args.arch and args.shape:
        rec = dryrun_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                          microbatches=args.microbatches,
                          count=not args.no_count)
        print(json.dumps(rec, indent=2))
        return
    mp_vals = (False, True)
    if args.single_pod_only:
        mp_vals = (False,)
    if args.multi_pod_only:
        mp_vals = (True,)
    archs = [args.arch] if args.arch else None
    shapes = [args.shape] if args.shape else None
    run_all(out, mp_vals, archs, shapes,
            microbatches=args.microbatches, count=not args.no_count)


if __name__ == "__main__":
    main()
