#!/usr/bin/env python
"""Replay the JAX package's ``remesh`` on gloo ranks: the port's
``train.elastic.remesh`` from plain tensors onto a (2, 4)
``("data", "model")`` mesh of 8 ranks, then onto a (2, 2) mesh of
ranks 0–3 (the other four lost), each rank's local shard of every
parameter and moment held to the slice the JAX package gives that
device; and a batch over ``("pod", "data")`` on a 2×2×2 mesh, one
tensor dim split over two mesh dims, held the same way (JAX splits it
pod-major).

``--case DIR`` holds what the JAX run wrote: ``state.npz`` (the
parameters, ``mu`` and ``nu``, keyed ``params/<path>`` etc., path parts
joined by ``.``, and the batch ``pod/tokens``) and ``slices.json``
(``{stage: {key: {device id: [[start, stop], ...]}}}`` for stages
``m8``, ``m4`` and ``pod``).  It imports ``torch`` and ``repro_torch``
only (never ``jax`` or ``repro``); it spawns the 8 ranks itself (gloo,
``file://`` rendezvous in DIR, no port), and each writes
``rank{r}.json``: the leaves checked and every mismatch::

    PYTHONPATH=src python tests/goldens/remesh_replay.py --case DIR
"""
from __future__ import annotations

import argparse
import json
import os
import sys

WORLD = 8


def rank_main(rank: int, case: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.models import logical_axes, reduced
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import _put
    from repro_torch.sharding import batch_shardings, distribute
    from repro_torch.train import OptState, adamw_init, remesh
    from repro_torch.train.tree import tree_items

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{case}/rdzv",
                            rank=rank, world_size=WORLD)
    try:
        cfg = reduced(get_config("tinyllama_1_1b"))
        arrays = np.load(os.path.join(case, "state.npz"))
        with open(os.path.join(case, "slices.json")) as f:
            slices = json.load(f)
        trees = {}
        for key in arrays.files:
            tree, path = key.split("/", 1)
            _put(trees.setdefault(tree, {}), path, arrays[key])
        params = params_from_numpy(trees["params"], cfg, device="cpu")
        opt = adamw_init(params)
        opt = OptState(mu=params_from_numpy(trees["mu"], cfg, device="cpu"),
                       nu=params_from_numpy(trees["nu"], cfg, device="cpu"),
                       step=opt.step + 7)
        axes = logical_axes(cfg)
        m8 = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                        mesh_dim_names=("data", "model"))
        m4 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
        p8, o8 = remesh(params, opt, axes, m8)
        p4, o4 = remesh(p8, o8, axes, m4)
        out = dict(checked=0, bad=[], step=None)
        for stage, (p, o) in (("m8", (p8, o8)), ("m4", (p4, o4))):
            for tree, t in (("params", p), ("mu", o.mu), ("nu", o.nu)):
                for path, d in tree_items(t):
                    key = f"{tree}/{'.'.join(path)}"
                    local = d.to_local().numpy()
                    sl = slices[stage][key].get(str(rank))
                    want = (arrays[key][tuple(slice(a, b) for a, b in sl)]
                            if sl is not None else np.zeros((0,), np.float32))
                    out["checked"] += 1
                    if not (local.shape == want.shape
                            and np.array_equal(local, want)):
                        out["bad"].append(f"{stage} {key}: local "
                                          f"{local.shape}, want {want.shape}")
        # a batch over ("pod", "data"): one tensor dim on two mesh dims
        m3 = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                        mesh_dim_names=("pod", "data", "model"))
        key = "pod/tokens"
        x = torch.from_numpy(arrays[key])
        sh = batch_shardings(dict(tokens=x), m3)["tokens"]
        local = distribute(x, sh).to_local().numpy()
        want = arrays[key][tuple(slice(a, b)
                                 for a, b in slices["pod"][key][str(rank)])]
        out["checked"] += 1
        if sh.spec != (("pod", "data"), None) or not np.array_equal(local,
                                                                    want):
            out["bad"].append(f"{key} under {sh.spec}: {local.tolist()}")
        if rank < 4:  # on the survivors: the whole values, unchanged
            for tree, t in (("params", p4), ("mu", o4.mu), ("nu", o4.nu)):
                for path, d in tree_items(t):
                    key = f"{tree}/{'.'.join(path)}"
                    if not np.array_equal(d.full_tensor().numpy(),
                                          arrays[key]):
                        out["bad"].append(f"full {key}")
            out["step"] = int(o4.step.full_tensor())
        with open(os.path.join(case, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", required=True)
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    mp.start_processes(rank_main, args=(os.path.abspath(args.case),),
                       nprocs=WORLD, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
