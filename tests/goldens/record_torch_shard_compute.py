#!/usr/bin/env python
"""Record JAX's side of the sharded LM compute for
``tests/test_torch_shard_compute.py``: on 8 forced host devices as a
(2, 4) ``("data", "model")`` mesh, for every reduced architecture, one
jitted train step of the JAX package on the weights both packages load
(``repro_torch.models.convert.numpy_params``) and the batch of
``shard_compute_replay.make_batch``, parameters and batch placed by its
``param_shardings`` / ``batch_shardings`` under ``set_mesh``, the step's
outputs kept on the parameters' shardings (as the dry-run jits it).

Writes ``torch_shard_compute.json``: the recipe; per architecture JAX's
sharded loss and gradient norm, and the slice ([start, stop] a dim) of
every parameter each device holds after the step (``mu`` and ``nu`` take
the same slices: asserted here).  About a minute::

    PYTHONPATH=src python tests/goldens/record_torch_shard_compute.py
"""
from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import shard_compute_replay as replay  # noqa: E402
import repro.models as M  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402
from repro.models.config import reduced  # noqa: E402
from repro.sharding import batch_shardings, param_shardings  # noqa: E402
from repro.sharding.compat import set_mesh  # noqa: E402
from repro.train.optimizer import OptState, adamw_init  # noqa: E402
from repro.train.train_step import TrainConfig, make_train_step  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import reduced as treduced  # noqa: E402
from repro_torch.models.convert import numpy_params  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_shard_compute.json")


def slices_of(x) -> dict:
    return {str(d.id): [list(s.indices(n))[:2] for s, n in zip(idx, x.shape)]
            for d, idx in x.sharding.devices_indices_map(x.shape).items()}


def one(arch: str, mesh) -> dict:
    R = replay.RECIPE
    cfg = reduced(get_config(arch))
    np_params = numpy_params(treduced(tget(arch)), seed=R["param_seed"])
    params = jax.tree.map(jnp.asarray, np_params)
    batch = {k: jnp.asarray(v) for k, v in replay.make_batch(
        cfg, R["batch"], R["seq"], R["batch_seed"]).items()}
    with set_mesh(mesh):
        p_sh = param_shardings(M.logical_axes(cfg), params, mesh)
        o_sh = OptState(mu=p_sh, nu=p_sh, step=NamedSharding(mesh, P()))
        b_sh = batch_shardings(batch, mesh)
        params = jax.device_put(params, p_sh)
        opt = jax.device_put(adamw_init(params), o_sh)
        batch = jax.device_put(batch, b_sh)
        step = jax.jit(make_train_step(cfg, TrainConfig()),
                       in_shardings=(p_sh, o_sh, b_sh),
                       out_shardings=(p_sh, o_sh, None))
        p1, o1, metrics = step(params, opt, batch)
    slices = {}
    for (kp, x), m, v in zip(jax.tree_util.tree_leaves_with_path(p1),
                             jax.tree.leaves(o1.mu), jax.tree.leaves(o1.nu)):
        key = ".".join(k.key for k in kp)
        slices[key] = slices_of(x)
        assert slices_of(m) == slices[key] == slices_of(v), key
    return dict(loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), slices=slices)


def main() -> int:
    dims, names = replay.MESH
    mesh = Mesh(np.array(jax.devices()).reshape(dims), names)
    out = dict(recipe=replay.RECIPE, mesh=[list(dims), list(names)],
               archs={})
    for arch in ARCHS:
        out["archs"][arch] = one(arch, mesh)
        print(arch, out["archs"][arch]["loss"], flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, separators=(",", ":"))
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
