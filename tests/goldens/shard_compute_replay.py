#!/usr/bin/env python
"""Replay sharded LM compute on gloo ranks: for every reduced
architecture, the port's train step, prefill and decode steps on a
(2, 4) ``("data", "model")`` mesh of 8 CPU ranks — parameters placed by
``param_shardings``, the batch by ``batch_shardings``, the cache by
``cache_shardings``, run inside ``sharding.use_mesh`` — against the
same calls on plain tensors in the same process, and each rank's shard
of every parameter and moment after the step against the slice the JAX
package gives that device.

``--case DIR`` receives one ``rank{r}.json`` a rank; ``--golden`` is
``tests/goldens/torch_shard_compute.json`` (from
``record_torch_shard_compute.py``: the recipe, JAX's sharded loss and
gradient norm, and JAX's slices).  It imports ``torch`` and
``repro_torch`` only (never ``jax`` or ``repro``); it spawns the 8 ranks
itself (gloo, ``file://`` rendezvous in DIR, no port)::

    PYTHONPATH=src python tests/goldens/shard_compute_replay.py \\
        --case DIR [--archs tinyllama_1_1b,dbrx_132b]

With ``--card`` it is instead ``chip_smoke.py``'s four-rank step (phase
17): ``CARD``'s ranks (gloo) share the one card on a (2, 2) mesh and run
``CARD``'s model — TinyLlama-1.1B at full width, depth 2, b 4 × 512 —
once sharded (``train_loss`` and its gradients under
``hlo_analysis.CostMode``, which counts the collectives by kind; then a
timed ``make_train_step`` step); rank 0 runs the plain step on the same
weights and batch (on the card where there is one) and holds the loss
and every gradient leaf to it.  First the ranks probe gloo's
collectives on CUDA tensors; if gloo carries them the ranks run on the
card (gloo has no all-to-all: ``DTensor``'s own all-gather-and-chunk
stands in, as on a CPU mesh), and if a collective fails or kills a
rank there (the rank writes which collective it is in before each) they
run again on the CPU; ``probe.json`` records what happened.

A rank's record for each architecture: the plain and sharded losses,
the worst gradient / updated-parameter / moment error as a fraction of
its gate (atol 1e-5 + rtol 1e-4 · |plain|: ≤ 1 passes), the relative L2
error of the prefill logits and of each decode step's logits, whether
the MoE dispatch's integers are equal, and every leaf whose local shard
is not JAX's slice.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

WORLD = 8
MESH = ((2, 4), ("data", "model"))
ATOL, RTOL = 1e-5, 1e-4
# AdamW at its defaults (lr 3e-4, 100 warm-up steps), as the unsharded
# step's precedent in tests/test_torch_train.py
RECIPE = dict(param_seed=0, batch_seed=1, batch=4, seq=32, decode_steps=3)


def make_batch(cfg, b: int, s: int, seed: int) -> dict:
    """The train batch both packages take, as numpy: ``tokens`` and
    ``labels`` [b, s] int32 from ``default_rng(seed)``, then Whisper's
    ``frames`` [b, encoder_seq, d] (normal · 0.02, float32) and M-RoPE's
    ``positions`` [b, 3, s] (0..s-1 on every stream)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
               labels=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.rope_type == "mrope":
        out["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (b, 3, s)).copy()
    return out


def _err(got, want) -> float:
    """max |got − want| / (ATOL + RTOL·|want|): ≤ 1 within the gate."""
    import torch

    return float(torch.max(torch.abs(got - want)
                           / (ATOL + RTOL * torch.abs(want))))


def _rel(got, want) -> float:
    import torch

    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def one_arch(arch: str, mesh, rank: int, golden) -> dict:
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.models import (init_cache, logical_axes, prefill,
                                    reduced, serve_step, train_loss)
    from repro_torch.models import moe
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.models.model import DenseLM
    from repro_torch.sharding import (Sharding, batch_shardings,
                                      cache_shardings, distribute,
                                      param_shardings, use_mesh)
    from repro_torch.train import (OptState, TrainConfig,
                                   adamw_init, make_train_step)
    from repro_torch.train.tree import tree_items, tree_leaves, tree_map

    R = golden["recipe"]
    cfg = reduced(get_config(arch))
    params = params_from_numpy(numpy_params(cfg, seed=R["param_seed"]), cfg,
                               device="cpu")
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, R["batch"], R["seq"], R["batch_seed"]).items()}
    p_sh = param_shardings(logical_axes(cfg), params, mesh)
    P = tree_map(distribute, params, p_sh)
    O = OptState(mu=tree_map(distribute, opt.mu, p_sh),
                 nu=tree_map(distribute, opt.nu, p_sh),
                 step=distribute(opt.step, Sharding(mesh, ())))
    B = tree_map(distribute, batch, batch_shardings(batch, mesh))
    step = make_train_step(cfg, TrainConfig())
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    rec: dict = {}

    def grads(tree, b):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), tree)
        loss = train_loss(leaves, b, cfg)
        gs = torch.autograd.grad(loss, tree_leaves(leaves))
        return full(loss).item(), [
            full(g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g)
            for g, p in zip(gs, tree_leaves(tree))]

    lp, gp = grads(params, batch)
    want = step(params, opt, batch)
    with use_mesh(mesh):
        ls, gs = grads(P, B)
        got = step(P, O, B)
    rec["loss"] = [lp, ls, got[2]["loss"].full_tensor().item(),
                   want[2]["loss"].item()]
    rec["grad_norm"] = [want[2]["grad_norm"].item(),
                        got[2]["grad_norm"].full_tensor().item()]
    rec["grad_err"] = max(_err(a, b) for a, b in zip(gs, gp, strict=True))
    rec["grad_rel"] = max(_rel(a, b) for a, b in zip(gs, gp, strict=True)
                          if b.abs().sum() > 0)
    rec["param_err"] = max(_err(full(a), b) for a, b in zip(
        tree_leaves(got[0]), tree_leaves(want[0]), strict=True))
    rec["moment_err"] = max(_err(full(a), b) for a, b in zip(
        tree_leaves(got[1].mu) + tree_leaves(got[1].nu),
        tree_leaves(want[1].mu) + tree_leaves(want[1].nu), strict=True))
    rec["step"] = int(full(got[1].step))

    # every rank's shard of every parameter and moment: JAX's slice
    bad, checked = [], 0
    slices = golden["archs"][arch]["slices"]
    for tree, t in (("params", got[0]), ("mu", got[1].mu),
                    ("nu", got[1].nu)):
        for path, d in tree_items(t):
            key = ".".join(path)
            sl = slices[key][str(rank)]
            want_local = d.full_tensor()[tuple(slice(a, b) for a, b in sl)]
            checked += 1
            if not (isinstance(d, DTensor) and torch.equal(d.to_local(),
                                                           want_local)):
                bad.append(f"{tree}/{key}")
    rec["slices_checked"], rec["bad_slices"] = checked, bad

    with torch.no_grad():
        pf = dict(positions=batch.get("positions"), frames=batch.get("frames"))
        lg_p = prefill(params, batch["tokens"], cfg, **pf)
        with use_mesh(mesh):
            lg_s = prefill(P, B["tokens"], cfg, positions=B.get("positions"),
                           frames=B.get("frames"))
        rec["prefill_rel"] = _rel(lg_s.full_tensor(), lg_p)

        b, s = batch["tokens"].shape
        cache_p = init_cache(cfg, b, s, "cpu", torch.float32)
        cache_s = tree_map(distribute, init_cache(cfg, b, s, "cpu",
                                                  torch.float32),
                           cache_shardings(cache_p, mesh, cfg))
        if cfg.family == "audio":
            cache_p["enc_out"] = DenseLM(cfg, params).encode(batch["frames"])
            with use_mesh(mesh):
                cache_s["enc_out"] = DenseLM(cfg, P).encode(B["frames"])
        rec["decode_rel"] = []
        tok_sh = batch_shardings(dict(t=batch["tokens"][:, 0]), mesh)["t"]
        for t in range(R["decode_steps"]):
            tok = batch["tokens"][:, t].contiguous()
            a, cache_p = serve_step(params, cache_p, tok, t, cfg)
            with use_mesh(mesh):
                d, cache_s = serve_step(P, cache_s, distribute(tok, tok_sh),
                                        t, cfg)
            rec["decode_rel"].append(_rel(d.full_tensor(), a))
        rec["cache_rel"] = max(
            _rel(cache_s[k].full_tensor(), v) if v.abs().sum() > 0 else
            float(cache_s[k].full_tensor().abs().max())
            for k, v in cache_p.items())

        if cfg.is_moe:  # the dispatch's integers, sharded and not
            x = torch.from_numpy(make_batch(cfg, b, s, 7)["tokens"])
            x = params["embed"][x]
            router = params["blocks"]["ffn"]["router"][0]
            want_d = moe.dispatch(x, router, cfg)
            with use_mesh(mesh):
                got_d = moe.dispatch(
                    distribute(x, batch_shardings(dict(x=x), mesh)["x"]),
                    P["blocks"]["ffn"]["router"][0], cfg)
            rec["moe_ints_equal"] = all(
                torch.equal(g.full_tensor(), w)
                for g, w in zip(got_d[1:4], want_d[1:4]))
            rec["moe_eb_rel"] = _rel(got_d[0].full_tensor(), want_d[0])
    return rec


def rank_main(rank: int, case: str, golden_path: str, archs) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    with open(golden_path) as f:
        golden = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{case}/rdzv",
                            rank=rank, world_size=WORLD)
    try:
        dims, names = MESH
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(dims),
                          mesh_dim_names=names)
        out = {}
        for arch in archs:
            try:
                out[arch] = one_arch(arch, mesh, rank, golden)
            except Exception as e:  # noqa: BLE001 — recorded, the test fails
                import traceback

                out[arch] = dict(error=f"{type(e).__name__}: {e}",
                                 trace=traceback.format_exc()[-3000:])
        with open(os.path.join(case, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


CARD = dict(world=4, mesh=[[2, 2], ["data", "model"]],
            arch="tinyllama_1_1b", depth=2, batch=4, seq=512, seed=11)
# c10d's calls, then the functional collectives DTensor redistributes
# through (asynchronous, each waited on)
PROBES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single", "functional all_reduce",
          "functional all_gather_into_tensor",
          "functional reduce_scatter_tensor")


def probe_rank(rank: int, case: str, spec: dict) -> None:
    """Each collective of ``PROBES`` once on a small CUDA tensor, through
    gloo; the rank's ``probe-rank{r}.json`` is rewritten before and after
    each, so a collective that kills the process is the one it names as
    running."""
    import torch
    import torch.distributed as dist

    path = os.path.join(case, f"probe-rank{rank}.json")
    out: dict = {}

    def note(**kw):
        out.update(kw)
        with open(path, "w") as f:
            json.dump(out, f)

    note(running=None)
    if not torch.cuda.is_available():
        note(skipped="no card")
        return
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{case}/rdzv-probe",
                            rank=rank, world_size=spec["world"])
    try:
        n = spec["world"]
        dev = torch.device("cuda", 0)
        x = torch.arange(4 * n, dtype=torch.float32, device=dev)
        for name in PROBES:
            note(running=name)
            try:
                if name == "all_reduce":
                    dist.all_reduce(x.clone())
                elif name == "all_gather_into_tensor":
                    dist.all_gather_into_tensor(
                        torch.empty(4 * n * n, device=dev), x)
                elif name == "reduce_scatter_tensor":
                    dist.reduce_scatter_tensor(torch.empty(4, device=dev), x)
                elif name == "all_to_all_single":
                    dist.all_to_all_single(torch.empty_like(x), x)
                else:
                    from torch.distributed import (
                        _functional_collectives as funcol)

                    group = dist.group.WORLD
                    if name == "functional all_reduce":
                        y = funcol.all_reduce(x, "sum", group)
                    elif name == "functional all_gather_into_tensor":
                        y = funcol.all_gather_tensor(x, 0, group)
                    else:
                        y = funcol.reduce_scatter_tensor(x, "sum", 0, group)
                    float(y.sum())
                torch.cuda.synchronize()
                note(**{name: "ok"})
            except Exception as e:  # noqa: BLE001 — the finding itself
                note(**{name: f"{type(e).__name__}: {str(e)[:200]}"})
        note(running=None)
    finally:
        dist.destroy_process_group()


def _gloo_alltoall() -> None:
    """On a gloo group ``DTensor``'s Shard→Shard all-to-all as its own CPU
    fallback (an all-gather and a chunk): gloo has no all-to-all, on
    either device."""
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol

        out = funcol.all_gather_tensor(input, gather_dim, (mesh, mesh_dim))
        if isinstance(out, funcol.AsyncCollectiveTensor):
            out = out.wait()
        return pt.Shard._custom_chunk(out, mesh.size(mesh_dim), dim=shard_dim)[
            mesh.get_local_rank(mesh_dim)].contiguous()

    pt.shard_dim_alltoall = alltoall


def _progress_mode(path: str):
    """A dispatch mode that writes the name and shape of every functional
    collective to ``path`` before it runs (and ``null`` after), so the
    collective that kills a rank is on disk."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Progress(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            name = str(getattr(func, "_overloadpacket", func))
            hot = name.startswith(("_c10d_functional.", "_dtensor."))
            if hot:
                shapes = [list(a.shape) for a in args if hasattr(a, "shape")]
                with open(path, "w") as f:
                    json.dump(dict(running=name, shapes=shapes), f)
            out = func(*args, **(kwargs or {}))
            if hot:
                with open(path, "w") as f:
                    json.dump(dict(running=None, last=name), f)
            return out

    return Progress()


def card_rank(rank: int, case: str, spec: dict, device: str) -> None:
    import dataclasses
    import time

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import CostMode, collective_bytes
    from repro_torch.models import logical_axes, train_loss
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.sharding import (Sharding, batch_shardings, distribute,
                                      param_shardings, use_mesh)
    from repro_torch.train import (OptState, TrainConfig, adamw_init,
                                   make_train_step)
    from repro_torch.train.tree import tree_leaves, tree_map

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{case}/rdzv-{device}",
                            rank=rank, world_size=spec["world"])
    rec: dict = dict(device=device)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
            _gloo_alltoall()
        dims, names = spec["mesh"]
        mesh = DeviceMesh(dev.type, torch.arange(spec["world"]).reshape(dims),
                          mesh_dim_names=tuple(names))
        cfg = dataclasses.replace(get_config(spec["arch"]),
                                  n_layers=spec["depth"])
        if spec.get("reduced"):  # a rehearsal's small widths
            from repro_torch.models import reduced

            cfg = reduced(cfg, n_layers=spec["depth"])
        params = params_from_numpy(numpy_params(cfg, seed=spec["seed"]), cfg,
                                   device=dev)
        rng = np.random.default_rng(spec["seed"])
        ids = torch.from_numpy(rng.integers(
            0, cfg.vocab, (spec["batch"], spec["seq"] + 1))).to(dev)
        batch = dict(tokens=ids[:, :-1].contiguous(),
                     labels=ids[:, 1:].contiguous())
        p_sh = param_shardings(logical_axes(cfg), params, mesh)
        P = tree_map(distribute, params, p_sh)
        B = tree_map(distribute, batch, batch_shardings(batch, mesh))

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        progress = _progress_mode(os.path.join(
            case, f"progress-{device}-rank{rank}.json"))
        ops.reset_launch_counts()
        with use_mesh(mesh), CostMode() as cost, progress:
            leaves = tree_map(lambda p: p.detach().requires_grad_(), P)
            loss = train_loss(leaves, B, cfg)
            gs = torch.autograd.grad(loss, tree_leaves(leaves))
            gs = [g.redistribute(p.device_mesh, p.placements)
                  for g, p in zip(gs, tree_leaves(P))]
        rec["flash_launches"] = ops.launch_counts()["flash_attention"]
        rec["collective_bytes"] = collective_bytes(cost.trace)
        rec["collective_counts"] = {}
        for op in cost.trace:
            if op.kind:
                rec["collective_counts"][op.kind] = rec[
                    "collective_counts"].get(op.kind, 0) + 1
        rec["loss_sharded"] = loss.full_tensor().item()
        full = [g.full_tensor() for g in gs]
        del gs, leaves
        step = make_train_step(cfg, TrainConfig())
        opt = adamw_init(params)
        O = OptState(mu=tree_map(distribute, opt.mu, p_sh),
                     nu=tree_map(distribute, opt.nu, p_sh),
                     step=distribute(opt.step, Sharding(mesh, ())))
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        with progress:
            out = step(P, O, B)
            out[2]["loss"].full_tensor()
        sync()
        rec["step_s"] = time.perf_counter() - t0
        del out
        rec["flash_launches_total"] = ops.launch_counts()["flash_attention"]
        if rank == 0:   # the plain step, on the card where there is one
            on = torch.device("cuda", 0) if torch.cuda.is_available() else dev
            leaves = tree_map(lambda p: p.detach().to(on).requires_grad_(),
                              params)
            ops.reset_launch_counts()
            lp = train_loss(leaves, {k: v.to(on) for k, v in batch.items()},
                            cfg)
            gp = [g.to(dev) for g in torch.autograd.grad(
                lp, tree_leaves(leaves))]
            rec["plain_on"] = str(on)
            rec["plain_flash_launches"] = ops.launch_counts()[
                "flash_attention"]
            rec["loss_plain"] = lp.item()
            rec["worst_rel_l2"] = max(_rel(a, b) for a, b in zip(full, gp))
            rec["leaves"] = len(gp)
    except Exception as e:  # noqa: BLE001 — recorded; the caller fails
        import traceback

        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["trace"] = traceback.format_exc()[-3000:]
    finally:
        with open(os.path.join(case, f"card-{device}-rank{rank}.json"),
                  "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()


# the collectives DTensor's redistributions need (all-to-all has its
# all-gather fallback, _gloo_alltoall)
NEEDED = ("functional all_reduce", "functional all_gather_into_tensor",
          "functional reduce_scatter_tensor")


def card_main(case: str, spec=CARD) -> int:
    """Probe gloo's collectives on CUDA tensors (``probe_rank``; a rank
    may die in one), then run ``spec``'s step on the card if gloo carried
    every collective of ``NEEDED`` there, else on the CPU; ``probe.json``
    records what each collective did.  The ranks run at a lower
    scheduling priority (``nice`` 10, inherited): beside ``chip_smoke.py``
    they should take the host's idle cores, not its main thread's."""
    import torch.multiprocessing as mp

    os.nice(10)

    try:
        mp.start_processes(probe_rank, args=(case, spec),
                           nprocs=spec["world"], start_method="spawn")
        died = None
    except Exception as e:  # noqa: BLE001 — a rank killed by a collective
        died = f"{type(e).__name__}: {e}"
    probe: dict = {}
    for r in range(spec["world"]):
        with open(os.path.join(case, f"probe-rank{r}.json")) as f:
            rec = json.load(f)
        if rec.get("running"):
            rec[rec["running"]] = f"the rank died in it ({died})"
        for k, v in rec.items():
            if k in PROBES and v != "ok" or k not in probe:
                probe[k] = v
    probe.pop("running", None)
    device = ("cuda" if "skipped" not in probe
              and all(probe.get(k) == "ok" for k in NEEDED) else "cpu")
    if device == "cuda":
        try:
            mp.start_processes(card_rank, args=(case, spec, "cuda"),
                               nprocs=spec["world"], start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank killed on the card
            crashed = []
            for r in range(spec["world"]):
                path = os.path.join(case, f"progress-cuda-rank{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        crashed.append(json.load(f))
            probe["sharded_step_on_cuda"] = dict(
                died=f"{type(e).__name__}: {e}", progress=crashed)
            device = "cpu"
    probe["ran_on"] = device
    with open(os.path.join(case, "probe.json"), "w") as f:
        json.dump(probe, f)
    if device == "cpu":
        mp.start_processes(card_rank, args=(case, spec, "cpu"),
                           nprocs=spec["world"], start_method="spawn")
    return 0


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", required=True)
    ap.add_argument("--golden",
                    default=os.path.join(here, "torch_shard_compute.json"))
    ap.add_argument("--archs", default=None)
    ap.add_argument("--card", action="store_true",
                    help="chip_smoke.py's four-rank step (CARD)")
    ap.add_argument("--card-spec", default=None,
                    help="JSON overriding CARD's keys (a smaller rehearsal)")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    if args.card:
        return card_main(os.path.abspath(args.case), dict(
            CARD, **json.loads(args.card_spec or "{}")))
    with open(args.golden) as f:
        archs = (args.archs.split(",") if args.archs
                 else list(json.load(f)["archs"]))
    mp.start_processes(rank_main, args=(os.path.abspath(args.case),
                                        os.path.abspath(args.golden), archs),
                       nprocs=WORLD, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
