"""End-to-end training CLI of the PyTorch port.

The same flags, output lines and exit codes as the JAX package's
``python -m repro.launch.train``, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions), for every family (Whisper's
batches carry seeded frame embeddings, Qwen2-VL's M-RoPE positions on
three equal streams, as the JAX CLI's ``extra``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
        --resume auto

The weights are random, drawn from a ``torch.Generator`` on the device
seeded with ``--seed`` (not the JAX package's numbers); the batches are
``data.synthetic_batches`` seeded per step, so a resumed run sees the
batches the crashed one would have.  Fault tolerance: checkpoints every
``--ckpt-every`` steps (atomic manifests, file-compatible with the JAX
package's), auto-resume from the latest complete checkpoint, straggler
detection via step-time z-score, crash injection (``--crash-at`` exits
42) for the restart test.

Launched by ``torch.distributed.run`` (``WORLD_SIZE`` > 1), the run is
sharded as the JAX CLI's under its local mesh: the process group opens
(``launch.mesh.init_peel_group``: NCCL on ``cuda``, one rank a card;
gloo on ``cpu``), ``make_local_mesh`` builds the ``("data", "model")``
mesh, the parameters are placed by ``param_shardings``, AdamW's moments
with them, and each step's batch by ``batch_shardings``; rank 0 prints.
Every rank draws the same weights and batches.  A single process runs
on plain tensors, as before::

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train \
        --arch tinyllama_1_1b --reduced --steps 4 --batch 4 --seq 32 \
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


def train(args) -> dict:
    """The run: prints the JAX CLI's lines and returns {losses,
    step_seconds (host clock, each ending in the loss's copy to the
    host), start, stragglers, cfg, params (the last step's)}."""
    from ..configs import get_config
    from ..device import resolve_device
    from ..data import DataConfig, synthetic_batches
    from ..models import init_params, reduced
    from ..train import (AdamWConfig, StragglerDetector, TrainConfig,
                         adamw_init, latest_step, make_train_step,
                         restore_checkpoint, save_checkpoint)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.seq:
        cfg = dataclasses.replace(cfg, max_seq=args.seq)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from .mesh import init_peel_group, make_local_mesh

        dev = init_peel_group(args.device)
        mesh = make_local_mesh(dev.type)
    else:
        dev = resolve_device(args.device)
    say = print if mesh is None or mesh.get_rank() == 0 else _quiet

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev, torch.float32)
    opt = adamw_init(params)
    if mesh is not None:
        params, opt = _place_state(cfg, params, opt, mesh)
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps),
    )
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            params, opt, _ = restore_checkpoint(args.ckpt_dir, s, params, opt)
            start = s
            say(f"[train] resumed from step {s}", flush=True)

    dcfg = DataConfig(batch=args.batch, seq=args.seq or cfg.max_seq,
                      vocab=cfg.vocab, seed=args.seed)
    data = synthetic_batches(dcfg, start_step=start,
                             extra=batch_extra(cfg, args.batch,
                                               args.seq or cfg.max_seq))

    det = StragglerDetector()
    losses, seconds = [], []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        if mesh is not None:
            from ..sharding import batch_shardings, distribute
            from ..train.tree import tree_map

            batch = tree_map(distribute, batch, batch_shardings(batch, mesh))
        t0 = time.perf_counter()
        det.start()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(_whole(metrics["loss"]))
        straggler = det.stop()
        seconds.append(time.perf_counter() - t0)
        if straggler:
            say(f"[train] straggler step {step} detected", flush=True)
        losses.append(loss)
        if step % args.log_every == 0:
            say(f"[train] step {step} loss {loss:.4f} "
                f"gnorm {float(_whole(metrics['grad_norm'])):.3f}",
                flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, params, opt,
                            extra=dict(arch=cfg.name))
        if args.crash_at is not None and step + 1 == args.crash_at:
            say("[train] injected crash", flush=True)
            os._exit(42)

    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, params, opt,
                        extra=dict(arch=cfg.name))
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    say(f"[train] done: loss {first:.4f} -> {last:.4f} "
        f"({len(losses)} steps, stragglers={det.flagged})", flush=True)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return dict(losses=losses, step_seconds=seconds, start=start,
                stragglers=det.flagged, cfg=cfg, params=params)


def _quiet(*args, **kwargs) -> None:
    """``print`` on ranks other than 0: nothing."""


def _whole(x):
    """A metric as a plain tensor (a ``DTensor`` gathered whole)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _place_state(cfg, params, opt, mesh):
    """Parameters placed by ``param_shardings`` on ``mesh``, AdamW's
    moments with them and its step replicated (the JAX CLI's placement)."""
    from ..models import logical_axes
    from ..sharding import Sharding, distribute, param_shardings
    from ..train import OptState
    from ..train.tree import tree_map

    p_sh = param_shardings(logical_axes(cfg), params, mesh)
    return tree_map(distribute, params, p_sh), OptState(
        mu=tree_map(distribute, opt.mu, p_sh),
        nu=tree_map(distribute, opt.nu, p_sh),
        step=distribute(opt.step, Sharding(mesh, ())))


def batch_extra(cfg, batch: int, seq: int):
    """The JAX CLI's per-step extra inputs: Whisper's frame embeddings
    [batch, encoder_seq, d] (normal · 0.02, float32) and M-RoPE's
    positions [batch, 3, seq] (0..seq-1 on every stream), each drawn
    from the step's generator after the tokens; None for the rest."""
    extra = None
    if cfg.family == "audio":
        extra = {"frames": lambda rng: rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32) * 0.02}
    if cfg.rope_type == "mrope":
        extra = {"positions": lambda rng: np.broadcast_to(
            np.arange(seq, dtype=np.int32)[None, None],
            (batch, 3, seq)).copy()}
    return extra


def run(args) -> int:
    train(args)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto")
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    sys.exit(run(parse_args(argv)))


if __name__ == "__main__":
    main()
