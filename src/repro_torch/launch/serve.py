"""Batched serving driver of the PyTorch port: prefill a batch of
prompts, then decode with a KV cache (greedy).

The same flags and output lines as the JAX package's ``python -m
repro.launch.serve`` (``--arch --reduced --batch --prompt-len --gen
--seed``), plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels).  The weights are random, drawn from a
``torch.Generator`` seeded with ``--seed`` (not the JAX package's
numbers); the prompts come from ``np.random.default_rng(--seed)`` as
there, and for the audio family the frame embeddings after them
(``normal · 0.02``, float32, the JAX CLI's draw), encoded into the
cache's ``enc_out``.  Every family's architectures (MoE with MLA:
``deepseek_v2_236b``; with GQA: ``dbrx_132b``; SSM: ``xlstm_1_3b``;
hybrid: ``zamba2_7b``; audio: ``whisper_large_v3``; VLM, text-only
positions: ``qwen2_vl_72b``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
        --batch 4 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek_v2_236b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \
        --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper_large_v3 --batch 4 --prompt-len 16 --gen 16

Launched by ``torch.distributed.run`` (``WORLD_SIZE`` > 1) it serves
under the local mesh, as the JAX CLI does: the process group opens
(NCCL on ``cuda``, gloo on ``cpu``), the weights are placed by
``param_shardings`` on ``make_local_mesh``, the cache by
``cache_shardings`` and each step's tokens by ``batch_shardings``; rank
0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch


def run(args) -> int:
    from ..configs import get_config
    from ..device import resolve_device
    from ..models import DenseLM, init_cache, init_params, reduced

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from .mesh import init_peel_group, make_local_mesh

        dev = init_peel_group(args.device)
        mesh = make_local_mesh(dev.type)
    else:
        dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev, torch.float32)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    total = args.prompt_len + args.gen
    prompts = rng.integers(0, cfg.vocab, (b, args.prompt_len)).astype(np.int64)
    cache = init_cache(cfg, b, total, dev, torch.float32)
    place = (lambda x: x) if mesh is None else _placer(mesh)
    if mesh is not None:
        from ..models import logical_axes
        from ..sharding import cache_shardings, distribute, param_shardings
        from ..train.tree import tree_map

        params = tree_map(distribute, params,
                          param_shardings(logical_axes(cfg), params, mesh))
        cache = tree_map(distribute, cache,
                         cache_shardings(cache, mesh, cfg))
    model = DenseLM(cfg, params)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            from ..sharding import use_mesh

            stack.enter_context(use_mesh(mesh))
        if cfg.family == "audio":
            # the audio frontend stub's input, drawn as the JAX CLI draws it
            frames = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                      * 0.02).astype(np.float32)
            with torch.no_grad():
                cache["enc_out"] = model.encode(
                    place(torch.from_numpy(frames).to(dev)))

        # prefill via the decode path (teacher-forced) then greedy generate
        tok = torch.from_numpy(prompts[:, 0]).to(dev)
        t0 = time.time()
        out_tokens = [prompts[:, 0]]
        for i in range(total - 1):
            logits, cache = model.serve_step(cache, place(tok), i)
            if i + 1 < args.prompt_len:
                tok = torch.from_numpy(prompts[:, i + 1]).to(dev)
            else:
                tok = _whole(torch.argmax(logits, dim=-1))
            out_tokens.append(tok.cpu().numpy())
        dt = time.time() - t0
    if mesh is None or mesh.get_rank() == 0:
        seqs = np.stack(out_tokens, axis=1)
        print(f"[serve] {b} seqs × {total} steps in {dt:.2f}s "
              f"({b * (total - 1) / dt:.1f} tok/s)")
        print("[serve] sample:", seqs[0, args.prompt_len:][:16].tolist())
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _whole(x):
    """A ``DTensor`` gathered whole; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _placer(mesh):
    """Places a batch-major tensor (tokens, frames) by
    ``batch_shardings`` on ``mesh``."""
    from ..sharding import batch_shardings, distribute

    return lambda x: distribute(x, batch_shardings(dict(x=x), mesh)["x"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    sys.exit(run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
