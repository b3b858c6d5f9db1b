"""Batched serving driver of the PyTorch port: prefill a batch of
prompts, then decode with a KV cache (greedy).

The same flags and output lines as the JAX package's ``python -m
repro.launch.serve`` (``--arch --reduced --batch --prompt-len --gen
--seed``), plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels).  The weights are random, drawn from a
``torch.Generator`` seeded with ``--seed`` (not the JAX package's
numbers); the prompts come from ``np.random.default_rng(--seed)`` as
there.  Dense-family architectures only::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
        --batch 4 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def run(args) -> int:
    from ..configs import get_config
    from ..core.peel import resolve_device
    from ..models import DenseLM, init_cache, init_params, reduced

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = DenseLM(cfg, init_params(cfg, gen, dev, torch.float32))
    rng = np.random.default_rng(args.seed)
    b = args.batch
    total = args.prompt_len + args.gen
    prompts = rng.integers(0, cfg.vocab, (b, args.prompt_len)).astype(np.int64)
    cache = init_cache(cfg, b, total, dev, torch.float32)

    # prefill via the decode path (teacher-forced) then greedy generate
    tok = torch.from_numpy(prompts[:, 0]).to(dev)
    t0 = time.time()
    out_tokens = [tok.cpu().numpy()]
    for i in range(total - 1):
        logits, cache = model.serve_step(cache, tok, i)
        if i + 1 < args.prompt_len:
            tok = torch.from_numpy(prompts[:, i + 1]).to(dev)
        else:
            tok = torch.argmax(logits, dim=-1)
        out_tokens.append(tok.cpu().numpy())
    dt = time.time() - t0
    seqs = np.stack(out_tokens, axis=1)
    print(f"[serve] {b} seqs × {total} steps in {dt:.2f}s "
          f"({b * (total - 1) / dt:.1f} tok/s)")
    print("[serve] sample:", seqs[0, args.prompt_len:][:16].tolist())
    return 0


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
