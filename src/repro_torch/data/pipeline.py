"""Token data pipeline — a copy of the JAX package's ``data/pipeline.py``
(numpy only), held array-equal to the original by
``tests/test_torch_analysis.py``.

Deterministic, restart-safe synthetic stream (seeded per step — resuming
at step k reproduces the exact batch k would have seen, which makes
checkpoint/restart bit-reproducible), plus a memmap-backed file source
for real corpora.  Each host materializes only its data shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "synthetic_batches", "memmap_batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    vocab: int
    seed: int = 0


def _make_batch(cfg: DataConfig, step: int,
                extra: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((cfg.seed, step))
    # zipfian tokens — realistic softmax skew
    z = rng.zipf(1.3, size=(cfg.batch, cfg.seq + 1))
    toks = (z % cfg.vocab).astype(np.int32)
    out = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    if extra:
        out.update({k: f(rng) for k, f in extra.items()})
    return out


def synthetic_batches(cfg: DataConfig, start_step: int = 0,
                      extra: Optional[Dict] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield _make_batch(cfg, step, extra)
        step += 1


def memmap_batches(path: str, cfg: DataConfig, start_step: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Flat int32 token file; sequential non-overlapping windows."""
    data = np.memmap(path, dtype=np.int32, mode="r")
    per_batch = cfg.batch * (cfg.seq + 1)
    n_batches = data.size // per_batch
    step = start_step
    while True:
        i = step % n_batches
        window = np.asarray(
            data[i * per_batch:(i + 1) * per_batch]
        ).reshape(cfg.batch, cfg.seq + 1) % cfg.vocab
        yield dict(tokens=window[:, :-1], labels=window[:, 1:])
        step += 1
