"""Record the JAX package's logits of ChatGLM3-6B at full width, depth 2,
for the PyTorch port's LM path.

``chip_smoke.py`` (phase 9) runs the port's ``forward`` and
``serve_step`` on the card with the same weights and holds them to the
values written here (the card's machine has no JAX).  The weights are
``repro_torch.models.convert.numpy_params(cfg, seed=0)`` — one numpy
stream in the JAX package's layout and distribution — handed to the JAX
package as they are.  Recorded, for prompts of b=2, s=256 drawn from
``np.random.default_rng(1)``:

* ``forward``: at positions {0, 127, 255} of each row, the logits over a
  fixed 512-id subset of the vocabulary (``np.random.default_rng(2)``),
  and each row's argmax, top-2 gap and logsumexp over the whole vocab;
* ``decode``: the same for the teacher-forced ``serve_step`` logits at
  the same positions;
* ``param_check``: the first four values and the float64 sum of a few
  weight tensors, so a numpy that draws another stream shows as such.

Run from the repository root (about two minutes and ~10 GiB on a CPU)::

    PYTHONPATH=src python tests/goldens/record_torch_lm.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import repro.models as M
from repro.configs import get_config
from repro_torch.models.convert import numpy_params

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_lm.json")
ARCH = "chatglm3_6b"
N_LAYERS = 2
B, S = 2, 256
POSITIONS = (0, 127, 255)
N_IDS = 512
PARAM_CHECK = ("embed", "lm_head", "blocks.attn.wq", "blocks.ffn.w2")


def config():
    return dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)


def summarize(logits: np.ndarray, ids: np.ndarray) -> dict:
    """``logits`` [B, len(POSITIONS), V] f32 -> the recorded values."""
    x = logits.astype(np.float64)
    top2 = np.sort(x, axis=-1)[..., -2:]
    mx = x.max(axis=-1, keepdims=True)
    lse = mx[..., 0] + np.log(np.exp(x - mx).sum(axis=-1))
    return dict(subset=logits[..., ids].tolist(),
                argmax=logits.argmax(axis=-1).tolist(),
                top2_gap=(top2[..., 1] - top2[..., 0]).tolist(),
                logsumexp=lse.tolist())


def leaf(tree, path):
    for p in path.split("."):
        tree = tree[p]
    return tree


def record(cfg, batch=B, seq=S, positions=POSITIONS, n_ids=N_IDS, seed=0,
           log=print) -> dict:
    """The JAX package's forward and teacher-forced decode logits of
    ``cfg`` on ``numpy_params(cfg, seed)``, summarized."""
    t0 = time.time()
    params = numpy_params(cfg, seed=seed)
    check = {p: dict(first=[float(x) for x in leaf(params, p).reshape(-1)[:4]],
                     sum=float(leaf(params, p).sum(dtype=np.float64)))
             for p in PARAM_CHECK if p != "lm_head" or not cfg.tie_embeddings}
    jp = jax.tree.map(jnp.asarray, params)
    del params
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (batch, seq))
    ids = np.sort(np.random.default_rng(2).choice(cfg.vocab, n_ids,
                                                  replace=False))
    pos = list(positions)

    logits = M.forward(jp, jnp.asarray(tokens, jnp.int32), cfg)
    fwd = np.asarray(logits[:, pos])
    del logits
    log(f"[record] forward in {time.time() - t0:.1f} s")

    cache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                         M.cache_specs(cfg, batch, seq, dtype=jnp.float32))
    step = jax.jit(lambda p, c, t, l: M.serve_step(p, c, t, l, cfg))
    dec = []
    for i in range(max(pos) + 1):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, i], jnp.int32),
                         jnp.int32(i))
        if i in pos:
            dec.append(np.asarray(lg))
    dec = np.stack(dec, axis=1)
    log(f"[record] {max(pos) + 1} decode steps in {time.time() - t0:.1f} s")
    return dict(
        arch=cfg.name, n_layers=cfg.n_layers, seed=seed, positions=pos,
        tokens=tokens.tolist(), ids=ids.tolist(), param_check=check,
        forward=summarize(fwd, ids), decode=summarize(dec, ids),
        jax_forward_vs_decode_max_abs=float(np.abs(fwd - dec).max()),
    )


def main() -> None:
    t0 = time.time()
    out = record(config())
    with open(OUT, "w") as f:
        json.dump(out, f)
    print(f"[record] wrote {OUT} in {time.time() - t0:.1f} s; JAX forward vs "
          f"decode max abs {out['jax_forward_vs_decode_max_abs']:.3e}")


if __name__ == "__main__":
    main()
