"""Record the JAX package's logits of xLSTM-1.3B and Zamba2-7B at full
width, cut in depth, for the PyTorch port's SSM and hybrid paths.

``chip_smoke.py`` (phase 15) runs the port's ``forward`` and
``serve_step`` on the card with the same weights
(``repro_torch.models.convert.numpy_params(cfg, seed=0)``) and holds them
to the values written here (the card's machine has no JAX).  Each model
is ``tests/goldens/record_torch_lm.py``'s ``record`` (see its docstring
for the fields) at B 2, S 128, positions (0, 63, 127): two 64-token
chunks, so the forward runs the inter-chunk scan.  The depths:

* xLSTM-1.3B at depth 8, one group (7 mLSTM layers and the sLSTM layer;
  0.76 G parameters);
* Zamba2-7B at depth 6, one application of the shared attention block
  (0.90 G parameters).

For Zamba2 it also records ``bf16_prefill_rel``: the relative L2 of the
JAX package's own bf16 last-position logits (the same weights rounded
to bf16) against its f32 ones, on the same tokens.  The port's bf16
route is held to a multiple of it: this model's bf16 logits drift from
its f32 ones far past 3·10⁻² as depth grows, in the reference too.

Run from the repository root (a few minutes, about 20 GB of host memory
at its peak)::

    PYTHONPATH=src python tests/goldens/record_torch_ssm.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import record_torch_lm  # noqa: E402
import repro.models as M  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro_torch.models.convert import numpy_params  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_ssm.json")
B, S = 2, 128
POSITIONS = (0, 63, 127)
# the models whose bf16 drift is recorded
BF16 = ("zamba2_7b",)
# (arch, depth, the weights whose first values and sum are recorded)
MODELS = (
    ("xlstm_1_3b", 8, ("embed", "lm_head", "mlstm.wq", "slstm.R")),
    ("zamba2_7b", 6, ("embed", "lm_head", "blocks.in_proj",
                      "shared_attn.ffn.w2")),
)


def config(arch, depth):
    return dataclasses.replace(get_config(arch), n_layers=depth)


def record(cfg, param_check, **kw) -> dict:
    """``record_torch_lm.record`` of ``cfg`` with ``param_check``'s
    weights checked."""
    record_torch_lm.PARAM_CHECK = param_check
    return record_torch_lm.record(cfg, **kw)


def bf16_prefill_rel(cfg, rec) -> float:
    """‖bf16 − f32‖ / ‖f32‖ of the JAX package's last-position logits
    of ``cfg`` on ``rec``'s weights and tokens."""
    params = numpy_params(cfg, seed=rec["seed"])
    tokens = jnp.asarray(rec["tokens"], jnp.int32)
    last = [np.asarray(M.prefill(jax.tree.map(
        lambda a: jnp.asarray(a, dt), params), tokens, cfg).astype(
            jnp.float32), np.float64) for dt in (jnp.float32, jnp.bfloat16)]
    return float(np.linalg.norm(last[1] - last[0]) / np.linalg.norm(last[0]))


def main() -> None:
    t0 = time.time()
    out = {}
    for arch, depth, check in MODELS:
        out[arch] = record(config(arch, depth), check, batch=B, seq=S,
                           positions=POSITIONS)
        if arch in BF16:
            out[arch]["bf16_prefill_rel"] = bf16_prefill_rel(
                config(arch, depth), out[arch])
            print(f"[record] {arch}: JAX bf16 vs f32 last-position logits "
                  f"{out[arch]['bf16_prefill_rel']:.3e}", flush=True)
        print(f"[record] {arch} depth {depth}: JAX forward vs decode max "
              f"abs {out[arch]['jax_forward_vs_decode_max_abs']:.3e}",
              flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f)
    print(f"[record] wrote {OUT} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
