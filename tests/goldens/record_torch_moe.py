"""Record the JAX package's logits of DeepSeek-V2-236B at full width,
depth 1, for the PyTorch port's MoE path.

``chip_smoke.py`` (phase 14) runs the port's ``forward`` and
``serve_step`` on the card with the same weights
(``repro_torch.models.convert.numpy_params(cfg, seed=0)``) and holds them
to the values written here (the card's machine has no JAX).  The
recording is ``tests/goldens/record_torch_lm.py``'s ``record`` (see its
docstring for the fields; the weights checked are ``PARAM_CHECK``) at
B 2, S 128, positions (0, 63, 127), with the published capacity factor
1.25: a group of 128 tokens gives each of the
160 experts C = 8 slots, so the forward drops (token, expert) pairs and
the golden holds the drops at full width; the decode path (one token a
step) drops none.

Run from the repository root (about 41 GB of host memory at its peak:
the 20.4 GB of numpy weights, then the JAX package's copy)::

    PYTHONPATH=src python tests/goldens/record_torch_moe.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import record_torch_lm  # noqa: E402
from repro.configs import get_config  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_moe.json")
ARCH = "deepseek_v2_236b"
N_LAYERS = 1
B, S = 2, 128
POSITIONS = (0, 63, 127)
# the weights whose first values and sum are recorded (the MoE tree has
# expert weights where the dense one has ffn.w2)
PARAM_CHECK = ("embed", "lm_head", "blocks.attn.wq", "blocks.ffn.we2")


def record(cfg, **kw) -> dict:
    """``record_torch_lm.record`` of ``cfg`` with ``PARAM_CHECK``'s
    weights checked."""
    record_torch_lm.PARAM_CHECK = PARAM_CHECK
    return record_torch_lm.record(cfg, **kw)


def config():
    return dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)


def main() -> None:
    t0 = time.time()
    cfg = config()
    out = record(cfg, batch=B, seq=S, positions=POSITIONS)
    out["capacity_factor"] = cfg.capacity_factor
    with open(OUT, "w") as f:
        json.dump(out, f)
    print(f"[record] wrote {OUT} in {time.time() - t0:.1f} s; JAX forward vs "
          f"decode max abs {out['jax_forward_vs_decode_max_abs']:.3e} (the "
          f"forward drops pairs, the decode none)")


if __name__ == "__main__":
    main()
