"""Record the JAX package's logits of Whisper-large-v3 and Qwen2-VL-72B at
full width, cut in depth, for the PyTorch port's audio and VLM paths.

``chip_smoke.py`` (phase 16) runs the port's ``forward`` and
``serve_step`` on the card with the same weights
(``repro_torch.models.convert.numpy_params(cfg, seed=0)``) and holds them
to the values written here (the card's machine has no JAX).  For each
model, at B 2, S 128, prompts from ``np.random.default_rng(1)`` and a
512-id vocabulary subset from ``np.random.default_rng(2)`` (the fields of
``record_torch_lm.summarize``):

* Whisper-large-v3 with 4 encoder and 4 decoder layers (0.250 G
  parameters) over 1 500 frame embeddings drawn as the serving CLI draws
  them (``np.random.default_rng(3).normal(...) · 0.02``, float32):
  ``forward`` and the teacher-forced ``serve_step`` (its cache's
  ``enc_out`` the encoder's output), a fixed sample of the encoder's
  output, and ``frames`` (the draw's seed and scale, the frames' first
  values and sum);
* Qwen2-VL-72B at depth 1 (3.37 G parameters): ``forward`` with M-RoPE
  positions that hold an image block (``chip_smoke.mrope_image_positions``:
  16 text tokens, an 8 × 8 patch grid, text; written out under
  ``mrope_positions``), and ``forward`` and the teacher-forced
  ``serve_step`` on text-only positions (the decode step puts a token at
  one position on all three streams, so it equals the forward there
  only).

Each also records ``bf16_prefill_rel``: the relative L2 of the JAX
package's bf16 last-position logits (the weights, and Whisper's frames,
rounded to bf16) against its f32 ones on the same inputs.

Run from the repository root (a few minutes, about 30 GB of host memory
at its peak, Qwen2-VL's)::

    PYTHONPATH=src python tests/goldens/record_torch_audio_vlm.py
"""
from __future__ import annotations

import dataclasses
import importlib.util
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
from repro.models.model import _whisper_encode  # noqa: E402
from repro_torch.models.convert import numpy_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_audio_vlm.json")
B, S = 2, 128
POSITIONS = (0, 15, 47, 79, 127)
FRAMES_SEED = 3
# the encoder output's recorded sample: its first, middle and last
# frames, ENC_CHANNELS channels drawn from default_rng(4)
ENC_CHANNELS = 64
# Qwen2-VL's image block in the golden's 128 positions
IMAGE = dict(start=16, grid=(8, 8))
# (arch, depth overrides, the weights whose first values and sum are
# recorded)
MODELS = (
    ("whisper_large_v3", dict(n_layers=4, encoder_layers=4),
     ("embed", "enc_blocks.attn.wq", "dec_blocks.cross.wv",
      "dec_blocks.ffn.w2")),
    ("qwen2_vl_72b", dict(n_layers=1),
     ("embed", "lm_head", "blocks.attn.wk", "blocks.ffn.w3")),
)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(arch, depth):
    return dataclasses.replace(get_config(arch), **depth)


def frame_embeddings(cfg, batch, seed=FRAMES_SEED) -> np.ndarray:
    """The golden's frames: the serving CLI's draw from ``seed``."""
    return (np.random.default_rng(seed).normal(
        size=(batch, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _check(arr) -> dict:
    return dict(first=[float(x) for x in arr.reshape(-1)[:4]],
                sum=float(arr.sum(dtype=np.float64)))


def _to_jax(tree) -> dict:
    """The numpy tree as JAX arrays, each numpy leaf dropped once copied
    (Qwen2-VL's 13.5 GB are never held twice)."""
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = _to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
        del v
    return out


def _decode(jp, cfg, tokens, pos, enc_out=None) -> np.ndarray:
    """Teacher-forced ``serve_step`` logits [B, len(pos), V]."""
    batch, _ = tokens.shape
    cache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                         M.cache_specs(cfg, batch, max(pos) + 1,
                                       dtype=jnp.float32))
    if enc_out is not None:
        cache["enc_out"] = enc_out
    step = jax.jit(lambda p, c, t, l: M.serve_step(p, c, t, l, cfg))
    out = []
    for i in range(max(pos) + 1):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, i], jnp.int32),
                         jnp.int32(i))
        if i in pos:
            out.append(np.asarray(lg))
    return np.stack(out, axis=1)


def _bf16_rel(jp, cfg, tokens, **kw) -> float:
    """‖bf16 − f32‖ / ‖f32‖ of the last-position logits of a prefill."""
    last = []
    for dt in (jnp.float32, jnp.bfloat16):
        p = jax.tree.map(lambda a: a.astype(dt), jp)
        args = {k: (v.astype(dt) if k == "frames" else v)
                for k, v in kw.items()}
        last.append(np.asarray(M.prefill(p, tokens, cfg, **args).astype(
            jnp.float32), np.float64))
        del p
    return float(np.linalg.norm(last[1] - last[0]) / np.linalg.norm(last[0]))


def record(cfg, param_check, batch=B, seq=S, positions=POSITIONS,
           n_ids=record_torch_lm.N_IDS, seed=0, image=IMAGE,
           log=print) -> dict:
    """The JAX package's logits of ``cfg`` (audio or vlm) on
    ``numpy_params(cfg, seed)``, summarized (module docstring)."""
    t0 = time.time()
    summarize = record_torch_lm.summarize
    params = numpy_params(cfg, seed=seed)
    check = {p: _check(record_torch_lm.leaf(params, p)) for p in param_check}
    jp = _to_jax(params)
    del params
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (batch, seq))
    ids = np.sort(np.random.default_rng(2).choice(cfg.vocab, n_ids,
                                                  replace=False))
    pos = list(positions)
    jt = jnp.asarray(tokens, jnp.int32)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, seed=seed,
               positions=pos, tokens=tokens.tolist(), ids=ids.tolist(),
               param_check=check)
    if cfg.family == "audio":
        frames = frame_embeddings(cfg, batch)
        jf = jnp.asarray(frames)
        enc_out = _whisper_encode(jp, jf, cfg)
        se = cfg.encoder_seq
        at = [0, se // 2, se - 1]
        channels = np.sort(np.random.default_rng(4).choice(
            cfg.d_model, min(ENC_CHANNELS, cfg.d_model), replace=False))
        fwd = np.asarray(M.forward(jp, jt, cfg, frames=jf)[:, pos])
        log(f"[record] {cfg.name} forward in {time.time() - t0:.1f} s")
        dec = _decode(jp, cfg, tokens, pos, enc_out)
        out.update(
            encoder_layers=cfg.encoder_layers,
            frames=dict(seed=FRAMES_SEED, scale=0.02, **_check(frames)),
            encoder=dict(frames=at, channels=channels.tolist(),
                         values=np.asarray(enc_out)[:, at][
                             :, :, channels].tolist()),
            bf16_prefill_rel=_bf16_rel(jp, cfg, jt, frames=jf))
    else:
        mpos = _smoke().mrope_image_positions(batch, seq, image["start"],
                                              image["grid"])
        image_fwd = np.asarray(M.forward(jp, jt, cfg,
                                         positions=jnp.asarray(mpos))[:, pos])
        fwd = np.asarray(M.forward(jp, jt, cfg)[:, pos])
        log(f"[record] {cfg.name} forwards in {time.time() - t0:.1f} s")
        dec = _decode(jp, cfg, tokens, pos)
        out.update(
            image=dict(start=image["start"], grid=list(image["grid"])),
            mrope_positions=mpos.tolist(),
            image_forward=summarize(image_fwd, ids),
            jax_image_vs_text_max_abs=float(np.abs(image_fwd - fwd).max()),
            bf16_prefill_rel=_bf16_rel(jp, cfg, jt,
                                       positions=jnp.asarray(mpos)))
    log(f"[record] {cfg.name}: {max(pos) + 1} decode steps and bf16 in "
        f"{time.time() - t0:.1f} s")
    out.update(forward=summarize(fwd, ids), decode=summarize(dec, ids),
               jax_forward_vs_decode_max_abs=float(np.abs(fwd - dec).max()))
    return out


def main() -> None:
    t0 = time.time()
    out = {}
    for arch, depth, check in MODELS:
        out[arch] = record(config(arch, depth), check)
        print(f"[record] {arch} {depth}: JAX forward vs decode max abs "
              f"{out[arch]['jax_forward_vs_decode_max_abs']:.3e}, bf16 vs "
              f"f32 last-position logits {out[arch]['bf16_prefill_rel']:.3e}",
              flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f)
    print(f"[record] wrote {OUT} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
