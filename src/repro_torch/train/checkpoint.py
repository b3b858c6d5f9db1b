"""Fault-tolerant checkpointing — the port of the JAX package's
``train/checkpoint.py``, file-compatible with it both ways.

* params and the optimizer state are saved as one npz per process,
  keyed by JAX's flattened tree paths (``blocks/attn/wq``; the state as
  ``.mu/<path>``, ``.nu/<path>`` and ``.step``);
* a JSON manifest (step, process count, tree-structure hashes, extra)
  is written LAST with an atomic rename — a checkpoint without a
  manifest is incomplete and ignored on restore;
* ``latest_step`` scans manifests, so a crash mid-save can never be
  resumed from;
* the hashes are the sha256[:16] of JAX's treedef string
  (``PyTreeDef({'blocks': {'w': *}, 'embed': *})``; the state
  ``PyTreeDef(CustomNode(namedtuple[OptState], [<params>, <params>,
  *]))``), built here without JAX, so either package refuses the
  other's checkpoint of another structure and restores one of the same.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .optimizer import OptState
from .tree import tree_items, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _flat(tree) -> Dict[str, np.ndarray]:
    """The npz's arrays, keyed by JAX's flattened paths; a ``DTensor``
    leaf (a sharded run: every rank calls this) is gathered whole."""
    from torch.distributed.tensor import DTensor

    return {"/".join(path): (leaf.full_tensor() if isinstance(leaf, DTensor)
                             else leaf).detach().cpu().numpy()
            for path, leaf in tree_items(tree)}


def _treedef(tree) -> str:
    if isinstance(tree, OptState):
        return ("CustomNode(namedtuple[OptState], ["
                + ", ".join(_treedef(x) for x in tree) + "])")
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _treedef_hash(tree) -> str:
    s = f"PyTreeDef({_treedef(tree)})"
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def _process() -> Tuple[int, int]:
    """(index, count) of this process: its ``torch.distributed`` rank and
    world size, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    proc, n_proc = _process()
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)

    np.savez(os.path.join(path, f"params_{proc}.npz"), **_flat(params))
    np.savez(os.path.join(path, f"opt_{proc}.npz"), **_flat(opt_state))

    manifest = dict(
        step=step,
        n_processes=n_proc,
        params_hash=_treedef_hash(params),
        opt_hash=_treedef_hash(opt_state),
        extra=extra or {},
    )
    # manifest last + atomic: incomplete checkpoints are invisible
    fd, tmp = tempfile.mkstemp(dir=path)
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "MANIFEST.json"))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "MANIFEST.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _unflat(template, flat):
    """``template``'s structure with each leaf read from ``flat`` at its
    path, in the template leaf's dtype and on its device (a ``DTensor``
    leaf's shard of it, placed as that leaf is)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(path, leaf):
        t = torch.from_numpy(np.asarray(flat["/".join(path)])).to(
            device=leaf.device, dtype=leaf.dtype)
        if isinstance(leaf, DTensor):
            return distribute_tensor(t, leaf.device_mesh, leaf.placements,
                                     src_data_rank=None)
        return t
    return tree_unflatten(template, [one(path, leaf)
                                     for path, leaf in tree_items(template)])


def restore_checkpoint(ckpt_dir: str, step: int, params_template,
                       opt_template) -> Tuple[Any, Any, Dict]:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if manifest["params_hash"] != _treedef_hash(params_template):
        raise ValueError(
            "checkpoint tree structure differs from model config — "
            "refusing to restore")
    proc, _ = _process()
    with np.load(os.path.join(path, f"params_{proc}.npz")) as pz, \
            np.load(os.path.join(path, f"opt_{proc}.npz")) as oz:
        params = _unflat(params_template, pz)
        opt = _unflat(opt_template, oz)
    return params, opt, manifest
