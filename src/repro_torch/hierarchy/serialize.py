"""Versioned save/load of hierarchy forests as flat npz (numpy; a copy
of the JAX package's ``hierarchy/serialize.py``, so a file written by
either package loads in the other with equal arrays and meta).

Layout: every :class:`~repro_torch.hierarchy.build.Hierarchy` array
under its field name, plus one JSON ``header`` blob carrying the format
version, kind and provenance (the engine-tagged ``PeelStats`` dict; the
CD partition/ranges/⋈init arrays ride along as first-class arrays).

Format history (the loader keeps a branch per shipped version):

* **v1** — the Hierarchy arrays + meta header.
* **v2** — v1 plus a *pack cache*: the ``depth`` vector and
  binary-lifting ``up`` table that :func:`~repro_torch.hierarchy.query
  .pack_forest` otherwise rebuilds with an O(n_nodes) host walk.  v1
  files still load (the pack cache is recomputed);
  ``save_hierarchy(..., version=1)`` keeps writing the old layout.
"""
from __future__ import annotations

import io
import json
import os
from typing import Union

import numpy as np

from .build import Hierarchy
from .query import depth_and_up

__all__ = ["FORMAT_VERSION", "save_hierarchy", "load_hierarchy"]

FORMAT_VERSION = 2
_SUPPORTED_VERSIONS = (1, 2)

_ARRAY_FIELDS = (
    "theta", "node_level", "parent", "entity_node",
    "member_off", "member_ids", "child_off", "child_ids",
    "tin", "tout", "ent_order", "estart", "eend",
    "node_m", "node_nu", "node_nv", "density",
)
# provenance arrays that may ride in meta (PeelResult.provenance())
_META_ARRAYS = ("part", "ranges", "support_init")
# v2 pack cache: query.pack_forest / the tenant pool read these from
# meta instead of re-walking the parent array on every cold load
_PACK_ARRAYS = ("pack_depth", "pack_up")


def save_hierarchy(path: Union[str, os.PathLike, io.IOBase],
                   h: Hierarchy, version: int = FORMAT_VERSION) -> None:
    """Write ``h`` to ``path`` (npz).  Flat arrays only — no pickling,
    so artifacts are portable across python/numpy versions.  The file
    lands at EXACTLY ``path`` (``np.savez`` would silently append
    ``.npz`` to suffix-less string paths, leaving the artifact where
    neither the caller nor ``load_hierarchy`` looks).  ``version``
    selects the written layout (old versions stay writable so the
    loader branches remain testable against real files)."""
    if version not in _SUPPORTED_VERSIONS:
        raise ValueError(
            f"cannot write hierarchy format {version!r} "
            f"(writable: {_SUPPORTED_VERSIONS})")
    meta = dict(h.meta)
    meta.pop("pack_depth", None)
    meta.pop("pack_up", None)
    arrays = {f: getattr(h, f) for f in _ARRAY_FIELDS}
    for key in _META_ARRAYS:
        if key in meta:
            arrays[f"meta_{key}"] = np.asarray(meta.pop(key))
    if version >= 2:
        depth, up = depth_and_up(np.asarray(h.parent))
        arrays["pack_depth"] = depth
        arrays["pack_up"] = up
    header = dict(
        format_version=version,
        kind=h.kind,
        n_entities=int(h.n_entities),
        meta=meta,
    )
    payload = dict(
        header=np.frombuffer(
            json.dumps(header).encode("utf-8"), dtype=np.uint8
        ),
        **arrays,
    )
    if isinstance(path, (str, os.PathLike)):
        with open(path, "wb") as fh:
            np.savez_compressed(fh, **payload)
    else:
        np.savez_compressed(path, **payload)


def load_hierarchy(path: Union[str, os.PathLike, io.IOBase]) -> Hierarchy:
    """Load a hierarchy artifact; raises ``ValueError`` on a format
    version this code does not understand.  One loader branch per
    shipped version: v1 files lack the pack cache (it is recomputed on
    first ``pack_forest``), v2 files carry it in ``meta``."""
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode("utf-8"))
        version = header.get("format_version")
        if version not in _SUPPORTED_VERSIONS:
            raise ValueError(
                f"hierarchy artifact format {version!r} unsupported "
                f"(this build reads {_SUPPORTED_VERSIONS})"
            )
        arrays = {f: z[f] for f in _ARRAY_FIELDS}
        meta = header["meta"]
        for key in _META_ARRAYS:
            if f"meta_{key}" in z.files:
                meta[key] = z[f"meta_{key}"]
        if version >= 2:
            for key in _PACK_ARRAYS:
                meta[key] = z[key]
    return Hierarchy(
        kind=header["kind"],
        n_entities=int(header["n_entities"]),
        meta=meta,
        **arrays,
    )
