"""Logical-axis → mesh-axis resolution: the JAX package's partitioning
rules (``sharding/partition.py``), resolved to ``DTensor`` placements.

Models annotate every parameter dimension with a logical axis name
(``models.logical_axes``); here those names meet a mesh:

    vocab / heads / kv / mlp / expert  -> "model"   (TP / EP)
    embed                              -> "data"    (FSDP / ZeRO-3)
    layers / None                      -> replicated

A dimension that does not divide its mesh axis falls back to replication
(e.g. gemma's single KV head on a 16-way model axis).  Batch and cache
shardings are given per shape kind (train / prefill / decode / long).

A spec is a plain tuple with one entry a tensor dim, as a JAX
``PartitionSpec`` reads through ``tuple()``: a mesh axis name, a tuple
of names (one dim over several mesh axes, e.g. ``("pod", "data")``), or
None; trailing Nones trimmed where JAX trims them, and a one-name tuple
written as the bare name, as ``PartitionSpec`` normalises it.  Every
function takes a mesh through its ``shape`` and ``mesh_dim_names``, so a
``torch.distributed.device_mesh.DeviceMesh`` and a :class:`MeshShape`
(no process group) resolve alike.  :func:`placements` turns a spec into
one ``Shard(dim)`` / ``Replicate()`` a mesh dim: a dim over several mesh
axes is ``Shard(dim)`` on each, which ``DTensor`` splits in mesh-dim
order (pod-major for ``("pod", "data")``), as JAX does.

:func:`use_mesh` is the counterpart of the JAX package's ``set_mesh``:
the mesh ``models.layers.constrain`` reads while a sharded step runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

from ..train.tree import tree_items, tree_map, tree_unflatten

__all__ = [
    "LOGICAL_RULES",
    "MeshShape",
    "Sharding",
    "resolve_spec",
    "placements",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "data_axes",
    "distribute",
    "use_mesh",
    "current_mesh",
]

LOGICAL_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "expert": "model",
    "embed": "data",
    "layers": None,  # scanned — never sharded
}


class MeshShape(NamedTuple):
    """A mesh by its dims' sizes and names — a ``DeviceMesh``'s ``shape``
    and ``mesh_dim_names`` without its ranks — for resolving specs where
    no process group is open."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the batch: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _entry(axes: Tuple[str, ...]):
    """One spec entry for ``axes``: None, the bare name, or the tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                 mesh, rules: Optional[Dict[str, Optional[str]]] = None
                 ) -> tuple:
    """The spec of one parameter, with divisibility fallback: a logical
    axis takes its mesh axis if the mesh has it, no earlier dim took it
    and the dim divides it; trailing Nones trimmed."""
    rules = rules or LOGICAL_RULES
    sizes = _sizes(mesh)
    out = []
    used = set()
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax) if ax else None
        if (mesh_ax and mesh_ax in sizes and mesh_ax not in used
                and dim % sizes[mesh_ax] == 0):
            out.append(mesh_ax)
            used.add(mesh_ax)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """One ``DTensor`` placement a mesh dim for ``spec``: ``Shard(d)`` on
    each mesh dim that tensor dim d's entry names, ``Replicate()`` on the
    others.  An entry of several axes must name them in mesh-dim order
    (``DTensor``'s split order), and no axis may shard two dims.  A mesh
    dim of size 1 is ``Replicate()`` whatever the spec: the same layout,
    and ``DTensor`` cannot reshape a size-1 tensor dim it calls sharded
    (a batch of 1 on the (1, 1) mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    ones = {a for a, n in _sizes(mesh).items() if n == 1}
    out: list = [Replicate()] * len(names)
    used = set()
    for dim, entry in enumerate(spec):
        idx = []
        for ax in _entry_axes(entry):
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not an axis of "
                                 f"the mesh {names}")
            i = names.index(ax)
            if ax in used:
                raise ValueError(f"spec {spec} uses the mesh axis {ax!r} "
                                 "twice")
            used.add(ax)
            idx.append(i)
            out[i] = Replicate() if ax in ones else Shard(dim)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} spans {entry} out of "
                             f"the mesh's order {names}")
    return out


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec: the counterpart of JAX's ``NamedSharding`` (a
    leaf of the port's tree walkers, which open namedtuples)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """Each device's local shape of a tensor of ``shape``."""
        sizes = _sizes(self.mesh)
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _entry_axes(entry))
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide {n} ({entry})")
            out[dim] //= n
        return tuple(out)


_CURRENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the current mesh in this thread
    for the block, as JAX's ``set_mesh``: ``models.layers.constrain``
    redistributes activations against it.  Inside, a plain tensor that
    meets a ``DTensor`` is taken as replicated on its mesh
    (``implicit_replication``): positions, masks and tables the model
    makes with ``torch.arange`` are the same on every rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    stack = _CURRENT.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        stack.pop()


def current_mesh():
    """The innermost :func:`use_mesh` mesh of this thread, or None."""
    stack = getattr(_CURRENT, "stack", None)
    return stack[-1] if stack else None


def distribute(x, sharding: Sharding):
    """``x`` (the same full tensor on every rank of the mesh, or a meta
    tensor) as a ``DTensor`` under ``sharding``: each rank keeps its own
    shard, split locally with no collective; a rank outside the mesh
    keeps an empty one."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def param_shardings(axes_tree, shapes_tree, mesh,
                    rules: Optional[Dict[str, Optional[str]]] = None):
    """A ``Sharding`` tree for a parameter tree (``shapes_tree``: any
    leaves with a ``shape``)."""
    return tree_map(lambda axes, x: Sharding(mesh, resolve_spec(
        tuple(axes), tuple(x.shape), mesh, rules)), axes_tree, shapes_tree)


def _dp(mesh) -> Tuple[Any, int]:
    """The batch entry of a spec and the batch axes' size."""
    dp = data_axes(mesh)
    sizes = _sizes(mesh)
    return _entry(dp), math.prod(sizes[a] for a in dp)


def batch_shardings(batch_tree, mesh):
    """Shard batch dims over ('pod', 'data'); sequence stays unsharded for
    training (activations shard over model inside the computation)."""
    dp, dp_size = _dp(mesh)

    def one(x):
        nd = len(x.shape)
        if nd == 0:
            return Sharding(mesh, ())
        return Sharding(mesh, (dp if x.shape[0] % dp_size == 0 else None,)
                        + (None,) * (nd - 1))

    return tree_map(one, batch_tree)


def cache_shardings(cache_tree, mesh, cfg, seq_axis_shard: bool = True):
    """Decode caches: batch over ('pod', 'data'), cache sequence dim over
    'model' (SP).  Batch-1 long-context: state heads over 'model',
    replicate elsewhere.  Layout conventions per ``models.cache_specs``."""
    dp, dp_size = _dp(mesh)
    sizes = _sizes(mesh)
    mdl = sizes.get("model")
    state_dim = getattr(cfg, "shard_state_dim", False)

    def one(name, shp):
        spec = [None] * len(shp)

        def put(i, entry, n):
            if entry is not None and n and shp[i] % n == 0:
                spec[i] = entry

        # leading dim is the stacked-layer axis for most entries
        if name in ("k", "v", "attn_k", "attn_v"):  # [L, B, KV, S, hd]
            put(1, dp, dp_size)
            if seq_axis_shard:
                put(3, "model", mdl)
        elif name == "ckv":  # [L, B, S, lora]
            put(1, dp, dp_size)
            if seq_axis_shard:
                put(2, "model", mdl)
        elif name == "enc_out":
            put(0, dp, dp_size)
        elif name in ("mlstm_S", "mlstm_n"):
            # [G, M, B, nh, ...] — batch over data; heads over model, OR
            # (shard_state_dim) the last feature dim: nh is usually tiny
            # (xlstm: 4) and falls back to full replication
            put(2, dp, dp_size)
            put(len(shp) - 1 if state_dim else 3, "model", mdl)
        elif name in ("slstm_h", "slstm_c", "slstm_n"):
            put(1, dp, dp_size)
            put(len(shp) - 1 if state_dim else 2, "model", mdl)
        elif name in ("conv", "S"):
            # [L, B, ...] mamba states: batch over data, channel/head dim
            # over model
            put(1, dp, dp_size)
            put(2, "model", mdl)
        while spec and spec[-1] is None:
            spec.pop()
        return Sharding(mesh, tuple(spec))

    return tree_unflatten(cache_tree, [
        one(path[-1] if path else "", tuple(x.shape))
        for path, x in tree_items(cache_tree)])
