"""Meshes on ``torch.distributed`` — the port of the JAX package's
``launch/mesh.py``.

A JAX ``Mesh`` with named axes becomes a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``:
``("peel",)`` for the flat peel mesh, ``("grp", "loc")`` for the
two-stage one, and the LM meshes ``("data", "model")`` (16 × 16, one
pod) and ``("pod", "data", "model")`` (2 × 16 × 16) that the sharding
rules (``sharding.partition``) resolve against.  Each needs a default
process group: :func:`init_peel_group` opens it from the ``torchrun``
environment (``python -m torch.distributed.run``), or the caller opens
one itself (the LM dry-run: a fake group of 256 or 512 ranks).  Nothing
here runs at import.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "PRODUCTION_MESHES",
    "fake_group",
    "init_peel_group",
    "make_local_mesh",
    "make_peel_mesh",
    "make_peel_mesh_2d",
    "make_production_mesh",
]

# (shape, axis names) of the LM production meshes, by multi_pod: 256
# chips as one pod, 512 as two
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_peel_group(device: str = "cuda", backend: Optional[str] = None
                    ) -> torch.device:
    """Open the default process group from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and the rendezvous
    ``MASTER_ADDR`` / ``MASTER_PORT``) and return this rank's device:
    ``cuda:{LOCAL_RANK % device_count}`` on ``device="cuda"`` (made the
    current device), the CPU on ``device="cpu"``.

    ``backend`` defaults to ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``.
    NCCL takes one rank per card, so ``nccl`` with more ranks than cards
    raises; ``gloo`` runs any number of ranks, several on one card (their
    collectives then pass through the host).  Nothing is switched
    quietly: a ``cuda`` device with no card raises too."""
    kind = torch.device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "--device cpu (backend gloo) to peel on the CPU")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and world > n_cards:
            raise ValueError(
                f"nccl runs one rank per card: {world} ranks on {n_cards} "
                "card(s); pass --backend gloo to run several ranks on one "
                "card")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
        # a live context on this card before any DeviceMesh is built, so
        # the mesh keeps it instead of picking cuda:LOCAL_RANK itself
        torch.zeros((1,), device=dev)
    elif backend == "nccl":
        raise ValueError("nccl needs device='cuda'; the CPU takes gloo")
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, rank=rank, world_size=world)
    return dev


def _mesh(device: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def make_peel_mesh(n_devices: Optional[int] = None, device: str = "cuda"):
    """1-D ``("peel",)`` mesh for distributed graph peeling (CD index
    shards / FD partitions); ``n_devices`` defaults to the world size."""
    n = n_devices or dist.get_world_size()
    return _mesh(device, (n,), ("peel",))


def make_peel_mesh_2d(n_devices: Optional[int] = None,
                      groups: Optional[int] = None, device: str = "cuda"):
    """2-D ``("grp", "loc")`` mesh for hierarchical CD collectives.

    The CD round's single logical reduction runs staged over this mesh
    (``core.distributed._all_reduce_staged`` with ``("grp", "loc")``):
    within each group of ``loc`` co-located ranks, then across the
    ``groups`` groups.  ``groups`` defaults to the largest power of two
    with groups² ≤ n that divides n (8 → 2×4, 512 → 16×32); for n = 1
    the mesh is (1, 1) and the staged reduction is a pair of no-ops."""
    n = n_devices or dist.get_world_size()
    if groups is None:
        groups = 1
        while groups * 2 * groups * 2 <= n and n % (groups * 2) == 0:
            groups *= 2
    if n % groups:
        raise ValueError(f"groups={groups} does not divide n={n}")
    return _mesh(device, (groups, n // groups), ("grp", "loc"))


def _world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a default process group: open one "
                           "first (init_peel_group, or "
                           "torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16×16 ``("data", "model")`` single pod (256 ranks) or 2×16×16
    ``("pod", "data", "model")`` two-pod (512 ranks); the process group
    must have exactly that many ranks."""
    shape, names = PRODUCTION_MESHES[multi_pod]
    world = _world("make_production_mesh")
    if world != math.prod(shape):
        raise ValueError(f"the {'two-pod' if multi_pod else 'one-pod'} mesh "
                         f"{shape} takes {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    return _mesh(device, shape, names)


def _local_mesh_shape(n: int) -> tuple:
    """The JAX package's local mesh for n devices: (1, 1) for one, else
    (n // m, m) with m = 2 if n is even (1 if odd)."""
    if n == 1:
        return (1, 1)
    m = 2 if n % 2 == 0 else 1
    return (n // m, m)


def make_local_mesh(device: str = "cuda"):
    """Whatever this job has: a ``("data", "model")`` mesh over every rank
    of the default process group (``_local_mesh_shape`` of its size)."""
    n = _world("make_local_mesh")
    return _mesh(device, _local_mesh_shape(n), ("data", "model"))


@contextlib.contextmanager
def fake_group(n: int):
    """A fake process group of ``n`` ranks, this process rank 0, for the
    dry-runs: meshes and ``DTensor`` placement run, collectives complete
    and move no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry-run opens its own fake process group, "
                           "and one is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
