"""Cost accounting for the dry-run and the roofline — the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

JAX reads a compiled program: ``cost_analysis()`` for FLOPs and bytes,
and the SPMD-partitioned HLO text, parsed here for the bytes of every
collective.  The port compiles no program.  In its place, :class:`CostMode`
(a ``TorchDispatchMode``) records the ops one rank runs while the
dry-run drives the step on meta ``DTensor``s: it lets ``DTensor`` take
each op first (returns ``NotImplemented`` for them), so what it records
is what follows ``DTensor``'s dispatch on this rank — the local ops on
local shards, and the functional collectives of every redistribution.
The trace (:class:`Op` records) takes the place of the HLO text:

* ``flops`` — the local ops' FLOPs by ``torch.utils.flop_counter``'s
  formulas (``FlopCounterMode``'s): matrix products and attention
  (``kernels.flash_attention``'s count of visible (query, key) pairs).
  Elementwise work counts nothing, as ``FlopCounterMode`` counts it.
  Being local, these are per-device FLOPs, replicated work included:
  nothing is divided by the rank count.
* ``bytes`` — each non-view op's input and output bytes.  This is an
  upper bound of unfused eager traffic, where XLA's ``bytes accessed``
  is that of a fused program.
* :func:`collective_bytes` — the result-shape bytes of every collective
  per device, by JAX's kinds, as JAX's ``hlo_analysis.collective_bytes``
  counts them.  On a CPU mesh (the dry-run's fake group) ``DTensor``
  would replace an all-to-all by an all-gather and a local chunk;
  :func:`count_costs` keeps the all-to-all a CUDA mesh runs.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, NamedTuple

import torch

__all__ = ["COLLECTIVES", "CostMode", "Op", "collective_bytes", "count_costs",
           "count_ops"]

# JAX's collective kinds, in its order
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


class Op(NamedTuple):
    """One op of a rank's trace: its name (``aten.mm``), FLOPs, bytes
    read and written, and for a collective its kind and result bytes."""
    name: str
    flops: int
    bytes: int
    kind: str = ""
    out_bytes: int = 0


def _collective_kinds() -> dict:
    """{op packet: JAX kind} of the functional collectives ``DTensor``
    redistributes through."""
    c10d = torch.ops._c10d_functional
    kinds = {}
    for name, kind in (("all_reduce", "all-reduce"),
                       ("all_reduce_coalesced", "all-reduce"),
                       ("all_gather_into_tensor", "all-gather"),
                       ("all_gather_into_tensor_coalesced", "all-gather"),
                       ("reduce_scatter_tensor", "reduce-scatter"),
                       ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
                       ("all_to_all_single", "all-to-all")):
        try:
            kinds[getattr(c10d, name)] = kind
        except (AttributeError, RuntimeError):
            pass
    try:
        kinds[torch.ops._dtensor.shard_dim_alltoall] = "all-to-all"
    except (AttributeError, RuntimeError):
        pass
    return kinds


def _nbytes(tree) -> int:
    out = 0
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out += x.numel() * x.element_size()
    return out


class CostMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every op this rank runs below ``DTensor`` (see the module
    docstring) as :class:`Op`s in ``trace``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.trace: list = []
        self._flops = flop_registry  # read live: formulas registered later count
        self._kinds = _collective_kinds()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor first: record its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (isinstance(func, torch._ops.HigherOrderOperator)
                or any(issubclass(t, FakeTensor) for t in types)
                or any(isinstance(o, FakeTensor)
                       for o in torch.utils._pytree.tree_leaves(out))):
            # DTensor's sharding propagation runs ops on global-shape fake
            # tensors to learn their output's shape: not the rank's work
            return out
        packet = func._overloadpacket
        kind = self._kinds.get(packet, "")
        if kind:
            self.trace.append(Op(str(packet), 0, 0, kind, _nbytes(out)))
        elif not func.is_view and packet is not torch.ops._c10d_functional \
                .wait_tensor:
            formula = self._flops.get(packet)
            flops = formula(*args, **kwargs, out_val=out) if formula else 0
            self.trace.append(Op(str(packet), int(flops),
                                 _nbytes((args, kwargs)) + _nbytes(out)))
        return out

    @property
    def flops(self) -> int:
        return sum(op.flops for op in self.trace)

    @property
    def bytes_accessed(self) -> int:
        return sum(op.bytes for op in self.trace)


@contextlib.contextmanager
def count_costs():
    """A :class:`CostMode` over the block, with ``DTensor``'s CPU fallback
    for a Shard→Shard all-to-all (an all-gather and a chunk) replaced by
    the all-to-all itself, as a CUDA mesh runs it (on a torch without
    that hook the fallback stays and is counted as an all-gather), and
    ``flash_attention`` taking meta tensors (``flash_attention.counting``)."""
    from torch.distributed.tensor import placement_types as pt

    from ..kernels.flash_attention import counting

    original = getattr(pt, "shard_dim_alltoall", None)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    if original is not None:
        pt.shard_dim_alltoall = alltoall
    try:
        with counting(), CostMode() as mode:
            yield mode
    finally:
        if original is not None:
            pt.shard_dim_alltoall = original


def collective_bytes(trace) -> Dict[str, int]:
    """Bytes moved per collective kind (result-shape accounting, per
    device), as JAX's ``hlo_analysis.collective_bytes`` of the HLO."""
    out: Dict[str, int] = defaultdict(int)
    for op in trace:
        if op.kind:
            out[op.kind] += op.out_bytes
    return dict(out)


def count_ops(trace, opcodes=("aten.mm", "aten.bmm",
                              "repro_torch.flash_attention_count")
              ) -> Dict[str, int]:
    """How many ops of each name in ``opcodes`` the trace holds (JAX's
    counts fusions, dots and convolutions in the HLO)."""
    out = {k: 0 for k in opcodes}
    for op in trace:
        if op.name in out:
            out[op.name] += 1
    return out
