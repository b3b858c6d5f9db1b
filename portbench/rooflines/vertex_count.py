"""Operations and bytes of ``vertex_count`` calls (``kernels/csrc/
butterfly_count.cu``, ``vc::vertex_count_kernel``), from the shape of the
adjacency each ``ops.vertex_butterflies`` call is given.

One call counts Σ_{j≠r} C(W[r, j], 2) for the n rows of a 0/1 adjacency
A [n, k], W = A·Aᵀ never stored.  W is symmetric, so the function needs
only the n(n − 1)/2 pairs j > r, each a k-deep dot product: n(n − 1)k
operations (a multiply and an add each), about n²k, counted on the real
n and k, not the padded shape the kernel runs.  They run as int8 on the
tensor cores, so the bound is operations at the int8 peak, or bytes
where that is longer: the int8 operand read once (n·k bytes, the real
shape) and the int64 counts written once (8n).  The pack to int8
(``pack_s8``) is a kernel of its own and is not counted here.
"""
from __future__ import annotations

__all__ = ["TARGET", "DEVICE_KERNELS", "SHARES_KERNELS_WITH", "OPS_KIND",
           "Calls"]

TARGET = ("repro_torch.kernels.ops", "vertex_butterflies")
DEVICE_KERNELS = ("vertex_count_kernel",)
# vertex_count_tile launches vertex_count_kernel too (its other instance)
SHARES_KERNELS_WITH = ("vertex_count_tile",)
OPS_KIND = "int8"


class Calls:
    """Records the shape of each call's adjacency."""

    def __init__(self):
        self.shapes = []

    def on_call(self, A, *args, **kwargs):
        self.shapes.append((int(A.shape[0]), int(A.shape[1])))

    def totals(self):
        """(operations, bytes) of every recorded call."""
        n_ops = sum(n * (n - 1) * k for n, k in self.shapes)
        n_bytes = sum(n * k + 8 * n for n, k in self.shapes)
        return n_ops, n_bytes
