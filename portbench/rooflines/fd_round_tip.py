"""Operations and bytes of ``fd_round_tip`` calls (``kernels/csrc/
fd_round.cu``), from the shapes and state of each call.

One call is one FD round over B stacked partitions: the launches
``fd_advance``, ``fd_tip_pairs`` and ``fd_apply``.  There is no
arithmetic to speak of (integer compares and adds), so the bound is
bytes.  Per call, counting each input byte read once and each output
byte written once, and only what the inputs need:

* a live partition (one with a vertex left at the round's start) reads
  its support and alive rows (2 x 4E bytes), writes its support, alive
  and theta rows (3 x 4E), and reads its real pair entries, 12 bytes a
  pair (pa, pb, bf); padding pairs (bf = 0) are not counted;
* a partition already drained reads its alive row (4E) and nothing else.

Which partitions were live in which call is not read during the run:
the kernel adds 1 to ``rounds[b]`` each round that partition b is live,
so the live partition-rounds of one FD loop are the growth of its
``rounds`` tensor from its first call to its last.
"""
from __future__ import annotations

__all__ = ["TARGET", "DEVICE_KERNELS", "SHARES_KERNELS_WITH", "OPS_KIND",
           "Calls"]

TARGET = ("repro_torch.kernels.ops", "fd_round_tip")
DEVICE_KERNELS = ("fd_advance", "fd_tip_pairs", "fd_apply")
# fd_round_wing launches fd_advance and fd_apply too
SHARES_KERNELS_WITH = ("fd_round_wing",)
OPS_KIND = None


class Calls:
    """Records each call's shapes and its loop's state tensors."""

    def __init__(self):
        self.loops = {}     # id(rounds) -> [rounds, start, bf, calls, E]

    def on_call(self, sup, alive, theta, k, rounds, pa, pb, bf):
        key = id(rounds)
        if key not in self.loops:
            self.loops[key] = [rounds, rounds.clone(), bf, 0, sup.shape[1]]
        self.loops[key][3] += 1

    def totals(self):
        """(operations, bytes) of every recorded call."""
        n_bytes = 0
        for rounds, start, bf, calls, E in self.loops.values():
            live = (rounds - start).reshape(-1).cpu().long()
            pairs = (bf != 0).sum(dim=1).cpu().long()
            B = live.numel()
            live_rounds = int(live.sum())
            dead_rounds = calls * B - live_rounds
            n_bytes += (20 * E * live_rounds + 12 * int((live * pairs).sum())
                        + 4 * E * dead_rounds)
        return 0, n_bytes
