"""Continuous-batching serving engine.

The port of the JAX package's ``serve/engine.py``, with its slot, EOS
and recycle semantics.  A fixed pool of batch *slots* shares one KV
cache; requests join free slots (prefill by teacher forcing on the
decode path), finished sequences retire and free their slot.  Each
iteration is one ``DenseLM.serve_step`` over every slot; the cache
(per-head keys and values, MLA's compressed ``ckv`` rows, the SSM and
hybrid families' recurrent states, or Whisper's keys and values beside
its encoder output ``enc_out``) is written in place, and zeroed
wholesale at a quiescent point, recurrent states and ``enc_out``
included.  As in the JAX package, the engine takes no frames: Whisper's
``enc_out`` starts at zero, and a caller may fill it before ``run``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import DenseLM, init_cache

__all__ = ["Request", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int = 16
    eos: Optional[int] = None  # stop at the FIRST generated eos, inclusive
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching over ``serve_step``.

    As in the JAX package, all slots advance with one shared position
    (the cache write position), reads are masked to it, and cache slots
    are recycled only at quiescent points (all slots done, or step 0).
    ``params`` must lie on ``device`` (default the card; refused where
    there is none)."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_seq: int = 128, greedy: bool = True, device="cuda"):
        dev = resolve_device(device)
        self.device = params["embed"].device
        if self.device.type != dev.type or dev.index not in (
                None, self.device.index):
            raise ValueError(f"params on {self.device}, engine on {dev}")
        self.cfg = cfg
        self.model = DenseLM(cfg, params)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.slot_len = np.zeros(n_slots, np.int64)
        self.slot_todo: List[List[int]] = [[] for _ in range(n_slots)]
        self._cache = init_cache(cfg, n_slots, max_seq, self.device,
                                 torch.float32)
        self.position = 0
        self.steps = 0

    # ------------------------------------------------------------ admin
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                self.slot_todo[i] = list(req.prompt)
                self.slot_len[i] = 0

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def pending(self) -> int:
        return len(self.queue)

    # ------------------------------------------------------------- step
    def step(self) -> None:
        """One engine iteration: admit, decode one token per slot."""
        if self.position == 0 or self.active == 0:
            self._admit()
        tok = np.zeros(self.n_slots, np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self.slot_todo[i]:
                tok[i] = self.slot_todo[i].pop(0)   # prefill (teacher)
            elif req.output:
                tok[i] = req.output[-1]
        logits, self._cache = self.model.serve_step(
            self._cache, torch.from_numpy(tok).to(self.device), self.position)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        self.position += 1
        self.steps += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_len[i] += 1
            if self.slot_todo[i]:
                continue  # still prefilling
            req.output.append(int(nxt[i]))
            # eos contract: stop at the first GENERATED eos, which is
            # included in the output; prefill (teacher-forced) tokens
            # never trigger this (the `continue` above skips them)
            hit_eos = req.eos is not None and int(nxt[i]) == req.eos
            if len(req.output) >= req.max_new or hit_eos \
                    or self.position >= self.max_seq - 1:
                req.done = True
                self.slots[i] = None
        if self.active == 0:
            # quiescent point: reset clock, recycle the cache wholesale
            self.position = 0
            for t in self._cache.values():
                t.zero_()

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drain the queue; returns all completed requests."""
        done: List[Request] = []
        seen: Dict[int, Request] = {}
        while (self.queue or self.active) and self.steps < max_steps:
            for s in self.slots:
                if s is not None:
                    seen[s.uid] = s
            self.step()
        for r in seen.values():
            if r.done:
                done.append(r)
        return sorted(done, key=lambda r: r.uid)
