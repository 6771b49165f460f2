"""Deterministic admission for the continuous-batching engine.

Port of ``repro.serve.scheduler`` (host-only, no framework). The schedule is
a pure function of the request stream:

  1. *Admission order*: pending requests in ascending request id (FCFS by
     id: ids are the arrival clock).
  2. *Admission condition*: a free slot AND page-pool room for the request's
     worst case (``ceil((prompt + max_new) / page)`` pages, reserved up
     front): no mid-flight OOM.
  3. *Slot assignment*: the lowest-numbered free slot.
  4. *Eviction*: a finished request releases its slot and pages at the end
     of the step it finished in.

None of this reaches tokens (row-independent math, fixed page order); it
makes the schedule itself reproducible.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``id`` must be unique; a lower id is an
    earlier turn."""
    id: int
    tokens: Tuple[int, ...]
    max_new_tokens: int = 16

    def __post_init__(self):
        if len(self.tokens) == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be > 0, got "
                             f"{self.max_new_tokens}")


class FCFSScheduler:
    """FCFS-by-request-id admission over a fixed set of cache slots."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.pending: Dict[int, Request] = {}
        self.active: Dict[int, Request] = {}          # slot -> request
        self._free_slots = list(range(n_slots))
        heapq.heapify(self._free_slots)

    def submit(self, req: Request) -> None:
        if (req.id in self.pending
                or any(r.id == req.id for r in self.active.values())):
            raise ValueError(f"duplicate request id {req.id}")
        self.pending[req.id] = req

    @property
    def idle(self) -> bool:
        return not self.pending and not self.active

    def admit(self, fits: Callable[[Request], bool]
              ) -> List[Tuple[int, Request]]:
        """Admit pending requests (ascending id) while slots and pages allow;
        stop at the first that does not fit (head-of-line FCFS). If ``fits``
        raises, every admission of this call is rolled back."""
        admitted: List[Tuple[int, Request]] = []
        try:
            for rid in sorted(self.pending):
                if not self._free_slots:
                    break
                req = self.pending[rid]
                if not fits(req):
                    break
                slot = heapq.heappop(self._free_slots)
                del self.pending[rid]
                self.active[slot] = req
                admitted.append((slot, req))
        except BaseException:
            for slot, req in admitted:
                del self.active[slot]
                heapq.heappush(self._free_slots, slot)
                self.pending[req.id] = req
            raise
        return admitted

    def release(self, slot: int) -> None:
        del self.active[slot]
        heapq.heappush(self._free_slots, slot)
