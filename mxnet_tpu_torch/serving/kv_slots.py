"""KV-cache slot management for continuous batching (counterpart of
``mxnet_tpu/serving/kv_slots.py``).

The engine owns one persistent batched KV cache per layer: rows
0..S-1 are slots a request leases for its lifetime, row S is scratch
(the target of padding rows in a bucketed prefill and of free slots in
a decode step, which runs every row).  Continuous batching falls out of
rows sitting at independent positions.  Scheduler-thread-only: the
engine serializes all access.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .errors import ServingError

__all__ = ["SlotState", "SlotAllocator"]


class SlotState:
    """Decode-time state of one leased slot.  A slot is prefilling until
    its first token sets ``last_token``; ``pos`` is the position of
    ``last_token``, where the next decode step writes its K/V."""

    __slots__ = ("request", "prompt_len", "pos", "last_token", "generated",
                 "max_new_tokens", "tokens", "t_first", "pages")

    def __init__(self, request, prompt_len: int, max_new_tokens: int,
                 tokens=None):
        self.request = request
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.pos = prompt_len
        self.last_token: Optional[int] = None
        self.generated: List[int] = []
        self.tokens = tokens
        self.t_first: Optional[float] = None
        # paged layout: the slot's physical pages in logical order
        self.pages: List[int] = []

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def prefilling(self) -> bool:
        return self.last_token is None

    def advance(self, token: int):
        """Record one generated token; generated[i] sits at position
        prompt_len + i, so pos tracks the last token's position."""
        self.generated.append(token)
        self.last_token = token
        self.pos = self.prompt_len + len(self.generated) - 1


class SlotAllocator:
    """Free-list allocator over the S cache rows (scratch excluded)."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ServingError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.scratch = num_slots           # row S of the (S+1, ...) cache
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._active: Dict[int, SlotState] = {}
        self.active_highwater = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return len(self._active)

    def alloc(self, state: SlotState) -> int:
        if not self._free:
            raise ServingError("no free KV slots (admission bug: engine "
                               "must admit <= free_count)")
        slot = self._free.pop()
        self._active[slot] = state
        self.active_highwater = max(self.active_highwater,
                                    len(self._active))
        return slot

    def free(self, slot: int) -> SlotState:
        """End a lease.  Stale K/V needs no scrubbing: the next prefill
        overwrites [0, Tb) and decode rewrites each later position
        before attending it."""
        state = self._active.pop(slot)
        self._free.append(slot)
        return state

    def items(self):
        """(slot, state) pairs of active leases, slot-ordered."""
        return sorted(self._active.items())
