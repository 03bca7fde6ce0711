"""KV-cache slot management for continuous batching (counterpart of
``mxnet_tpu/serving/kv_slots.py``).

The engine owns one persistent batched KV cache per layer: rows
0..S-1 are slots a request leases for its lifetime, row S is scratch
(the target of padding rows in a bucketed prefill and of free slots in
a decode step, which runs every row), and in the dense layout rows
S+1..S+P are the prefix pool (:mod:`.prefix_cache`), written only by
the engine's row-to-row copies.  Continuous batching falls out of rows
sitting at independent positions.  A lease runs admit → [prefix copy →
chunked prefill …] → decode … → free.  Scheduler-thread-only: the
engine serializes all access.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .errors import ServingError

__all__ = ["SlotState", "SlotAllocator"]


class SlotState:
    """Decode-time state of one leased slot.  A slot is prefilling until
    its first token sets ``last_token``; ``filled`` counts the cache
    positions already populated (a prefix-cache hit plus completed
    prefill chunks); ``pos`` is the position of ``last_token``, where
    the next decode step writes its K/V.  ``pinned`` holds the prefix
    entry this slot copied from, read-pinned until its prefill ends;
    ``t_schedule`` is the admission time (the page-victim order).  In the
    paged layout ``pages`` are the slot's pages in logical order, the
    first ``pages_shared`` shared whole from a prefix entry and read-only
    to it (the NaN scrub must know which pages the slot could have
    written); ``waiting`` marks a slot whose page claim was deferred this
    cycle (it sits out prefill and decode until the pages come)."""

    __slots__ = ("request", "prompt_len", "pos", "last_token", "generated",
                 "max_new_tokens", "tokens", "filled", "pinned", "t_first",
                 "t_schedule", "pages", "pages_shared", "waiting")

    def __init__(self, request, prompt_len: int, max_new_tokens: int,
                 tokens=None):
        self.request = request
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.pos = prompt_len
        self.last_token: Optional[int] = None
        self.generated: List[int] = []
        self.tokens = tokens
        self.filled = 0               # populated K/V positions [0, filled)
        self.pinned = None            # prefix entry read while prefilling
        self.t_first: Optional[float] = None
        self.t_schedule: Optional[float] = None
        self.pages: List[int] = []
        self.pages_shared = 0
        self.waiting = False

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def prefilling(self) -> bool:
        return self.last_token is None

    @property
    def remaining(self) -> int:
        """Decode budget left: what speculation may accept at most."""
        return self.max_new_tokens - len(self.generated)

    def advance(self, token: int):
        """Record one generated token; generated[i] sits at position
        prompt_len + i, so pos tracks the last token's position."""
        self.generated.append(token)
        self.last_token = token
        self.pos = self.prompt_len + len(self.generated) - 1

    def advance_many(self, tokens):
        """Record a verify window's accepted tokens in order.  ``pos``
        ends at the last accepted one; K/V the verify wrote past it is
        rewritten before it can be attended, so a rejected draft rewinds
        by not advancing."""
        for t in tokens:
            self.advance(t)


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

    def __contains__(self, slot: int) -> bool:
        return slot in self._active
