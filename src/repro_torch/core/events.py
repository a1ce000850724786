"""Discrete-event machinery: global clock + ordered event queue."""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# Event kinds (paper §III-B: request events + client events, plus the
# extensions for comm, faults and elastic scaling)
REQUEST_ARRIVAL = "request_arrival"
STAGE_DISPATCH = "stage_dispatch"          # request handed to a client
CLIENT_STEP_DONE = "client_step_done"      # one engine step completed
TRANSFER_DONE = "transfer_done"            # inter-client data transfer done
CLIENT_FAIL = "client_fail"
CLIENT_RECOVER = "client_recover"
CLIENT_ADD = "client_add"                  # elastic scale-out
CLIENT_REMOVE = "client_remove"
STRAGGLER_CHECK = "straggler_check"        # per-dispatch rescue deadline
PREFIX_MIGRATE = "prefix_migrate"          # start shipping a radix KV chain
MIGRATE_DONE = "migrate_done"              # migrated chain landed at dst
AUTOSCALE_CHECK = "autoscale_check"        # periodic closed-loop controller tick


@dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    payload: Any = field(compare=False, default=None)


class EventQueue:
    def __init__(self):
        self._heap = []
        self._counter = itertools.count()
        self.now = 0.0
        self.popped = 0     # lifetime pops — the simulator-cost metric

    def push(self, time: float, kind: str, payload=None) -> Event:
        assert time >= self.now - 1e-12, (time, self.now, kind)
        ev = Event(time, next(self._counter), kind, payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Optional[Event]:
        if not self._heap:
            return None
        ev = heapq.heappop(self._heap)
        # global clock: monotone, no client may run ahead (paper §III-B)
        self.now = max(self.now, ev.time)
        self.popped += 1
        return ev

    def __len__(self):
        return len(self._heap)

    def peek_time(self) -> Optional[float]:
        return self._heap[0].time if self._heap else None
