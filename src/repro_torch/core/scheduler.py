"""Base schedulers for single-step clients (paper §III-D).

* ``BatchedScheduler`` — tasks with reuse (RAG lookup, KV retrieval): all
  queued requests run as one batch per step.
* ``SequentialScheduler`` — no-reuse tasks (padding, truncation, detokenize):
  available cores drain the queue linearly.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

from repro_torch.core.request import Request


@dataclass
class SimpleStep:
    requests: List[Request]
    duration: float
    energy: float = 0.0


def _take_head(waiting: Deque[Request], n: int) -> List[Request]:
    """Pop up to ``n`` requests off the queue head — O(batch), not the
    O(queue) slice-and-copy the list version paid every step."""
    return [waiting.popleft() for _ in range(min(n, len(waiting)))]


class BatchedScheduler:
    def __init__(self, latency_fn: Callable[[List[Request]], float],
                 max_batch: int = 256, energy_fn=None):
        self.latency_fn = latency_fn
        self.energy_fn = energy_fn
        self.max_batch = max_batch
        self.waiting: Deque[Request] = deque()

    def add(self, req: Request):
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting)

    def plan_step(self) -> Optional[SimpleStep]:
        if not self.waiting:
            return None
        batch = _take_head(self.waiting, self.max_batch)
        dur = self.latency_fn(batch)
        en = self.energy_fn(batch, dur) if self.energy_fn else 0.0
        return SimpleStep(batch, dur, en)

    def finish_step(self, step: SimpleStep, now: float) -> List[Request]:
        return step.requests

    def requeue_step(self, step: SimpleStep) -> None:
        """An in-flight step is being discarded unfinished (client fail or
        removal): planning popped its requests off ``waiting``, so without
        putting them back ``drain()`` would silently lose them."""
        self.waiting.extendleft(reversed(step.requests))

    def drain(self) -> List[Request]:
        out = list(self.waiting)
        self.waiting.clear()
        return out


class SequentialScheduler:
    """n_cores parallel lanes, linear within a lane."""

    def __init__(self, per_request_fn: Callable[[Request], float],
                 n_cores: int = 8, energy_fn=None):
        self.per_request_fn = per_request_fn
        self.energy_fn = energy_fn
        self.n_cores = n_cores
        self.waiting: Deque[Request] = deque()

    def add(self, req: Request):
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting)

    def plan_step(self) -> Optional[SimpleStep]:
        if not self.waiting:
            return None
        batch = _take_head(self.waiting, self.n_cores)
        dur = max(self.per_request_fn(r) for r in batch)
        en = self.energy_fn(batch, dur) if self.energy_fn else 0.0
        return SimpleStep(batch, dur, en)

    def finish_step(self, step: SimpleStep, now: float) -> List[Request]:
        return step.requests

    def requeue_step(self, step: SimpleStep) -> None:
        self.waiting.extendleft(reversed(step.requests))

    def drain(self) -> List[Request]:
        out = list(self.waiting)
        self.waiting.clear()
        return out
