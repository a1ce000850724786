"""Window arithmetic: what the end-to-end metrics take from the served
requests. Times are host monotonic seconds. Each metric is taken over the
whole window ``[w0, w1)``, never from medians of parts of it.

``percentile`` is a frozen copy of ``repro_torch/core/metrics.py`` at
commit 1253b8593d7c (last changed there in 19092fce30c1).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


# -- frozen copy (repro_torch/core/metrics.py @ 1253b8593d7c) ---------------

def percentile(vals: Sequence[float], p: float) -> float:
    if not len(vals):
        return float("nan")
    return float(np.percentile(np.asarray(vals), p))


# ---------------------------------------------------------------------------

class Served:
    """One request as the benchmark saw it: its due time, the token times
    the program stamped, and whether it was refused at submission."""

    def __init__(self, due: float, req=None, refused: bool = False):
        self.due = due
        self.req = req
        self.refused = refused

    @property
    def first(self) -> Optional[float]:
        return None if self.req is None else self.req.first_token_time

    @property
    def times(self) -> List[float]:
        return [] if self.req is None else self.req.token_times


def ttfts_ms(served: List[Served], w0: float, w1: float,
             end: float) -> List[float]:
    """First-token time less due time of every request due in the window.
    One without a first token by ``end`` counts at its wait until ``end``
    (censored); a refused one counts as missed, at the same wait."""
    out = []
    for s in served:
        if not w0 <= s.due < w1:
            continue
        first = s.first
        t = end if (s.refused or first is None or first > end) else first
        out.append((t - s.due) * 1e3)
    return out


def gaps_ms(served: List[Served], w0: float, w1: float) -> List[float]:
    """Every gap between two consecutive streamed tokens of one request
    whose later token falls in the window."""
    out = []
    for s in served:
        ts = s.times
        out.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]) if w0 <= b < w1)
    return out


def tokens_in(served: List[Served], w0: float, w1: float) -> int:
    """Output tokens streamed in the window."""
    return sum(sum(1 for t in s.times if w0 <= t < w1) for s in served)
