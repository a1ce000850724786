"""Metrics collection (paper §III-F2): request / scheduler / client / global."""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request


def percentile(vals: Sequence[float], p: float) -> float:
    if not len(vals):
        return float("nan")
    return float(np.percentile(np.asarray(vals), p))


def simulator_stats(coord) -> Dict[str, float]:
    """Simulator-cost counters for a finished run: heap events popped, engine
    iterations actually simulated (fast-forward macro-steps count their full
    window), windows planned, and per-client step events. Deliberately kept
    OUT of ``MetricsCollector.summary()`` — the summary is a statement about
    the modeled system and must be bit-identical whether or not the decode
    fast-forward engine collapsed the event stream that produced it."""
    out = {"events_popped": coord.queue.popped,
           "micro_steps": 0, "macro_windows": 0, "step_events": 0}
    for c in coord.clients.values():
        sched = c.scheduler
        out["micro_steps"] += getattr(sched, "micro_steps", 0)
        out["macro_windows"] += getattr(sched, "macro_windows", 0)
        # prefer the monotonic counter: with SchedulerLimits.history_limit
        # the history deque drops old entries (or is disabled outright), so
        # its length undercounts; the counter survives either way
        se = getattr(sched, "step_events", None)
        out["step_events"] += (se if se is not None
                               else len(getattr(sched, "history", ())))
    return out


@dataclass(frozen=True)
class SLO:
    """Paper Table II: slowdowns over baseline TTFT/TPOT; all six must hold."""
    ttft_base: float = 0.250
    tpot_base: float = 0.025
    ttft_mult: Dict[int, float] = field(
        default_factory=lambda: {50: 2.0, 90: 3.0, 99: 6.0})
    tpot_mult: Dict[int, float] = field(
        default_factory=lambda: {50: 1.25, 90: 1.5, 99: 5.0})

    def satisfied(self, ttfts: Sequence[float], tpots: Sequence[float]) -> bool:
        for p, m in self.ttft_mult.items():
            if percentile(ttfts, p) > self.ttft_base * m:
                return False
        for p, m in self.tpot_mult.items():
            if percentile(tpots, p) > self.tpot_base * m:
                return False
        return True


class MetricsCollector:
    def __init__(self):
        self.serviced: List[Request] = []
        self.dropped: List[Request] = []
        self.comm_events: int = 0
        self.comm_bytes: float = 0.0
        # KV paging (paper §III-D admission control + §III-E3 tiering):
        # wire-side swap traffic observed by the coordinator ...
        self.swap_events: int = 0
        self.swap_bytes: float = 0.0
        # prefill->decode KV bytes that never shipped because the decode
        # client's radix cache already held the prefix pages
        self.kv_transfer_dedup_bytes: float = 0.0
        # cross-client radix prefix migrations: completed transfers and the
        # wire bytes they put on Network links (the per-allocator view —
        # blocks imported/refused, hit tokens on migrated pages — folds in
        # from allocator stats below)
        self.kv_migrations: int = 0
        self.kv_migrated_bytes: float = 0.0
        # ... and allocator counters aggregated over clients at run() end
        # (clients retired mid-run fold into _kv_retired so their history
        # survives removal; collect_kv recomputes, so it is idempotent)
        _zero = {"page_faults": 0, "admission_failures": 0, "evictions": 0,
                 "swap_ins": 0, "swap_bytes_out": 0.0, "swap_bytes_in": 0.0,
                 "recompute_drops": 0, "peak_blocks": 0,
                 # shared-prefix radix cache
                 "prefix_hit_tokens": 0, "prefix_hit_blocks": 0,
                 "prefix_tokens_seen": 0,
                 "cow_forks": 0, "cow_copied_blocks": 0,
                 "radix_evictions": 0, "shared_blocks": 0,
                 "block_refs_total": 0, "blocks_allocated_total": 0,
                 # cross-client prefix migration
                 "migrated_out_blocks": 0, "migrated_in_blocks": 0,
                 "migration_refused_blocks": 0, "migration_hit_tokens": 0}
        self.kv: Dict[str, float] = dict(_zero)
        self._kv_retired: Dict[str, float] = dict(_zero)
        # latency arrays memoized on len(serviced): requests are terminal
        # once complete() sees them, and serviced is append-only, so the
        # count is a sufficient cache key. One O(R) pass serves the ~8
        # property reads a summary() used to pay separately for.
        self._lat_key: int = -1
        self._lat: tuple = ([], [], [])
        # completion-time array for the sliding-window views, grown
        # incrementally (append-only, like serviced itself). Events pop in
        # nondecreasing time order and complete() runs at event time, so the
        # array is sorted — window boundaries resolve by bisection. The
        # windowed-metrics regression test recomputes from the raw list to
        # guard both the sort assumption and this cache's invalidation.
        self._ct: List[float] = []

    def complete(self, req: Request):
        self.serviced.append(req)

    def drop(self, req: Request):
        self.dropped.append(req)

    def observe_step_swaps(self, step):
        """Per-step wire traffic from swap/recompute preemptions."""
        nbytes = getattr(step, "swap_bytes", 0.0)
        if nbytes > 0:
            self.swap_events += 1
            self.swap_bytes += nbytes

    # high-water-mark counters fold with max, the rest accumulate
    _KV_PEAKS = ("peak_blocks", "shared_blocks")

    @classmethod
    def _fold_kv(cls, totals: Dict[str, float], stats: Dict):
        for k in totals:
            if k in cls._KV_PEAKS:
                totals[k] = max(totals[k], stats.get(k, 0))
            else:
                totals[k] += stats.get(k, 0)

    def retire_client_kv(self, client):
        """Preserve a removed client's allocator counters before it is
        dropped from the coordinator's client map."""
        stats = client.kv_stats() if hasattr(client, "kv_stats") else {}
        self._fold_kv(self._kv_retired, stats)

    def collect_kv(self, clients):
        """Recompute run totals from retired + live clients (idempotent)."""
        totals = dict(self._kv_retired)
        for c in clients:
            self._fold_kv(totals, c.kv_stats() if hasattr(c, "kv_stats")
                          else {})
        self.kv = totals

    # ------------------------------------------------------------------
    def _latency_arrays(self) -> tuple:
        """(ttfts, tpots, e2es) in one pass over ``serviced``, cached."""
        if self._lat_key != len(self.serviced):
            ttfts: List[float] = []
            tpots: List[float] = []
            e2es: List[float] = []
            for r in self.serviced:
                if r.ttft is not None:
                    ttfts.append(r.ttft)
                if r.tpot is not None and r.decoded_tokens > 1:
                    tpots.append(r.tpot)
                if r.e2e is not None:
                    e2es.append(r.e2e)
            self._lat = (ttfts, tpots, e2es)
            self._lat_key = len(self.serviced)
        return self._lat

    @property
    def ttfts(self) -> List[float]:
        return self._latency_arrays()[0]

    @property
    def tpots(self) -> List[float]:
        return self._latency_arrays()[1]

    @property
    def e2es(self) -> List[float]:
        return self._latency_arrays()[2]

    def total_tokens(self) -> int:
        return sum(r.decoded_tokens * r.branches for r in self.serviced)

    def throughput(self, horizon: float) -> float:
        return self.total_tokens() / max(horizon, 1e-9)

    def goodput(self, slo: SLO, horizon: float) -> float:
        """Tokens/sec from requests individually meeting TTFT-P50&TPOT-P50."""
        tok = 0
        ttft_cap = slo.ttft_base * slo.ttft_mult[50]
        tpot_cap = slo.tpot_base * slo.tpot_mult[50]
        for r in self.serviced:
            if ((r.ttft or 1e9) <= ttft_cap
                    and (r.tpot if r.tpot is not None else 0.0) <= tpot_cap):
                tok += r.decoded_tokens * r.branches
        return tok / max(horizon, 1e-9)

    def goodput_by_tier(self, slos, horizon: float) -> Dict[str, float]:
        """Per-tier goodput: ``slos`` is either one SLO applied to every
        observed ``Request.tier``, or a mapping tier -> SLO (tiers without an
        entry fall back to the mapping's ``"default"`` key, else are skipped).
        One pass over ``serviced``; tiers with no serviced requests do not
        appear."""
        caps: Dict[str, tuple] = {}
        tok: Dict[str, int] = {}
        for r in self.serviced:
            tier = getattr(r, "tier", "default")
            if tier not in caps:
                slo = (slos if isinstance(slos, SLO)
                       else slos.get(tier, slos.get("default")))
                if slo is None:
                    caps[tier] = None
                else:
                    caps[tier] = (slo.ttft_base * slo.ttft_mult[50],
                                  slo.tpot_base * slo.tpot_mult[50])
                tok[tier] = 0
            if caps[tier] is None:
                continue
            ttft_cap, tpot_cap = caps[tier]
            if ((r.ttft or 1e9) <= ttft_cap
                    and (r.tpot if r.tpot is not None else 0.0) <= tpot_cap):
                tok[tier] += r.decoded_tokens * r.branches
        return {t: n / max(horizon, 1e-9)
                for t, n in tok.items() if caps[t] is not None}

    # ------------------------------------------------------------------
    # sliding-window views (closed-loop autoscaler observations): recent,
    # not cumulative, health. A window is the closed completion-time
    # interval [since, until]; ``until=None`` means "everything so far".
    # ------------------------------------------------------------------
    def _completion_times(self) -> List[float]:
        ct = self._ct
        sv = self.serviced
        if len(ct) < len(sv):
            for r in sv[len(ct):]:
                t = r.completion_time
                ct.append(float("inf") if t is None else t)
        return ct

    def window_view(self, since: float,
                    until: Optional[float] = None) -> List[Request]:
        """Requests whose completion time falls in ``[since, until]``, in
        completion order (a contiguous slice of ``serviced``)."""
        ct = self._completion_times()
        lo = bisect_left(ct, since)
        hi = len(ct) if until is None else bisect_right(ct, until)
        return self.serviced[lo:hi]

    @staticmethod
    def _tier_caps(slos, tier: str):
        """P50 (ttft_cap, tpot_cap) for ``tier`` under one SLO or a
        tier->SLO mapping (same fallback rules as ``goodput_by_tier``);
        None when the tier has no SLO."""
        slo = (slos if isinstance(slos, SLO)
               else slos.get(tier, slos.get("default")))
        if slo is None:
            return None
        return (slo.ttft_base * slo.ttft_mult[50],
                slo.tpot_base * slo.tpot_mult[50])

    def window_stats(self, since: float, until: Optional[float] = None,
                     slos=None) -> Dict:
        """One-pass recent-health summary over the ``[since, until]``
        completion window: serviced/token counts, TTFT/TPOT percentiles,
        and — when ``slos`` is given (one SLO or a tier->SLO mapping) —
        per-tier SLO-attainment fractions and windowed goodput. Goodput
        divides by the window span, so ``until`` defaults to the newest
        completion when open-ended. Matches a brute-force recompute over
        the raw ``serviced`` list by contract (regression-tested)."""
        reqs = self.window_view(since, until)
        ttfts: List[float] = []
        tpots: List[float] = []
        tokens = 0
        caps: Dict[str, Optional[tuple]] = {}
        ok: Dict[str, int] = {}
        n_tier: Dict[str, int] = {}
        good_tok: Dict[str, int] = {}
        for r in reqs:
            tokens += r.decoded_tokens * r.branches
            if r.ttft is not None:
                ttfts.append(r.ttft)
            if r.tpot is not None and r.decoded_tokens > 1:
                tpots.append(r.tpot)
            if slos is None:
                continue
            tier = getattr(r, "tier", "default")
            if tier not in caps:
                caps[tier] = self._tier_caps(slos, tier)
                ok[tier] = n_tier[tier] = good_tok[tier] = 0
            if caps[tier] is None:
                continue
            n_tier[tier] += 1
            ttft_cap, tpot_cap = caps[tier]
            if ((r.ttft or 1e9) <= ttft_cap
                    and (r.tpot if r.tpot is not None else 0.0) <= tpot_cap):
                ok[tier] += 1
                good_tok[tier] += r.decoded_tokens * r.branches
        end = until
        if end is None:
            end = max((c for c in (r.completion_time for r in reqs)
                       if c is not None), default=since)
        span = max(end - since, 1e-9)
        out: Dict = {
            "since": since, "until": end, "n": len(reqs), "tokens": tokens,
            "ttft_p50": percentile(ttfts, 50),
            "ttft_p90": percentile(ttfts, 90),
            "tpot_p50": percentile(tpots, 50),
            "tpot_p90": percentile(tpots, 90),
        }
        if slos is not None:
            out["slo_frac_by_tier"] = {
                t: ok[t] / n_tier[t] for t in n_tier if n_tier[t] > 0}
            scored = sum(n_tier.values())
            out["slo_frac"] = (sum(ok.values()) / scored if scored else None)
            out["goodput_by_tier"] = {t: good_tok[t] / span for t in good_tok
                                      if caps[t] is not None}
            out["goodput_tok_s"] = sum(good_tok.values()) / span
        return out

    def summary(self, horizon: Optional[float] = None,
                total_energy: float = 0.0, slo: Optional[SLO] = None) -> Dict:
        ttfts, tpots, e2es = self._latency_arrays()
        horizon = horizon or (max(e2es, default=0.0) + 1e-9)
        s = {
            "n_serviced": len(self.serviced),
            "n_dropped": len(self.dropped),
            "tokens": self.total_tokens(),
            "throughput_tok_s": self.throughput(horizon),
            "ttft_mean": float(np.mean(ttfts)) if ttfts else float("nan"),
            "tpot_mean": float(np.mean(tpots)) if tpots else float("nan"),
            "e2e_mean": float(np.mean(e2es)) if e2es else float("nan"),
        }
        for p in (50, 90, 99):
            s[f"ttft_p{p}"] = percentile(ttfts, p)
            s[f"tpot_p{p}"] = percentile(tpots, p)
            s[f"e2e_p{p}"] = percentile(e2es, p)
        if total_energy > 0:
            s["energy_j"] = total_energy
            s["tok_per_joule"] = s["tokens"] / total_energy
        s["preemptions"] = sum(r.preemptions for r in self.serviced)
        s["swap_events"] = self.swap_events
        s["swap_bytes"] = self.swap_bytes
        s["kv_transfer_dedup_bytes"] = self.kv_transfer_dedup_bytes
        s["kv_migrations"] = self.kv_migrations
        s["kv_migrated_bytes"] = self.kv_migrated_bytes
        for k, v in self.kv.items():
            s[f"kv_{k}"] = v
        # logical block references per physical block allocated (>= 1; 1 means
        # no page was ever shared) — the radix cache's dedup factor
        s["kv_dedup_ratio"] = (self.kv["block_refs_total"]
                               / max(1, self.kv["blocks_allocated_total"]))
        if slo is not None:
            s["slo_ok"] = self.slo_satisfied(slo)
            s["goodput_tok_s"] = self.goodput(slo, horizon)
        return s

    def slo_satisfied(self, slo: SLO) -> bool:
        return slo.satisfied(self.ttfts, self.tpots)
