"""Routing & load balancing (paper §III-B1): Round-Robin, Load-based,
Heavy-Light split and Prefix-Affinity, each parameterizable by load metrics
(input len, output len, KV size, tokens remaining) — the paper's "up to nine
distinct routing strategies". Modular: subclass Router and register.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from repro_torch.core.client import Client
from repro_torch.core.fleet import StageMembers
from repro_torch.core.request import Request

LOAD_METRICS = ("queue", "input_len", "output_len", "kv_size",
                "kv_pressure", "tokens_remaining")


class Router:
    name = "base"
    coordinator = None           # back-reference, set by Coordinator.bind

    def bind(self, coordinator) -> None:
        """Coordinator back-reference hook. Routers that can trigger
        coordinator actions — e.g. the prefix-affinity fetch policy starting
        a cross-client KV migration — reach it through ``self.coordinator``;
        plain load balancers just ignore it."""
        self.coordinator = coordinator

    def route(self, req: Request, candidates: List[Client], now: float) -> Client:
        raise NotImplementedError


class RoundRobinRouter(Router):
    """Round-robin over the *name-sorted* live candidates. Sorting pins the
    assignment under client churn: the raw candidate list follows client-dict
    order, which a CLIENT_ADD/REMOVE silently reshuffles mid-rotation (the
    same determinism fix HeavyLightRouter has). With a fleet index
    the sorted order is maintained incrementally (O(1) pick per route)."""

    name = "round_robin"

    def __init__(self):
        self._counters: Dict[str, itertools.count] = {}

    def route(self, req, candidates, now):
        key = req.current_stage.kind
        c = self._counters.setdefault(key, itertools.count())
        k = next(c)
        if isinstance(candidates, StageMembers):
            return candidates.pick_sorted(k)
        cands = sorted(candidates, key=lambda x: x.name)
        return cands[k % len(cands)]


class LoadBasedRouter(Router):
    name = "load_based"

    def __init__(self, metric: str = "queue"):
        assert metric in LOAD_METRICS, metric
        self.metric = metric

    def route(self, req, candidates, now):
        if isinstance(candidates, StageMembers):
            return candidates.load_best(self.metric, now)
        return min(candidates, key=lambda c: c.load(self.metric, now))


class HeavyLightRouter(Router):
    """Heavy-light split [26]: long requests go to a dedicated heavy pool so
    short interactive requests never queue behind them."""

    name = "heavy_light"

    def __init__(self, threshold_tokens: int = 4096, heavy_frac: float = 0.25,
                 metric: str = "queue"):
        self.threshold = threshold_tokens
        self.heavy_frac = heavy_frac
        self.metric = metric

    def route(self, req, candidates, now):
        # deterministic split: the candidate list follows client-dict order,
        # which a fail/recover/add silently reshuffles — partition a
        # name-sorted view so the heavy pool is stable across churn. The
        # fleet index maintains that view incrementally (no per-route sort);
        # the per-pool min stays O(pool) — pools are load-ordered subsets a
        # single heap cannot serve.
        if isinstance(candidates, StageMembers):
            cands = candidates.sorted_live()
        else:
            cands = sorted(candidates, key=lambda c: c.name)
        n_heavy = max(1, int(len(cands) * self.heavy_frac))
        heavy, light = cands[:n_heavy], cands[n_heavy:] or cands
        work = req.input_tokens + req.output_tokens * req.branches
        pool = heavy if work >= self.threshold else light
        return min(pool, key=lambda c: c.load(self.metric, now))


class PrefixAffinityRouter(Router):
    """Cache-aware placement: prefer the client whose radix cache already
    holds the longest prefix of the request's prompt (its pages get mapped,
    not recomputed), tie-breaking — and falling back for identity-less
    requests — on a load metric. Hits below ``min_hit_tokens`` are ignored
    so a stale one-block hit cannot override load balance.

    Fetch policy (``fetch_load_factor``): affinity alone concentrates hot
    prefixes on one client until it saturates. When the warm client's load
    exceeds ``fetch_load_factor ×`` the load-best candidate's (floored at
    one load unit so an idle fleet is not "overloaded" by a single
    request), the request routes to the load-best client instead — and the
    coordinator is asked to *migrate* the prefix there, shipping the KV
    pages over the Network when the wire fetch prices cheaper than
    recomputing them (``Coordinator.maybe_fetch_prefix``). None disables
    the policy (pure-affinity behavior)."""

    name = "prefix_affinity"

    def __init__(self, metric: str = "queue", min_hit_tokens: int = 64,
                 fetch_load_factor: Optional[float] = None):
        assert metric in LOAD_METRICS, metric
        self.metric = metric
        self.min_hit_tokens = min_hit_tokens
        self.fetch_load_factor = fetch_load_factor

    def route(self, req, candidates, now):
        if isinstance(candidates, StageMembers):
            # fleet-level root-hash inverted index: only clients holding the
            # chain's root block can have a nonzero hit, so exact hits are
            # probed on that (usually tiny) warm set instead of the fleet.
            # Decision-identical: everyone else's hit is provably 0, and a
            # best hit of 0 routes load-best — exactly what the full scan
            # concludes when no candidate has a positive hit.
            warm_cands = candidates.warm_candidates(req)
            hits = {c.name: c.prefix_hit_tokens(req) for c in warm_cands}
            best = max(hits.values(), default=0)
            if best < max(self.min_hit_tokens, 1):
                return candidates.load_best(self.metric, now)
            warm = [c for c in warm_cands if hits[c.name] == best]
            load_best_fn = lambda: candidates.load_best(self.metric, now)
        else:
            hits = {c.name: c.prefix_hit_tokens(req) for c in candidates}
            best = max(hits.values())
            if best < self.min_hit_tokens:
                return min(candidates, key=lambda c: c.load(self.metric, now))
            warm = [c for c in candidates if hits[c.name] == best]
            load_best_fn = lambda: min(
                candidates, key=lambda c: c.load(self.metric, now))
        warm_best = min(warm, key=lambda c: c.load(self.metric, now))
        if self.fetch_load_factor is None or self.coordinator is None:
            return warm_best
        load_best = load_best_fn()
        if load_best is warm_best:
            return warm_best
        w_load = warm_best.load(self.metric, now)
        l_load = load_best.load(self.metric, now)
        if w_load <= self.fetch_load_factor * max(l_load, 1.0):
            return warm_best               # affinity wins below the knob
        # warm client overloaded: place on the load-best client and warm it
        # (the fetch-vs-recompute pricing inside decides whether the prefix
        # actually ships or the new home just recomputes it)
        self.coordinator.maybe_fetch_prefix(warm_best, load_best, req, now)
        return load_best


def make_router(policy: str = "round_robin", metric: str = "queue",
                **kw) -> Router:
    if policy == "round_robin":
        return RoundRobinRouter()
    if policy == "load_based":
        return LoadBasedRouter(metric)
    if policy == "heavy_light":
        return HeavyLightRouter(metric=metric, **kw)
    if policy == "prefix_affinity":
        return PrefixAffinityRouter(metric=metric, **kw)
    raise ValueError(policy)
