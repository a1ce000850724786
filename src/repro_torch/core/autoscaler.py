"""Closed-loop goodput autoscaler (ROADMAP item 4; paper §VI fleet scaling).

Nothing in the system used to *react* to load: CLIENT_ADD/CLIENT_REMOVE were
only fired from hand-scripted schedules. ``Autoscaler`` closes the loop: the
``Coordinator`` ticks it on a periodic ``AUTOSCALE_CHECK`` event; each tick
it observes a sliding window of recent health (``MetricsCollector.
window_stats``: per-tier SLO attainment, windowed goodput, TTFT percentiles)
plus instantaneous queue depth, asks a pluggable ``AutoscalePolicy`` for the
desired fleet size, and applies the difference as CLIENT_ADD / CLIENT_REMOVE
actions against a warm pool of templated client specs.

Scale-out rides the push-mode prefix warming (``CoordinatorConfig.
warm_on_scale_out``: the coordinator ships the donor's hottest radix chains
to the new replica as it lands). Scale-in drains through the
``requeue_step`` path — ``Coordinator._on_remove`` requeues the removed
client's in-flight admissions and re-dispatches its whole queue — so no
request is ever lost or duplicated across scale events (property-tested in
``tests/test_autoscale.py``).

Decision determinism contract
-----------------------------
Every observation the controller reads is invariant under decode
fast-forward: windowed serviced stats (windows never span a request
completion — the planner's K bound stops at the next completion), ``queue``
depth (windows plan only when nothing is waiting) and ``tokens_remaining``
(``Client.load`` folds the virtually-committed window prefix in). The same
schedule therefore produces the bit-identical action sequence — and summary
— with ``fast_forward`` on or off, which is exactly what the hypothesis
suite asserts. Policies must not read materialized KV state (``kv_size`` /
``kv_pressure``) without the coordinator `_sync`-ing candidates first; the
built-in policies don't.

Flap damping is split between the two layers: *policies* carry hysteresis
bands (scale-in thresholds strictly below scale-out thresholds), the
*controller* enforces cooldowns measured from the last action of either
direction — ``cooldown_out`` must elapse before a scale-out, ``cooldown_in``
before a scale-in. A remove can thus never be chased by an add (or vice
versa) inside the respective cooldown, the no-flap property the hypothesis
suite pins.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import request as rq
from repro_torch.core.client import Client, LLMClient
from repro_torch.core.metrics import SLO


@dataclass
class AutoscalerConfig:
    interval: float = 0.25          # AUTOSCALE_CHECK period (seconds)
    window: float = 1.0             # sliding observation window (seconds)
    min_clients: int = 1            # live-fleet bounds, both inclusive
    max_clients: int = 8
    cooldown_out: float = 0.5       # min gap after any action before scale-out
    cooldown_in: float = 1.5        # min gap after any action before scale-in
    stage: str = rq.LLM             # stage kind this controller manages
    name_prefix: str = "scale"      # warm-pool replica names: scale0, scale1…
    scale_in_metric: str = "tokens_remaining"  # least-loaded pick for drain


@dataclass
class Observation:
    """What a policy sees each tick. Window fields are ``None`` when nothing
    completed inside the window (policies must not treat silence as
    health — an overloaded fleet completing nothing looks exactly like an
    idle one on SLO fractions; queue depth disambiguates)."""
    now: float
    n_live: int
    queue_depth: float              # waiting+running over live stage clients
    queue_per_client: float
    tokens_remaining: float         # virtually-committed, fast-forward-exact
    window_n: int                   # requests completed inside the window
    slo_frac: Optional[float]       # fraction of those meeting P50 SLO caps
    slo_frac_by_tier: Dict[str, float]
    goodput_tok_s: float            # windowed, SLO-gated tokens/sec
    goodput_by_tier: Dict[str, float]
    ttft_p90: float                 # over the window (nan when empty)


class AutoscalePolicy:
    """Maps an ``Observation`` to a desired live-fleet size. Pure: policies
    hold tuning constants, never mutable controller state, so one policy
    object can be shared across arms/runs."""

    name = "base"

    def desired(self, obs: Observation) -> int:
        raise NotImplementedError


class ThresholdHysteresisPolicy(AutoscalePolicy):
    """Classic band controller: scale out when queue depth per client rises
    above ``queue_hi`` or windowed SLO attainment falls below ``slo_lo``;
    scale in only when the queue is below ``queue_lo`` AND attainment is
    above ``slo_hi``. The dead band between the thresholds is the
    hysteresis — a fleet sitting inside it holds steady, so threshold noise
    cannot flap add/remove (cooldowns damp whatever the band lets through).
    """

    name = "threshold"

    def __init__(self, queue_hi: float = 8.0, queue_lo: float = 1.0,
                 slo_lo: float = 0.7, slo_hi: float = 0.9, step_out: int = 1):
        assert queue_lo < queue_hi and slo_lo <= slo_hi
        self.queue_hi = queue_hi
        self.queue_lo = queue_lo
        self.slo_lo = slo_lo
        self.slo_hi = slo_hi
        self.step_out = step_out

    def desired(self, obs: Observation) -> int:
        n = obs.n_live
        slo_bad = obs.slo_frac is not None and obs.slo_frac < self.slo_lo
        if obs.queue_per_client > self.queue_hi or slo_bad:
            return n + self.step_out
        slo_good = obs.slo_frac is None or obs.slo_frac >= self.slo_hi
        if obs.queue_per_client < self.queue_lo and slo_good:
            return n - 1
        return n


class TargetTrackingPolicy(AutoscalePolicy):
    """Proportional controller tracking a queue-depth-per-client setpoint:
    desired = ceil(n * measured / target), clamped to ``max_step`` adds per
    tick. Scale-in waits for measured load to fall below
    ``scale_in_ratio * target`` (the tolerance band playing the hysteresis
    role) and sheds one replica at a time. A windowed SLO-attainment floor
    overrides the proportional term — queue depth can look fine while TTFT
    targets burn (long prompts, warm-up after scale-out)."""

    name = "target_tracking"

    def __init__(self, target_queue: float = 4.0, slo_floor: float = 0.8,
                 scale_in_ratio: float = 0.5, max_step: int = 4):
        assert 0.0 < scale_in_ratio < 1.0
        self.target_queue = target_queue
        self.slo_floor = slo_floor
        self.scale_in_ratio = scale_in_ratio
        self.max_step = max_step

    def desired(self, obs: Observation) -> int:
        n = obs.n_live
        ratio = obs.queue_per_client / max(self.target_queue, 1e-9)
        want = n
        if ratio > 1.0:
            want = min(n + self.max_step, math.ceil(n * ratio))
        elif ratio < self.scale_in_ratio:
            want = n - 1
        if obs.slo_frac is not None and obs.slo_frac < self.slo_floor:
            want = max(want, n + 1)
        return want


def make_policy(name: str, **kw) -> AutoscalePolicy:
    if name == "threshold":
        return ThresholdHysteresisPolicy(**kw)
    if name == "target_tracking":
        return TargetTrackingPolicy(**kw)
    raise ValueError(name)


class ClientTemplate:
    """Templated spec for warm-pool replicas: everything needed to stamp out
    a fresh ``LLMClient`` under a new name. Replicas share the template's
    ``ClientPerf`` (its memo is keyed on pure shapes, safely shared); each
    gets its own scheduler/allocator — a scaled-out replica starts cold and
    is warmed by the coordinator's push-mode prefix migration, not by
    inheriting state."""

    def __init__(self, cluster, model_cfg, strategy: str = "continuous",
                 limits=None, packing: str = "fcfs", perf=None,
                 group: Optional[str] = None):
        from repro_torch.core.llm_scheduler import SchedulerLimits
        self.cluster = cluster
        self.model_cfg = model_cfg
        self.strategy = strategy
        self.limits = limits if limits is not None else SchedulerLimits()
        self.packing = packing
        self.perf = perf
        self.group = group

    @classmethod
    def from_client(cls, c: LLMClient) -> "ClientTemplate":
        return cls(c.cluster, c.model_cfg, c.strategy, c.scheduler.limits,
                   c.scheduler.packing, c.scheduler.perf, c.group)

    def build(self, name: str) -> LLMClient:
        return LLMClient(name, self.cluster, self.model_cfg, self.strategy,
                         self.limits, self.packing, self.perf,
                         group=self.group)


class Autoscaler:
    """The controller the coordinator ticks on AUTOSCALE_CHECK events.

    Tracks its own audit trail: ``actions`` is the exact, ordered
    ``(time, "add"|"remove", name)`` sequence (what the golden scenario test
    pins), ``fleet_trace`` samples ``(time, n_live)`` at every tick and
    action, and ``client_seconds`` integrates provisioned-client time — the
    cost metric the benchmark weighs goodput against. Names of removed
    warm-pool replicas return to a free list and are reused smallest-first,
    so a long diurnal run cycles scale0/scale1 instead of growing the
    namespace without bound."""

    def __init__(self, template: ClientTemplate,
                 policy: Optional[AutoscalePolicy] = None,
                 cfg: Optional[AutoscalerConfig] = None,
                 slos=None):
        self.template = template
        self.policy = policy or TargetTrackingPolicy()
        self.cfg = cfg or AutoscalerConfig()
        assert 1 <= self.cfg.min_clients <= self.cfg.max_clients
        self.slos = slos            # SLO or tier->SLO map for window_stats
        self.actions: List[Tuple[float, str, str]] = []
        self.fleet_trace: List[Tuple[float, int]] = []
        self.client_seconds: float = 0.0
        self.checks: int = 0
        self._last_action = -math.inf
        self._counter = 0
        self._free_names: List[str] = []
        self._cost_t: Optional[float] = None

    # -- fleet views -------------------------------------------------------
    def _stage_clients(self, coord) -> List[Client]:
        """Provisioned clients dedicated to the managed stage, in client-dict
        order (identical with the fleet index on or off — the index preserves
        baseline iteration order by contract). Only single-stage clients are
        eligible: the controller must never remove a client that also serves
        some other stage."""
        return [c for c in coord.clients.values()
                if c.stages == (self.cfg.stage,)]

    def _live(self, coord) -> List[Client]:
        return [c for c in self._stage_clients(coord) if not c.failed]

    # -- cost integral -----------------------------------------------------
    def _advance_cost(self, coord, now: float):
        """client_seconds integrates *provisioned* (failed included — they
        are still paid for) stage clients over time."""
        if self._cost_t is not None and now > self._cost_t:
            self.client_seconds += ((now - self._cost_t)
                                    * len(self._stage_clients(coord)))
        self._cost_t = max(now, self._cost_t or now)

    def bind(self, coord, now: float):
        """Called by ``Coordinator.attach_autoscaler``: opens the cost
        integral and the fleet trace at the initial fleet."""
        self._cost_t = now
        self.fleet_trace.append((now, len(self._live(coord))))

    def finalize(self, coord, now: float):
        """Close the cost integral at the end of a run (idempotent; a
        resumed ``run()`` keeps integrating from here)."""
        self._advance_cost(coord, now)

    # -- observation -------------------------------------------------------
    def observe(self, coord, now: float) -> Observation:
        live = self._live(coord)
        n = len(live)
        queue = sum(c.load("queue", now) for c in live)
        toks = sum(c.load("tokens_remaining", now) for c in live)
        w = coord.metrics.window_stats(now - self.cfg.window, until=now,
                                       slos=self.slos or SLO())
        return Observation(
            now=now, n_live=n, queue_depth=queue,
            queue_per_client=queue / max(n, 1),
            tokens_remaining=toks,
            window_n=w["n"],
            slo_frac=w.get("slo_frac") if w["n"] else None,
            slo_frac_by_tier=w.get("slo_frac_by_tier", {}),
            goodput_tok_s=w.get("goodput_tok_s", 0.0),
            goodput_by_tier=w.get("goodput_by_tier", {}),
            ttft_p90=w["ttft_p90"])

    # -- the tick ----------------------------------------------------------
    def on_check(self, coord, now: float):
        self.checks += 1
        self._advance_cost(coord, now)
        obs = self.observe(coord, now)
        want = max(self.cfg.min_clients,
                   min(self.cfg.max_clients, self.policy.desired(obs)))
        n = obs.n_live
        if want > n and now - self._last_action >= self.cfg.cooldown_out:
            self._scale_out(coord, now, want - n)
        elif want < n and now - self._last_action >= self.cfg.cooldown_in:
            self._scale_in(coord, now)
        self.fleet_trace.append((now, len(self._live(coord))))

    def _next_name(self) -> str:
        if self._free_names:
            return self._free_names.pop(0)
        name = f"{self.cfg.name_prefix}{self._counter}"
        self._counter += 1
        return name

    def _scale_out(self, coord, now: float, k: int):
        for _ in range(k):
            name = self._next_name()
            self._advance_cost(coord, now)   # cost of the larger fleet
            coord._on_add(self.template.build(name), now)  # starts accruing now
            self.actions.append((now, "add", name))
        self._last_action = now

    def _scale_in(self, coord, now: float):
        """Remove the most-drained (least-loaded) live replica — ties break
        on name so the pick is deterministic. ``Coordinator._on_remove``
        requeues its in-flight step and re-dispatches its queue, so the
        drain loses nothing."""
        live = self._live(coord)
        if len(live) <= self.cfg.min_clients:
            return
        victim = min(live, key=lambda c: (c.load(self.cfg.scale_in_metric,
                                                 now), c.name))
        self._advance_cost(coord, now)       # close out the larger fleet
        coord._on_remove(victim.name, now)
        if victim.name.startswith(self.cfg.name_prefix):
            self._free_names.append(victim.name)
            self._free_names.sort()
        self.actions.append((now, "remove", victim.name))
        self._last_action = now
