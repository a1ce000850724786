"""Global Coordinator (paper §III-B, Algorithm 1).

Owns the global event queue + clock, routes request stages to clients,
prices inter-client transfers through the Network, and handles client
fail/recover/add/remove for fault tolerance and elastic scaling.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core import events as ev
from repro_torch.core import request as rq
from repro_torch.core.client import Client, LLMClient
from repro_torch.core.comm import Network
from repro_torch.core.fleet import FleetIndex, StageMembers
from repro_torch.core.metrics import SLO, MetricsCollector
from repro_torch.core.router import Router, RoundRobinRouter


@dataclass
class CoordinatorConfig:
    disaggregation: str = "global"        # global | local (paper §II-B)
    kv_transfer_granularity: str = "layerwise"  # full | layerwise
    straggler_deadline: Optional[float] = None  # re-route if queued longer
    max_sim_time: float = 1e7
    # cross-client radix prefix migration (paper §V-B remote KV retrieval):
    # ship resident KV prefix chains between clients over the Network
    # instead of letting a cold replica recompute them from scratch
    prefix_migration: bool = False
    migration_granularity: Optional[str] = None  # default: kv_transfer_gran.
    warm_on_scale_out: bool = True     # push-mode warming on ADD / RECOVER
    warm_max_blocks: int = 256         # donor block budget per warming push
    # fleet-scale routing indexes (``fleet.py``): incremental
    # stage->client / load / root-hash structures replacing the per-request
    # linear scans. Decision-identical to the scan baseline by contract;
    # False keeps the baseline path (the A/B arm the identity checks use).
    fleet_index: bool = True


class Coordinator:
    def __init__(self, clients: List[Client], router: Optional[Router] = None,
                 network: Optional[Network] = None,
                 cfg: Optional[CoordinatorConfig] = None):
        self.clients: Dict[str, Client] = {c.name: c for c in clients}
        self.router = router or RoundRobinRouter()
        self.network = network or Network()
        # a fresh config per coordinator: a shared mutable default would let
        # one simulation's cfg tweak silently leak into every later one
        self.cfg = cfg if cfg is not None else CoordinatorConfig()
        self.queue = ev.EventQueue()
        self.metrics = MetricsCollector()
        self._active_step: Dict[str, object] = {}
        self._accepted = 0
        self._dispatch_times: Dict[int, float] = {}
        # in-flight prefix migrations, keyed (dst, chain): dedup so a burst
        # of same-prefix routing decisions starts one transfer, not many
        self._migrations_inflight: set = set()
        self.fleet: Optional[FleetIndex] = \
            FleetIndex(self) if self.cfg.fleet_index else None
        # closed-loop autoscaler (core/autoscaler.py), ticked on periodic
        # AUTOSCALE_CHECK events; None = open-loop (scripted churn only)
        self.autoscaler = None
        self.router.bind(self)
        # times of pending *external* events (everything but step completions)
        # — the fast-forward planner stops windows at the next one so the
        # priced tail is rarely discarded by truncate-and-replay
        self._ext_times: List[float] = []

    def _push_ext(self, time: float, kind: str, payload=None):
        heapq.heappush(self._ext_times, time)
        return self.queue.push(time, kind, payload)

    def _ff_horizon(self, now: float) -> Optional[float]:
        """Earliest pending external event strictly after ``now`` (advisory:
        a window running past it is still cut correctly by ``_interrupt``)."""
        h = self._ext_times
        while h and h[0] <= now:
            heapq.heappop(h)
        return h[0] if h else None

    # ------------------------------------------------------------------
    def submit(self, requests: List[rq.Request]):
        for r in requests:
            self._accepted += 1
            self._push_ext(r.arrival, ev.REQUEST_ARRIVAL, r)

    def schedule_failure(self, client_name: str, at: float,
                         recover_at: Optional[float] = None):
        self._push_ext(at, ev.CLIENT_FAIL, client_name)
        if recover_at is not None:
            self._push_ext(recover_at, ev.CLIENT_RECOVER, client_name)

    def schedule_add_client(self, client: Client, at: float):
        self._push_ext(at, ev.CLIENT_ADD, client)

    def schedule_remove_client(self, client_name: str, at: float):
        self._push_ext(at, ev.CLIENT_REMOVE, client_name)

    def attach_autoscaler(self, scaler, start_at: Optional[float] = None):
        """Close the scaling loop: tick ``scaler`` every
        ``scaler.cfg.interval`` seconds, starting one interval from now (or
        at ``start_at``). Check events are deliberately NOT external-event
        horizon caps: a check that takes no action must not cut decode
        fast-forward windows, and one that does interrupts its targets
        through the ordinary add/remove paths."""
        self.autoscaler = scaler
        scaler.bind(self, self.queue.now)
        t0 = start_at if start_at is not None \
            else self.queue.now + scaler.cfg.interval
        self.queue.push(t0, ev.AUTOSCALE_CHECK, None)

    # ------------------------------------------------------------------
    # stages that may be absent from a system spec; requests skip them
    _OPTIONAL_STAGES = (rq.PREPROCESS, rq.POSTPROCESS)

    def _candidates(self, req: rq.Request) -> Optional[List[Client]]:
        stage = req.current_stage.kind
        if self.fleet is not None:
            return self._candidates_indexed(req, stage)
        cands = [c for c in self.clients.values()
                 if stage in c.stages and not c.failed]
        if not cands and stage in self._OPTIONAL_STAGES:
            return None
        # local disaggregation: decode must stay in the prefill client's group
        if stage == rq.DECODE and self.cfg.disaggregation == "local":
            prev = next((s.client for s in reversed(req.stages[:req.stage_idx])
                         if s.kind == rq.PREFILL and s.client), None)
            if prev is not None:
                g = getattr(self.clients.get(prev), "group", None)
                if g is not None:
                    grouped = [c for c in cands
                               if getattr(c, "group", None) == g]
                    cands = grouped or cands
        if not cands:
            raise RuntimeError(f"no live client serves stage '{stage}'")
        return cands

    def _candidates_indexed(self, req: rq.Request,
                            stage: str) -> Optional[StageMembers]:
        """Index-backed twin of the linear scan above: same None / raise
        semantics, same candidate iteration order, same group-filter
        fallback (an empty group view falls back to the stage view)."""
        view = self.fleet.candidates(stage)
        if view is None or not view:
            if stage in self._OPTIONAL_STAGES:
                return None
            raise RuntimeError(f"no live client serves stage '{stage}'")
        if stage == rq.DECODE and self.cfg.disaggregation == "local":
            prev = next((s.client for s in reversed(req.stages[:req.stage_idx])
                         if s.kind == rq.PREFILL and s.client), None)
            if prev is not None:
                g = getattr(self.clients.get(prev), "group", None)
                if g is not None:
                    gview = self.fleet.group_candidates(stage, g)
                    if gview:
                        view = gview
        return view

    def _complete(self, req: rq.Request):
        """Terminal bookkeeping: straggler dispatch-time entries die with the
        request (they previously leaked for the whole run)."""
        self._dispatch_times.pop(req.rid, None)
        self.metrics.complete(req)

    def _arm_straggler(self, req: rq.Request, at: float):
        """(Re)arm the per-dispatch rescue deadline. The payload carries the
        arming dispatch time so the deadline guard compares exactly instead
        of reconstructing it from floats. Deliberately NOT an _ext_times
        entry: a deadline check cannot perturb a running decode window (it
        only rescues *queued* requests, and any resulting re-dispatch
        interrupts its target itself), so it must not cap fast-forward
        window lengths."""
        self._dispatch_times[req.rid] = at
        if self.cfg.straggler_deadline is not None:
            self.queue.push(at + self.cfg.straggler_deadline,
                            ev.STRAGGLER_CHECK, (req, at))

    def _dispatch(self, req: rq.Request, now: float):
        """Route current stage to a client (Algorithm 1 'Request-push')."""
        while not req.done and self._candidates(req) is None:
            req.advance_stage(now)     # optional stage with no client: skip
        if req.done:
            self._complete(req)
            return
        cands = self._candidates(req)
        self._sync(cands, now)         # routers must see committed state
        client = self.router.route(req, cands, now)
        st = req.current_stage
        st.client = client.name
        st.dispatch_time = now
        st.start_time = now
        self._arm_straggler(req, now)
        self._interrupt(client.name, now)  # arrival lands mid-window
        client.add(req)
        self._touch(client.name)
        self._kick(client, now)

    def _touch(self, name: str):
        """Dirty-mark a client whose scheduler/allocator state this event
        mutated: its cached load-index values are stale. Every chokepoint
        where the coordinator reaches into a client calls this — missing one
        breaks the decision-identity contract (and is what the churn
        hypothesis test in tests/test_fleet_scale.py hunts for)."""
        if self.fleet is not None:
            self.fleet.touch(name)

    def _kick(self, client: Client, now: float):
        if client.failed or client.name in self._active_step:
            return
        step = client.plan_step(now, self._ff_horizon(now))
        # plan_step itself mutates load-bearing state (admission, swap-ins,
        # preemption) even when it ends up planning nothing
        self._touch(client.name)
        if step is None:
            return
        self._active_step[client.name] = step
        if self.fleet is not None and getattr(step, "n_steps", 1) > 1:
            self.fleet.set_windowed(client.name, True)
        end = getattr(step, "end_time", None)
        self.queue.push(end if end is not None else now + step.duration,
                        ev.CLIENT_STEP_DONE, (client.name, step))

    # --- decode fast-forward invalidation ------------------------------
    def _interrupt(self, name: str, now: float, reschedule: bool = True,
                   inclusive: bool = False):
        """Truncate-and-replay an in-flight macro-step: commit the
        iterations that already finished, put the one spanning ``now`` back
        in flight as a plain step ending at its original boundary (the stale
        macro CLIENT_STEP_DONE is skipped by the identity check), and let the
        discarded tail be re-planned. Single steps are atomic in per-step
        execution too, so they are left untouched."""
        step = self._active_step.get(name)
        if step is None or getattr(step, "n_steps", 1) <= 1:
            return
        client = self.clients.get(name)
        if client is None:
            return
        del self._active_step[name]
        if self.fleet is not None:
            self.fleet.set_windowed(name, False)
            self.fleet.touch(name)         # truncation commits window state
        rem = client.truncate_step(step, now, inclusive)
        if rem is not None and reschedule:
            self._active_step[name] = rem
            self.queue.push(rem.end_time, ev.CLIENT_STEP_DONE, (name, rem))

    # load metrics whose exact value requires materialized KV block state;
    # the rest are either invariant mid-window (queue, input_len, output_len)
    # or folded in virtually by Client.load (tokens_remaining)
    _KV_EXACT_METRICS = ("kv_size", "kv_pressure")

    def _sync(self, clients, now: float):
        """Make routing state exact. Routers reading raw allocator state
        need every candidate's fast-forward window committed up to ``now``;
        for every other metric ``Client.load(metric, now)`` already reports
        the virtually-committed value, so the windows of routing *losers*
        survive untouched (only the chosen client is interrupted, by the
        caller, before the request is enqueued)."""
        if getattr(self.router, "metric", None) not in self._KV_EXACT_METRICS:
            return
        if isinstance(clients, StageMembers):
            # only windowed candidates need cutting — _interrupt is a no-op
            # (and pushes no event) for everyone else, so skipping them
            # pushes the exact event sequence the baseline loop would
            clients = clients.windowed()
        for c in clients:
            self._interrupt(c.name, now)

    # ------------------------------------------------------------------
    def _account_swap_traffic(self, client: Client, step, now: float):
        """KV-page swap traffic from preemptions (paper §III-E3). The
        engine's stall is already priced inside the step duration (Eq. 1
        tier term); here the bytes are counted in the metrics and recorded
        against the client's dedicated spill link so ``Network.stats()``
        reports per-client swap volume. (The spill link is private to the
        client — host-side contention with other traffic is not modeled.)"""
        nbytes = getattr(step, "swap_bytes", 0.0)
        if nbytes <= 0:
            return
        self.metrics.observe_step_swaps(step)
        if self.network.paths.get((client.name, f"{client.name}:kvpool")):
            self.network.transfer(client.name, f"{client.name}:kvpool",
                                  nbytes, now)

    # ------------------------------------------------------------------
    def _transfer_and_forward(self, req: rq.Request, src: str, now: float):
        """Price inter-stage data movement, then re-enqueue as a new request
        event at the destination (paper §III-B2)."""
        prev_stage = req.stages[req.stage_idx - 1] if req.stage_idx else None
        while not req.done and self._candidates(req) is None:
            req.advance_stage(now)     # optional stage with no client: skip
        nxt = req.current_stage
        if nxt is None:
            self._complete(req)
            return
        # choose destination now so we can price the wire
        cands = self._candidates(req)
        self._sync(cands, now)
        dst_client = self.router.route(req, cands, now)
        nbytes, gran, n_layers = 0.0, "full", 1
        if prev_stage is not None and nxt is not None:
            if prev_stage.kind == rq.PREFILL and nxt.kind == rq.DECODE:
                src_c = self.clients.get(src)
                if isinstance(src_c, LLMClient):
                    nbytes = src_c.kv_transfer_bytes_fn(req)
                    # wire-side prefix dedup: pages the destination's radix
                    # cache already holds need not ship (the decode client
                    # maps them at admission instead). Priced at transfer-
                    # schedule time; a page evicted before the request is
                    # admitted still rides for free — real systems pin
                    # matched pages for the transfer window, which we
                    # approximate by not re-checking at admission.
                    hit = dst_client.prefix_hit_tokens(req)
                    if hit > 0:
                        saved = min(nbytes,
                                    hit * src_c.scheduler.kv_per_token)
                        nbytes -= saved
                        self.metrics.kv_transfer_dedup_bytes += saved
                    n_layers = src_c.model_cfg.num_layers
                    gran = self.cfg.kv_transfer_granularity
            elif prev_stage.kind in (rq.RAG_RETRIEVE, rq.RAG_EMBED):
                nbytes = req.rag_tokens * 2.0 * 4  # context ids+embeddings
            elif prev_stage.kind == rq.KV_RETRIEVAL:
                nbytes = 0.0  # priced inside the retrieval stage itself
        arrive = self.network.transfer(src, dst_client.name, nbytes, now,
                                       granularity=gran, n_layers=n_layers)
        self.metrics.comm_events += 1
        self.metrics.comm_bytes += nbytes
        st = req.current_stage
        st.client = dst_client.name
        st.dispatch_time = arrive
        st.start_time = arrive
        # the forwarded stage is a fresh dispatch: refresh the straggler
        # bookkeeping and arm a deadline of its own. Without this, a deadline
        # armed at the PREVIOUS stage's dispatch still matched the stale
        # _dispatch_times entry and could preempt a request legitimately
        # queued at its next stage — and forwarded stages had no straggler
        # protection at all.
        self._arm_straggler(req, arrive)
        self._push_ext(arrive, ev.TRANSFER_DONE, (req, dst_client.name))

    # ------------------------------------------------------------------
    # cross-client radix prefix migration (paper §V-B remote KV retrieval)
    # ------------------------------------------------------------------
    @staticmethod
    def _kv_of(client) -> Optional[object]:
        return getattr(getattr(client, "scheduler", None), "kv", None)

    def maybe_fetch_prefix(self, src: Client, dst: Client, req: rq.Request,
                           now: float) -> bool:
        """Fetch-vs-recompute decision (Eq. 1 tier term vs. the analytical
        prefill model): the router found the warm client overloaded and is
        about to place ``req`` on ``dst`` cold. Ship the prefix when the
        wire fetch is cheaper than re-prefilling the same tokens at the
        destination. Returns True when a migration toward ``dst`` is (now)
        in flight. Deliberately reads only window-invariant allocator state
        (radix residency, link occupancy, pure perf models) so the decision
        is bit-identical with decode fast-forward on or off."""
        if not self.cfg.prefix_migration:
            return False
        src_kv, dst_kv = self._kv_of(src), self._kv_of(dst)
        if src_kv is None or dst_kv is None or not req.prefix_segments:
            return False
        hashes = tuple(req.prefix_block_hashes(src_kv.block_tokens))
        if not hashes:
            return False
        ship = (len(src_kv.radix.match(hashes))
                - len(dst_kv.radix.match(hashes)))
        if ship <= 0:
            return False
        key = (dst.name, hashes)
        if key in self._migrations_inflight:
            return True                    # already warming toward dst
        nbytes = ship * src_kv.block_bytes
        gran = self.cfg.migration_granularity \
            or self.cfg.kv_transfer_granularity
        n_layers = src.model_cfg.num_layers if isinstance(src, LLMClient) else 1
        fetch_t = self.network.estimate(src.name, dst.name, nbytes, now,
                                        granularity=gran, n_layers=n_layers)
        recompute_t = dst.scheduler.perf.prefill(
            ship * src_kv.block_tokens, 1).time
        if fetch_t >= recompute_t:
            return False                   # recompute wins: let dst rebuild
        self._migrations_inflight.add(key)
        self._push_ext(now, ev.PREFIX_MIGRATE,
                       (src.name, dst.name, hashes, key))
        return True

    def _warm_client(self, client: Client, now: float):
        """Push-mode replica warming (CLIENT_ADD / CLIENT_RECOVER): ship the
        hottest resident prefix chains from the warmest compatible peer so a
        scaled-out or recovered client serves prefix hits before organic
        traffic refills it."""
        if not (self.cfg.prefix_migration and self.cfg.warm_on_scale_out):
            return
        if self._kv_of(client) is None:
            return
        donors = [c for c in self.clients.values()
                  if c is not client and not c.failed
                  and self._kv_of(c) is not None
                  and set(c.stages) & set(client.stages)]
        if not donors:
            return
        donor = max(donors,
                    key=lambda c: len(self._kv_of(c).radix.by_block))
        chains = self._kv_of(donor).hot_chains(self.cfg.warm_max_blocks)
        for chain in chains:
            key = (client.name, tuple(chain))
            if key in self._migrations_inflight:
                continue
            self._migrations_inflight.add(key)
            self._push_ext(now, ev.PREFIX_MIGRATE,
                           (donor.name, client.name, tuple(chain), key))

    def _start_migration(self, src_name: str, dst_name: str, hashes, key,
                         now: float):
        """PREFIX_MIGRATE: pin the source chain and put its bytes on the
        wire (layerwise or full granularity, like the prefill→decode
        handoff). MIGRATE_DONE lands as an *external* event so a decode
        fast-forward window at the destination truncates-and-replays
        instead of committing state the import would have changed."""
        src, dst = self.clients.get(src_name), self.clients.get(dst_name)
        src_kv = self._kv_of(src) if src is not None else None
        dst_kv = self._kv_of(dst) if dst is not None else None
        if (src is None or dst is None or src.failed or dst.failed
                or src_kv is None or dst_kv is None):
            self._migrations_inflight.discard(key)
            return
        # pages the destination already holds need not ship (same wire-side
        # dedup the prefill→decode handoff applies)
        skip = len(dst_kv.radix.match(hashes))
        export = src_kv.export_chain(hashes, skip=skip)
        if export is None:
            self._migrations_inflight.discard(key)
            return
        handle, n_resident, nbytes = export
        self._touch(src_name)              # export pins bump refcounts
        gran = self.cfg.migration_granularity \
            or self.cfg.kv_transfer_granularity
        n_layers = src.model_cfg.num_layers if isinstance(src, LLMClient) else 1
        arrive = self.network.transfer(src_name, dst_name, nbytes, now,
                                       granularity=gran, n_layers=n_layers)
        self.metrics.comm_events += 1
        self.metrics.comm_bytes += nbytes
        self._push_ext(arrive, ev.MIGRATE_DONE,
                       (src_name, dst_name, handle,
                        tuple(hashes[:n_resident]), nbytes, key))

    def _finish_migration(self, payload, now: float):
        """MIGRATE_DONE: unpin the source pages and materialize the chain at
        the destination (collision truncation + free-list-only capacity
        backpressure happen inside ``import_chain``)."""
        src_name, dst_name, handle, chain, nbytes, key = payload
        self._migrations_inflight.discard(key)
        src = self.clients.get(src_name)
        src_kv = self._kv_of(src) if src is not None else None
        if src_kv is not None:
            src_kv.release_export(handle)
            self._touch(src_name)
        dst = self.clients.get(dst_name)
        dst_kv = self._kv_of(dst) if dst is not None else None
        if dst is None or dst.failed or dst_kv is None:
            return        # destination died in flight: bytes spent, pages lost
        # the import lands mid-window: commit the finished iterations first
        # so the window's free-list reservation stays exact
        self._interrupt(dst_name, now)
        dst_kv.import_chain(list(chain))
        self._touch(dst_name)
        self.metrics.kv_migrations += 1
        self.metrics.kv_migrated_bytes += nbytes

    # ------------------------------------------------------------------
    def run(self, until: Optional[float] = None) -> MetricsCollector:
        """Algorithm 1 main loop."""
        horizon = until or self.cfg.max_sim_time
        while len(self.queue):
            if self.queue.peek_time() > horizon:
                break
            event = self.queue.pop()
            now = event.time
            kind = event.kind

            if kind == ev.REQUEST_ARRIVAL:
                self._dispatch(event.payload, now)

            elif kind == ev.TRANSFER_DONE:
                req, dst = event.payload
                client = self.clients.get(dst)
                if client is None or client.failed:
                    self._dispatch(req, now)   # destination died in flight
                else:
                    self._interrupt(dst, now)  # arrival lands mid-window
                    client.add(req)
                    self._touch(dst)
                    self._kick(client, now)

            elif kind == ev.CLIENT_STEP_DONE:
                name, step = event.payload
                client = self.clients.get(name)
                if client is None or self._active_step.get(name) is not step:
                    continue  # stale (failed/removed client)
                del self._active_step[name]
                if self.fleet is not None:
                    self.fleet.set_windowed(name, False)
                if client.failed:
                    continue
                self._touch(name)
                finished = client.finish_step(step, now)
                self._account_swap_traffic(client, step, now)
                for req in finished:
                    req.advance_stage(now)
                    if req.done:
                        self._complete(req)
                    else:
                        self._transfer_and_forward(req, name, now)
                self._kick(client, now)

            elif kind == ev.CLIENT_FAIL:
                self._on_fail(event.payload, now)

            elif kind == ev.CLIENT_RECOVER:
                c = self.clients.get(event.payload)
                if c is not None:
                    was_failed = c.failed
                    c.failed = False
                    if self.fleet is not None and was_failed:
                        self.fleet.set_failed(c.name, False)
                    self._warm_client(c, now)  # its device KV died with it
                    self._kick(c, now)

            elif kind == ev.CLIENT_ADD:
                self._on_add(event.payload, now)

            elif kind == ev.CLIENT_REMOVE:
                self._on_remove(event.payload, now)

            elif kind == ev.AUTOSCALE_CHECK:
                if self.autoscaler is not None:
                    self.autoscaler.on_check(self, now)
                    # re-arm while anything remains in flight; when the last
                    # pending event is this check, the loop is allowed to end
                    if len(self.queue):
                        self.queue.push(now + self.autoscaler.cfg.interval,
                                        ev.AUTOSCALE_CHECK, None)

            elif kind == ev.STRAGGLER_CHECK:
                self._check_straggler(*event.payload, now)

            elif kind == ev.PREFIX_MIGRATE:
                self._start_migration(*event.payload, now)

            elif kind == ev.MIGRATE_DONE:
                self._finish_migration(event.payload, now)

        # horizon cut-off: commit in-flight fast-forward windows up to the
        # horizon (iterations ending exactly there included — their events
        # would have fired) so observable state matches per-step execution
        # truncated at the same time; remainders are rescheduled beyond the
        # horizon in case run() is resumed.
        for name in list(self._active_step):
            self._interrupt(name, horizon, inclusive=True)

        if self.autoscaler is not None:     # close the client-seconds
            self.autoscaler.finalize(self, self.queue.now)   # cost integral
        self.metrics.collect_kv(self.clients.values())
        return self.metrics

    # ------------------------------------------------------------------
    def _on_fail(self, name: str, now: float):
        client = self.clients.get(name)
        if client is None:
            return
        # tokens from already-finished window iterations were streamed to the
        # user; commit them before the in-flight (remainder) step is lost
        self._interrupt(name, now, reschedule=False)
        was_failed = client.failed
        client.failed = True
        if self.fleet is not None and not was_failed:
            self.fleet.set_failed(name, True)
        step = self._active_step.pop(name, None)   # in-flight step is lost
        if step is not None:
            # ... but its admitted-not-finished prefills must not be: put
            # them back in the queue so the drain below re-dispatches them
            client.requeue_step(step)
        if self.fleet is not None:
            self.fleet.set_windowed(name, False)
        for req in client.drain():             # checkpoint/restart semantics:
            # the stage restarts on another client; decoded tokens already
            # streamed to the user are kept.
            self._dispatch(req, now)

    def _on_add(self, c: Client, now: float):
        """CLIENT_ADD (scripted schedule or autoscaler scale-out)."""
        self.clients[c.name] = c
        if self.fleet is not None:
            self.fleet.add(c)
        self._warm_client(c, now)              # scaled-out replica is cold
        self._kick(c, now)

    def _on_remove(self, name: str, now: float):
        if name in self.clients:
            self._interrupt(name, now, reschedule=False)
        client = self.clients.pop(name, None)
        if client is None:
            return
        # mid-migration removal: a removed *donor* must not leave its export
        # pins behind (retired kv_stats would count permanently-pinned
        # blocks, and check_invariants on the retired allocator would fail);
        # a removed *recipient* must not leave its in-flight keys behind —
        # a warm-pool replica re-added later under the same name would be
        # refused warming by the stale dedup key. The MIGRATE_DONE events
        # themselves land as no-ops: release against a discarded handle
        # does nothing, and the dst lookup misses (or finds the same-named
        # fresh replica, which the import then legitimately warms).
        kv = self._kv_of(client)
        if kv is not None:
            kv.discard_exports()
        self._migrations_inflight = {
            k for k in self._migrations_inflight if k[0] != name}
        self.metrics.retire_client_kv(client)
        step = self._active_step.pop(name, None)
        if step is not None:
            client.requeue_step(step)
        drained = client.drain()
        if self.fleet is not None:
            self.fleet.remove(name, client)
        for req in drained:
            self._dispatch(req, now)

    def _check_straggler(self, req: rq.Request, armed_at: float, now: float):
        """Hedged re-dispatch (straggler mitigation), armed per dispatch as a
        deadline event instead of rescanning every client's waiting queue on
        every step completion: a request still queued — not started — at the
        client it was dispatched to when its deadline fires is re-routed.
        A request that cannot be rescued yet (running, or no alternative
        client) re-arms for another deadline, covering late stragglers the
        old continuous rescan would have caught (e.g. a preemption dropping
        it back into a slow client's queue after its first check)."""
        ddl = self.cfg.straggler_deadline
        if ddl is None or req.done:
            return
        # re-dispatched since this deadline was armed: a newer one is queued
        if self._dispatch_times.get(req.rid) != armed_at:
            return
        st = req.current_stage
        client = self.clients.get(st.client) if st.client else None
        if client is None:
            return
        rearm = lambda: self.queue.push(now + ddl, ev.STRAGGLER_CHECK,
                                        (req, armed_at))
        if client.failed:
            rearm()                       # fail-drain will re-dispatch it
            return
        sched = client.scheduler
        waiting = getattr(sched, "waiting", ())
        if req not in waiting:
            rearm()                       # running now, may be preempted yet
            return
        cands = self._candidates(req) or []
        if not any(c is not client for c in cands):
            rearm()                       # nowhere else to go (for now)
            return
        if hasattr(sched, "remove_waiting"):
            sched.remove_waiting(req)     # frees any pages it held
        else:
            waiting.remove(req)
        self._touch(client.name)
        req.preemptions += 1
        self._dispatch(req, now)

    # ------------------------------------------------------------------
    @property
    def total_energy(self) -> float:
        return sum(c.total_energy for c in self.clients.values())

    def all_serviced(self) -> bool:
        return len(self.metrics.serviced) >= self._accepted
