"""vLLM-style LLM scheduler with the paper's five batching strategies
(§III-D1): static, continuous, chunked, mixed, disaggregated (prefill_only /
decode_only halves), plus FCFS / least-work-left packing.

KV memory is managed by the paged allocator (``core/memory.py``): admission
reserves whole-context block tables, decode growth faults in blocks one at a
time, and exhaustion is resolved by a pluggable preemption policy —
``swap`` (offload the coldest request's pages to the next tier, priced with
the Eq. 1 tier term) or ``recompute`` (drop pages, re-enqueue the prefill).

Prefix sharing (``limits.prefix_caching``, on by default): requests carrying
``prefix_segments`` admit against the allocator's radix cache — resident
shared-prefix blocks are mapped instead of re-allocated, and the hit tokens
discount the prefill compute (``Request.cached_tokens`` becomes a *real*
lookup). Multi-branch reasoning requests fork their block table copy-on-write
on the first divergent decode write, so branches share every prefill page.

Decode fast-forward (``limits.fast_forward``, on by default): when the batch
composition is provably stable — nothing waiting or swapped, no pending swap
charges, every decode table on-device with an unshared tail, and the next
``K`` growth steps fit in the free list — ``plan_step`` returns one
*macro-step* covering ``K = min(tokens-to-next-completion,
tokens-to-block-boundary-pressure)`` decode iterations instead of ``K``
events. Pricing is exact summation: the per-step cost is evaluated at every
context in the window (bit-equal with per-step execution; the LRU-memoized
``ClientPerf`` makes repeats cheap), and per-step end times are accumulated
in the same order the event loop would, so token timestamps, energy and
every ``kv_*`` counter are identical with the flag on or off. The
coordinator may *truncate-and-replay* an in-flight window when an external
event lands mid-window (``truncate_step``).
"""
from __future__ import annotations

import itertools
from collections import deque
from heapq import heappop, heappush
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory import PagedKVAllocator, tier_transfer_time
from repro_torch.core.request import Request
from repro_torch.perfmodel import analytical as ana
from repro_torch.perfmodel.hardware import CacheTierSpec, ClusterSpec, \
    DEFAULT_SWAP_TIERS

STRATEGIES = ("static", "continuous", "chunked", "mixed",
              "prefill_only", "decode_only")
PREEMPTION_POLICIES = ("swap", "recompute")


@dataclass(frozen=True)
class SchedulerLimits:
    max_batch: int = 64
    max_prefill_tokens: int = 8192     # prefill token budget per step
    chunk_size: int = 512              # chunked-batching token budget
    # paged KV allocator knobs
    kv_block_tokens: int = 32          # tokens per KV page
    preemption: str = "swap"           # swap | recompute
    kv_capacity_frac: float = 1.0      # scale usable HBM (capacity studies)
    swap_tiers: Tuple[CacheTierSpec, ...] = DEFAULT_SWAP_TIERS
    # shared-prefix radix cache + copy-on-write branch forking. Neutral for
    # workloads without prefix_segments / branches; set False to reproduce
    # the pre-radix allocator behavior exactly.
    prefix_caching: bool = True
    # decode fast-forward: collapse provably-stable decode windows into one
    # macro-step event. Metrics-neutral by construction (see module doc);
    # set False to force one event per decode iteration.
    fast_forward: bool = True
    # speculative decoding: every pure-decode step drafts ``spec_k`` tokens
    # with the ``spec_draft`` model and verifies them in one target pass
    # (priced by ``analytical.speculative_decode_step``). ``spec_acceptance``
    # is either a scalar alpha (geometric acceptance) or a measured
    # per-position CONDITIONAL distribution — e.g. the real engine's
    # ``spec_stats()["conditional_acceptance_per_position"]``, which is how
    # ``benchmarks/spec_decode.py`` calibrates the simulator. Fast-forward
    # is disabled while speculation is on (variable tokens/step break the
    # window invariants).
    spec_k: int = 0
    spec_draft: str = "guard_2b"
    spec_acceptance: object = 0.8      # float | Sequence[float]
    # swap granularity (§III-B2 applied to the swap path): "full" stalls for
    # the whole table crossing the tier boundary; "layerwise" overlaps the
    # move with layer-by-layer compute so only ~one layer group of payload is
    # exposed — the same pricing the disaggregated KV handoff uses
    # (``comm.Network._exposed`` / engine ``move_pages``). Bytes accounting
    # is identical either way. ``swap_layer_groups=0`` means one group per
    # model layer.
    swap_granularity: str = "full"     # full | layerwise
    swap_layer_groups: int = 0         # 0 -> num_layers
    # per-step history retention: None keeps every step dict (seed behavior,
    # fine for small fleets), 0 disables recording entirely, n > 0 keeps a
    # ring buffer of the last n steps. ``step_events`` stays a monotonic
    # counter either way, so ``simulator_stats`` is retention-independent.
    history_limit: Optional[int] = None


@dataclass
class LLMStep:
    kind: str                          # "prefill" | "decode" | "chunked"
    prefill: List[Tuple[Request, int]] = field(default_factory=list)  # (req, tokens)
    decode: List[Request] = field(default_factory=list)
    duration: float = 0.0
    energy: float = 0.0
    flops: float = 0.0
    # KV paging traffic attributed to this step (set at plan/finish time)
    swap_bytes: float = 0.0
    swap_time: float = 0.0
    preemptions: int = 0
    # speculative decode step: expected committed tokens per request this
    # iteration (0.0 = plain decode, one token); finish_step integerizes
    # through the scheduler's carry accumulator
    spec_expected: float = 0.0
    # fast-forward macro-step window (n_steps > 1): absolute per-iteration
    # end times (== token emission times) and the per-iteration cost vectors,
    # all accumulated in event-loop order so truncation replays exactly
    n_steps: int = 1
    end_time: Optional[float] = None   # absolute; None => now + duration
    token_times: Optional[List[float]] = None
    step_durations: Optional[List[float]] = None
    step_energies: Optional[List[float]] = None
    step_flops: Optional[List[float]] = None

    @property
    def n_tokens(self) -> int:
        pre = sum(t for _, t in self.prefill)
        dec = sum(r.branches for r in self.decode)
        return pre + dec * self.n_steps


# SLO-tier admission ranks for the ``slo_tier`` packing: lower ranks admit
# first (interactive traffic has the tightest TTFT SLO, batch the loosest).
# Tiers outside the map take the "default" rank, between the two.
TIER_PRIORITY: Dict[str, int] = {"interactive": 0, "default": 1, "batch": 2}


class WaitQueue:
    """Admission queue for ``LLMScheduler``.

    ``fcfs`` packing is a deque — ``popleft``/``appendleft`` replace the
    O(n) list-head ``pop(0)``/``insert(0)`` churn. ``least_work`` and
    ``slo_tier`` packings are incremental lazy-deletion min-heaps, replacing
    the full re-sort previously done on every ``add``: ``least_work`` keys
    on remaining work at push time; ``slo_tier`` keys on the request's SLO
    tier rank (``TIER_PRIORITY``), FCFS within a tier, so under overload
    interactive-tier requests admit ahead of earlier-arrived batch requests
    (per-tier SLO-aware admission). Preempted victims rejoin their tier's
    tail. Iteration yields live requests in insertion order (heap order only
    matters at the head)."""

    def __init__(self, packing: str = "fcfs"):
        self.packing = packing
        self._heaped = packing in ("least_work", "slo_tier")
        self._dq: deque = deque()
        self._heap: List[Tuple[float, int, Request]] = []
        self._live: Dict[int, Request] = {}    # id(req) -> req (heap mode)
        self._seq = itertools.count()

    @staticmethod
    def _work(r: Request) -> int:
        return r.effective_prefill_tokens + r.remaining_tokens

    @staticmethod
    def _rank(r: Request) -> int:
        return TIER_PRIORITY.get(getattr(r, "tier", "default"),
                                 TIER_PRIORITY["default"])

    def _key(self, r: Request) -> float:
        return self._work(r) if self.packing == "least_work" else self._rank(r)

    def push(self, r: Request):
        if self._heaped:
            heappush(self._heap, (self._key(r), next(self._seq), r))
            self._live[id(r)] = r
        else:
            self._dq.append(r)

    # list-compatible aliases (external callers/tests enqueue directly)
    append = push

    def requeue(self, r: Request):
        """Preempted victim: back to the head (FCFS) / keyed spot (heap)."""
        if self._heaped:
            self.push(r)
        else:
            self._dq.appendleft(r)

    def _head(self) -> Optional[Request]:
        while self._heap:
            _, _, r = self._heap[0]
            if id(r) in self._live:
                return r
            heappop(self._heap)            # lazily-deleted entry
        return None

    def peek(self) -> Optional[Request]:
        if self._heaped:
            return self._head()
        return self._dq[0] if self._dq else None

    def popleft(self) -> Request:
        if self._heaped:
            r = self._head()
            heappop(self._heap)
            del self._live[id(r)]
            return r
        return self._dq.popleft()

    def remove(self, r: Request) -> bool:
        if self._heaped:
            return self._live.pop(id(r), None) is not None
        try:
            self._dq.remove(r)
            return True
        except ValueError:
            return False

    def clear(self):
        self._dq.clear()
        self._heap.clear()
        self._live.clear()

    def __contains__(self, r: Request) -> bool:
        if self._heaped:
            return id(r) in self._live
        return r in self._dq

    def __iter__(self) -> Iterable[Request]:
        if self._heaped:
            return iter(list(self._live.values()))
        return iter(self._dq)

    def __reversed__(self):
        if self._heaped:
            # the list version was kept sorted by key, so reversed() means
            # worst-candidate-first (heaviest work / lowest-priority tier)
            # — preserve that for victim-selection callers. The sort is
            # stable, so within a tier later arrivals are preempted first.
            return reversed(sorted(self._live.values(), key=self._key))
        return reversed(self._dq)

    def __len__(self) -> int:
        if self._heaped:
            return len(self._live)
        return len(self._dq)

    def __bool__(self) -> bool:
        return len(self) > 0


class ClientPerf:
    """Runtime predictor for a client: fitted regression with analytical
    fallback (paper §III-E1).

    Every entry point is memoized through one bounded LRU keyed on the exact
    argument tuple: identical decode steps — the common case, since a stable
    batch re-prices the same ``(batch, avg_ctx)`` point every iteration and
    sweeps revisit whole scenarios — return the cached ``StageCost``
    (immutable, safely shared) instead of re-running the analytical roofline
    or the regression predict.

    With ``use_regression`` the ridge fits live on ``device`` (default the
    card; no CPU fallback), and each memo miss prices one point there;
    without it no tensor is made and ``device`` is unused."""

    MEMO_CAPACITY = 8192

    def __init__(self, model_cfg: ModelConfig, cluster: ClusterSpec,
                 use_regression: bool = True, device="cuda"):
        self.cfg = model_cfg
        self.cluster = cluster
        self.decode_model = None
        self.prefill_model = None
        self._memo: Dict[Tuple, ana.StageCost] = {}
        self._spec_memo: Dict[Tuple, Tuple[ana.StageCost, float]] = {}
        if use_regression:
            from repro_torch.perfmodel import regression as reg
            self.decode_model = reg.fit_decode_model(model_cfg, cluster,
                                                     device=device)
            self.prefill_model = reg.fit_prefill_model(model_cfg, cluster,
                                                       device=device)

    def _memo_get(self, key: Tuple) -> Optional[ana.StageCost]:
        c = self._memo.pop(key, None)
        if c is not None:
            self._memo[key] = c            # refresh recency
        return c

    def _memo_put(self, key: Tuple, cost: ana.StageCost) -> ana.StageCost:
        if len(self._memo) >= self.MEMO_CAPACITY:
            del self._memo[next(iter(self._memo))]   # evict LRU head
        self._memo[key] = cost
        return cost

    def prefill(self, tokens: int, batch: int, past: int = 0) -> ana.StageCost:
        key = ("p", tokens, batch, past)
        hit = self._memo_get(key)
        if hit is not None:
            return hit
        c = ana.prefill_time(self.cfg, self.cluster, tokens, batch, past)
        if self.prefill_model is not None:
            t = float(self.prefill_model.predict([past], [tokens], [batch])[0])
            if t > 0:
                c = ana.StageCost(t, c.energy * t / max(c.time, 1e-12),
                                  c.flops, c.bytes, c.bound)
        return self._memo_put(key, c)

    def decode(self, batch: int, avg_ctx: int) -> ana.StageCost:
        key = ("d", batch, avg_ctx)
        hit = self._memo_get(key)
        if hit is not None:
            return hit
        c = ana.decode_step_time(self.cfg, self.cluster, batch, avg_ctx)
        if self.decode_model is not None:
            t = float(self.decode_model.predict([batch], [avg_ctx])[0])
            if t > 0:
                c = ana.StageCost(t, c.energy * t / max(c.time, 1e-12),
                                  c.flops, c.bytes, c.bound)
        return self._memo_put(key, c)

    def spec_decode(self, batch: int, avg_ctx: int, draft_cfg: ModelConfig,
                    k: int, alpha) -> Tuple[ana.StageCost, float]:
        """Price one speculative iteration — draft ``k`` tokens with
        ``draft_cfg`` plus one (k+1)-position verify pass on the target —
        and its expected committed tokens. ``alpha`` is a scalar or a
        measured per-position acceptance distribution."""
        akey = alpha if isinstance(alpha, (int, float)) else tuple(alpha)
        key = (batch, avg_ctx, k, akey)
        hit = self._spec_memo.get(key)
        if hit is not None:
            return hit
        out = ana.speculative_decode_step(self.cfg, draft_cfg, self.cluster,
                                          batch, avg_ctx, k=k, alpha=alpha)
        if len(self._spec_memo) >= self.MEMO_CAPACITY:
            del self._spec_memo[next(iter(self._spec_memo))]
        self._spec_memo[key] = out
        return out

    def chunked(self, chunk_tokens: int, decode_batch: int,
                avg_ctx: int) -> ana.StageCost:
        key = ("c", chunk_tokens, decode_batch, avg_ctx)
        hit = self._memo_get(key)
        if hit is not None:
            return hit
        return self._memo_put(key, ana.chunked_step_time(
            self.cfg, self.cluster, chunk_tokens, decode_batch, avg_ctx))


class LLMScheduler:
    def __init__(self, strategy: str, model_cfg: ModelConfig,
                 cluster: ClusterSpec, perf: Optional[ClientPerf] = None,
                 limits: SchedulerLimits = SchedulerLimits(),
                 packing: str = "fcfs"):
        assert strategy in STRATEGIES, strategy
        assert limits.preemption in PREEMPTION_POLICIES, limits.preemption
        self.strategy = strategy
        self.cfg = model_cfg
        self.cluster = cluster
        self.perf = perf or ClientPerf(model_cfg, cluster, use_regression=False)
        self.limits = limits
        self.packing = packing
        self.waiting = WaitQueue(packing)
        self.running: List[Request] = []
        self.swapped: List[Request] = []   # preempted-to-tier, awaiting swap-in
        self.chunk_progress: Dict[int, int] = {}   # rid -> prefilled tokens
        self.static_batch: List[Request] = []
        weights = model_cfg.param_count() * ana.BYTES_PER_PARAM / cluster.tp
        capacity = max(cluster.total_mem - weights * cluster.n_chips / max(
            1, cluster.tp) * cluster.tp, cluster.total_mem * 0.15)
        self.kv_per_token = ana.kv_bytes_per_token(model_cfg) + (
            ana.ssm_state_bytes(model_cfg) / 4096.0)
        self.kv = PagedKVAllocator(
            capacity * limits.kv_capacity_frac, self.kv_per_token,
            block_tokens=limits.kv_block_tokens,
            swap_tiers=limits.swap_tiers)
        # speculative decoding: draft config resolved once; the fractional
        # expected-tokens stream integerizes through a carry accumulator so
        # long-run emitted tokens match the expectation exactly
        self._draft_cfg: Optional[ModelConfig] = None
        self._spec_carry = 0.0
        if limits.spec_k:
            from repro_torch.configs import get_config
            self._draft_cfg = get_config(limits.spec_draft)
        # swap traffic incurred inside finish_step, charged to the NEXT step
        self._pending_swap_bytes = 0.0
        self._pending_swap_time = 0.0
        self._pending_preemptions = 0
        # decode_only victims of recompute preemption: their KV must be
        # re-fetched (a decode replica cannot re-run prefill), priced on
        # re-admission like a swap-in from the first spill tier
        self._needs_refetch: set = set()
        # scheduler-level metrics (paper §III-F2). history_limit bounds the
        # per-step dicts held in memory (None = keep all, 0 = record none,
        # n = ring of last n); step_events counts appends regardless so
        # simulator_stats stays exact at 1000-client scale.
        hl = limits.history_limit
        self.history = ([] if hl is None
                        else deque(maxlen=hl if hl > 0 else 0))
        self.step_events = 0
        self.total_energy = 0.0
        self.total_tokens = 0
        # simulator-cost accounting: engine iterations actually simulated
        # (a macro-step counts n_steps) vs. macro windows planned
        self.micro_steps = 0
        self.macro_windows = 0
        # in-flight fast-forward window, so load metrics can be read
        # against virtually-committed state without cutting the window
        self._window: Optional[LLMStep] = None

    # ------------------------------------------------------------------
    def add(self, req: Request):
        if self.strategy == "decode_only":
            # KV produced by the prefill client arrives with the request
            if self._admit_decode(req):
                self.running.append(req)
            else:
                self.waiting.push(req)
        else:
            self.waiting.push(req)

    # --- prefix sharing -------------------------------------------------
    def _prefix_hashes(self, r: Request) -> List[int]:
        if not self.limits.prefix_caching or not r.prefix_segments:
            return []
        return r.prefix_block_hashes(self.kv.block_tokens)

    def _apply_prefix_discount(self, r: Request) -> List[int]:
        """Turn ``cached_tokens`` into a real radix-cache lookup: the tokens
        whose blocks are already resident need no prefill compute. At least
        one token is always computed (the sampling position). Requests
        without a shared-prefix identity keep their fiat value."""
        hashes = self._prefix_hashes(r)
        if hashes:
            hit = self.kv.peek_prefix_tokens(hashes)
            r.cached_tokens = min(hit, r.input_tokens + r.rag_tokens - 1)
        return hashes

    def _branch_rids(self, r: Request) -> List:
        """Allocator keys for the copy-on-write branch tables of a
        multi-branch reasoning request (the parent keeps ``r.rid``)."""
        if r.branches <= 1 or not self.limits.prefix_caching:
            return []
        return [("br", r.rid, b) for b in range(1, r.branches)]

    def _release_kv(self, r: Request):
        """Free the request's main table plus any forked branch tables."""
        for br in self._branch_rids(r):
            if self.kv.holds(br):
                self.kv.free(br)
        self.kv.free(r.rid)

    def _drop_kv(self, r: Request):
        """Recompute-preemption drop, branch tables included."""
        for br in self._branch_rids(r):
            if self.kv.holds(br):
                self.kv.free(br)
        self.kv.drop(r.rid)

    def _admit_decode(self, req: Request) -> bool:
        # prefix hashes dedup handed-off pages against this client's radix
        # cache, but the hit tokens were already counted at the prefill
        # client — count_hits=False keeps the global counters single-counted
        hashes = self._prefix_hashes(req)
        resident = self.kv.peek_prefix_tokens(hashes) if hashes else 0
        if not self.kv.allocate(req.rid, req.total_context,
                                prefix_hashes=hashes,
                                force=self._oversized(req.total_context),
                                count_hits=False):
            return False
        if req.rid in self._needs_refetch:
            self._needs_refetch.discard(req.rid)
            # pages the radix lookup just mapped locally need no wire fetch
            # — same dedup the coordinator applies to the first handoff
            nbytes = req.total_context * self.kv_per_token
            nbytes -= min(nbytes, resident * self.kv_per_token)
            if nbytes > 0:
                self._pending_swap_bytes += nbytes
                if self.kv.tiers:
                    self._pending_swap_time += tier_transfer_time(
                        nbytes, self.kv.tiers[0].spec)
        if req.decoded_tokens == 0:
            req.decoded_tokens = 1   # disagg prefill emitted token #1
        return True

    def _oversized(self, tokens: int) -> bool:
        """A context bigger than the entire pool can never be admitted by
        backpressure alone — overcommit it (counted) so the system stays
        live, matching real engines' max-model-len escape valves."""
        return self.kv.blocks_for_tokens(tokens) > self.kv.num_blocks

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.static_batch
                    or self.swapped)

    # ------------------------------------------------------------------
    def _admit_prefills(self, token_budget: int, batch_budget: int
                        ) -> List[Tuple[Request, int]]:
        """Admit whole-request prefills under budgets + paged KV memory."""
        out = []
        used = 0
        while self.waiting and len(out) < batch_budget:
            r = self.waiting.peek()
            hashes = self._apply_prefix_discount(r)
            toks = r.effective_prefill_tokens
            if out and used + toks > token_budget:
                break
            # decoded_tokens > 0 happens on re-admission after a recompute
            # preemption: the regenerated KV occupies slots again
            ctx = r.input_tokens + r.rag_tokens + r.decoded_tokens
            if not self.kv.allocate(r.rid, ctx, prefix_hashes=hashes,
                                    force=self._oversized(ctx)):
                break
            self.waiting.popleft()
            out.append((r, toks))
            used += toks
        return out

    def plan_step(self, now: Optional[float] = None, slowdown: float = 1.0,
                  horizon: Optional[float] = None) -> Optional[LLMStep]:
        """Plan the next engine step. ``now``/``slowdown`` enable decode
        fast-forward: with the absolute clock known, a stable decode batch is
        expanded into a macro-step whose per-iteration end times are
        pre-accumulated (slowdown applied per iteration, exactly as the event
        loop would). Without ``now`` (direct callers, non-coordinator use)
        planning stays strictly per-step; single steps are returned unscaled
        and the caller applies slowdown as before."""
        self._try_swap_in()
        s = self.strategy
        if s in ("continuous", "prefill_only", "mixed"):
            step = self._plan_continuous(mixed=(s == "mixed"),
                                         prefill_only=(s == "prefill_only"))
        elif s == "decode_only":
            step = self._plan_decode_only()
        elif s == "chunked":
            step = self._plan_chunked()
        elif s == "static":
            step = self._plan_static()
        else:
            raise ValueError(s)
        if step is not None:
            if now is not None:
                self._maybe_fast_forward(step, now, slowdown, horizon)
            self._attach_pending_swaps(step)
        return step

    # --- decode fast-forward (macro-steps) ------------------------------
    def _ff_groups(self, dec: List[Request]) -> Optional[List[Tuple[List, int]]]:
        """Per-request allocator growth groups for a fast-forward window, or
        None when any request disqualifies the batch: a pending branch fork,
        an off-device or missing table, or a shared partial tail (the next
        write would copy-on-write — let the per-step path take it; one step
        later the tail is private and the window opens)."""
        kv = self.kv
        tables = kv.tables
        # with zero shared blocks device-wide no tail can be shared, so the
        # per-table COW probe is skipped on the (dominant) unshared path
        check_tails = kv._n_shared > 0
        groups: List[Tuple[List, int]] = []
        for r in dec:
            if r.output_tokens <= r.decoded_tokens:
                return None
            brs = self._branch_rids(r)
            if brs and not kv.holds(brs[0]):
                return None                  # fork happens on the next write
            rids = [r.rid] + brs
            for rid in rids:
                t = tables.get(rid)
                if t is None or t.tier != 0:
                    return None
                if check_tails and kv.shared_partial_tail(rid):
                    return None
            groups.append((rids, 1 if brs else r.branches))
        return groups

    def _maybe_fast_forward(self, step: LLMStep, now: float, slowdown: float,
                            horizon: Optional[float] = None):
        """Expand a stable pure-decode step into a macro-step in place.

        Stability invariants (all checked here, so the window can only be cut
        short by an *external* event, which the coordinator handles with
        truncate-and-replay):
        * pure decode — no prefill admissions this step, and none possible
          before the window ends (``waiting`` empty; static batches ignore
          ``waiting`` until they drain, so it may be non-empty there);
        * no swapped-out requests to resume and no pending swap/preemption
          charges to attach;
        * every table grows preemption-free: the worst-case block demand of
          the whole window fits in the free list (``max_growth_steps``), so
          no page fault, radix eviction or victim selection can fire.
        The window length is ``K = min(tokens-to-next-completion,
        tokens-to-block-boundary-pressure)``, additionally cut at the first
        iteration crossing ``horizon`` (the coordinator's next known external
        event — that iteration would be the one in flight when the event
        lands, so pricing past it is work truncate-and-replay would discard).
        Windows of length 1 stay plain steps."""
        if not self.limits.fast_forward or step.n_steps != 1:
            return
        if self.limits.spec_k:
            return   # spec steps emit variable tokens; window invariants
                     # assume exactly one per iteration
        if self.strategy not in ("continuous", "decode_only", "static"):
            return
        if step.kind != "decode" or step.prefill or not step.decode:
            return
        if self.swapped or (self.waiting and self.strategy != "static"):
            return
        if self._pending_swap_bytes or self._pending_swap_time \
                or self._pending_preemptions:
            return
        dec = step.decode
        groups = self._ff_groups(dec)
        if groups is None:
            return
        k_done = min(r.remaining_tokens for r in dec)
        k = self.kv.max_growth_steps(groups, k_done)
        if k <= 1:
            return
        batch = sum(r.branches for r in dec)
        ctx0 = self._avg_ctx(dec)   # grows by exactly 1 per step (stable batch)
        times: List[float] = []
        durs: List[float] = []
        energies: List[float] = []
        flops: List[float] = []
        t = now
        for i in range(k):
            c = self.perf.decode(batch, ctx0 + i)
            d = c.time * slowdown if slowdown != 1.0 else c.time
            t = t + d               # event-loop accumulation order, bit-exact
            times.append(t)
            durs.append(d)
            energies.append(c.energy)
            flops.append(c.flops)
            if horizon is not None and t >= horizon:
                break               # keep the crossing iteration, drop the rest
        k = len(times)
        if k <= 1:
            return
        step.n_steps = k
        step.token_times = times
        step.step_durations = durs
        step.step_energies = energies
        step.step_flops = flops
        step.end_time = times[-1]
        step.duration = times[-1] - now      # reporting only
        step.energy = sum(energies)
        step.flops = sum(flops)
        self.macro_windows += 1
        self._window = step

    def _attach_pending_swaps(self, step: LLMStep):
        """Charge swap traffic (from preemptions and swap-ins) to this step:
        the engine stalls at idle power while pages cross the tier boundary."""
        if self._pending_swap_time > 0 or self._pending_swap_bytes > 0 \
                or self._pending_preemptions:
            step.swap_bytes += self._pending_swap_bytes
            step.swap_time += self._pending_swap_time
            step.duration += self._pending_swap_time
            step.preemptions += self._pending_preemptions
            step.energy += ana.idle_stall_energy(self._pending_swap_time,
                                                 self.cluster)
            self._pending_swap_bytes = 0.0
            self._pending_swap_time = 0.0
            self._pending_preemptions = 0

    def _swap_groups(self) -> int:
        """Layer groups for layerwise swap pricing; 0 = one per layer."""
        n = self.limits.swap_layer_groups
        return n if n > 0 else self.cfg.num_layers

    def _try_swap_in(self):
        """Resume swapped-out requests oldest-first, keeping one block of
        headroom per running request to avoid swap ping-pong. When nothing
        else is active the headroom is waived so the system stays live."""
        while self.swapped:
            r = self.swapped[0]
            need = len(self.kv.tables[r.rid].blocks)
            headroom = len(self.running) if (self.running or self.waiting) else 0
            if need + headroom > self.kv.available_blocks:
                break
            res = self.kv.swap_in(r.rid, self.limits.swap_granularity,
                                  self._swap_groups())
            if res is None:
                break
            nbytes, t = res
            self._pending_swap_bytes += nbytes
            self._pending_swap_time += t
            self.swapped.pop(0)
            if self.strategy == "static":
                self.static_batch.append(r)
            else:
                self.running.append(r)

    # --- preemption ----------------------------------------------------
    def _preemptable(self, exclude: Request) -> Optional[Request]:
        """Coldest victim = the most recently admitted request (LIFO), so the
        oldest request always keeps its pages and the system stays live.
        Finished requests (no pages to reclaim usefully, must not re-enter
        the queues) are never victims."""
        for pool in (self.running, self.static_batch):
            for r in reversed(pool):
                if r is not exclude and r.remaining_tokens > 0 \
                        and self.kv.holds(r.rid):
                    return r
        return None

    def _preempt_one(self, grower: Request) -> bool:
        """Evict one victim to make room for ``grower``. Returns False when
        nobody but ``grower`` holds pages."""
        # a finished static-batch member still holds pages until the batch
        # drains — reclaim those first, in place, so it never lands in
        # swapped/waiting (where a done request would stall _plan_static)
        for r in self.static_batch:
            if r is not grower and r.remaining_tokens <= 0 \
                    and self.kv.holds(r.rid):
                self._release_kv(r)
                return True
        victim = self._preemptable(exclude=grower)
        if victim is None:
            # last resort: a queued chunked request holding partial pages
            for r in reversed(self.waiting):
                if r is not grower and self.kv.holds(r.rid):
                    self._drop_kv(r)
                    r.prefilled_tokens = 0
                    self.chunk_progress.pop(r.rid, None)
                    r.preemptions += 1
                    self._pending_preemptions += 1
                    return True
            return False
        victim.preemptions += 1
        self._pending_preemptions += 1
        if self.limits.preemption == "swap":
            # swap moves physical pages, so it applies only to refcount-1
            # tables; shared-prefix / forked victims return None and degrade
            # to recompute (which merely drops references)
            res = self.kv.swap_out(victim.rid, self.limits.swap_granularity,
                                   self._swap_groups())
            if res is not None:
                nbytes, t = res
                self._pending_swap_bytes += nbytes
                self._pending_swap_time += t
                self._remove_from_pools(victim)
                self.swapped.append(victim)
                return True
            # spill tiers full or pages shared: degrade to recompute
        self._drop_kv(victim)
        victim.prefilled_tokens = 0
        self.chunk_progress.pop(victim.rid, None)
        if self.strategy == "decode_only":
            self._needs_refetch.add(victim.rid)
        self._remove_from_pools(victim)
        self.waiting.requeue(victim)
        return True

    def _remove_from_pools(self, r: Request):
        for pool in (self.running, self.static_batch):
            if r in pool:
                pool.remove(r)

    def _grow(self, r: Request) -> bool:
        """Decode growth with preemption: returns False only when ``r`` was
        itself preempted (recompute) and must not emit a token this step.

        Multi-branch requests (prefix sharing on) grow one token per branch
        across copy-on-write tables forked from the prefill table on the
        first divergent write — branches share every prefill page and own
        only their divergent decode pages. With sharing off, the pre-radix
        behavior (one table growing ``branches`` slots per step) is kept."""
        brs = self._branch_rids(r)
        if brs:
            if not self.kv.holds(brs[0]):     # first divergent decode write
                for br in brs:
                    self.kv.fork(r.rid, br)
            grow = lambda force=False: self.kv.grow_request(
                [r.rid] + brs, 1, force=force)
        else:
            grow = lambda force=False: self.kv.append_tokens(
                r.rid, r.branches, force=force)
        while not grow():
            if not self._preempt_one(r):
                # r alone holds the pool (oversized request): overcommit
                grow(force=True)
                return True
            if not self.kv.holds(r.rid) or not self.kv.tables[r.rid].on_device:
                return False   # r lost its own pages to the policy
        return True

    # --- continuous / mixed / prefill-only ----------------------------
    def _plan_continuous(self, mixed: bool, prefill_only: bool) -> Optional[LLMStep]:
        pre = self._admit_prefills(self.limits.max_prefill_tokens,
                                   self.limits.max_batch)
        if pre:
            step = LLMStep("prefill", prefill=pre)
            toks = sum(t for _, t in pre)
            cost = self.perf.prefill(toks, 1)
            if mixed and self.running:
                dec = self.running[: self.limits.max_batch]
                step.decode = dec
                cost2 = self.perf.chunked(toks, sum(r.branches for r in dec),
                                          self._avg_ctx(dec))
                step.duration, step.energy, step.flops = (cost2.time,
                                                          cost2.energy, cost2.flops)
            else:
                step.duration, step.energy, step.flops = (cost.time, cost.energy,
                                                          cost.flops)
            return step
        if prefill_only or not self.running:
            return None
        return self._decode_step(self.running[: self.limits.max_batch])

    # --- pure decode (disaggregated decode client) ---------------------
    def _plan_decode_only(self) -> Optional[LLMStep]:
        # admit arrivals that found the pool full at add()
        while self.waiting:
            r = self.waiting.peek()
            if not self._admit_decode(r):
                break
            self.waiting.popleft()
            self.running.append(r)
        if not self.running:
            return None
        return self._decode_step(self.running[: self.limits.max_batch])

    # --- chunked (Sarathi) ---------------------------------------------
    def _plan_chunked(self) -> Optional[LLMStep]:
        dec = self.running[: self.limits.max_batch]
        budget = self.limits.chunk_size - sum(r.branches for r in dec)
        pre: List[Tuple[Request, int]] = []
        while budget > 0 and self.waiting:
            r = self.waiting.peek()
            done = self.chunk_progress.get(r.rid, 0)
            if done == 0 and not self.kv.holds(r.rid):
                hashes = self._apply_prefix_discount(r)
                ctx = r.input_tokens + r.rag_tokens + r.decoded_tokens
                if not self.kv.allocate(r.rid, ctx, prefix_hashes=hashes,
                                        force=self._oversized(ctx)):
                    break
            remaining = r.effective_prefill_tokens - done
            take = min(remaining, budget)
            pre.append((r, take))
            self.chunk_progress[r.rid] = done + take
            budget -= take
            if done + take >= r.effective_prefill_tokens:
                self.waiting.popleft()
            else:
                break  # head-of-line request still prefilling
        if not pre and not dec:
            return None
        toks = sum(t for _, t in pre)
        cost = self.perf.chunked(toks, sum(r.branches for r in dec),
                                 self._avg_ctx(dec) if dec else 0)
        return LLMStep("chunked", prefill=pre, decode=dec, duration=cost.time,
                       energy=cost.energy, flops=cost.flops)

    # --- static (FasterTransformers) ------------------------------------
    def _plan_static(self) -> Optional[LLMStep]:
        if not self.static_batch:
            pre = self._admit_prefills(10 ** 12, self.limits.max_batch)
            if not pre:
                return None
            self.static_batch = [r for r, _ in pre]
            toks = sum(t for _, t in pre)
            cost = self.perf.prefill(toks, 1)
            return LLMStep("prefill", prefill=pre, duration=cost.time,
                           energy=cost.energy, flops=cost.flops)
        live = [r for r in self.static_batch if r.remaining_tokens > 0]
        if not live:
            return None
        return self._decode_step(live)

    # ------------------------------------------------------------------
    def _decode_step(self, dec: List[Request]) -> LLMStep:
        """Price a pure-decode iteration. With ``limits.spec_k`` set this is
        a SPEC_DECODE stage — one draft+verify iteration committing
        ``spec_expected`` tokens per request in expectation — otherwise the
        classic one-token decode step."""
        batch = sum(r.branches for r in dec)
        ctx = self._avg_ctx(dec)
        if self.limits.spec_k:
            cost, exp = self.perf.spec_decode(batch, ctx, self._draft_cfg,
                                              self.limits.spec_k,
                                              self.limits.spec_acceptance)
            return LLMStep("decode", decode=dec, duration=cost.time,
                           energy=cost.energy, flops=cost.flops,
                           spec_expected=exp)
        cost = self.perf.decode(batch, ctx)
        return LLMStep("decode", decode=dec, duration=cost.time,
                       energy=cost.energy, flops=cost.flops)

    # ------------------------------------------------------------------
    def _avg_ctx(self, reqs: List[Request]) -> int:
        if not reqs:
            return 0
        return int(sum(r.total_context for r in reqs) / len(reqs))

    # ------------------------------------------------------------------
    def _apply_decode_window(self, step: LLMStep, j: int) -> List[Request]:
        """Commit the first ``j`` iterations of a macro-step: bulk KV growth
        (one allocator call per request instead of one per token), token
        emissions at the pre-accumulated per-iteration times, and energy
        accumulated in the same per-step order the event loop would use.
        Planning reserved the whole window's worst-case block demand out of
        the free list, so growth cannot fail. Completions can only happen at
        the window's final iteration (``K = tokens-to-next-completion``), so
        a truncated commit (``j < n_steps``) never finishes a request."""
        finished: List[Request] = []
        times = step.token_times[:j]
        for e in step.step_energies[:j]:
            self.total_energy += e
        # KV growth is bulk — unless this commit completes a request. A
        # completion's release interleaves with neighbours' growth in the
        # per-step loop, so to keep the transient peak_blocks high-water mark
        # bit-equal the first j-1 iterations grow in bulk (pure monotone
        # growth: order is transparent to the peak) and the final iteration
        # replays the per-step grow-emit-release order request by request.
        def _grow_bulk(r: Request, n: int) -> bool:
            brs = self._branch_rids(r)
            if brs:
                return self.kv.grow_request([r.rid] + brs, n)
            return self.kv.append_tokens(r.rid, n * r.branches)

        completes = any(r.remaining_tokens == j for r in step.decode)
        head = j - 1 if completes else j
        if head > 0:
            for r in step.decode:
                if not _grow_bulk(r, head):   # plan reserved this headroom
                    raise AssertionError(
                        "fast-forward window overran its reserved headroom")
        for r in step.decode:
            if completes and not _grow_bulk(r, 1):
                raise AssertionError(
                    "fast-forward window overran its reserved headroom")
            r.decoded_tokens += j
            if r.first_token_time is None:
                r.first_token_time = times[0]
            r.last_token_time = times[-1]
            r.token_times.extend(times)
            self.total_tokens += r.branches * j
            if r.remaining_tokens <= 0 and self.strategy != "static":
                finished.append(r)
                self._release_kv(r)
                if r in self.running:
                    self.running.remove(r)
        if self.strategy == "static" and self.static_batch and \
                all(r.remaining_tokens <= 0 for r in self.static_batch):
            for r in self.static_batch:
                finished.append(r)
                self._release_kv(r)
            self.static_batch = []
        self.micro_steps += j
        self.step_events += 1
        self.history.append({
            "time": times[-1], "queue": len(self.waiting),
            "running": len(self.running), "swapped": len(self.swapped),
            "mem_used": self.kv.used,
            "kv_util": self.kv.used_blocks / max(1, self.kv.num_blocks),
            "step_tokens": sum(r.branches for r in step.decode) * j,
            "kind": step.kind, "steps": j,
        })
        return finished

    def truncate_step(self, step: LLMStep, now: float,
                      inclusive: bool = False
                      ) -> Tuple[Optional[LLMStep], List[float]]:
        """Macro-step invalidation (truncate-and-replay): an external event
        landed at ``now``, mid-window. Commit the prefix of iterations that
        already finished — strictly before ``now``; ``inclusive`` (horizon
        cut-off) also commits one ending exactly at ``now`` — and return
        ``(remainder, committed_energies)``. The remainder is the iteration
        in flight across ``now``, repackaged as a plain single step ending at
        its original boundary: exactly the step a per-step execution would
        have had in flight, so the replay is bit-equal. ``remainder`` is None
        when the whole window committed (only possible via ``inclusive``)."""
        self._window = None
        cut = bisect_right if inclusive else bisect_left
        j = cut(step.token_times, now)
        if j > 0:
            self._apply_decode_window(step, j)
        if j >= step.n_steps:
            return None, step.step_energies
        rem = LLMStep("decode", decode=list(step.decode),
                      duration=step.step_durations[j],
                      energy=step.step_energies[j],
                      flops=step.step_flops[j])
        rem.end_time = step.token_times[j]
        return rem, step.step_energies[:j]

    def finish_step(self, step: LLMStep, now: float) -> List[Request]:
        """Apply step effects; returns requests whose LLM stage completed."""
        if step.n_steps > 1:
            self._window = None
            return self._apply_decode_window(step, step.n_steps)
        finished: List[Request] = []
        self.total_energy += step.energy
        for r, toks in step.prefill:
            r.prefilled_tokens += toks
            if r.prefilled_tokens >= r.effective_prefill_tokens:
                self.chunk_progress.pop(r.rid, None)
                # prefill emits the first output token
                if r.decoded_tokens == 0:
                    r.decoded_tokens = 1
                    r.first_token_time = now
                    r.last_token_time = now
                    r.token_times.append(now)
                    self.total_tokens += 1
                if self.strategy == "prefill_only":
                    finished.append(r)  # hand off to the decode client
                    # KV ships to the decode client; radix-registered prefix
                    # blocks stay cached for the next same-prefix prefill
                    self._release_kv(r)
                elif r.remaining_tokens <= 0:
                    finished.append(r)
                    self._release_kv(r)
                elif self.strategy != "static":
                    self.running.append(r)
        n_emit = 1
        if step.spec_expected and step.decode:
            # integerize the fractional expectation through the carry so the
            # long-run token stream matches it exactly (expected >= 1 keeps
            # every iteration emitting at least one token)
            self._spec_carry += step.spec_expected
            n_emit = max(1, int(self._spec_carry))
            self._spec_carry -= n_emit
        for r in step.decode:
            if r.remaining_tokens <= 0:
                continue
            if not self.kv.holds(r.rid) or not self.kv.tables[r.rid].on_device:
                continue   # preempted earlier in this very step
            emit = 0
            for _ in range(min(n_emit, r.remaining_tokens)):
                if not self._grow(r):
                    break  # recompute-preempted itself; stop emitting
                emit += 1
            if not emit:
                continue
            r.decoded_tokens += emit
            if r.first_token_time is None:
                r.first_token_time = now
            r.last_token_time = now
            r.token_times.extend([now] * emit)
            self.total_tokens += r.branches * emit
            if r.remaining_tokens <= 0 and self.strategy != "static":
                finished.append(r)
                self._release_kv(r)
                if r in self.running:
                    self.running.remove(r)
        if self.strategy == "static" and self.static_batch and \
                all(r.remaining_tokens <= 0 for r in self.static_batch):
            for r in self.static_batch:
                finished.append(r)
                self._release_kv(r)
            self.static_batch = []
        self.micro_steps += 1
        self.step_events += 1
        self.history.append({
            "time": now, "queue": len(self.waiting), "running": len(self.running),
            "swapped": len(self.swapped), "mem_used": self.kv.used,
            "kv_util": self.kv.used_blocks / max(1, self.kv.num_blocks),
            "step_tokens": step.n_tokens, "kind": step.kind, "steps": 1,
        })
        return finished

    # --- fault tolerance ------------------------------------------------
    def requeue_step(self, step: LLMStep) -> None:
        """An in-flight step is being discarded unfinished (client fail or
        removal). Prefill admission pops requests out of ``waiting`` while
        they only enter ``running`` at ``finish_step`` — inside a discarded
        step they are invisible to ``drain()`` and would be lost outright
        (a straggler deadline then re-arms for them forever). Put them back
        first. Decode members are still in ``running`` and static batches
        in ``static_batch``, both already drain-visible."""
        for r, _ in step.prefill:
            if (r not in self.waiting and r not in self.running
                    and r not in self.static_batch):
                self.waiting.requeue(r)

    def drain(self) -> List[Request]:
        """Client failure: return every in-flight request for re-dispatch.
        KV state is lost; prefill restarts (paper-scale systems re-prefill)."""
        out = (list(self.waiting) + list(self.running)
               + list(self.static_batch) + list(self.swapped))
        for r in out:
            self._release_kv(r)
            r.prefilled_tokens = 0
            if r.decoded_tokens > 1:
                r.decoded_tokens = max(1, r.decoded_tokens)  # keep emitted tokens
            r.failures += 1
        self.waiting.clear()
        self.running, self.static_batch = [], []
        self.swapped = []
        self._window = None
        self.chunk_progress.clear()
        self._needs_refetch.clear()
        self.kv.discard_exports()      # pinned chains died with the device
        self.kv.clear_cache()          # a failed client's radix cache is gone
        self.kv.check_invariants()
        return out

    def remove_waiting(self, r: Request) -> bool:
        """Straggler rescue: pull a queued request and release any pages it
        already holds (chunked admission allocates at first touch). Partial
        prefill progress dies with the pages — the new client restarts it."""
        if r not in self.waiting:
            return False
        self.waiting.remove(r)
        self._release_kv(r)
        self.chunk_progress.pop(r.rid, None)
        self._needs_refetch.discard(r.rid)
        r.prefilled_tokens = 0
        return True
