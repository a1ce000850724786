"""Clients (paper §III-C): a hardware cluster + scheduler specialized for a
subset of stages. Five types: pre/post-processing, RAG (embed / retrieve),
KV-cache retrieval, and LLM inference (continuous/chunked/static/mixed or a
disaggregated prefill/decode half).
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import request as rq
from repro_torch.core.llm_scheduler import (ClientPerf, LLMScheduler, LLMStep,
                                            SchedulerLimits)
from repro_torch.core.memory import (expected_retrieval_latency,
                                     sample_retrieval_latency)
from repro_torch.core.scheduler import BatchedScheduler, SequentialScheduler
from repro_torch.perfmodel import analytical as ana
from repro_torch.perfmodel import rag_model
from repro_torch.perfmodel.hardware import CacheTierSpec, ClusterSpec


class Client:
    """Base client: owns a scheduler and a ClusterSpec."""

    kind = "base"

    def __init__(self, name: str, cluster: ClusterSpec, stages: Sequence[str]):
        self.name = name
        self.cluster = cluster
        self.stages = tuple(stages)
        self.busy = False
        self.failed = False
        self.slowdown = 1.0            # straggler factor (>1 => slower)
        self.total_energy = 0.0
        self.steps_done = 0
        self.served = 0

    # scheduler protocol -------------------------------------------------
    def add(self, req: rq.Request):
        self.scheduler.add(req)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def plan_step(self, now: Optional[float] = None,
                  horizon: Optional[float] = None):
        step = self.scheduler.plan_step()
        if step is not None and self.slowdown != 1.0:
            step.duration *= self.slowdown
        return step

    def finish_step(self, step, now: float) -> List[rq.Request]:
        done = self.scheduler.finish_step(step, now)
        # macro-steps carry per-iteration energies; accumulate them in the
        # order the event loop would so the total stays bit-equal
        energies = getattr(step, "step_energies", None)
        for e in (energies if energies is not None
                  else (getattr(step, "energy", 0.0),)):
            self.total_energy += e
        self.steps_done += getattr(step, "n_steps", 1)
        self.served += len(done)
        return done

    def truncate_step(self, step, now: float, inclusive: bool = False):
        """Commit the finished prefix of an in-flight macro-step (fast
        forward invalidation); returns the single-step remainder or None.
        Base clients plan atomic steps only, so there is nothing to cut."""
        return None

    def requeue_step(self, step) -> None:
        """Return the requests of a discarded in-flight step to the queue
        (client fail/remove) so the subsequent ``drain()`` re-dispatches
        them instead of losing them."""
        self.scheduler.requeue_step(step)

    def drain(self) -> List[rq.Request]:
        return self.scheduler.drain()

    # load metrics for routing (paper §III-B1) ---------------------------
    def _window_committed_steps(self, now: Optional[float]) -> int:
        """Decode iterations of an in-flight fast-forward window that have
        finished by ``now`` but are not yet materialized. Load metrics fold
        them in virtually, so routing sees exactly the state a per-step
        execution would — without the coordinator having to cut the window
        of every routing *candidate* (only the chosen client's is cut)."""
        sched = self.scheduler
        w = getattr(sched, "_window", None)
        if w is None or now is None:
            return 0
        if getattr(sched, "strategy", "") == "static":
            return 0      # static batches are invisible to load metrics
        return bisect_left(w.token_times, now)

    def load(self, metric: str = "queue", now: Optional[float] = None) -> float:
        sched = self.scheduler
        waiting = list(getattr(sched, "waiting", []))
        running = (list(getattr(sched, "running", []))
                   + list(getattr(sched, "swapped", [])))
        if metric == "queue":
            return len(waiting) + len(running)
        if metric == "input_len":
            # effective prefill work, not raw prompt length: KV-retrieval /
            # RAG / prefix-cached requests only cost their uncached tokens,
            # so they must not repel the router from the right client
            return sum(r.effective_prefill_tokens for r in waiting + running)
        if metric == "output_len":
            return sum(r.output_tokens for r in waiting + running)
        if metric == "kv_size":
            kv = getattr(sched, "kv", None)
            return kv.used if kv is not None else 0.0
        if metric == "kv_pressure":
            # fragmentation-aware: resident blocks (slack included) plus the
            # block demand parked in the queue, as a fraction of the pool
            kv = getattr(sched, "kv", None)
            if kv is None:
                return float(len(waiting) + len(running))
            queued = sum(kv.blocks_for_tokens(r.input_tokens + r.rag_tokens)
                         for r in waiting)
            return (kv.used_blocks + queued) / max(1, kv.num_blocks)
        if metric == "tokens_remaining":
            total = sum(r.remaining_tokens + max(
                0, r.effective_prefill_tokens - r.prefilled_tokens)
                for r in waiting + running)
            j = self._window_committed_steps(now)
            if j:
                # every window member decoded j more tokens than materialized
                total -= j * len(sched._window.decode)
            return total
        raise ValueError(metric)

    def kv_stats(self) -> Dict:
        """Paged-allocator counters (empty for non-LLM clients)."""
        kv = getattr(self.scheduler, "kv", None)
        return kv.stats() if kv is not None else {}

    def prefix_hit_rate(self) -> float:
        """Fraction of prefix-eligible prompt tokens this client served out
        of its radix cache (migrated pages included). The per-replica
        warm-up signal the prefix-migration benchmark tracks: a freshly
        scaled-out client starts at 0 and converges toward its donor's rate
        as pushed/fetched chains land."""
        kv = getattr(self.scheduler, "kv", None)
        if kv is None or kv.prefix_tokens_seen <= 0:
            return 0.0
        return kv.prefix_hit_tokens / kv.prefix_tokens_seen

    def prefix_hit_tokens(self, req: rq.Request) -> int:
        """Prompt tokens of ``req`` whose KV pages this client's radix cache
        already holds (0 for non-LLM clients or identity-less requests).
        Routers use this for prefix-affinity placement."""
        kv = getattr(self.scheduler, "kv", None)
        if kv is None or not req.prefix_segments:
            return 0
        if not getattr(self.scheduler.limits, "prefix_caching", False):
            return 0
        return kv.peek_prefix_tokens(req.prefix_block_hashes(kv.block_tokens))


class PreprocessClient(Client):
    kind = "preprocess"

    def __init__(self, name: str, cluster: ClusterSpec,
                 per_token_us: float = 0.02, base_us: float = 50.0,
                 n_cores: int = 16):
        super().__init__(name, cluster, (rq.PREPROCESS,))
        fn = lambda r: (base_us + per_token_us * r.input_tokens) * 1e-6
        en = lambda batch, dur: dur * cluster.chip.power * 0.2
        self.scheduler = SequentialScheduler(fn, n_cores=n_cores, energy_fn=en)


class PostprocessClient(Client):
    """Detokenize + safety filters; optionally prices a small (~2B) guard
    model forward pass (paper §III-E4)."""

    kind = "postprocess"

    def __init__(self, name: str, cluster: ClusterSpec,
                 guard_model: Optional[ModelConfig] = None, n_cores: int = 16):
        super().__init__(name, cluster, (rq.POSTPROCESS,))
        self.guard_model = guard_model

        def fn(r: rq.Request) -> float:
            t = 1e-5 + 2e-8 * r.decoded_tokens * r.branches  # word-lookup pass
            if guard_model is not None:
                t += ana.prefill_time(guard_model, cluster,
                                      max(8, r.decoded_tokens)).time
            return t

        en = lambda batch, dur: dur * cluster.chip.power * 0.3
        self.scheduler = SequentialScheduler(fn, n_cores=n_cores, energy_fn=en)


class RAGClient(Client):
    """Embedding and/or retrieval+rerank (paper §III-C2, §IV-B). When
    ``co_located`` it serves both RAG stages on one cluster."""

    kind = "rag"

    def __init__(self, name: str, cluster: ClusterSpec,
                 embed_model: Optional[ModelConfig] = None,
                 ivf: rag_model.IVFPQConfig = rag_model.IVFPQConfig(),
                 serve_embed: bool = True, serve_retrieve: bool = True):
        stages = ([rq.RAG_EMBED] if serve_embed else []) + \
                 ([rq.RAG_RETRIEVE] if serve_retrieve else [])
        super().__init__(name, cluster, stages)
        self.embed_model = embed_model
        self.ivf = ivf
        self.serve_embed = serve_embed
        self.serve_retrieve = serve_retrieve

        def latency(batch: List[rq.Request]) -> float:
            t = 0.0
            for r in batch:
                if self.serve_embed and r.current_stage.kind == rq.RAG_EMBED:
                    if embed_model is not None:
                        t = max(t, ana.prefill_time(embed_model, cluster,
                                                    r.input_tokens).time)
                    if r.current_stage.params.get("co_located"):
                        t += (rag_model.retrieval_time(ivf, cluster).time
                              + rag_model.rerank_time(ivf, cluster).time)
                if self.serve_retrieve and r.current_stage.kind == rq.RAG_RETRIEVE:
                    t += (rag_model.retrieval_time(ivf, cluster).time
                          + rag_model.rerank_time(ivf, cluster).time)
            return t

        en = lambda batch, dur: dur * cluster.chip.power * 0.5
        self.scheduler = BatchedScheduler(latency, energy_fn=en)


class KVRetrievalClient(Client):
    """Multi-level cache retrieval (paper §III-C3/§III-E3, Eq. 1)."""

    kind = "kv_retrieval"

    def __init__(self, name: str, cluster: ClusterSpec,
                 tiers: Sequence[CacheTierSpec],
                 kv_bytes_per_token: float = 160e3,
                 recompute_fn=None, sample: bool = True, seed: int = 0):
        super().__init__(name, cluster, (rq.KV_RETRIEVAL,))
        self.tiers = list(tiers)
        self.kv_bytes_per_token = kv_bytes_per_token
        self.recompute_fn = recompute_fn or (lambda size: 0.2)
        self.rng = np.random.default_rng(seed)
        self.sample = sample

        def latency(batch: List[rq.Request]) -> float:
            t = 0.0
            for r in batch:
                # fiat mode prices the granted cached_tokens; radix real-
                # lookup mode grants 0 up front, so the stage prices the
                # candidate context it probes the tier chain for
                cand = max(r.cached_tokens,
                           r.current_stage.params.get("candidate_tokens", 0))
                size = cand * self.kv_bytes_per_token
                miss = self.recompute_fn(size)
                if self.sample:
                    lt = sample_retrieval_latency(size, self.tiers, miss, self.rng)
                else:
                    lt = expected_retrieval_latency(size, self.tiers, miss)
                t = max(t, lt)
            return t

        en = lambda batch, dur: dur * cluster.chip.power * 0.4
        self.scheduler = BatchedScheduler(latency, energy_fn=en)


class LLMClient(Client):
    kind = "llm"

    def __init__(self, name: str, cluster: ClusterSpec, model_cfg: ModelConfig,
                 strategy: str = "continuous",
                 limits: SchedulerLimits = SchedulerLimits(),
                 packing: str = "fcfs", perf: Optional[ClientPerf] = None,
                 group: Optional[str] = None):
        stage_map = {"prefill_only": (rq.PREFILL,),
                     "decode_only": (rq.DECODE,)}
        stages = stage_map.get(strategy, (rq.LLM,))
        super().__init__(name, cluster, stages)
        self.model_cfg = model_cfg
        self.strategy = strategy
        self.group = group               # local-disaggregation pairing group
        self.scheduler = LLMScheduler(strategy, model_cfg, cluster,
                                      perf=perf, limits=limits, packing=packing)

    def plan_step(self, now: Optional[float] = None,
                  horizon: Optional[float] = None):
        """With the absolute clock, the scheduler may fast-forward a stable
        decode batch into a macro-step; those arrive with the slowdown
        already folded into every per-iteration time, so only plain single
        steps take the legacy scaling path here. ``horizon`` (the next known
        external event) bounds the window so its tail is rarely discarded."""
        step = self.scheduler.plan_step(now=now, slowdown=self.slowdown,
                                        horizon=horizon)
        if step is not None and step.n_steps == 1 and self.slowdown != 1.0:
            step.duration *= self.slowdown
        return step

    def truncate_step(self, step, now: float, inclusive: bool = False):
        if getattr(step, "n_steps", 1) <= 1:
            return None
        rem, committed = self.scheduler.truncate_step(step, now, inclusive)
        for e in committed:
            self.total_energy += e
        self.steps_done += len(committed)
        return rem

    @property
    def kv_transfer_bytes_fn(self):
        per_tok = self.scheduler.kv_per_token
        return lambda req: req.total_context * per_tok
