"""Workload generation (paper §III-F1): request sizes from real-trace-shaped
synthetic distributions, injection processes (uniform/normal/poisson/bursty).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

import numpy as np

from repro_torch.core import request as rq


@dataclass(frozen=True)
class TraceSpec:
    """Token-count distribution. Defaults mirror the AzureLLMInference 2023
    trace statistics the paper uses (Conv: short-in/short-out; Code:
    long-in/short-out)."""
    name: str
    input_mean: float
    input_std: float
    output_mean: float
    output_std: float
    input_max: int = 16_384
    output_max: int = 4_096

    def sample(self, rng: np.random.Generator, n: int):
        ins = np.clip(rng.lognormal(np.log(self.input_mean), self.input_std, n),
                      16, self.input_max).astype(int)
        outs = np.clip(rng.lognormal(np.log(self.output_mean), self.output_std, n),
                       4, self.output_max).astype(int)
        return ins, outs


AZURE_CONV = TraceSpec("azure-conv", input_mean=1020, input_std=0.85,
                       output_mean=210, output_std=0.7)
AZURE_CODE = TraceSpec("azure-code", input_mean=2040, input_std=1.0,
                       output_mean=28, output_std=0.6)


def synthetic_trace(input_mean: float, input_std: float, output_mean: float,
                    output_std: float, name: str = "synthetic") -> TraceSpec:
    """Paper: synthetic traces are normal-shaped with configurable mean/var."""
    return TraceSpec(name, input_mean, input_std, output_mean, output_std)


# ---------------------------------------------------------------------------
# injection processes
# ---------------------------------------------------------------------------

def arrival_times(rng: np.random.Generator, n: int, rate: float,
                  process: str = "poisson", burst_factor: float = 5.0) -> np.ndarray:
    """n arrival timestamps at ``rate`` req/s under the given process."""
    if process == "uniform":
        gaps = np.full(n, 1.0 / rate)
    elif process == "poisson":
        gaps = rng.exponential(1.0 / rate, n)
    elif process == "normal":
        gaps = np.clip(rng.normal(1.0 / rate, 0.3 / rate, n), 1e-6, None)
    elif process == "bursty":
        # alternating hot/cold phases
        gaps = np.where(rng.random(n) < 0.5,
                        rng.exponential(1.0 / (rate * burst_factor), n),
                        rng.exponential(burst_factor / rate, n))
    else:
        raise ValueError(process)
    return np.cumsum(gaps)


@dataclass
class WorkloadConfig:
    trace: TraceSpec = AZURE_CONV
    rate: float = 2.0                       # requests/sec (per system)
    n_requests: int = 200
    process: str = "poisson"
    pipeline: str = "regular"               # regular | rag | kv | reasoning
    disaggregated: bool = False
    model: str = "llama3-70b"
    seed: int = 0
    # pipeline extras
    rag_added_tokens: int = 3_000           # paper §V-A: RAG adds 3K tokens
    kv_cached_tokens: int = 3_000           # paper §V-A: 3K cached context
    reasoning_scale: float = 8.0
    reasoning_branches: int = 1
    postprocess: bool = True
    # shared-prefix knobs (all off by default -> no overlapping prefixes and
    # pre-radix behavior). When on, prompts carry ``prefix_segments`` so
    # the radix cache can actually dedup pages across requests:
    shared_prefix_pool: int = 0             # distinct system prompts (0 = off)
    shared_prefix_tokens: int = 512         # tokens per pooled system prompt
    prefix_reuse_rate: float = 1.0          # P(request draws from the pool)
    rag_chunk_pool: int = 0                 # distinct RAG chunks (0 = fiat
    rag_chunk_tokens: int = 500             #   rag_added_tokens, no identity)
    # scale-out scenario knobs: a traffic surge at ``rate_ramp_at`` (the
    # moment an operator would add a replica) — arrivals after it come
    # ``rate_ramp``x faster. The surge is a deterministic time-compression
    # of the same arrival sequence, so sweeps over ramp timing/intensity
    # see the same request population.
    rate_ramp_at: Optional[float] = None
    rate_ramp: float = 1.0
    # multi-phase generalization (diurnal / surge traces for the closed-loop
    # autoscaler): ``((t0, m0), (t1, m1), ...)`` — from wall-clock ``t_i``
    # until the next breakpoint the instantaneous arrival rate is
    # ``rate * m_i`` (multiplier 1.0 before ``t0``). Like ``rate_ramp``,
    # phases are a deterministic time-warp of one base-rate arrival
    # sequence, so every phase schedule sees the same request population.
    # Mutually exclusive with ``rate_ramp_at``.
    rate_phases: Optional[tuple] = None


def warp_times(times: np.ndarray, phases) -> np.ndarray:
    """Deterministically time-warp base-rate arrival times through a
    piecewise-constant rate-multiplier schedule ``((t0, m0), (t1, m1), ...)``
    (breakpoints in warped/wall-clock time, strictly increasing, multipliers
    > 0; multiplier is 1.0 before ``t0``). A base arrival consuming ``s``
    seconds of unit-rate "arrival work" lands at the wall-clock time ``w``
    where the integral of the multiplier over ``[0, w]`` equals ``s``."""
    if not phases:
        return times
    ts = [float(t) for t, _ in phases]
    ms = [float(m) for _, m in phases]
    if any(t1 <= t0 for t0, t1 in zip(ts, ts[1:])):
        raise ValueError(f"rate_phases breakpoints must strictly increase: {ts}")
    if any(m <= 0 for m in ms):
        raise ValueError(f"rate_phases multipliers must be positive: {ms}")
    # base-time ("work") consumed at each breakpoint: before t0 the
    # multiplier is 1, afterwards each phase spends (t_{i+1}-t_i)*m_i
    work = [ts[0]]
    for i in range(len(ts) - 1):
        work.append(work[-1] + (ts[i + 1] - ts[i]) * ms[i])
    idx = np.searchsorted(work, times, side="right") - 1
    out = np.asarray(times, dtype=float).copy()
    pre = idx < 0                       # before the first breakpoint: identity
    post = ~pre
    i = np.clip(idx, 0, len(ts) - 1)
    out[post] = (np.asarray(ts)[i][post]
                 + (times[post] - np.asarray(work)[i][post])
                 / np.asarray(ms)[i][post])
    return out


def generate(cfg: WorkloadConfig) -> List[rq.Request]:
    rng = np.random.default_rng(cfg.seed)
    ins, outs = cfg.trace.sample(rng, cfg.n_requests)
    times = arrival_times(rng, cfg.n_requests, cfg.rate, cfg.process)
    if cfg.rate_phases and cfg.rate_ramp_at is not None:
        raise ValueError("rate_phases and rate_ramp_at are mutually exclusive")
    if cfg.rate_ramp_at is not None and cfg.rate_ramp != 1.0:
        t0 = cfg.rate_ramp_at
        times = np.where(times > t0, t0 + (times - t0) / cfg.rate_ramp, times)
    elif cfg.rate_phases:
        times = warp_times(times, cfg.rate_phases)
    out: List[rq.Request] = []
    for t, i, o in zip(times, ins, outs):
        if cfg.pipeline == "regular":
            stages = rq.regular_pipeline(cfg.disaggregated, cfg.postprocess)
        elif cfg.pipeline == "rag":
            stages = rq.rag_pipeline(cfg.disaggregated, postprocess=cfg.postprocess)
        elif cfg.pipeline == "kv":
            stages = rq.kv_retrieval_pipeline(cfg.disaggregated, cfg.postprocess)
        elif cfg.pipeline == "reasoning":
            stages = rq.regular_pipeline(cfg.disaggregated, cfg.postprocess)
        else:
            raise ValueError(cfg.pipeline)
        r = rq.Request(arrival=float(t), input_tokens=int(i),
                       output_tokens=int(o), stages=stages, model=cfg.model)
        segments: List = []
        if cfg.shared_prefix_pool > 0:
            # pooled system prompt, *prepended* so it is a block-aligned
            # shareable prefix; a (1 - reuse_rate) fraction gets a unique one
            if rng.random() < cfg.prefix_reuse_rate:
                k = int(rng.integers(cfg.shared_prefix_pool))
                seg_id = f"sys{k}"
            else:
                seg_id = f"uniq{r.rid}"
            segments.append((seg_id, cfg.shared_prefix_tokens))
            r.input_tokens += cfg.shared_prefix_tokens
        if cfg.pipeline == "rag":
            if cfg.rag_chunk_pool > 0:
                # retrieved chunks drawn from a shared corpus follow the
                # system prompt, ahead of the unique user query, so repeated
                # chunk sets stay inside the shareable prefix. A retriever
                # returns k *distinct* chunks — sample without replacement so
                # the context size matches fiat mode and the knob measures
                # sharing, not a lighter workload
                n_chunks = max(1, cfg.rag_added_tokens // cfg.rag_chunk_tokens)
                if cfg.rag_chunk_pool < n_chunks:
                    raise ValueError(
                        f"rag_chunk_pool={cfg.rag_chunk_pool} cannot supply "
                        f"{n_chunks} distinct chunks "
                        f"(rag_added_tokens/rag_chunk_tokens); a smaller "
                        f"context would confound sharing sweeps with a "
                        f"lighter workload")
                chunks = sorted(int(c) for c in rng.choice(
                    cfg.rag_chunk_pool, size=n_chunks, replace=False))
                segments.extend((f"doc{c}", cfg.rag_chunk_tokens)
                                for c in chunks)
                r.rag_tokens = n_chunks * cfg.rag_chunk_tokens
            else:
                r.rag_tokens = cfg.rag_added_tokens
        if cfg.pipeline == "kv":
            r.input_tokens += cfg.kv_cached_tokens
            if cfg.shared_prefix_pool > 0:
                # real lookup mode: the cached context is a pooled shared
                # prefix; hits (and the prefill discount) come from the radix
                # cache at admission instead of a fiat cached_tokens grant.
                # The retrieval stage still prices fetching the candidate
                # context (cached_tokens is 0 until the radix hit lands).
                # It follows the system prompt so the most-widely-shared
                # segment stays the leading block-aligned prefix. Note
                # prefix_reuse_rate therefore gates the *entire* prefix: a
                # request that drew a unique system prompt diverges at block
                # 0 and its kv context cannot hit either — exactly how a
                # radix cache behaves when the leading segment differs.
                k = int(rng.integers(cfg.shared_prefix_pool))
                segments.append((f"kvctx{k}", cfg.kv_cached_tokens))
                for st in stages:
                    if st.kind == rq.KV_RETRIEVAL:
                        st.params["candidate_tokens"] = cfg.kv_cached_tokens
            else:
                r.cached_tokens = cfg.kv_cached_tokens
        if cfg.pipeline == "reasoning":
            rq.reasoning_request(r, cfg.reasoning_scale, cfg.reasoning_branches)
        r.prefix_segments = tuple(segments)
        out.append(r)
    return out
