"""Requests and their multi-stage pipelines (paper Fig. 1)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# stage kinds
PREPROCESS = "preprocess"
RAG_EMBED = "rag_embed"
RAG_RETRIEVE = "rag_retrieve"
KV_RETRIEVAL = "kv_retrieval"
LLM = "llm"              # prefill + decode on one client (continuous/chunked)
PREFILL = "prefill"      # disaggregated prefill
DECODE = "decode"        # disaggregated decode
POSTPROCESS = "postprocess"

_rid = itertools.count()


@dataclass
class Stage:
    kind: str
    params: Dict = field(default_factory=dict)
    # bookkeeping filled at runtime
    client: Optional[str] = None
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    dispatch_time: Optional[float] = None


@dataclass
class Request:
    arrival: float
    input_tokens: int
    output_tokens: int
    stages: List[Stage]
    model: str = "llama3-70b"
    rid: int = field(default_factory=lambda: next(_rid))
    branches: int = 1                  # multi-path reasoning thought branches
    cached_tokens: int = 0             # KV tokens recovered by kv_retrieval
    rag_tokens: int = 0                # context tokens added by RAG
    tier: str = "default"              # SLO tier (MetricsCollector.goodput_by_tier)
    # shared-prefix identity: ordered (content_id, n_tokens) segments covering
    # the *leading* part of the prompt (system prompt, reused RAG chunks, ...).
    # Two requests with equal leading segments share a block-aligned KV prefix
    # in the radix cache; everything past the segments is unique content.
    prefix_segments: Tuple[Tuple[str, int], ...] = ()
    _prefix_hash_cache: Dict[int, List[int]] = field(default_factory=dict,
                                                     repr=False)
    # --- runtime state ---
    stage_idx: int = 0
    prefilled_tokens: int = 0
    decoded_tokens: int = 0
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    completion_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    preemptions: int = 0
    failures: int = 0

    # ------------------------------------------------------------------
    @property
    def current_stage(self) -> Optional[Stage]:
        return self.stages[self.stage_idx] if self.stage_idx < len(self.stages) else None

    @property
    def done(self) -> bool:
        return self.stage_idx >= len(self.stages)

    @property
    def effective_prefill_tokens(self) -> int:
        """Tokens the prefill actually has to compute (prefix-cache aware)."""
        total = self.input_tokens + self.rag_tokens
        return max(0, total - self.cached_tokens)

    @property
    def total_context(self) -> int:
        return self.input_tokens + self.rag_tokens + self.decoded_tokens

    @property
    def remaining_tokens(self) -> int:
        return max(0, self.output_tokens - self.decoded_tokens)

    def prefix_block_hashes(self, block_tokens: int) -> List[int]:
        """Chained content hashes for the full, block-aligned blocks covered
        by ``prefix_segments`` — the keys the radix cache shares pages under.
        Hash i chains over hash i-1, so equal chains imply equal prefixes."""
        if not self.prefix_segments:
            return []
        cached = self._prefix_hash_cache.get(block_tokens)
        if cached is not None:
            return cached
        ids: List[Tuple[str, int]] = []
        for seg, n in self.prefix_segments:
            ids.extend((seg, j) for j in range(n))
        out: List[int] = []
        h = 0
        for i in range(len(ids) // block_tokens):
            h = hash((h, tuple(ids[i * block_tokens:(i + 1) * block_tokens])))
            out.append(h)
        self._prefix_hash_cache[block_tokens] = out
        return out

    def advance_stage(self, now: float):
        st = self.current_stage
        if st is not None:
            st.end_time = now
        self.stage_idx += 1
        if self.done:
            self.completion_time = now

    # --- derived metrics -------------------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.last_token_time is None or self.first_token_time is None:
            return None
        n = max(1, self.decoded_tokens - 1)
        return (self.last_token_time - self.first_token_time) / n

    @property
    def e2e(self) -> Optional[float]:
        if self.completion_time is None:
            return None
        return self.completion_time - self.arrival


# ---------------------------------------------------------------------------
# pipeline factories (paper Fig. 1 a/b/c)
# ---------------------------------------------------------------------------

def regular_pipeline(disaggregated: bool = False, postprocess: bool = True) -> List[Stage]:
    llm = ([Stage(PREFILL), Stage(DECODE)] if disaggregated else [Stage(LLM)])
    tail = [Stage(POSTPROCESS)] if postprocess else []
    return [Stage(PREPROCESS)] + llm + tail


def rag_pipeline(disaggregated: bool = False, co_located_rag: bool = False,
                 postprocess: bool = True) -> List[Stage]:
    rag = ([Stage(RAG_EMBED, {"co_located": True})] if co_located_rag
           else [Stage(RAG_EMBED), Stage(RAG_RETRIEVE)])
    llm = ([Stage(PREFILL), Stage(DECODE)] if disaggregated else [Stage(LLM)])
    tail = [Stage(POSTPROCESS)] if postprocess else []
    return [Stage(PREPROCESS)] + rag + llm + tail


def kv_retrieval_pipeline(disaggregated: bool = False,
                          postprocess: bool = True) -> List[Stage]:
    llm = ([Stage(PREFILL), Stage(DECODE)] if disaggregated else [Stage(LLM)])
    tail = [Stage(POSTPROCESS)] if postprocess else []
    return [Stage(PREPROCESS), Stage(KV_RETRIEVAL)] + llm + tail


def reasoning_request(req: Request, scale: float = 8.0, branches: int = 1) -> Request:
    """Scale output tokens for reasoning (paper §IV-A: single-path 8-32x,
    multi-path 4-16x with parallel branches sharing the prefill KV)."""
    req.output_tokens = int(req.output_tokens * scale)
    req.branches = branches
    return req
