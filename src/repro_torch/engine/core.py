"""The serving engines of the PyTorch port (twin of the single-device
paths of ``repro.engine.core``: whole-prompt and chunked prefill, speculative
decoding, and the dense ``SlotEngine``).

``EngineCore`` holds the ``PagedKVStore``, the physical K/V pools, the
host mirrors of the block tables and lengths, admission, growth and
preemption, and the decode and chunk passes; ``Engine`` drives one of three
iterations: the legacy whole-prompt one (admit with one blocking prefill
per admission, then one ``(max_batch, 1)`` decode pass), the mixed one of
chunked prefill (one decode pass, then one ``(max_batch, chunk_size)``
chunk pass, sharing a token budget), or with a draft model one speculative
iteration (draft, fork, verify, accept). ``SlotEngine`` is the dense
per-slot engine the paged one is held against. The interface contract is
the JAX engine's:

* ``max_len`` is a multiple of ``block_tokens``; ``max_context`` (default
  ``max_len``; above it only with chunked prefill) is too, and ``max_blocks
  = max_context // block_tokens``; the pool holds ``num_blocks`` pages plus
  one trash page (index ``num_blocks``) that dead rows point at.
* The model masks positions ``>= length`` to probability exactly 0, so stale
  page content cannot leak into live rows.
* Full block-aligned prompt blocks register in the store's radix index; a
  later prompt sharing that prefix maps the same physical pages.
* Preemption is real: ``swap`` copies the victim's pages to host memory
  (``.cpu()``) and back (``.to(device)``) on resume; ``recompute`` drops them
  and re-prefills ``prompt + generated[:-1]``. Both keep every token
  generated so far; victims requeue FIFO-fairly.
* Chunked prefill (``EngineConfig(chunk_size=...)``): admission reserves
  pages for the first chunk only and runs no forward pass; each mixed
  iteration decodes the decode-phase rows (chunk-phase rows seen as
  trash/0) and then advances every chunk-phase row's fill front by up to
  ``chunk_size`` tokens within the token budget, growing its table as it
  goes (``paged_chunk_attention``). A prompt whose last chunk completes
  streams its first token from that pass; greedy streams equal whole
  prefill's.
* Speculative decoding (``EngineConfig(draft_cfg=..., spec_k=...)``, whole
  prefill only): each iteration drafts up to ``spec_k`` greedy tokens per
  row with the draft model (its own paged pool, never short of pages),
  COW-forks the target tables (``PagedKVStore.fork_table``), scores every
  draft position in one target pass (``paged_verify_attention``) and
  commits the longest agreeing prefix plus the bonus token; greedy streams
  equal plain decode's.

Every entry point runs on ``device="cuda"`` unless the caller passes another
device (the CPU tests pass ``device="cpu"``); without a card, CUDA fails
loudly, nothing falls back.

The fixed-shape passes (``_decode`` at ``(max_batch, 1)``, ``_chunk`` at
``(max_batch, chunk_size)``, ``_draft_decode``, ``_verify`` at ``(max_batch,
spec_k + 1)``, and the ``SlotEngine``'s ``_decode``) are ``CompiledPass``es
(``graphs.py``), the twins of the JAX engine's jitted functions: built with
the engine, captured as CUDA graphs on the card and replayed every pass
(``cuda_graphs=False`` runs them eagerly over the same static buffers).
Their inputs go through static buffers: tokens and ``q_valid`` per pass,
and one block-table and one length buffer per cache dict, which the
caches' ``(L, ...)`` views point at for the engine's life. The pools are
written in place and never rebound (admission, swap and COW copies
included); the lengths come from the host mirrors. Whole prefill stays
eager: its shape varies.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.graphs import CompiledPass, StaticInputs
from repro_torch.engine.paged_kv import PagedKVStore, prefix_chain
from repro_torch.models import steps
from repro_torch.models import transformer as tf


@dataclass
class EngineConfig:
    """Scheduling policy of the paged ``Engine``: the TTFT-vs-ITL knob.

    ``chunk_size == 0`` keeps whole-prompt admission (one blocking prefill
    per admission). With ``chunk_size > 0`` every iteration is a mixed one:
    running decodes take their ``(b, 1)`` step and waiting or partial
    prefills advance by up to one ``(b, chunk_size)`` chunk pass in the same
    iteration, so a long prompt never stalls running decodes for its whole
    length.

    * ``chunk_size`` — prompt tokens per request per iteration.
    * ``token_budget`` — forward tokens an iteration may spend across both
      passes; 0 means ``max_batch + chunk_size``.
    * ``decode_share`` — share of ``token_budget`` reserved for decode rows
      while any run; the rest is the chunk budget. 0 reserves exactly the
      running decodes; 1.0 starves prefill until every decode finishes.
    * ``max_context`` — logical KV tokens one request may span; 0 means
      ``max_len``. Above ``max_len`` (a multiple of ``block_tokens``) only
      with chunked prefill, whose per-pass working set stays ``chunk_size``
      wide.

    Speculative decoding (``draft_cfg`` + ``spec_k``, needs ``chunk_size ==
    0``): every iteration runs the draft model for up to ``spec_k`` greedy
    tokens per row, verifies them in one target pass and commits the
    longest matching prefix plus the bonus token.

    * ``draft_cfg`` — config of the draft model (GQA, dense or vlm, the
      target's vocabulary). None disables speculation.
    * ``spec_k`` — draft tokens proposed per iteration (0 disables).
    * ``draft_seed`` — seed of the draft parameters when the engine is not
      handed ``draft_params``.
    """
    chunk_size: int = 0
    token_budget: int = 0
    decode_share: float = 0.0
    max_context: int = 0
    draft_cfg: Optional[ModelConfig] = None
    spec_k: int = 0
    draft_seed: int = 1


@dataclass
class EngineRequest:
    rid: int
    prompt: np.ndarray                       # (p,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)
    slot: Optional[int] = None
    state: str = "new"            # new | running | swapped | preempted | done
    preemptions: int = 0
    # ``ctx`` is the context this admission must write to KV (prompt, or
    # prompt + generated[:-1] on a recompute resume); ``prefilled`` counts
    # how much of it is written, ``prefilled == len(ctx)`` marks the request
    # decode-phase
    ctx: Optional[np.ndarray] = None
    prefilled: int = 0

    @property
    def itl(self) -> List[float]:
        """Inter-token latencies (seconds) between consecutive streamed
        tokens — the per-request tail-latency surface the chunked scheduler
        is tuned against."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    @property
    def ttft(self):
        return (self.first_token_time - self.submit_time
                if self.first_token_time else None)

    @property
    def tpot(self):
        if self.finish_time is None or self.first_token_time is None:
            return None
        return ((self.finish_time - self.first_token_time)
                / max(1, len(self.tokens) - 1))


def _check_config(config: EngineConfig, cfg: ModelConfig, max_len: int,
                  block_tokens: int) -> int:
    """Raise on an inconsistent configuration; returns ``max_context``."""
    if config.chunk_size < 0:
        raise ValueError(f"chunk_size={config.chunk_size} < 0")
    max_context = config.max_context or max_len
    if not config.chunk_size and max_context != max_len:
        raise ValueError(
            "max_context > max_len needs chunked prefill (chunk_size > 0): "
            "the whole-prompt path prefills through a (1, max_len) cache")
    if max_context % block_tokens or max_context < max_len:
        raise ValueError("max_context must be a multiple of block_tokens "
                         "and >= max_len")
    if config.draft_cfg is not None and config.spec_k > 0:
        if config.chunk_size:
            raise ValueError("speculative decoding needs the whole-prefill "
                             "path (EngineConfig.chunk_size == 0)")
        tf.check_family(config.draft_cfg)
        if config.draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
    return max_context


class EngineCore:
    """Store + cache pool + block tables + admission/preemption/growth and
    the decode and chunk passes, on one device.

    ``PASSES`` names the compiled passes the role may run: the engine
    compiles (and on the card captures) those of them that its
    configuration asks for, and no other. A prefill worker runs only the
    chunk pass, a decode worker only the decode pass."""

    PASSES: Tuple[str, ...] = ("decode", "chunk", "draft_decode", "verify")

    def __init__(self, cfg: ModelConfig, params=None, max_batch: int = 4,
                 max_len: int = 512, seed: int = 0, block_tokens: int = 16,
                 num_blocks: Optional[int] = None, preemption: str = "swap",
                 trace_occupancy: bool = False,
                 config: Optional[EngineConfig] = None, draft_params=None,
                 device="cuda", cuda_graphs: bool = True):
        self.device = torch.device(device)
        with self._dev_scope():
            if max_len % block_tokens:
                raise ValueError("max_len must be a multiple of block_tokens")
            if preemption not in ("swap", "recompute"):
                raise ValueError(f"preemption={preemption!r}")
            self.config = config or EngineConfig()
            max_context = _check_config(self.config, cfg, max_len,
                                        block_tokens)
            self.chunk_size = self.config.chunk_size
            self.cfg = cfg
            self.max_batch = max_batch
            self.max_len = max_len
            self.max_context = max_context
            # generation stop bound and submit()'s validation bound: chunked
            # rows may span max_context, whole-prefill rows stop at max_len
            # as the dense oracle does
            self._len_limit = max_context if self.chunk_size else max_len
            self.block_tokens = block_tokens
            self.max_blocks = max_context // block_tokens
            self.num_blocks = (max_batch * self.max_blocks
                               if num_blocks is None else num_blocks)
            self.preemption = preemption
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                params = tf.init_model(cfg, gen, self.device)
            self.params = _to_device(params, self.device)
            self.store = PagedKVStore(self.num_blocks, block_tokens)
            self.caches = tf.init_paged_cache(cfg, max_batch, self.num_blocks,
                                              block_tokens, self.max_blocks,
                                              self.device)
            self._rows = self._static_rows(self.caches)
            trash = self.store.trash_block
            self._tables_np = np.full((max_batch, self.max_blocks), trash,
                                      np.int32)
            self._lengths_np = np.zeros((max_batch,), np.int32)
            self.active: List[Optional[EngineRequest]] = [None] * max_batch
            self.waiting: List[EngineRequest] = []
            self.finished: List[EngineRequest] = []
            self.steps = 0
            self._next_rid = 0
            self._admit_seq = 0
            self._admit_order: Dict[int, int] = {}  # rid -> admit seq
            self.trace_occupancy = trace_occupancy
            self.occupancy: List[Dict] = []         # per-step occupancy

            # -- speculative decoding (draft model + verify pass) ----------
            self.spec_k = self.config.spec_k
            self.draft_cfg = self.config.draft_cfg
            self.spec = self.draft_cfg is not None and self.spec_k > 0
            if self.spec and "verify" not in self.PASSES:
                raise ValueError(
                    f"{type(self).__name__} runs no speculative decoding: it "
                    "is a single-engine feature (the draft rides the decode "
                    "pass)")
            if self.spec:
                dcfg = self.draft_cfg
                if draft_params is None:
                    gen = torch.Generator(device=self.device).manual_seed(
                        self.config.draft_seed)
                    draft_params = tf.init_model(dcfg, gen, self.device)
                self.draft_params = _to_device(draft_params, self.device)
                # the draft pool is sized so it can never run out: capacity
                # planning stays a target-pool problem and draft admission
                # cannot fail
                self.draft_store = PagedKVStore(max_batch * self.max_blocks,
                                                block_tokens)
                self.draft_caches = tf.init_paged_cache(
                    dcfg, max_batch, self.draft_store.num_blocks, block_tokens,
                    self.max_blocks, self.device)
                self._draft_rows = self._static_rows(self.draft_caches)
                self._draft_tables_np = np.full(
                    (max_batch, self.max_blocks),
                    self.draft_store.trash_block, np.int32)
                self._draft_lengths_np = np.zeros((max_batch,), np.int32)
                # rid -> leading draft-cache positions whose KV matches the
                # request's true token stream (the rewind point for drafting)
                self._draft_valid: Dict[int, int] = {}
                # acceptance accounting (spec_stats())
                self.spec_iters = 0
                self.spec_row_steps = 0
                self.spec_emitted = 0
                self._spec_pos_proposed = np.zeros((self.spec_k,),
                                                   np.int64)
                self._spec_pos_accepted = np.zeros((self.spec_k,),
                                                   np.int64)

            # -- compiled passes (built last: they capture over the
            # buffers), those of the configuration that the role runs; a
            # speculative engine never runs the plain decode pass --
            self.cuda_graphs = cuda_graphs
            if not self.spec and "decode" in self.PASSES:
                self._decode = self._compile("decode", steps.serve_step,
                                             self.params, cfg, self.caches,
                                             self._rows, 1)
            if self.chunk_size and "chunk" in self.PASSES:
                self._chunk = self._compile(
                    "chunk", steps.chunk_step, self.params, cfg, self.caches,
                    self._rows, self.chunk_size, q_valid=True)
            if self.spec:
                self._draft_decode = self._compile(
                    "draft_decode", steps.serve_step, self.draft_params,
                    self.draft_cfg, self.draft_caches, self._draft_rows, 1)
                self._verify = self._compile(
                    "verify", steps.verify_step, self.params, cfg,
                    self.caches, self._rows, self.spec_k + 1, q_valid=True)

    def _dev_scope(self):
        """The core's card made current (``torch.cuda.device``) for its
        construction and every step, so that the passes' warm-up, capture
        and replays and the kernels' launches land on it (the twin of the
        JAX core's ``jax.default_device`` scope); a null context off CUDA
        and for ``"cuda"`` without an index, which is the current card."""
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" and self.device.index is not None
                else contextlib.nullcontext())

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _static_rows(self, caches) -> StaticInputs:
        """The static block-table and length buffers of ``caches``, every
        layer's view pointing at them from now on (all-trash / 0)."""
        b, mb = self.max_batch, self.max_blocks
        rows = StaticInputs({"tables": (b, mb), "lengths": (b,)},
                            self.device)
        _push_trash(rows, _trash_page(caches))
        for g in caches.values():
            L = g["block_tables"].shape[0]
            g["block_tables"] = rows.dev["tables"][None].expand(L, b, mb)
            g["length"] = rows.dev["lengths"][None].expand(L, b)
        return rows

    def _compile(self, name: str, step, params, cfg: ModelConfig, caches,
                 rows: StaticInputs, s: int,
                 q_valid: bool = False) -> CompiledPass:
        """The pass ``step`` at ``(max_batch, s)`` over ``caches`` (and
        ``q_valid`` for chunk and verify). Its warm-up sees every row of
        ``rows`` on the trash page at length 0 (the host mirrors are not
        touched; every pass pushes its rows first). Outputs: (tokens,
        logits). The closures hold the buffers, not the engine."""
        b = self.max_batch
        shapes = {"tokens": (b, s)}
        if q_valid:
            shapes["q_valid"] = (b,)

            def body(tokens, q_valid):
                return step(params, tokens, q_valid, caches, cfg)[:2]
        else:
            def body(tokens):
                return step(params, tokens, caches, cfg)[:2]

        return CompiledPass(
            name, body, shapes, self.device, capture=self.cuda_graphs,
            trash=functools.partial(_push_trash, rows, _trash_page(caches)))

    def passes(self) -> Dict[str, CompiledPass]:
        """The engine's compiled passes by name."""
        return {n: getattr(self, f"_{n}") for n in
                ("decode", "chunk", "draft_decode", "verify")
                if hasattr(self, f"_{n}")}

    # ------------------------------------------------------------------
    def _validate_submit(self, prompt: np.ndarray, max_new_tokens: int):
        """A prompt must leave room for at least one generated token under
        the stop bound, and the request must fit the pool."""
        limit = self._len_limit
        if len(prompt) > limit - 2:
            if self.chunk_size:
                raise ValueError(
                    f"prompt of {len(prompt)} tokens exceeds max_context - 2 "
                    f"= {limit - 2}; raise EngineConfig.max_context")
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds max_len - 2 = "
                f"{limit - 2}; enable chunked prefill "
                f"(EngineConfig(chunk_size=..., max_context=...)) to serve "
                f"prompts past max_len")
        need = self.store.blocks_for_tokens(
            min(len(prompt) + max_new_tokens, limit - 1))
        if need > self.num_blocks:
            raise ValueError(
                f"request needs {need} blocks but the pool holds only "
                f"{self.num_blocks}; raise num_blocks or shrink the request")

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> EngineRequest:
        prompt = np.asarray(prompt, np.int32)
        self._validate_submit(prompt, max_new_tokens)
        r = EngineRequest(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          submit_time=time.monotonic())
        self._next_rid += 1
        self.waiting.append(r)
        return r

    def enqueue(self, r: EngineRequest):
        """Queue a request FIFO-fairly (by rid)."""
        rids = [w.rid for w in self.waiting]
        self.waiting.insert(bisect.bisect_left(rids, r.rid), r)

    # -- block-table row maintenance -----------------------------------
    def _pad_ids(self, blocks: List[int]) -> np.ndarray:
        ids = np.full((self.max_blocks,), self.store.trash_block, np.int32)
        ids[:len(blocks)] = blocks
        return ids

    def _set_row(self, slot: int, blocks: List[int], length: int):
        self._tables_np[slot] = self._pad_ids(blocks)
        self._lengths_np[slot] = length

    def _clear_row(self, slot: int):
        self._tables_np[slot] = self.store.trash_block
        self._lengths_np[slot] = 0

    def _push_rows(self, tables: Optional[np.ndarray] = None,
                   lengths: Optional[np.ndarray] = None):
        """Sync block-table/length rows into the target's static buffers:
        the host mirrors by default; the mixed iteration's decode pass
        pushes a view instead, in which chunk-phase rows are trash/0."""
        _push(self._rows,
              self._tables_np if tables is None else tables,
              self._lengths_np if lengths is None else lengths)

    # -- admission ------------------------------------------------------
    def _resume_ctx(self, r: EngineRequest) -> np.ndarray:
        """Prompt plus every generated token but the last: decode resumes by
        feeding tokens[-1]. Nothing generated is lost."""
        return np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)]) \
            if r.tokens else r.prompt

    def _place(self, slot: int, r: EngineRequest):
        """Admission tail of every path: bind request to slot, stamp the
        admit order, (re-)prefill the draft model when speculating."""
        r.slot = slot
        r.state = "running"
        self._admit_order[r.rid] = self._admit_seq
        self._admit_seq += 1
        self.active[slot] = r
        if self.spec:
            self._admit_draft(r)

    def _admit_one(self, slot: int, r: EngineRequest) -> bool:
        """Try to place ``r`` in ``slot``; False when KV capacity blocks it
        (head-of-line: the caller stops admitting, keeping FIFO order)."""
        if r.state == "swapped":
            blocks = self.store.swap_in(r.rid)
            if blocks is None:
                return False
            t = self.store.tables[r.rid]
            pages = {name: {k: v.to(self.device) for k, v in g.items()}
                     for name, g in t.host_pages.items()}
            steps.scatter_pages(self.caches, pages,
                                self._tensor(np.asarray(blocks, np.int64)))
            t.host_pages = None
            self._set_row(slot, blocks, t.tokens)
            # mid-prefill swap victims resume chunking where the fill front
            # stopped; mid-decode victims have prefilled == len(ctx)
            r.ctx = self._resume_ctx(r)
            r.prefilled = t.tokens
        elif self.chunk_size:
            # chunked admission: reserve KV for the first chunk only (plus
            # any resident matched prefix); the mixed iteration prefills
            # chunk by chunk, growing the table at the fill front. No
            # forward pass runs here, so admission never stalls decodes.
            ctx = self._resume_ctx(r)
            chain = prefix_chain(r.prompt, self.block_tokens)
            got = self.store.allocate(r.rid, min(self.chunk_size, len(ctx)),
                                      chain, filled=0,
                                      context_tokens=len(ctx))
            if got is None:
                return False
            blocks, _ = got
            r.ctx = ctx
            r.prefilled = 0
            self._set_row(slot, blocks, 0)
        else:
            ctx = self._resume_ctx(r)
            chain = prefix_chain(r.prompt, self.block_tokens)
            got = self.store.allocate(r.rid, len(ctx), chain)
            if got is None:
                return False
            blocks, _ = got
            logits, dense = steps.prefill_step(
                self.params, {"tokens": self._tensor(ctx[None, :])}, self.cfg,
                self.max_len)
            # matched prefix blocks are rewritten with bit-identical content
            # (same tokens at same positions => same K/V)
            steps.write_prefill_pages(
                self.caches, dense,
                self._tensor(np.asarray(blocks, np.int64)),
                block_tokens=self.block_tokens)
            if r.state == "new":
                tok = int(torch.argmax(logits, -1)[0])
                r.first_token_time = time.monotonic()
                r.tokens.append(tok)
                r.token_times.append(r.first_token_time)
            self._set_row(slot, blocks, len(ctx))
            r.ctx = ctx
            r.prefilled = len(ctx)
        self._place(slot, r)
        return True

    def _admit_draft(self, r: EngineRequest):
        """(Re-)prefill the draft model over ``r``'s resume context, at every
        admission path: draft KV is never swapped, it is dropped at
        preemption and rebuilt here."""
        ctx = r.ctx
        got = self.draft_store.allocate(r.rid, len(ctx), ())
        if got is None:
            raise RuntimeError("draft pool is sized never to run out")
        blocks, _ = got
        _, dense = steps.prefill_step(
            self.draft_params, {"tokens": self._tensor(ctx[None, :])},
            self.draft_cfg, self.max_len)
        steps.write_prefill_pages(
            self.draft_caches, dense,
            self._tensor(np.asarray(blocks, np.int64)),
            block_tokens=self.block_tokens)
        self._draft_tables_np[r.slot] = self.draft_store.trash_block
        self._draft_tables_np[r.slot, :len(blocks)] = blocks
        self._draft_lengths_np[r.slot] = len(ctx)
        self._draft_valid[r.rid] = len(ctx)

    def _drop_draft(self, r: EngineRequest, slot: int):
        """Free ``r``'s draft KV and clear its draft row."""
        if r.rid in self.draft_store.tables:
            self.draft_store.free(r.rid)
        self._draft_valid.pop(r.rid, None)
        self._draft_tables_np[slot] = self.draft_store.trash_block
        self._draft_lengths_np[slot] = 0

    def _admit(self):
        for slot in range(self.max_batch):
            if self.active[slot] is not None or not self.waiting:
                continue
            if not self._admit_one(slot, self.waiting[0]):
                break
            self.waiting.pop(0)

    # -- preemption -----------------------------------------------------
    def preempt_slot(self, slot: int, policy: Optional[str] = None):
        """Evict the request in ``slot`` and requeue it FIFO-fairly.
        ``swap`` moves its pages to host memory; ``recompute`` drops them.
        Either way the tokens generated so far are kept."""
        r = self.active[slot]
        if r is None:
            return
        policy = policy or self.preemption
        rid = r.rid
        if self.spec:
            # a mid-step victim may hold a speculative fork: roll the target
            # table back to its committed base before swap/drop; the draft
            # KV is dropped outright (rebuilt by _admit_draft on resume)
            if rid in self.store.forks:
                self.store.abort_fork(rid)
            self._drop_draft(r, slot)
        if policy == "swap":
            blocks = self.store.swap_out(rid)
            if blocks is None:                 # shared pages: degrade
                policy = "recompute"
            else:
                # exactly the victim's pages, not the trash-padded table
                pages = steps.gather_pages(
                    self.caches, self._tensor(np.asarray(blocks, np.int64)))
                self.store.tables[rid].host_pages = {
                    name: {k: v.cpu() for k, v in g.items()}
                    for name, g in pages.items()}
                r.state = "swapped"
        if policy == "recompute":
            self.store.drop(rid)
            r.state = "preempted"
        r.preemptions += 1
        self.active[slot] = None
        r.slot = None
        self._clear_row(slot)
        self.enqueue(r)

    def _make_room(self, for_rid: int) -> bool:
        """Free blocks by preempting the most-recently-admitted other active
        request (the simulator's coldest-victim rule)."""
        victims = [r for r in self.active
                   if r is not None and r.rid != for_rid]
        if not victims:
            return False
        v = max(victims, key=lambda r: self._admit_order[r.rid])
        self.preempt_slot(v.slot)
        return True

    # -- decode ---------------------------------------------------------
    def _is_decoding(self, r: EngineRequest) -> bool:
        """Decode-phase rows have their whole context in KV; chunk-phase
        rows are still filling it (chunked prefill only)."""
        return r.prefilled >= len(r.ctx)

    def _grow_active(self):
        """Fault in pages so every active decode row's table covers the KV
        slot its next decode write lands in; exhaustion preempts victims."""
        for slot in range(self.max_batch):
            r = self.active[slot]      # re-read: _make_room may evict slots
            if r is None or not self._is_decoding(r) \
                    or not self.store.needs_block(r.rid):
                continue
            while True:
                b = self.store.grow(r.rid)
                if b is not None:
                    self._tables_np[r.slot,
                                    len(self.store.tables[r.rid].blocks) - 1] = b
                    break
                if not self._make_room(r.rid):
                    raise RuntimeError(
                        "KV pool exhausted with no preemptable victim")

    def _grow_to(self, r: EngineRequest, target_tokens: int):
        """Fault pages until ``r``'s table covers ``target_tokens`` KV slots
        (chunk-phase growth at the fill front); exhaustion preempts victims,
        never ``r`` itself."""
        t = self.store.tables[r.rid]
        while len(t.blocks) * self.block_tokens < target_tokens:
            b = self.store.grow(r.rid)
            if b is not None:
                self._tables_np[r.slot, len(t.blocks) - 1] = b
                continue
            if not self._make_room(r.rid):
                raise RuntimeError(
                    "KV pool exhausted with no preemptable victim")

    def _finish(self, r: EngineRequest, now: float):
        r.finish_time = now
        r.state = "done"
        if self.spec:
            self._drop_draft(r, r.slot)
        self.store.free(r.rid)
        del self._admit_order[r.rid]
        self.finished.append(r)
        self.active[r.slot] = None
        self._clear_row(r.slot)
        r.slot = None

    def _trace_step(self):
        self.steps += 1
        if self.trace_occupancy:
            st = self.store
            self.occupancy.append({
                "step": self.steps, "used_blocks": st.used_blocks,
                "free_blocks": st.free_blocks,
                "cached_blocks": st.cached_blocks,
                "active": sum(a is not None for a in self.active),
            })

    def _decode_bookkeeping(self, new_tok: np.ndarray):
        """Per decode row: stream the token, advance the store, finish rows
        that hit a stop condition. Chunk-phase rows are skipped."""
        now = time.monotonic()
        for s, r in enumerate(self.active):
            if r is None or not self._is_decoding(r):
                continue
            self.store.advance(r.rid)
            self._lengths_np[s] = min(self._lengths_np[s] + 1,
                                      self._len_limit - 1)
            t = int(new_tok[s])
            r.tokens.append(t)
            r.token_times.append(now)
            done = (len(r.tokens) >= r.max_new_tokens
                    or (r.eos_id is not None and t == r.eos_id)
                    or len(r.prompt) + len(r.tokens) >= self._len_limit - 1)
            if done:
                self._finish(r, now)

    def _decode_pass(self):
        """One ``(max_batch, 1)`` decode pass over the decode-phase rows,
        with chunk-phase rows seen as trash/0 so the pass's write at
        position ``length`` can never land in a live page; dead rows ride
        along on the trash page. A no-op when no row is decode-phase."""
        dec = [r for r in self.active
               if r is not None and self._is_decoding(r)]
        if not dec:
            return
        tabs = self._tables_np.copy()
        lens = self._lengths_np.copy()
        for r in self.active:
            if r is not None and not self._is_decoding(r):
                tabs[r.slot] = self.store.trash_block
                lens[r.slot] = 0
        last = np.zeros((self.max_batch, 1), np.int32)
        for r in dec:
            last[r.slot, 0] = r.tokens[-1]
        self._push_rows(tabs, lens)
        new_tok, _ = self._decode.run(tokens=last)
        self._decode_bookkeeping(new_tok.cpu().numpy())

    # -- chunked prefill pass -------------------------------------------
    def _chunk_budget(self, n_dec: int) -> int:
        """Chunk tokens this iteration may spend after the decode
        reservation (the TTFT-vs-ITL split of the token budget)."""
        budget = self.config.token_budget or (self.max_batch + self.chunk_size)
        if n_dec == 0:
            return max(budget, 1)
        reserved = max(n_dec,
                       int(np.ceil(self.config.decode_share * budget)))
        return max(0, budget - reserved)

    def _chunk_pass(self):
        """One ``(max_batch, chunk_size)`` chunked-prefill pass advancing
        each chunk-phase row's fill front by up to ``chunk_size`` tokens
        within the iteration's token budget, rows taken in admit order. A
        prompt completing its last chunk streams its first token from this
        pass. ``_grow_to`` may preempt victims (most recently admitted),
        including rows already scheduled this pass: takes are re-checked
        after."""
        chunkers = sorted(
            (r for r in self.active
             if r is not None and not self._is_decoding(r)),
            key=lambda r: self._admit_order[r.rid])
        budget = self._chunk_budget(sum(1 for r in self.active
                                        if r is not None
                                        and self._is_decoding(r)))
        takes: Dict[int, int] = {}
        for r in chunkers:
            if r.slot is None or self.active[r.slot] is not r:
                continue                       # evicted by a peer's growth
            take = min(self.chunk_size, len(r.ctx) - r.prefilled, budget)
            if take <= 0:
                continue
            self._grow_to(r, r.prefilled + take)
            takes[r.rid] = take
            budget -= take
        alive = {r.rid for r in self.active if r is not None}
        takes = {rid: tk for rid, tk in takes.items() if rid in alive}
        if takes:
            toks = np.zeros((self.max_batch, self.chunk_size), np.int32)
            q_valid = np.zeros((self.max_batch,), np.int32)
            rows = [r for r in self.active
                    if r is not None and r.rid in takes]
            for r in rows:
                tk = takes[r.rid]
                toks[r.slot, :tk] = r.ctx[r.prefilled:r.prefilled + tk]
                q_valid[r.slot] = tk
            self._push_rows()                  # real tables for every row
            new_tok, _ = self._chunk.run(tokens=toks, q_valid=q_valid)
            new_tok = new_tok.cpu().numpy()
            now = time.monotonic()
            for r in rows:
                tk = takes[r.rid]
                self.store.advance(r.rid, tk)
                r.prefilled += tk
                self._lengths_np[r.slot] = r.prefilled
                if r.prefilled == len(r.ctx) and not r.tokens:
                    # prompt complete: stream the first token (resumes keep
                    # their stream and re-enter decode by feeding tokens[-1])
                    tok = int(new_tok[r.slot])
                    r.first_token_time = now
                    r.tokens.append(tok)
                    r.token_times.append(now)
        self._trace_step()

    def kv_stats(self) -> Dict[str, float]:
        return self.store.stats()


class Engine(EngineCore):
    """Continuous-batching engine over paged KV on one device."""

    def _step_decode(self):
        """Whole-prefill iteration: one (max_batch, 1) decode pass."""
        self._grow_active()
        self._decode_pass()
        self._trace_step()

    def _step_mixed(self):
        """One mixed iteration: the decode pass for decode-phase rows (the
        legacy iteration's shape and numerics), then the chunked-prefill
        pass for chunk-phase rows, sharing the iteration's token budget."""
        self._grow_active()
        self._decode_pass()
        self._chunk_pass()

    # -- speculative iteration (draft k, verify in one target pass) -----
    def _step_spec(self):
        """One speculative iteration over the active rows:

        1. DRAFT — rewind each row's draft cache to its last
           stream-consistent position, catch it up on the true stream, then
           roll the draft forward for up to ``k_eff`` greedy tokens (batched
           ``(b, 1)`` passes; rows done drafting sit out as trash/0).
        2. FORK — COW-fork each row's target table so the verify pass may
           write KV at positions ``L .. L + k_eff`` without touching
           committed pages; capacity faults preempt peers like
           ``_grow_active``.
        3. VERIFY — one ``(b, spec_k + 1)`` target pass feeds the last
           committed token plus the draft tokens; ``greedy[:, j]`` is what
           sequential decode would emit at that position.
        4. ACCEPT — per row, emit greedy tokens while they confirm the
           draft, plus the bonus token, applying the stop conditions token
           by token; ``commit_fork`` keeps KV for what was emitted.

        Streams equal ``_step_decode``'s: verify reproduces sequential
        numerics, and acceptance only decides how many of those tokens
        commit per pass (1..k_eff + 1, never 0)."""
        live = [r for r in self.active if r is not None]
        limit = self._len_limit
        k_eff: Dict[int, int] = {}
        for r in live:
            # k_eff caps so the verify feed never proposes past the stop
            # bounds: at most max_new - 1 further tokens ride behind the
            # guaranteed bonus token, and writes stay inside the table
            L = int(self._lengths_np[r.slot])
            k_eff[r.rid] = max(0, min(self.spec_k,
                                      r.max_new_tokens - len(r.tokens) - 1,
                                      limit - 1 - L))

        # -- 1. draft phase --------------------------------------------
        drafts: Dict[int, List[int]] = {r.rid: [] for r in live}
        queues: Dict[int, List[int]] = {}
        part = [r for r in live if k_eff[r.rid] > 0]
        for r in part:
            dv = self._draft_valid[r.rid]
            L = int(self._lengths_np[r.slot])
            stream = np.concatenate([r.ctx, np.asarray(r.tokens, np.int32)])
            # feeding stream[dv..L] rewrites draft KV at positions dv..L
            # (over any rejected-draft garbage); the last feed's output is
            # the first draft token
            queues[r.rid] = [int(t) for t in stream[dv:L + 1]]
            self._draft_lengths_np[r.slot] = dv
        while part:
            feed = np.zeros((self.max_batch, 1), np.int32)
            tabs = np.full_like(self._draft_tables_np,
                                self.draft_store.trash_block)
            lens = np.zeros_like(self._draft_lengths_np)
            for r in part:
                q = queues[r.rid]
                feed[r.slot, 0] = q.pop(0) if q else drafts[r.rid][-1]
                D = int(self._draft_lengths_np[r.slot])
                dt = self.draft_store.tables[r.rid]
                while len(dt.blocks) * self.block_tokens <= D:
                    b = self.draft_store.grow(r.rid)
                    if b is None:
                        raise RuntimeError(
                            "draft pool is sized never to run out")
                    self._draft_tables_np[r.slot, len(dt.blocks) - 1] = b
                tabs[r.slot] = self._draft_tables_np[r.slot]
                lens[r.slot] = D
            _push(self._draft_rows, tabs, lens)
            out, _ = self._draft_decode.run(tokens=feed)
            out = out.cpu().numpy()
            nxt = []
            for r in part:
                D = int(self._draft_lengths_np[r.slot])
                dt = self.draft_store.tables[r.rid]
                if D + 1 > dt.tokens:      # store tracks the high-water mark
                    self.draft_store.advance(r.rid, D + 1 - dt.tokens)
                self._draft_lengths_np[r.slot] = D + 1
                if not queues[r.rid]:
                    drafts[r.rid].append(int(out[r.slot]))
                if queues[r.rid] or len(drafts[r.rid]) < k_eff[r.rid]:
                    nxt.append(r)
            part = nxt

        # -- 2. fork target tables -------------------------------------
        for r in live:
            if r.slot is None or self.active[r.slot] is not r:
                continue                   # evicted by a peer's fork below
            while True:
                f = self.store.fork_table(r.rid, k_eff[r.rid] + 1)
                if f is not None:
                    break
                if not self._make_room(r.rid):
                    raise RuntimeError(
                        "KV pool exhausted with no preemptable victim")
            self._tables_np[r.slot] = self._pad_ids(
                self.store.tables[r.rid].blocks)
            if f.cow:
                # copy the COW'd pages so the fork's private copies hold
                # the shared prefix content the verify pass reads
                steps.copy_pages(
                    self.caches,
                    self._tensor(np.asarray([o for _, o, _ in f.cow],
                                            np.int64)),
                    self._tensor(np.asarray([n for _, _, n in f.cow],
                                            np.int64)))

        # -- 3. verify pass --------------------------------------------
        live = [r for r in live
                if r.slot is not None and self.active[r.slot] is r]
        if not live:
            self._trace_step()
            return
        toks = np.zeros((self.max_batch, self.spec_k + 1), np.int32)
        q_valid = np.zeros((self.max_batch,), np.int32)
        for r in live:
            k = k_eff[r.rid]
            toks[r.slot, 0] = r.tokens[-1]
            toks[r.slot, 1:1 + k] = drafts[r.rid][:k]
            q_valid[r.slot] = k + 1
        self._push_rows()
        greedy, _ = self._verify.run(tokens=toks, q_valid=q_valid)
        greedy = greedy.cpu().numpy()

        # -- 4. accept, emit, commit -----------------------------------
        now = time.monotonic()
        for r in live:
            k = k_eff[r.rid]
            d = drafts[r.rid]
            a = 0
            while a < k and d[a] == int(greedy[r.slot, a]):
                a += 1
            self._spec_pos_proposed[:k] += 1
            self._spec_pos_accepted[:a] += 1
            L = int(self._lengths_np[r.slot])
            m, done = 0, False
            for j in range(a + 1):
                t = int(greedy[r.slot, j])
                r.tokens.append(t)
                r.token_times.append(now)
                m += 1
                if (len(r.tokens) >= r.max_new_tokens
                        or (r.eos_id is not None and t == r.eos_id)
                        or len(r.prompt) + len(r.tokens) >= limit - 1):
                    done = True
                    break
            self.store.commit_fork(r.rid, m)
            self._tables_np[r.slot] = self._pad_ids(
                self.store.tables[r.rid].blocks)
            self._lengths_np[r.slot] = min(L + m, limit - 1)
            self.spec_emitted += m
            self.spec_row_steps += 1
            if done:
                self._finish(r, now)
            elif k:
                # draft KV is valid through the accepted prefix (positions
                # L+1..L+min(k-1, a, m) hold confirmed draft tokens), capped
                # at L+m so the next catch-up re-feeds at least the newest
                # token
                self._draft_valid[r.rid] = min(L + m,
                                               L + 1 + min(k - 1, a, m))
        self.spec_iters += 1
        self._trace_step()

    def spec_stats(self) -> Dict[str, object]:
        """Acceptance telemetry. ``acceptance_per_position[i]`` is the
        marginal P(draft positions 0..i all accepted) (acceptance stops at
        the first rejection, so accepted/proposed is already a cumulative
        product); ``conditional_acceptance_per_position[i]`` divides out the
        previous position's marginal: P(accept i | accepted 0..i-1)."""
        prop = self._spec_pos_proposed
        acc = self._spec_pos_accepted
        marginal = [float(a) / p if p else 0.0 for a, p in zip(acc, prop)]
        cond, prev = [], 1.0
        for m in marginal:
            cond.append(min(1.0, m / prev) if prev > 0 else 0.0)
            prev = m
        return {
            "spec_k": self.spec_k,
            "iterations": self.spec_iters,
            "row_steps": self.spec_row_steps,
            "emitted": self.spec_emitted,
            # mean tokens a row commits per target pass it takes part in
            # (1.0 for plain decode)
            "tokens_per_step": (self.spec_emitted / self.spec_row_steps
                                if self.spec_row_steps else 0.0),
            "proposed_per_position": [int(x) for x in prop],
            "accepted_per_position": [int(x) for x in acc],
            "acceptance_per_position": marginal,
            "conditional_acceptance_per_position": cond,
        }

    def run(self, max_steps: int = 100_000) -> List[EngineRequest]:
        if self.spec:
            step = self._step_spec
        else:
            step = self._step_mixed if self.chunk_size else self._step_decode
        while (self.waiting or any(a is not None for a in self.active)) \
                and self.steps < max_steps:
            self._admit()
            if any(a is not None for a in self.active):
                step()
        return self.finished


def _trash_page(caches) -> int:
    """The trash page of paged ``caches``: the pools' last page."""
    return caches["attn"]["k_pool"].shape[1] - 1


def _push(rows: StaticInputs, tables: np.ndarray, lengths: np.ndarray):
    """Write block-table/length rows into ``rows``' static buffers (one
    non-blocking copy from the pinned staging)."""
    rows.host["tables"][...] = tables
    rows.host["lengths"][...] = lengths
    rows.push()


def _push_trash(rows: StaticInputs, trash: int):
    """Every row of ``rows`` on the trash page at length 0."""
    _push(rows, trash, 0)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def paged_supported(cfg: ModelConfig) -> bool:
    """Can this config serve through the paged ``Engine``? Paging covers
    attention KV only (as in the JAX package)."""
    return (cfg.family in ("dense", "vlm", "audio", "moe")
            and cfg.attn_type != "mla")


def make_engine(cfg: ModelConfig, **kw):
    """Engine factory, as in the JAX package: the paged ``Engine`` when the
    config's attention cache pages, else the dense ``SlotEngine`` (MLA and
    the recurrent families), with the paged-only keywords dropped. A family
    the port does not serve yet raises (``transformer.check_family``), and
    an encoder-only config, which has no serving path, as JAX's serve
    launcher does (``ValueError``)."""
    tf.check_family(cfg)
    tf.check_serving(cfg)
    if paged_supported(cfg):
        return Engine(cfg, **kw)
    for k in ("block_tokens", "num_blocks", "preemption", "trace_occupancy",
              "config", "draft_params"):
        kw.pop(k, None)
    return SlotEngine(cfg, **kw)


# ---------------------------------------------------------------------------
# dense slot engine (the parity oracle)
# ---------------------------------------------------------------------------

class SlotEngine:
    """The dense-KV engine: one contiguous ``(max_len, kvh, hd)`` cache row
    per decode slot, no paging, decoding through ``decode_attention`` (MLA:
    a ``(max_len, kv_lora)`` latent row and its rope key, decoded by
    einsums; the recurrent families: each slot's recurrent state, and the
    hybrid's shared-block K/V rows; the engine ``make_engine`` gives MLA
    and the recurrent families). The
    oracle the paged ``Engine`` is held against (same admission policy,
    same greedy decode, so token streams must match). Its preemption keeps
    the JAX package's seed behaviour: it discards progress past the first
    streamed token.

    Its ``(max_batch, 1)`` decode pass ``_decode`` is a ``CompiledPass``
    over the dense caches, written in place: each row's K/V at its length,
    and ``lengths + 1`` back into the caches' ``length`` buffer inside the
    pass (the device holds the lengths; admission writes a slot's row,
    length included, in place; a recurrent state is written in place by
    the pass and whole by admission). A recurrent config's prompt must be
    one its chunked prefill takes (``transformer.check_prompt``), or
    ``submit`` raises."""

    def __init__(self, cfg: ModelConfig, params=None, max_batch: int = 4,
                 max_len: int = 512, seed: int = 0, device="cuda",
                 cuda_graphs: bool = True):
        tf.check_family(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = tf.init_model(cfg, gen, self.device)
        self.params = _to_device(params, self.device)
        self.caches = tf.init_cache(cfg, max_batch, max_len, self.device)
        self.active: List[Optional[EngineRequest]] = [None] * max_batch
        self.waiting: List[EngineRequest] = []
        self.finished: List[EngineRequest] = []
        self.steps = 0
        self._next_rid = 0
        self.cuda_graphs = cuda_graphs
        self._decode = self._compile_decode()

    def _compile_decode(self) -> CompiledPass:
        """The decode pass, advancing the lengths of every cache group that
        has them (the moe family's ``dense_attn`` and ``attn``, the
        hybrid's ``attn``); recurrent states are written in place by the
        model. Its warm-up runs every row at length ``max_len - 1`` (the
        trash position: a live row stops before its writes or reads reach
        it) and then restores the lengths and the recurrent states: by
        zeroing them where they were all zeros (a fresh engine: no copy of
        the state is kept, 5.6 GB for xlstm_1_3b at 8 slots), else from a
        copy."""
        params, caches, cfg = self.params, self.caches, self.cfg
        grouped = [name for name, g in caches.items() if "length" in g]
        lengths = [caches[name]["length"] for name in grouped]
        state = [t for g in caches.values() if "length" not in g
                 for t in g.values()]
        trash_at = self.max_len - 1

        def body(tokens):
            tok, logits, new = steps.serve_step(params, tokens, caches, cfg)
            for name, ln in zip(grouped, lengths):
                ln.copy_(new[name]["length"])
            return tok, logits

        def all_trash():
            saved = [ln.clone() for ln in lengths]
            kept = (None if not any(bool(t.any()) for t in state)
                    else [t.clone() for t in state])
            for ln in lengths:
                ln.fill_(trash_at)

            def restore():
                for ln, v in zip(lengths, saved):
                    ln.copy_(v)
                for i, t in enumerate(state):
                    if kept is None:
                        t.zero_()
                    else:
                        t.copy_(kept[i])
            return restore
        return CompiledPass("decode", body, {"tokens": (self.max_batch, 1)},
                            self.device, capture=self.cuda_graphs,
                            trash=all_trash)

    def passes(self) -> Dict[str, CompiledPass]:
        """The engine's compiled passes by name."""
        return {"decode": self._decode}

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> EngineRequest:
        prompt = np.asarray(prompt, np.int32)
        tf.check_prompt(self.cfg, len(prompt))
        r = EngineRequest(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          submit_time=time.monotonic())
        self._next_rid += 1
        self.waiting.append(r)
        return r

    def _write_slot(self, slot: int, req_cache):
        """Copy a single-request cache (every leaf ``(L, 1, ...)``) into
        batch slot ``slot``, lengths and recurrent states included."""
        for name, g in self.caches.items():
            for k, full in g.items():
                full[:, slot] = req_cache[name][k][:, 0].to(full.dtype)

    def _admit(self):
        for slot in range(self.max_batch):
            if self.active[slot] is not None or not self.waiting:
                continue
            r = self.waiting.pop(0)
            logits, cache1 = steps.prefill_step(
                self.params,
                {"tokens": torch.as_tensor(r.prompt[None, :],
                                           device=self.device)},
                self.cfg, self.max_len)
            tok = int(torch.argmax(logits, -1)[0])
            now = time.monotonic()
            r.first_token_time = now
            r.tokens.append(tok)
            r.token_times.append(now)
            r.slot = slot
            self._write_slot(slot, cache1)
            self.active[slot] = r

    def _step_decode(self):
        last = np.zeros((self.max_batch, 1), np.int32)
        for s, r in enumerate(self.active):
            if r is not None:
                last[s, 0] = r.tokens[-1]
        new_tok, _ = self._decode.run(tokens=last)
        new_tok = new_tok.cpu().numpy()
        now = time.monotonic()
        for s, r in enumerate(self.active):
            if r is None:
                continue
            t = int(new_tok[s])
            r.tokens.append(t)
            r.token_times.append(now)
            done = (len(r.tokens) >= r.max_new_tokens
                    or (r.eos_id is not None and t == r.eos_id)
                    or len(r.prompt) + len(r.tokens) >= self.max_len - 1)
            if done:
                r.finish_time = now
                self.finished.append(r)
                self.active[s] = None
        self.steps += 1

    def run(self, max_steps: int = 100_000) -> List[EngineRequest]:
        while (self.waiting or any(a is not None for a in self.active)) \
                and self.steps < max_steps:
            self._admit()
            if any(a is not None for a in self.active):
                self._step_decode()
        return self.finished

    def preempt_slot(self, slot: int):
        """Evict ``slot`` and requeue its request at the head, keeping only
        the first streamed token (the seed behaviour)."""
        r = self.active[slot]
        if r is None:
            return
        r.tokens = r.tokens[:1]
        r.token_times = r.token_times[:1]
        self.active[slot] = None
        self.waiting.insert(0, r)
