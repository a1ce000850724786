"""The serving engines of the PyTorch port (twin of the whole-prefill and
speculative paths of ``repro.engine.core``, and of its dense ``SlotEngine``).

``EngineCore`` holds the ``PagedKVStore``, the physical K/V pools, the
host mirrors of the block tables and lengths, admission, growth and
preemption; ``Engine`` drives the legacy whole-prompt iteration: admit (one
blocking prefill per admission), then one ``(max_batch, 1)`` decode pass,
or with a draft model one speculative iteration (draft, fork, verify,
accept). ``SlotEngine`` is the dense per-slot engine the paged one is held
against. The interface contract is the JAX engine's:

* ``max_len`` is a multiple of ``block_tokens``; ``max_blocks = max_len //
  block_tokens``; the pool holds ``num_blocks`` pages plus one trash page
  (index ``num_blocks``) that dead rows point at.
* The model masks positions ``>= length`` to probability exactly 0, so stale
  page content cannot leak into live rows.
* Full block-aligned prompt blocks register in the store's radix index; a
  later prompt sharing that prefix maps the same physical pages.
* Preemption is real: ``swap`` copies the victim's pages to host memory
  (``.cpu()``) and back (``.to(device)``) on resume; ``recompute`` drops them
  and re-prefills ``prompt + generated[:-1]``. Both keep every token
  generated so far; victims requeue FIFO-fairly.
* Speculative decoding (``EngineConfig(draft_cfg=..., spec_k=...)``): each
  iteration drafts up to ``spec_k`` greedy tokens per row with the draft
  model (its own paged pool, never short of pages), COW-forks the target
  tables (``PagedKVStore.fork_table``), scores every draft position in one
  target pass (``paged_verify_attention``) and commits the longest agreeing
  prefix plus the bonus token; greedy streams equal plain decode's.

Chunked prefill (``EngineConfig.chunk_size > 0``) arrives with a later
slice of the port and raises ``NotImplementedError`` here.

Every entry point runs on ``device="cuda"`` unless the caller passes another
device (the CPU tests pass ``device="cpu"``); without a card, CUDA fails
loudly, nothing falls back.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.paged_kv import PagedKVStore, prefix_chain
from repro_torch.models import steps
from repro_torch.models import transformer as tf


@dataclass
class EngineConfig:
    """Scheduling policy of the paged ``Engine``. The port serves
    whole-prompt admission (``chunk_size == 0``, ``max_context`` 0 or
    ``max_len``); the chunked-prefill fields keep the JAX package's names
    and raise ``NotImplementedError`` when set.

    Speculative decoding (``draft_cfg`` + ``spec_k``): every iteration runs
    the draft model for up to ``spec_k`` greedy tokens per row, verifies
    them in one target pass and commits the longest matching prefix plus
    the bonus token.

    * ``draft_cfg`` — config of the draft model (dense GQA, the target's
      vocabulary). None disables speculation.
    * ``spec_k`` — draft tokens proposed per iteration (0 disables).
    * ``draft_seed`` — seed of the draft parameters when the engine is not
      handed ``draft_params``.
    """
    chunk_size: int = 0
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
    # ``ctx`` is the context this admission wrote to KV (prompt, or prompt +
    # generated[:-1] on a recompute resume); ``prefilled`` counts it
    ctx: Optional[np.ndarray] = None
    prefilled: int = 0

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


def _check_config(config: EngineConfig, cfg: ModelConfig, max_len: int):
    if config.chunk_size or (config.max_context
                             and config.max_context != max_len):
        raise NotImplementedError(
            "chunked prefill (EngineConfig.chunk_size / max_context) arrives "
            "with the chunked-prefill slice of the PyTorch port")
    if config.draft_cfg is not None and config.spec_k > 0:
        tf.check_family(config.draft_cfg)
        if config.draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")


class EngineCore:
    """Store + cache pool + block tables + admission/preemption/growth and
    the decode pass, on one device."""

    def __init__(self, cfg: ModelConfig, params=None, max_batch: int = 4,
                 max_len: int = 512, seed: int = 0, block_tokens: int = 16,
                 num_blocks: Optional[int] = None, preemption: str = "swap",
                 trace_occupancy: bool = False,
                 config: Optional[EngineConfig] = None, draft_params=None,
                 device="cuda"):
        if max_len % block_tokens:
            raise ValueError("max_len must be a multiple of block_tokens")
        if preemption not in ("swap", "recompute"):
            raise ValueError(f"preemption={preemption!r}")
        self.config = config or EngineConfig()
        _check_config(self.config, cfg, max_len)
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_tokens = block_tokens
        self.max_blocks = max_len // block_tokens
        self.num_blocks = (max_batch * self.max_blocks if num_blocks is None
                           else num_blocks)
        self.preemption = preemption
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = tf.init_model(cfg, gen, self.device)
        self.params = _to_device(params, self.device)
        self.store = PagedKVStore(self.num_blocks, block_tokens)
        self.caches = tf.init_paged_cache(cfg, max_batch, self.num_blocks,
                                          block_tokens, self.max_blocks,
                                          self.device)
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
        self._admit_order: Dict[int, int] = {}   # rid -> admit seq
        self.trace_occupancy = trace_occupancy
        self.occupancy: List[Dict] = []          # per-step block occupancy

        # -- speculative decoding (draft model + verify pass) ----------
        self.spec_k = self.config.spec_k
        self.draft_cfg = self.config.draft_cfg
        self.spec = self.draft_cfg is not None and self.spec_k > 0
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
            self._draft_tables_np = np.full(
                (max_batch, self.max_blocks), self.draft_store.trash_block,
                np.int32)
            self._draft_lengths_np = np.zeros((max_batch,), np.int32)
            # rid -> leading draft-cache positions whose KV matches the
            # request's true token stream (the rewind point for drafting)
            self._draft_valid: Dict[int, int] = {}
            # acceptance accounting (spec_stats())
            self.spec_iters = 0
            self.spec_row_steps = 0
            self.spec_emitted = 0
            self._spec_pos_proposed = np.zeros((self.spec_k,), np.int64)
            self._spec_pos_accepted = np.zeros((self.spec_k,), np.int64)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------
    def _validate_submit(self, prompt: np.ndarray, max_new_tokens: int):
        """A prompt must leave room for at least one generated token under
        the stop bound, and the request must fit the pool."""
        limit = self.max_len
        if len(prompt) > limit - 2:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds max_len - 2 = "
                f"{limit - 2}")
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

    def _push_rows(self):
        """Sync the host mirrors of the block tables and lengths into the
        target's cache groups."""
        self._push(self.caches, self._tables_np, self._lengths_np)

    def _push(self, caches, tables: np.ndarray, lengths: np.ndarray):
        """Sync block-table/length rows into every cache group of
        ``caches`` (identical across layers: one device copy, broadcast as
        a view)."""
        tabs, lens = self._tensor(tables), self._tensor(lengths)
        for g in caches.values():
            L = g["block_tables"].shape[0]
            g["block_tables"] = tabs[None].expand(L, *tabs.shape)
            g["length"] = lens[None].expand(L, *lens.shape)

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
            r.ctx = self._resume_ctx(r)
            r.prefilled = t.tokens
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
    def _grow_active(self):
        """Fault in pages so every active row's table covers the KV slot its
        next decode write lands in; exhaustion preempts victims."""
        for slot in range(self.max_batch):
            r = self.active[slot]      # re-read: _make_room may evict slots
            if r is None or not self.store.needs_block(r.rid):
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
        """Stream the token, advance the store, finish rows that hit a stop
        condition."""
        now = time.monotonic()
        for s, r in enumerate(self.active):
            if r is None:
                continue
            self.store.advance(r.rid)
            self._lengths_np[s] = min(self._lengths_np[s] + 1,
                                      self.max_len - 1)
            t = int(new_tok[s])
            r.tokens.append(t)
            r.token_times.append(now)
            done = (len(r.tokens) >= r.max_new_tokens
                    or (r.eos_id is not None and t == r.eos_id)
                    or len(r.prompt) + len(r.tokens) >= self.max_len - 1)
            if done:
                self._finish(r, now)

    def _decode_pass(self):
        """One ``(max_batch, 1)`` decode pass over the active rows; dead
        rows ride along on the trash page."""
        if all(r is None for r in self.active):
            return
        last = np.zeros((self.max_batch, 1), np.int32)
        for r in self.active:
            if r is not None:
                last[r.slot, 0] = r.tokens[-1]
        self._push_rows()
        new_tok, _, self.caches = steps.serve_step(
            self.params, self._tensor(last), self.caches, self.cfg)
        self._decode_bookkeeping(new_tok.cpu().numpy())

    def kv_stats(self) -> Dict[str, float]:
        return self.store.stats()


class Engine(EngineCore):
    """Continuous-batching engine over paged KV on one device."""

    def _step_decode(self):
        """Whole-prefill iteration: one (max_batch, 1) decode pass."""
        self._grow_active()
        self._decode_pass()
        self._trace_step()

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
        limit = self.max_len
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
            self._push(self.draft_caches, tabs, lens)
            out, _, self.draft_caches = steps.serve_step(
                self.draft_params, self._tensor(feed), self.draft_caches,
                self.draft_cfg)
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
        greedy, _, self.caches = steps.verify_step(
            self.params, self._tensor(toks), self._tensor(q_valid),
            self.caches, self.cfg)
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
        step = self._step_spec if self.spec else self._step_decode
        while (self.waiting or any(a is not None for a in self.active)) \
                and self.steps < max_steps:
            self._admit()
            if any(a is not None for a in self.active):
                step()
        return self.finished


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def paged_supported(cfg: ModelConfig) -> bool:
    """Can this config serve through the paged ``Engine``? Paging covers
    attention KV only (as in the JAX package)."""
    return (cfg.family in ("dense", "vlm", "audio", "moe")
            and cfg.attn_type != "mla")


def make_engine(cfg: ModelConfig, **kw) -> Engine:
    """The paged ``Engine`` for the configs the port serves (dense GQA).
    The JAX package hands MLA and the recurrent families to the dense
    ``SlotEngine``; the port's ``SlotEngine`` serves only the dense GQA
    family, so those configs raise here, naming the slice that brings
    them."""
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: MLA and the recurrent families need their own "
            "layers, which arrive with the other-families slice of the "
            "PyTorch port")
    tf.check_family(cfg)
    return Engine(cfg, **kw)


# ---------------------------------------------------------------------------
# dense slot engine (the parity oracle)
# ---------------------------------------------------------------------------

class SlotEngine:
    """The dense-KV engine: one contiguous ``(max_len, kvh, hd)`` cache row
    per decode slot, no paging, decoding through ``decode_attention``. The
    oracle the paged ``Engine`` is held against (same admission policy,
    same greedy decode, so token streams must match). Its preemption keeps
    the JAX package's seed behaviour: it discards progress past the first
    streamed token."""

    def __init__(self, cfg: ModelConfig, params=None, max_batch: int = 4,
                 max_len: int = 512, seed: int = 0, device="cuda"):
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

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> EngineRequest:
        r = EngineRequest(rid=self._next_rid,
                          prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          submit_time=time.monotonic())
        self._next_rid += 1
        self.waiting.append(r)
        return r

    def _write_slot(self, slot: int, req_cache):
        """Copy a single-request cache (every leaf ``(L, 1, ...)``) into
        batch slot ``slot``, lengths included."""
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
        new_tok, _, self.caches = steps.serve_step(
            self.params, torch.as_tensor(last, device=self.device),
            self.caches, self.cfg)
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
