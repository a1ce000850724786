"""The paged serving engine of the PyTorch port (twin of the whole-prefill
path of ``repro.engine.core``).

``EngineCore`` holds the ``PagedKVStore``, the physical K/V pools, the
host mirrors of the block tables and lengths, admission, growth and
preemption; ``Engine`` drives the legacy whole-prompt iteration: admit (one
blocking prefill per admission), then one ``(max_batch, 1)`` decode pass.
The interface contract is the JAX engine's:

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

Chunked prefill (``EngineConfig.chunk_size > 0``), speculative decoding
(``draft_cfg``) and the dense ``SlotEngine`` arrive with later slices of the
port and raise ``NotImplementedError`` here.

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
    """Scheduling policy of the paged ``Engine``. This slice serves the
    defaults only: whole-prompt admission (``chunk_size == 0``,
    ``max_context`` 0 or ``max_len``) and no draft model; the fields that
    select the later slices' paths keep the JAX package's names and raise
    ``NotImplementedError`` when set."""
    chunk_size: int = 0
    max_context: int = 0
    draft_cfg: Optional[ModelConfig] = None
    spec_k: int = 0


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


def _check_config(config: EngineConfig, max_len: int):
    if config.chunk_size or (config.max_context
                             and config.max_context != max_len):
        raise NotImplementedError(
            "chunked prefill (EngineConfig.chunk_size / max_context) arrives "
            "with the chunked-prefill slice of the PyTorch port")
    if config.draft_cfg is not None or config.spec_k:
        raise NotImplementedError(
            "speculative decoding (EngineConfig.draft_cfg / spec_k) arrives "
            "with the speculative-decoding slice of the PyTorch port")


class EngineCore:
    """Store + cache pool + block tables + admission/preemption/growth and
    the decode pass, on one device."""

    def __init__(self, cfg: ModelConfig, params=None, max_batch: int = 4,
                 max_len: int = 512, seed: int = 0, block_tokens: int = 16,
                 num_blocks: Optional[int] = None, preemption: str = "swap",
                 trace_occupancy: bool = False,
                 config: Optional[EngineConfig] = None, device="cuda"):
        if max_len % block_tokens:
            raise ValueError("max_len must be a multiple of block_tokens")
        if preemption not in ("swap", "recompute"):
            raise ValueError(f"preemption={preemption!r}")
        self.config = config or EngineConfig()
        _check_config(self.config, max_len)
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

    def _push_rows(self, tables: np.ndarray, lengths: np.ndarray):
        """Sync block-table/length rows into every cache group (identical
        across layers: one device copy, broadcast as a view)."""
        tabs, lens = self._tensor(tables), self._tensor(lengths)
        for g in self.caches.values():
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
        r.slot = slot
        r.state = "running"
        self._admit_order[r.rid] = self._admit_seq
        self._admit_seq += 1
        self.active[slot] = r

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
        self._push_rows(self._tables_np, self._lengths_np)
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

    def run(self, max_steps: int = 100_000) -> List[EngineRequest]:
        while (self.waiting or any(a is not None for a in self.active)) \
                and self.steps < max_steps:
            self._admit()
            if any(a is not None for a in self.active):
                self._step_decode()
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
    """The paged ``Engine`` for the configs this slice serves (dense GQA).
    The JAX package hands MLA configs to the dense ``SlotEngine``, and the
    other paged families need their own layers; both raise here, each naming
    the slice of the port that brings it."""
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: needs the dense SlotEngine, which arrives with the "
            "SlotEngine / decode_attention slice of the PyTorch port")
    tf.check_family(cfg)
    return Engine(cfg, **kw)
