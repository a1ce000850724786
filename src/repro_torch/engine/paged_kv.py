"""Physical paged-KV bookkeeping for the PyTorch port's serving engine.

A copy of ``repro.engine.paged_kv`` (numpy only): the port owns it so that it
imports nothing of ``repro``, and ``tests/test_torch_engine.py`` walks both
copies through the same random operations to hold them equal.

``repro.core.memory.PagedKVAllocator`` models paged KV for the *simulator* —
block tables over a virtual byte pool. This module is its real-execution
twin: the same allocator semantics (fixed-size blocks, free list, refcounted
prefix sharing, cached refcount-0 radix blocks with LRU leaf-first reclaim,
swap/recompute preemption), but the blocks here index actual device tensors —
the pooled ``(num_pages, block_tokens, kvh, hd)`` K/V tensors built by
``models.transformer.init_paged_cache``. The store tracks *which* physical
page holds *what*; the ``Engine`` in ``engine/core.py`` owns the tensors and
performs the actual scatter/gather/device-transfers the store's decisions
imply.

Mirrored semantics (kept deliberately parallel to ``core/memory.py`` so the
fidelity benchmark compares like with like — see ``docs/architecture.md``):

* **Admission** reserves ``ceil(tokens / block_tokens)`` whole blocks; blocks
  whose block-aligned prompt-content hash chain is already resident are
  *shared* (refcount bump, no new page) and the rest come off the free list.
* **Growth** faults one block in at a time; exhaustion first reclaims cached
  radix blocks (LRU, leaf-first), then reports failure so the engine can
  preempt a victim.
* **Release** decrefs; registered blocks whose refcount hits 0 stay resident
  as evictable cache, everything else returns to the free list.
* **Swap-out** only moves refcount-1 tables (a shared page cannot leave the
  device without stranding its other owners — shared victims degrade to
  recompute), cascade-unregisters the chain so cached descendants never
  survive as orphans, and hands the engine the block list whose pages must
  move device → host.
* **Recompute drop** releases everything; the engine re-prefills on
  re-admission (keeping the tokens generated so far — the resume prompt is
  ``prompt + generated[:-1]``).
* **Speculative forks** (``fork_table`` / ``commit_fork`` / ``abort_fork``)
  extend a table by k tentative KV slots behind a copy-on-write boundary:
  shared or radix-registered pages in the write range are swapped for
  private copies and fresh pages are grown, so the draft-and-verify engine
  can reject speculation without ever having written a page someone else
  can see — the real-execution twin of the simulator's PR-2 radix COW.

Unlike the simulator allocator there is no overcommit: a physical pool
cannot hold more pages than it has, so an allocation that cannot be met even
after preemption is the caller's error (the engine sizes ``max_len`` against
the pool at submit).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def prefix_chain(tokens: Sequence[int], block_tokens: int) -> List[int]:
    """Block-aligned content-hash chain over a prompt: one hash per *full*
    block, each chained over its parent so equal chains imply equal
    block-aligned prefixes (the same scheme the simulator's workload layer
    feeds ``PagedKVAllocator``). The partial tail block never registers."""
    out: List[int] = []
    h = 0
    n_full = len(tokens) // block_tokens
    for i in range(n_full):
        blk = tuple(int(t) for t in
                    tokens[i * block_tokens:(i + 1) * block_tokens])
        h = hash((h, blk))
        out.append(h)
    return out


class _Node:
    __slots__ = ("hash", "block", "parent", "children")

    def __init__(self, h: int, block: int, parent: Optional["_Node"]):
        self.hash = h
        self.block = block
        self.parent = parent
        self.children: Dict[int, "_Node"] = {}


@dataclass
class PagedTable:
    """Per-request physical page map."""
    rid: int
    blocks: List[int] = field(default_factory=list)
    tokens: int = 0                    # KV slots actually filled
    hashes: List[int] = field(default_factory=list)  # registered chain prefix
    chain: List[int] = field(default_factory=list)   # full prompt hash chain
    on_device: bool = True
    host_pages: Optional[Dict] = None  # leaf-path -> np.ndarray when swapped


@dataclass
class PageExport:
    """A prefill-side handoff snapshot (``PagedKVStore.export_pages``): the
    filled physical blocks (table order), fill length, and the prompt hash
    chain the importing store dedups against."""
    rid: int
    blocks: List[int]
    tokens: int
    chain: List[int]


@dataclass
class Fork:
    """An in-flight speculative extension of one table (``fork_table``).

    Holds everything needed to abort back to the pre-fork state: the
    original block list / fill length / registered-chain prefix, which
    shared-or-registered blocks were COW'd out (``(index, old, new)``), and
    which fresh blocks were grown past the original table. COW'd-out
    original blocks stay refcounted by the fork itself until commit/abort
    resolves who keeps them."""
    rid: int
    base_blocks: List[int]
    base_tokens: int
    base_hashes: List[int]
    cow: List[Tuple[int, int, int]] = field(default_factory=list)
    grown: List[int] = field(default_factory=list)


class PagedKVStore:
    """Free list + refcounts + radix prefix index over a physical page pool.

    ``num_blocks`` allocatable pages (the engine's pool additionally carries
    one trash page at index ``num_blocks``, which this store never hands
    out)."""

    def __init__(self, num_blocks: int, block_tokens: int):
        assert num_blocks >= 1 and block_tokens >= 1
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.trash_block = self.num_blocks      # engine's sentinel page id
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.tables: Dict[int, PagedTable] = {}
        self.forks: Dict[int, Fork] = {}        # rid -> active fork
        self.refcount: Dict[int, int] = {}
        self.nodes: Dict[int, _Node] = {}       # chain hash -> node
        self.by_block: Dict[int, int] = {}      # block -> chain hash
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # rc-0, LRU
        # counters (mirrors of the simulator allocator's stats surface)
        self.page_faults = 0
        self.admission_failures = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.recompute_drops = 0
        self.radix_evictions = 0
        self.prefix_hit_blocks = 0
        self.prefix_hit_tokens = 0
        self.block_refs_total = 0
        self.blocks_allocated_total = 0
        self.peak_blocks = 0
        # disaggregated handoff accounting (export_pages / import_pages)
        self.exports = 0
        self.exported_blocks = 0
        self.imports = 0
        self.imported_blocks = 0
        self.import_dedup_blocks = 0

    # -- capacity ------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def available_blocks(self) -> int:
        return len(self._free) + len(self._cached)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free) - len(self._cached)

    def blocks_for_tokens(self, tokens: int) -> int:
        return max(0, -(-int(tokens) // self.block_tokens))

    # -- radix index ---------------------------------------------------------
    def match(self, chain: Sequence[int]) -> List[int]:
        out: List[int] = []
        for h in chain:
            node = self.nodes.get(h)
            if node is None:
                break
            out.append(node.block)
        return out

    def _register(self, h: int, block: int, parent_hash: Optional[int]) -> bool:
        if h in self.nodes:
            return False                       # collision: chain ends here
        parent = self.nodes.get(parent_hash) if parent_hash is not None else None
        node = _Node(h, block, parent)
        self.nodes[h] = node
        self.by_block[block] = h
        if parent is not None:
            parent.children[h] = node
        return True

    def _unregister(self, block: int):
        h = self.by_block.pop(block, None)
        if h is None:
            return
        node = self.nodes.pop(h)
        self._cached.pop(block, None)
        if node.parent is not None:
            node.parent.children.pop(h, None)

    def _unregister_subtree(self, block: int) -> List[int]:
        """Unregister a block's node and every registered descendant (swap-out
        path). Returns cached descendant blocks that must return to the free
        list — they lost their only reason to stay resident."""
        h = self.by_block.get(block)
        if h is None:
            return []
        freed: List[int] = []
        stack = list(self.nodes[h].children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            del self.nodes[node.hash]
            del self.by_block[node.block]
            if node.block in self._cached:
                del self._cached[node.block]
                freed.append(node.block)
        self._unregister(block)
        return freed

    def _evict_one(self) -> Optional[int]:
        """Reclaim the LRU cached *leaf* (a parent may not go before its
        registered children, so chains never get holes)."""
        for block in self._cached:             # insertion order == LRU
            if not self.nodes[self.by_block[block]].children:
                self._unregister(block)
                return block
        return None

    def _reclaim(self, n: int):
        while len(self._free) < n:
            b = self._evict_one()
            if b is None:
                break
            self._free.append(b)
            self.radix_evictions += 1

    # -- refcounts -----------------------------------------------------------
    def _incref(self, b: int):
        rc = self.refcount.get(b, 0) + 1
        self.refcount[b] = rc
        self.block_refs_total += 1
        if rc == 1:
            self._cached.pop(b, None)          # cached -> live

    def _decref(self, b: int):
        rc = self.refcount[b] - 1
        if rc > 0:
            self.refcount[b] = rc
            return
        del self.refcount[b]
        if b in self.by_block:
            self._cached[b] = None             # live -> cached (MRU end)
            self._cached.move_to_end(b)
        else:
            self._free.append(b)

    def _take(self, n: int) -> List[int]:
        self._reclaim(n)
        assert len(self._free) >= n, "PagedKVStore._take past capacity"
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._incref(b)
        self.blocks_allocated_total += len(got)
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        return got

    # -- admission / growth / release ----------------------------------------
    def _room_for(self, need_total: int, matched: Sequence[int]) -> bool:
        """Can ``need_total - len(matched)`` new blocks be taken once the
        matched blocks are revived? Matched blocks that are currently cached
        leave the evictable pool on revival, so they cannot also serve the
        unmatched remainder."""
        matched_cached = sum(1 for b in matched if b in self._cached)
        return (need_total - len(matched)
                <= self.available_blocks - matched_cached)

    def can_admit(self, tokens: int, chain: Sequence[int] = ()) -> bool:
        need_total = self.blocks_for_tokens(tokens)
        matched = self.match(chain)[:need_total]
        return self._room_for(need_total, matched)

    def allocate(self, rid: int, tokens: int, chain: Sequence[int] = (),
                 *, filled: Optional[int] = None,
                 context_tokens: Optional[int] = None,
                 count_hits: bool = True
                 ) -> Optional[Tuple[List[int], int]]:
        """Admission. Returns ``(blocks, n_matched)`` — the leading
        ``n_matched`` blocks are shared resident prefix pages the engine
        need not rewrite — or None when the pool (free + evictable cached)
        cannot cover the unmatched remainder.

        Whole-prompt path (defaults): reserve ``blocks_for(tokens)`` and
        declare all ``tokens`` filled (the engine writes them immediately).

        Chunked path: ``tokens`` covers only the FIRST chunk, ``filled=0``
        (nothing written yet — the mixed step fills and ``advance``s chunk
        by chunk, faulting later blocks in via ``grow``), and
        ``context_tokens`` is the full eventual context length. Matched
        prefix blocks are still claimed up to ``blocks_for(context_tokens)``
        — aliasing resident content is free, and it keeps prefix-hit
        accounting identical to the whole-prompt path.

        ``count_hits=False`` claims matched blocks without counting them as
        prefix hits — the decode-side page-import path uses this so handoff
        dedup (wire bytes saved) never inflates the prefix-cache hit rate,
        mirroring the simulator's ``PagedKVAllocator`` convention."""
        assert rid not in self.tables, f"double allocation for rid={rid}"
        context_tokens = int(tokens if context_tokens is None else context_tokens)
        need_chunk = self.blocks_for_tokens(tokens)
        cap = self.blocks_for_tokens(context_tokens)
        matched = self.match(chain)[:cap]
        need_fresh = max(0, need_chunk - len(matched))
        if not self._room_for(len(matched) + need_fresh, matched):
            self.admission_failures += 1
            return None
        for b in matched:
            self._incref(b)
        blocks = matched + self._take(need_fresh)
        t = PagedTable(rid, blocks, int(tokens if filled is None else filled))
        t.chain = list(chain)
        n_reg = min(len(chain), len(blocks))
        for i in range(len(matched), n_reg):
            if not self._register(chain[i], blocks[i],
                                  chain[i - 1] if i else None):
                n_reg = i
                break
        t.hashes = list(chain[:n_reg])
        self.tables[rid] = t
        if matched and count_hits:
            self.prefix_hit_blocks += len(matched)
            self.prefix_hit_tokens += min(context_tokens,
                                          len(matched) * self.block_tokens)
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        return blocks, len(matched)

    def needs_block(self, rid: int) -> bool:
        """Would writing one more KV slot require faulting in a page?"""
        t = self.tables[rid]
        return t.tokens >= len(t.blocks) * self.block_tokens

    def grow(self, rid: int) -> Optional[int]:
        """Fault one block in for ``rid``. Returns the new physical block, or
        None (counting a page fault) when nothing is free or evictable — the
        engine then preempts a victim and retries.

        Chain-aware: if the next block's prompt-content hash is resident
        (another request registered it since this one's admission — e.g.
        concurrent chunked prefills of a shared prefix), the resident page is
        aliased (refcount bump, no free block consumed). Fresh blocks whose
        chain position is known register as they are faulted in, so a
        chunked prefill publishes its prefix block by block exactly like a
        whole prefill publishes at admission."""
        assert rid not in self.forks, \
            f"rid={rid}: grow during an active fork (fork_table sizes growth)"
        t = self.tables[rid]
        assert t.on_device
        i = len(t.blocks)
        if i < len(t.chain):
            node = self.nodes.get(t.chain[i])
            if node is not None and (i == 0 or self.by_block.get(
                    t.blocks[i - 1]) == t.chain[i - 1]):
                self._incref(node.block)
                t.blocks.append(node.block)
                if i == len(t.hashes):
                    t.hashes.append(t.chain[i])
                self.prefix_hit_blocks += 1
                self.prefix_hit_tokens += self.block_tokens
                self.peak_blocks = max(self.peak_blocks, self.used_blocks)
                return node.block
        if self.available_blocks < 1:
            self.page_faults += 1
            return None
        (b,) = self._take(1)
        t.blocks.append(b)
        if i == len(t.hashes) and i < len(t.chain):
            if self._register(t.chain[i], b, t.chain[i - 1] if i else None):
                t.hashes.append(t.chain[i])
        return b

    def advance(self, rid: int, n: int = 1):
        assert rid not in self.forks, \
            f"rid={rid}: advance during an active fork (use commit_fork)"
        t = self.tables[rid]
        t.tokens += n
        assert t.tokens <= len(t.blocks) * self.block_tokens, \
            f"rid={rid} wrote past its block table"

    # -- speculative forks ---------------------------------------------------
    def fork_table(self, rid: int, extra_tokens: int) -> Optional[Fork]:
        """Open a copy-on-write fork covering ``extra_tokens`` speculative
        KV slots past the table's fill front.

        Any block in the speculative write range (block index
        ``>= tokens // block_tokens``) that is shared (refcount > 1) or
        registered in the radix index is COW'd out: the table row gets a
        fresh private page (the engine device-copies the old page's content
        into it before writing) and the original keeps its refcount — held
        by the fork — so shared owners and the prefix cache can never see a
        speculative write, accepted or not. Fresh blocks are then grown so
        the table covers ``tokens + extra_tokens`` slots. Exactly one of
        ``commit_fork`` / ``abort_fork`` must follow.

        Returns None (counting a page fault) when the pool cannot supply
        the fresh pages — nothing is mutated; the engine preempts a victim
        and retries, the same contract as ``grow``."""
        t = self.tables[rid]
        assert t.on_device, "cannot fork a swapped table"
        assert rid not in self.forks, f"rid={rid} already has an active fork"
        assert extra_tokens >= 0
        need_total = self.blocks_for_tokens(t.tokens + extra_tokens)
        first_write = t.tokens // self.block_tokens
        cow_idx = [i for i in range(first_write, len(t.blocks))
                   if self.refcount.get(t.blocks[i], 1) > 1
                   or t.blocks[i] in self.by_block]
        n_fresh = max(0, need_total - len(t.blocks)) + len(cow_idx)
        self._reclaim(n_fresh)
        if len(self._free) < n_fresh:
            self.page_faults += 1
            return None
        fork = Fork(rid, list(t.blocks), t.tokens, list(t.hashes))
        fresh = self._take(n_fresh)
        for i, nb in zip(cow_idx, fresh[:len(cow_idx)]):
            fork.cow.append((i, t.blocks[i], nb))
            t.blocks[i] = nb
        if cow_idx:
            # the table's blocks no longer follow the registered chain past
            # the first COW point (the replacement page is unregistered)
            t.hashes = t.hashes[:cow_idx[0]]
        fork.grown = fresh[len(cow_idx):]
        t.blocks.extend(fork.grown)
        self.forks[rid] = fork
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        return fork

    def commit_fork(self, rid: int, n_tokens: int):
        """Accept ``n_tokens`` speculative tokens: the forked layout becomes
        the table's real state. COW'd-out originals are released (shared
        owners / the radix cache keep them alive); grown blocks beyond the
        committed fill front return to the free list — but never blocks the
        table already held before the fork."""
        f = self.forks.pop(rid)
        t = self.tables[rid]
        assert n_tokens >= 0
        t.tokens = f.base_tokens + n_tokens
        assert t.tokens <= len(t.blocks) * self.block_tokens, \
            f"rid={rid} committed past its forked table"
        for _, old, _ in f.cow:
            self._decref(old)
        keep = max(self.blocks_for_tokens(t.tokens), len(f.base_blocks))
        for b in reversed(t.blocks[keep:]):
            self._decref(b)
        del t.blocks[keep:]

    def abort_fork(self, rid: int):
        """Reject the speculation entirely: restore the pre-fork table.
        COW replacement pages and grown pages are released; the originals
        (kept alive by the fork's refcounts) return to the table row. The
        fill front is untouched, so shared-prefix content is exactly as it
        was — speculative writes only ever landed in pages this fork owned
        privately."""
        f = self.forks.pop(rid)
        t = self.tables[rid]
        for b in reversed(f.grown):
            self._decref(b)
        for _, _, new in f.cow:
            self._decref(new)
        t.blocks = list(f.base_blocks)
        t.hashes = list(f.base_hashes)
        t.tokens = f.base_tokens

    def free(self, rid: int):
        """Release every reference (completion). Registered blocks stay
        resident as evictable cache; the rest return to the free list."""
        assert rid not in self.forks, \
            f"rid={rid}: free during an active fork (resolve it first)"
        t = self.tables.pop(rid)
        if not t.on_device:
            t.host_pages = None
            return
        for b in reversed(t.blocks):           # leaf-before-parent LRU aging
            self._decref(b)

    # -- preemption ----------------------------------------------------------
    def swap_out(self, rid: int) -> Optional[List[int]]:
        """Begin swap-out: returns the block ids whose pages the engine must
        gather to host, or None when the table holds shared (refcount > 1)
        pages — those victims degrade to recompute, exactly like the
        simulator's composition rule. The store releases the device blocks;
        the engine stores the gathered pages on the table record."""
        assert rid not in self.forks, \
            f"rid={rid}: swap_out during an active fork (abort it first)"
        t = self.tables[rid]
        assert t.on_device
        keep = self.blocks_for_tokens(t.tokens)
        kept, tail = t.blocks[:keep], t.blocks[keep:]
        if any(self.refcount.get(b, 1) > 1 for b in kept):
            return None
        # Unfilled tail blocks (chunked prefill reserves ahead of the fill
        # front) are simply released, not swapped — there is nothing of this
        # request's in them. A registered tail block someone else still
        # shares keeps its registration; a refcount-1 registered one parks
        # as evictable cache; the rest return to the free list. This runs
        # BEFORE the kept-block unregister walk so cascades see tail blocks
        # in their settled (cached) state.
        for b in reversed(tail):
            self._decref(b)
        t.hashes = t.hashes[:keep]
        for b in kept:
            for fb in self._unregister_subtree(b):
                self._free.append(fb)
                self.radix_evictions += 1
            self._decref(b)
        t.blocks = []
        t.hashes = []
        t.on_device = False
        self.swap_outs += 1
        return kept

    def swap_in(self, rid: int) -> Optional[List[int]]:
        """Allocate fresh device blocks for a swapped table. Returns the new
        block ids (the engine scatters ``host_pages`` into them) or None when
        the pool cannot hold the table yet."""
        t = self.tables[rid]
        assert not t.on_device
        n = self.blocks_for_tokens(t.tokens)
        if n > self.available_blocks:
            return None
        t.blocks = self._take(n)
        t.on_device = True
        self.swap_ins += 1
        return t.blocks

    def drop(self, rid: int):
        """Recompute preemption: discard the table entirely (pages are dead;
        the engine re-prefills from tokens on re-admission)."""
        self.free(rid)
        self.recompute_drops += 1

    # -- disaggregated handoff (export on prefill side, import on decode) ----
    def export_pages(self, rid: int) -> "PageExport":
        """Snapshot the FILLED portion of ``rid``'s table for a
        prefill->decode handoff: the physical block ids the engine must
        gather (in table order — position ``i`` covers tokens
        ``[i*bt, (i+1)*bt)``), the fill length, and the prompt hash chain
        the importing store dedups against. Mirrors the simulator's
        ``PagedKVAllocator.export_chain`` contract, minus the pin: the
        engine gathers the page payload synchronously before releasing the
        table, so nothing can reclaim the pages mid-export."""
        t = self.tables[rid]
        assert t.on_device, "cannot export a swapped table"
        assert rid not in self.forks, \
            f"rid={rid}: export during an active fork (resolve it first)"
        keep = self.blocks_for_tokens(t.tokens)
        self.exports += 1
        self.exported_blocks += keep
        return PageExport(rid=rid, blocks=list(t.blocks[:keep]),
                          tokens=t.tokens, chain=list(t.chain))

    def import_pages(self, rid: int, tokens: int,
                     chain: Sequence[int] = ()
                     ) -> Optional[Tuple[List[int], int]]:
        """Decode-side admission of an exported table: allocate
        ``blocks_for(tokens)`` pages, aliasing any resident chain prefix —
        the engine then scatters ONLY the unmatched pages' payload (matched
        pages already hold bit-identical content by the hash-chain
        contract: equal chains imply equal block-aligned token prefixes
        imply equal K/V). Returns ``(blocks, n_matched)`` or None when the
        pool cannot admit yet (head-of-line wait, like any admission).

        Matched blocks count as ``import_dedup_blocks`` — wire bytes the
        handoff never had to move — NOT as prefix-cache hits, mirroring the
        simulator's decode-side ``count_hits=False`` convention."""
        got = self.allocate(rid, tokens, chain, count_hits=False)
        if got is None:
            return None
        blocks, n_matched = got
        self.imports += 1
        self.imported_blocks += len(blocks) - n_matched
        self.import_dedup_blocks += n_matched
        return got

    # -- reporting -----------------------------------------------------------
    def check_invariants(self):
        from collections import Counter
        expect: Counter = Counter()
        for t in self.tables.values():
            if t.on_device:
                expect.update(t.blocks)
        for f in self.forks.values():
            # COW'd-out originals are held by the fork until commit/abort
            expect.update(old for _, old, _ in f.cow)
        assert dict(expect) == self.refcount, "refcount drift"
        live = sorted(expect)
        cached = sorted(self._cached)
        assert not set(live) & set(cached), "cached block is live"
        assert sorted(self._free + live + cached) == list(range(self.num_blocks)), \
            "block leak or double allocation"
        for b in self.by_block:
            assert b in expect or b in self._cached, \
                "radix entry points at a non-resident block"
        for rid in self.forks:
            assert rid in self.tables and self.tables[rid].on_device, \
                "fork outlived its table"
        for h, node in self.nodes.items():
            if node.parent is not None:
                assert self.nodes.get(node.parent.hash) is node.parent, \
                    "orphaned node"
                assert node.parent.children.get(h) is node, \
                    "parent lost child link"

    def stats(self) -> Dict[str, float]:
        return {
            "num_blocks": self.num_blocks,
            "block_tokens": self.block_tokens,
            "used_blocks": self.used_blocks,
            "free_blocks": self.free_blocks,
            "cached_blocks": self.cached_blocks,
            "peak_blocks": self.peak_blocks,
            "utilization": self.used_blocks / max(1, self.num_blocks),
            "page_faults": self.page_faults,
            "admission_failures": self.admission_failures,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "recompute_drops": self.recompute_drops,
            "radix_evictions": self.radix_evictions,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "block_refs_total": self.block_refs_total,
            "blocks_allocated_total": self.blocks_allocated_total,
            "dedup_ratio": (self.block_refs_total
                            / max(1, self.blocks_allocated_total)),
            "exports": self.exports,
            "exported_blocks": self.exported_blocks,
            "imports": self.imports,
            "imported_blocks": self.imported_blocks,
            "import_dedup_blocks": self.import_dedup_blocks,
        }
