"""Paged, tiered KV-cache subsystem (paper §III-D admission control +
§III-E3 multi-level retrieval, Eq. 1) with shared-prefix radix caching.

Three layers live here:

1. **Retrieval pricing (Eq. 1).** ``expected_retrieval_latency`` /
   ``sample_retrieval_latency`` evaluate the paper's recursive cache-lookup
   model over a ``CacheTierSpec`` chain:

       f(KV, C_n) = T_lookup_n + Hit_n * Size_KV / BW_n
                  + (1 - Hit_n) * f(KV, C_{n+1})

   Every *probed* tier charges its lookup latency — hit or miss — so the
   analytical expectation and the Monte-Carlo walk agree on the miss path
   (a probe must pay the directory lookup to learn it missed). A miss below
   the last level falls back to ``miss_cost`` — typically prefill
   recomputation (priced by the analytical model) or a DCN fetch.

2. **On-device allocation (``PagedKVAllocator``).** The same tier specs that
   parameterize Eq. 1 back the on-device allocator's spill hierarchy, so the
   analytical model and the discrete-event scheduler agree on bandwidths:

   * HBM is carved into fixed-size *blocks* of ``block_tokens`` KV slots;
     each request owns a *block table* (ordered list of physical block ids).
     Admission reserves whole blocks; decode growth faults in one block at a
     time; release returns blocks to a free list — O(1) each, no compaction.
   * When decode growth faults with an empty free list, a *preemption policy*
     makes room:
       - ``swap``      — the victim's pages move to the next tier down
                         (host DRAM → remote). The traffic is priced with the
                         tier term of Eq. 1 (``T_lookup + bytes / BW``) and,
                         at the coordinator, occupies ``Network`` links.
       - ``recompute`` — the victim's pages are dropped and its prefill
                         re-enqueued; cost resurfaces as recomputed prefill
                         FLOPs instead of wire bytes.
   * Internal fragmentation (allocated-but-unfilled token slots in each
     request's last block) is tracked and exported through ``stats()`` so
     routers can balance on real, fragmentation-aware KV pressure.

3. **Shared-prefix radix cache (``RadixBlockIndex``).** Physical blocks are
   *refcounted*; a hash chain over block-aligned prompt content maps prefixes
   to resident physical blocks, so

   * requests whose prompts share a block-aligned prefix map the *same*
     physical pages (paper §IV-A reasoning, RAG system-prompt/chunk reuse);
   * a multi-branch reasoning request ``fork``s its block table copy-on-write:
     branches share every prefill page and copy only the partial tail block
     on the first divergent decode write;
   * blocks whose refcount drops to zero stay resident as *cached* and are
     reclaimed leaf-first in LRU order only when the free list runs dry.

   The radix cache composes with the preemption policies above: ``swap_out``
   may only victimize tables whose pages all have refcount 1 (a shared page
   cannot move without stranding its other owners); shared victims degrade to
   ``recompute``, which merely drops references.

   Resident chains can also *migrate* between allocators (cross-client
   replica warming, paper §V-B remote KV retrieval): ``export_chain`` pins a
   source chain for the transfer window, ``import_chain`` materializes it at
   the destination as cached blocks through the same radix-registration
   rules (collision truncation, free-list-only capacity backpressure), and
   ``hot_chains`` enumerates a donor's hottest chains for push-mode warming.
   The coordinator prices the shipped bytes on ``Network`` links.
"""
from __future__ import annotations

import heapq
import itertools
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.perfmodel.hardware import CacheTierSpec


def expected_retrieval_latency(size_bytes: float,
                               tiers: Sequence[CacheTierSpec],
                               miss_cost: float) -> float:
    """Paper Eq. 1, evaluated recursively (expected value). Every probed
    tier charges its ``lookup_latency`` unconditionally — the same walk the
    Monte-Carlo ``sample_retrieval_latency`` takes — so the sampled mean
    converges to this expectation on workloads with deep miss chains."""
    if not tiers:
        return miss_cost
    t = tiers[0]
    return (t.lookup_latency + t.hit_rate * (size_bytes / t.bandwidth)
            + (1.0 - t.hit_rate) * expected_retrieval_latency(
                size_bytes, tiers[1:], miss_cost))


def sample_retrieval_latency(size_bytes: float, tiers: Sequence[CacheTierSpec],
                             miss_cost: float, rng: np.random.Generator) -> float:
    """Monte-Carlo variant for latency-CDF studies (paper Fig. 15)."""
    lat = 0.0
    for t in tiers:
        lat += t.lookup_latency
        if rng.random() < t.hit_rate:
            return lat + size_bytes / t.bandwidth
    return lat + miss_cost


def tier_transfer_time(nbytes: float, tier: CacheTierSpec,
                       granularity: str = "full",
                       n_layer_groups: int = 1) -> float:
    """One deterministic traversal of a tier boundary (Eq. 1 hit term).
    Used to price swap-out/swap-in; delegates to the spec so the allocator,
    the analytical model and the retrieval client share one formula.

    ``granularity="layerwise"`` prices a per-layer-group swap pipelined
    against layerwise compute, exactly like the disaggregated KV handoff
    (``Network._exposed``): the wire still carries all ``nbytes``, but the
    EXPOSED stall is one layer group of payload plus one lookup — the other
    groups overlap the consumer's layer-by-layer compute."""
    if granularity == "layerwise":
        return tier.transfer_time(nbytes / max(1, n_layer_groups))
    return tier.transfer_time(nbytes)


# ---------------------------------------------------------------------------
# tier accounting
# ---------------------------------------------------------------------------

DEVICE_TIER = 0   # block-table ``tier`` value for pages resident in HBM


@dataclass
class KVTierState:
    """Mutable byte accounting over one spill level (host DRAM, remote...)."""
    spec: CacheTierSpec
    used: float = 0.0
    peak: float = 0.0

    def has_room(self, nbytes: float) -> bool:
        return self.used + nbytes <= self.spec.capacity

    def reserve(self, nbytes: float):
        self.used += nbytes
        self.peak = max(self.peak, self.used)

    def release(self, nbytes: float):
        self.used = max(0.0, self.used - nbytes)


@dataclass
class BlockTable:
    """Per-request page map: which physical blocks hold this request's KV.
    ``hashes[i]`` (when present) is the radix-registered content hash of
    ``blocks[i]`` — only full, block-aligned prompt-prefix blocks register."""
    rid: object
    blocks: List[int] = field(default_factory=list)
    tokens: int = 0            # KV token slots actually filled
    tier: int = DEVICE_TIER    # DEVICE_TIER, or 1-based index into spill tiers
    hashes: List[int] = field(default_factory=list)

    @property
    def on_device(self) -> bool:
        return self.tier == DEVICE_TIER


# ---------------------------------------------------------------------------
# radix prefix index
# ---------------------------------------------------------------------------

class _RadixNode:
    __slots__ = ("hash", "block", "parent", "children", "is_root")

    def __init__(self, h: int, block: int, parent: Optional["_RadixNode"],
                 is_root: bool = False):
        self.hash = h
        self.block = block
        # direct object links, never hashes: a chain hash can resurface as a
        # *new* node after swap-out/swap-in, and hash-keyed parent accounting
        # would then corrupt the recreated node's child count
        self.parent = parent
        self.children: Dict[int, "_RadixNode"] = {}
        # registered with parent_hash=None, i.e. a chain's first block — the
        # key the fleet-level prefix inverted index tracks. Distinct from
        # ``parent is None``: a node whose parent hash was simply absent at
        # insert (resurfaced interior) is NOT a root.
        self.is_root = is_root


class RadixBlockIndex:
    """Block-granular radix cache: a chain of content hashes (each chained
    over its parent, so equal chains imply equal block-aligned prefixes) maps
    to resident physical blocks. Blocks with refcount 0 stay resident as
    *cached* entries and are evicted leaf-first in LRU order.

    Reclaim is O(log n) amortized: instead of rescanning the cached-LRU head
    for a leaf on every eviction (O(cached²) bulk reclaim), a dedicated
    evictable-leaf heap holds (release-seq, block) candidates. Entries go
    stale lazily — when a cached block gains a registered child, or is
    re-acquired — and are validated at pop; a parent is (re)pushed under its
    original release seq when its last registered child unregisters, so the
    eviction *order* is identical to the old head-scan."""

    def __init__(self):
        self.nodes: Dict[int, _RadixNode] = {}
        self.by_block: Dict[int, int] = {}       # block id -> hash
        self._cached: Dict[int, int] = {}        # rc-0 resident block -> seq
        self._leaf_heap: List[Tuple[int, int]] = []   # (seq, block) candidates
        self._seq = itertools.count()
        # fleet-index hook: called with (hash, added) when a chain-ROOT node
        # registers/unregisters, so a fleet-level hash->clients inverted
        # index can track which clients could serve a prefix hit
        self.on_root_change: Optional[Callable[[int, bool], None]] = None

    # -- lookup ------------------------------------------------------------
    def match(self, chain: Sequence[int]) -> List[int]:
        """Longest resident prefix: physical blocks for the leading hashes."""
        out: List[int] = []
        for h in chain:
            node = self.nodes.get(h)
            if node is None:
                break
            out.append(node.block)
        return out

    # -- registration ------------------------------------------------------
    def insert(self, h: int, block: int, parent_hash: Optional[int]) -> bool:
        """Register a freshly-filled block under its chain hash. A collision
        (the hash resurfacing after a partial unregister) keeps the existing
        entry and leaves the new block private."""
        if h in self.nodes:
            return False
        parent = self.nodes.get(parent_hash) if parent_hash is not None else None
        node = _RadixNode(h, block, parent, is_root=parent_hash is None)
        self.nodes[h] = node
        self.by_block[block] = h
        if parent is not None:
            parent.children[h] = node
        if node.is_root and self.on_root_change is not None:
            self.on_root_change(h, True)
        return True

    def holds_block(self, block: int) -> bool:
        return block in self.by_block

    def unregister(self, block: int):
        """Drop a block's entry (its content is leaving the device). Unlinks
        from the exact parent *object* linked at insert, so a parent hash
        resurfacing under a new node is never touched. A cached parent whose
        last registered child leaves is promoted into the evictable-leaf
        heap under its original release seq."""
        h = self.by_block.pop(block, None)
        if h is None:
            return
        node = self.nodes.pop(h)
        self._cached.pop(block, None)
        if node.is_root and self.on_root_change is not None:
            self.on_root_change(h, False)
        parent = node.parent
        if parent is not None:
            parent.children.pop(h, None)
            if not parent.children:
                seq = self._cached.get(parent.block)
                if seq is not None:
                    heapq.heappush(self._leaf_heap, (seq, parent.block))

    def unregister_subtree(self, block: int) -> List[int]:
        """Unregister a block's node *and every registered descendant* (the
        swap-out path: when a chain's interior leaves the device, cached
        descendants must not survive as orphans). Returns the descendant
        blocks that were cached (refcount 0) — they lost their only reason to
        stay resident and the caller must return them to the free list.
        Non-cached descendants belong to the departing table itself (any
        other live owner would hold the whole prefix, contradicting the
        caller's refcount-1 precondition) and are merely unregistered."""
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
        self.unregister(block)
        return freed

    # -- refcount transitions ---------------------------------------------
    def acquire(self, block: int):
        """Block went refcount 0 -> 1: it is live again, not evictable."""
        self._cached.pop(block, None)      # heap entry goes stale

    def release(self, block: int):
        """Registered block went refcount 1 -> 0: keep resident as cached."""
        seq = next(self._seq)              # (re)release = most recently used
        self._cached[block] = seq
        if not self.nodes[self.by_block[block]].children:
            heapq.heappush(self._leaf_heap, (seq, block))

    def peek_seq(self, block: int) -> Optional[int]:
        """Current cached-LRU seq of a block (None when live/unregistered)."""
        return self._cached.get(block)

    def restore_seq(self, block: int, seq: int):
        """Roll back a transient ``acquire`` (failed admission): re-cache the
        block under its ORIGINAL recency seq, so a stream of rejected
        admissions cannot keep a prefix artificially hot and perturb the
        eviction order vs. a trace where they never arrived. Re-pushing the
        (seq, block) heap entry may duplicate one already present — stale
        duplicates are skipped at pop, so this is harmless."""
        self._cached[block] = seq
        if not self.nodes[self.by_block[block]].children:
            heapq.heappush(self._leaf_heap, (seq, block))

    # -- eviction ----------------------------------------------------------
    def cached_count(self) -> int:
        return len(self._cached)

    def evict_one(self) -> Optional[int]:
        """Evict the LRU cached *leaf* (a node with registered children may
        not go before them, so chains never get holes). Returns the freed
        physical block id, or None when nothing is evictable. O(log n)
        amortized: pops stale heap entries (re-acquired, re-released under a
        newer seq, or currently interior) until a live leaf surfaces."""
        while self._leaf_heap:
            seq, block = heapq.heappop(self._leaf_heap)
            if self._cached.get(block) != seq:
                continue                   # re-acquired or re-released since
            if self.nodes[self.by_block[block]].children:
                continue                   # gained a child; repushed on unlink
            self.unregister(block)
            return block
        return None


# ---------------------------------------------------------------------------
# paged allocator
# ---------------------------------------------------------------------------

class PagedKVAllocator:
    """Fixed-size-block KV allocator over an HBM pool with spill tiers and a
    shared-prefix radix cache.

    All admission/growth/release in ``LLMScheduler`` goes through this; the
    free list + refcounts are the single source of truth for device KV
    occupancy. Physical blocks are refcounted so block tables may alias:
    prefix-sharing admissions and copy-on-write ``fork``s reference the same
    pages instead of duplicating them.
    """

    def __init__(self, capacity_bytes: float, bytes_per_token: float,
                 block_tokens: int = 32,
                 swap_tiers: Sequence[CacheTierSpec] = ()):
        assert block_tokens >= 1
        self.block_tokens = int(block_tokens)
        self.bytes_per_token = float(bytes_per_token)
        self.block_bytes = self.block_tokens * self.bytes_per_token
        self.num_blocks = max(1, int(capacity_bytes // max(self.block_bytes, 1.0)))
        self.capacity = self.num_blocks * self.block_bytes
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.tables: Dict[object, BlockTable] = {}
        self.tiers: List[KVTierState] = [KVTierState(s) for s in swap_tiers]
        self.refcount: Dict[int, int] = {}
        self.radix = RadixBlockIndex()
        # overcommit escape hatch: requests larger than the whole pool get
        # "overflow" blocks with ids >= num_blocks (counted, never recycled
        # into the free list) so the simulation stays live and the pressure
        # is visible as utilization > 1 instead of a hard failure
        self._next_overflow_id = self.num_blocks
        self._overflow_live = 0
        self.overcommitted_blocks = 0  # cumulative
        # counters (surfaced via stats() -> MetricsCollector)
        self.page_faults = 0           # growth attempts that found no free block
        self.admission_failures = 0
        self.evictions = 0             # swap-out events
        self.swap_ins = 0
        self.swap_bytes_out = 0.0
        self.swap_bytes_in = 0.0
        self.recompute_drops = 0
        self.peak_blocks = 0
        # prefix-sharing counters
        self.prefix_hit_tokens = 0     # prompt tokens served from the radix cache
        self.prefix_hit_blocks = 0
        self.cow_forks = 0             # fork() events (branch table splits)
        self.cow_copied_blocks = 0     # partial tail blocks copied on write
        self.radix_evictions = 0       # cached blocks reclaimed for allocation
        self.block_refs_total = 0      # logical block references ever created
        self.blocks_allocated_total = 0  # physical blocks ever taken
        self._n_shared = 0             # blocks with refcount > 1, now
        self.shared_blocks_peak = 0
        self.prefix_tokens_seen = 0    # prefix-eligible prompt tokens admitted
        # cross-client prefix migration (export pins resident source chains
        # for the transfer window; import materializes them as cached blocks)
        self._exports: Dict[int, List[int]] = {}  # handle -> pinned blocks
        self._export_seq = itertools.count()
        self._migrated_in: set = set()  # resident blocks created by import
        self.migrated_out_blocks = 0
        self.migrated_in_blocks = 0
        self.migration_refused_blocks = 0  # import backpressure + collisions
        self.migration_hit_tokens = 0  # prompt tokens served off migrated pages

    # -- capacity queries ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Resident refcount-0 blocks retained by the radix cache."""
        return self.radix.cached_count()

    @property
    def available_blocks(self) -> int:
        """Immediately allocatable: free list + evictable cached blocks."""
        return len(self._free) + self.radix.cached_count()

    @property
    def used_blocks(self) -> int:
        """Blocks referenced by at least one live table (cached excluded)."""
        return (self.num_blocks - len(self._free) - self.radix.cached_count()
                + self._overflow_live)

    @property
    def used(self) -> float:
        """Device bytes held (block-granular, fragmentation included)."""
        return self.used_blocks * self.block_bytes

    def blocks_for_tokens(self, tokens: int) -> int:
        return max(0, -(-int(tokens) // self.block_tokens))

    def can_allocate(self, tokens: int) -> bool:
        return self.blocks_for_tokens(tokens) <= self.available_blocks

    def fragmentation_bytes(self) -> float:
        """Allocated-but-unfilled token slots across resident block tables."""
        slack = 0.0
        for t in self.tables.values():
            if t.on_device:
                slack += len(t.blocks) * self.block_tokens - t.tokens
        return slack * self.bytes_per_token

    def _return_free(self, b: int):
        """Single exit back to the free list: a recycled block id sheds its
        migrated-in identity so a later unrelated occupant cannot count
        migration hits."""
        self._migrated_in.discard(b)
        self._free.append(b)

    # -- refcount plumbing ---------------------------------------------------
    def _incref(self, b: int):
        rc = self.refcount.get(b, 0) + 1
        self.refcount[b] = rc
        self.block_refs_total += 1
        if rc == 1:
            self.radix.acquire(b)          # cached -> live
        elif rc == 2:
            self._n_shared += 1
            self.shared_blocks_peak = max(self.shared_blocks_peak,
                                          self._n_shared)

    def _decref(self, b: int) -> bool:
        """Drop one reference. Returns True when the block returned to the
        free list (registered blocks stay resident as cached instead)."""
        rc = self.refcount[b] - 1
        if rc > 0:
            self.refcount[b] = rc
            if rc == 1:
                self._n_shared -= 1
            return False
        del self.refcount[b]
        if b >= self.num_blocks:           # overflow ids retire, never recycle
            self._overflow_live -= 1
            return False
        if self.radix.holds_block(b):
            self.radix.release(b)          # live -> cached, evictable LRU
            return False
        self._return_free(b)
        return True

    def _unref_matched(self, b: int, orig_seq: Optional[int]):
        """Failed-admission rollback of one matched-block ``_incref``. A
        block that was *cached* before the attempt returns to the cache under
        its ORIGINAL recency seq (``restore_seq``): a rejected admission must
        not refresh LRU order. Blocks that were live keep the plain decref."""
        if orig_seq is not None and self.refcount.get(b) == 1:
            del self.refcount[b]
            self.radix.restore_seq(b, orig_seq)
            return
        self._decref(b)

    # -- allocation / growth / release --------------------------------------
    def _reclaim(self, n: int):
        """Evict cached radix blocks (LRU, leaf-first) until the free list
        holds ``n`` blocks or nothing cached remains evictable."""
        while len(self._free) < n:
            b = self.radix.evict_one()
            if b is None:
                break
            self._return_free(b)
            self.radix_evictions += 1

    def _take(self, n: int, force: bool = False) -> List[int]:
        self._reclaim(n)
        real = min(n, len(self._free))
        got = [self._free.pop() for _ in range(real)]
        if n > real:
            assert force
            got.extend(range(self._next_overflow_id,
                             self._next_overflow_id + n - real))
            self._next_overflow_id += n - real
            self._overflow_live += n - real
            self.overcommitted_blocks += n - real
        for b in got:
            self._incref(b)
        self.blocks_allocated_total += len(got)
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        return got

    def peek_prefix_tokens(self, prefix_hashes: Sequence[int]) -> int:
        """Tokens of the chain currently resident (read-only lookup)."""
        if not prefix_hashes:
            return 0
        return len(self.radix.match(prefix_hashes)) * self.block_tokens

    def allocate(self, rid, tokens: int, prefix_hashes: Sequence[int] = (),
                 force: bool = False, count_hits: bool = True) -> bool:
        """Whole-context admission (prefill): reserve ceil(tokens/B) blocks.
        Blocks whose chain hash is resident in the radix cache are *shared*
        (refcount bump, no new page); the rest come off the free list and the
        full prompt-prefix ones register for future admissions to hit.
        ``force`` overcommits instead of failing (requests bigger than the
        entire pool — the caller decides, normal backpressure stays intact).
        ``count_hits=False`` still dedups pages but leaves the prefix-hit
        counters alone (disaggregated decode admission: the same tokens were
        already counted as hits at the prefill client, and the decode-side
        saving is reported as ``kv_transfer_dedup_bytes`` instead).

        Modeling note: blocks register at admission, before the prefill that
        fills them completes, so an immediately-following same-prefix request
        hits in-flight KV (SGLang-style cache-aware scheduling). Real radix
        caches that gate on computed blocks would hit one step later."""
        assert rid not in self.tables, f"double allocation for rid={rid}"
        need_total = self.blocks_for_tokens(tokens)
        matched: List[int] = []
        if prefix_hashes:
            matched = self.radix.match(prefix_hashes)[:need_total]
        need_new = need_total - len(matched)
        # revive matched blocks first: cached ones leave the evictable pool,
        # so the availability check must see the post-match state
        shared_peak0 = self.shared_blocks_peak
        orig_seqs = {b: s for b in matched
                     for s in (self.radix.peek_seq(b),) if s is not None}
        for b in matched:
            self._incref(b)
        if need_new > self.available_blocks and not force:
            for b in matched:
                self._unref_matched(b, orig_seqs.get(b))
            # admission never happened: no logical refs, no sharing peak,
            # and previously-cached blocks keep their original LRU seq
            self.block_refs_total -= len(matched)
            self.shared_blocks_peak = shared_peak0
            self.admission_failures += 1
            return False
        blocks = matched + self._take(need_new, force)
        t = BlockTable(rid, blocks, int(tokens))
        # register the newly-filled full prefix blocks so later admissions hit
        n_reg = min(len(prefix_hashes), need_total)
        for i in range(len(matched), n_reg):
            if blocks[i] >= self.num_blocks:   # never cache overflow pages
                n_reg = i
                break
            if not self.radix.insert(prefix_hashes[i], blocks[i],
                                     prefix_hashes[i - 1] if i else None):
                n_reg = i                      # collision: chain ends here
                break
        t.hashes = list(prefix_hashes[:n_reg])
        self.tables[rid] = t
        if prefix_hashes and count_hits:
            # prefix-eligible tokens this admission presented: the hit-rate
            # denominator (kv_prefix_hit_tokens / kv_prefix_tokens_seen)
            self.prefix_tokens_seen += min(int(tokens),
                                           len(prefix_hashes) * self.block_tokens)
        if matched and count_hits:
            self.prefix_hit_blocks += len(matched)
            self.prefix_hit_tokens += min(int(tokens),
                                          len(matched) * self.block_tokens)
            mig = sum(1 for b in matched if b in self._migrated_in)
            if mig:
                self.migration_hit_tokens += min(int(tokens),
                                                 mig * self.block_tokens)
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)
        return True

    def fork(self, parent_rid, child_rid) -> None:
        """Copy-on-write fork: the child shares every one of the parent's
        pages (refcount bump, zero new blocks). Divergent decode writes copy
        only the partial tail block — see ``grow_request``."""
        pt = self.tables[parent_rid]
        assert pt.on_device, f"forking swapped-out rid={parent_rid}"
        assert child_rid not in self.tables
        for b in pt.blocks:
            self._incref(b)
        ct = BlockTable(child_rid, list(pt.blocks), pt.tokens,
                        hashes=list(pt.hashes))
        self.tables[child_rid] = ct
        self.cow_forks += 1

    def _append_need(self, t: BlockTable, n: int) -> Tuple[int, int]:
        """(new blocks, COW copies) required to append ``n`` token slots."""
        need = self.blocks_for_tokens(t.tokens + n) - len(t.blocks)
        if need < 0:
            need = 0
        cow = 1 if (t.blocks
                    and self.refcount.get(t.blocks[-1], 1) > 1
                    and len(t.blocks) * self.block_tokens > t.tokens) else 0
        return need, cow

    def grow_request(self, rids: Sequence, n: int = 1,
                     force: bool = False) -> bool:
        """Decode growth across one request's tables (the main table plus any
        forked branch tables), appending ``n`` token slots to each. Writing
        into a *shared* partial tail block first copies it (copy-on-write) so
        siblings keep the pre-divergence content. Capacity is checked for the
        whole group up front; on exhaustion nothing is touched, a page fault
        is counted, and the caller resolves it through its preemption policy,
        falling back to ``force`` when no victim exists."""
        tabs = [self.tables[r] for r in rids]
        for t in tabs:
            assert t.on_device, f"growing swapped-out rid={t.rid}"
        if len(tabs) == 1:
            # single-table fast path (the overwhelmingly common decode case):
            # no sibling COW accounting, no Counter
            t = tabs[0]
            need, cow = self._append_need(t, n)
            if not cow:
                if need > self.available_blocks and not force:
                    self.page_faults += 1
                    return False
                if need:
                    t.blocks.extend(self._take(need, force))
                t.tokens += n
                return True
        total = sum(self._append_need(t, n)[0] for t in tabs)
        # COW copies: siblings in this group sharing one tail block need
        # m - 1 copies (the last keeps the original) — m only if someone
        # outside the group also references it
        tails: Counter = Counter(t.blocks[-1] for t in tabs
                                 if self._append_need(t, n)[1])
        for b, m in tails.items():
            total += m if self.refcount[b] > m else m - 1
        if total > self.available_blocks and not force:
            self.page_faults += 1
            return False
        for t in tabs:
            # re-derive per-table: an earlier COW in this group may have
            # dropped the shared tail's refcount to 1 (last sibling keeps it)
            need, cow = self._append_need(t, n)
            if cow:
                old = t.blocks[-1]
                (new,) = self._take(1, force)
                t.blocks[-1] = new
                self._decref(old)
                self.cow_copied_blocks += 1
            if need > 0:
                t.blocks.extend(self._take(need, force))
            t.tokens += n
        return True

    def append_tokens(self, rid, n: int = 1, force: bool = False) -> bool:
        """Decode growth for a single table: extend by ``n`` token slots,
        faulting in new blocks as needed. Returns False (and counts a page
        fault) on exhaustion."""
        return self.grow_request([rid], n, force)

    # -- fast-forward capacity planning --------------------------------------
    def shared_partial_tail(self, rid) -> bool:
        """True when the table's last block is shared *and* partially filled,
        so the next append would copy-on-write it."""
        t = self.tables[rid]
        return bool(t.blocks) and self.refcount.get(t.blocks[-1], 1) > 1 \
            and len(t.blocks) * self.block_tokens > t.tokens

    def max_growth_steps(self, groups: Sequence[Tuple[Sequence, int]],
                         k_max: int) -> int:
        """Largest ``K <= k_max`` such that ``K`` growth steps — each step
        appending ``g`` token slots to every table in ``rids`` for every
        ``(rids, g)`` group — fit in the free list alone: no radix eviction,
        no preemption, no overcommit. The decode fast-forward window uses
        this as its block-boundary-pressure bound; because nothing but the
        free list is touched, committing the window in bulk is counter-exact
        with committing it one step at a time. Callers must have ruled out
        copy-on-write tails (``shared_partial_tail``)."""
        free = len(self._free)
        B = self.block_tokens
        slacks = [(len(t.blocks) * B - t.tokens, g)
                  for rids, g in groups for t in (self.tables[r] for r in rids)]

        def need(k: int) -> int:
            total = 0
            for slack, g in slacks:
                grow = k * g - slack
                if grow > 0:
                    total += -(-grow // B)
                    if total > free:
                        break
            return total

        if need(k_max) <= free:
            return k_max
        lo, hi = 0, k_max          # invariant: need(lo) <= free < need(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if need(mid) <= free:
                lo = mid
            else:
                hi = mid
        return lo

    def free(self, rid) -> int:
        """Release every reference of a request (completion/drop). Returns
        the number of device blocks returned to the free list; shared blocks
        survive under their other owners and radix-registered blocks stay
        resident as evictable cache."""
        t = self.tables.pop(rid, None)
        if t is None:
            return 0
        if t.on_device:
            freed = 0
            # deepest-first so cached chains age leaf-before-parent in LRU
            for b in reversed(t.blocks):
                if self._decref(b):
                    freed += 1
            return freed
        self.tiers[t.tier - 1].release(len(t.blocks) * self.block_bytes)
        return 0

    def holds(self, rid) -> bool:
        return rid in self.tables

    # -- preemption: swap ----------------------------------------------------
    def swap_out(self, rid, granularity: str = "full",
                 n_layer_groups: int = 1) -> Optional[Tuple[float, float]]:
        """Offload a resident request's pages to the first spill tier with
        room. Returns (bytes_moved, transfer_time) or None when no tier can
        take them (caller falls back to recompute) — or when any page is
        shared (refcount > 1): a shared page cannot move without stranding
        its other owners, so shared victims degrade to recompute.

        ``granularity="layerwise"`` moves the table one layer group at a
        time, overlapped with compute (``SchedulerLimits.swap_granularity``)
        — bytes_moved is unchanged, transfer_time is the exposed stall of
        ~one of ``n_layer_groups`` groups, the same §III-B2 pricing the
        disaggregated handoff uses."""
        t = self.tables[rid]
        assert t.on_device
        if len(t.blocks) > self.num_blocks:
            return None   # could never swap back in; caller recomputes
        if any(self.refcount.get(b, 1) > 1 for b in t.blocks):
            return None   # refcount-1 pages only (radix/fork sharing intact)
        nbytes = len(t.blocks) * self.block_bytes
        for i, tier in enumerate(self.tiers, start=1):
            if tier.has_room(nbytes):
                tier.reserve(nbytes)
                for b in t.blocks:
                    # content leaves the device; cascade so cached descendant
                    # chains cannot survive as orphans under a parent hash
                    # that may later resurface as a different node
                    for fb in self.radix.unregister_subtree(b):
                        self._return_free(fb)
                        self.radix_evictions += 1
                    self._decref(b)
                t.blocks = [-1] * len(t.blocks)   # physical ids are tier-side
                t.tier = i                     # hashes kept: swap_in restores
                self.evictions += 1
                self.swap_bytes_out += nbytes
                return nbytes, tier_transfer_time(nbytes, tier.spec,
                                                  granularity, n_layer_groups)
        return None

    def swap_in(self, rid, granularity: str = "full",
                n_layer_groups: int = 1) -> Optional[Tuple[float, float]]:
        """Bring a swapped request's pages back to HBM. Returns
        (bytes_moved, transfer_time) or None when HBM lacks free blocks.
        ``granularity`` prices the stall exactly like ``swap_out``."""
        t = self.tables[rid]
        assert not t.on_device
        n = len(t.blocks)
        if n > self.available_blocks:
            return None
        tier = self.tiers[t.tier - 1]
        nbytes = n * self.block_bytes
        tier.release(nbytes)
        t.blocks = self._take(n)
        # swap-in resumes existing logical references — it must not dilute
        # dedup_ratio (block_refs_total / blocks_allocated_total) under
        # preemption churn, so back out _take's counter bumps
        self.block_refs_total -= n
        self.blocks_allocated_total -= n
        t.tier = DEVICE_TIER
        # the prefix content is back on device: re-register its chain so
        # future admissions hit again (a collision — the chain resurfaced
        # under another block while we were away — truncates ours there)
        for i, h in enumerate(t.hashes):
            if not self.radix.insert(h, t.blocks[i],
                                     t.hashes[i - 1] if i else None):
                t.hashes = t.hashes[:i]
                break
        self.swap_ins += 1
        self.swap_bytes_in += nbytes
        return nbytes, tier_transfer_time(nbytes, tier.spec,
                                          granularity, n_layer_groups)

    # -- cross-client prefix migration ---------------------------------------
    def export_chain(self, prefix_hashes: Sequence[int], skip: int = 0,
                     max_blocks: Optional[int] = None
                     ) -> Optional[Tuple[int, int, float]]:
        """Pin the resident prefix chain for an outbound migration. The
        pinned blocks (chain positions ``skip`` onward — the part the
        destination does not already hold) take one extra reference for the
        transfer window, so neither radix eviction nor swap-out can move
        their content off-device while it is on the wire. Returns
        ``(handle, n_resident, nbytes)`` — the caller ships
        ``prefix_hashes[:n_resident]`` and ``nbytes`` of KV pages, then
        releases the pin with ``release_export(handle)`` when the transfer
        lands. None when nothing past ``skip`` is resident."""
        matched = self.radix.match(prefix_hashes)
        if max_blocks is not None:
            matched = matched[:skip + max_blocks]
        ship = matched[skip:]
        if not ship:
            return None
        for b in ship:
            self._incref(b)
        # a transfer pin is not a logical reference (dedup_ratio stays
        # comparable with migration off), but it DOES count as sharing for
        # the window: a pinned live page genuinely has two holders, and the
        # refcount>1 rule is exactly what keeps swap_out off it mid-transfer
        self.block_refs_total -= len(ship)
        handle = next(self._export_seq)
        self._exports[handle] = list(ship)
        self.migrated_out_blocks += len(ship)
        return handle, len(matched), len(ship) * self.block_bytes

    def release_export(self, handle: int):
        """Unpin an outbound migration's source pages (transfer landed or
        aborted). Previously-cached blocks re-enter the evictable LRU as
        most-recently-used — the transfer just read them. A handle already
        discarded by ``discard_exports`` (source failure) is a no-op."""
        for b in self._exports.pop(handle, ()):
            self._decref(b)

    def discard_exports(self):
        """Device KV died (client failure/teardown): drop every in-flight
        outbound pin so the pinned content cannot outlive the failure as
        resident cache. Callers follow with ``clear_cache`` — the unpinned
        blocks land there as cached and are purged with everything else;
        the in-flight transfer itself still completes at the destination
        (the bytes were already on the wire)."""
        for handle in list(self._exports):
            self.release_export(handle)

    def import_chain(self, prefix_hashes: Sequence[int]) -> Tuple[int, int]:
        """Materialize a migrated chain as resident *cached* (refcount-0)
        radix blocks, extending whatever prefix of it is already resident.
        Future same-prefix admissions map these pages exactly like locally
        produced ones. Two hard rules:

        * **capacity backpressure** — imports draw on the free list alone:
          a migrated copy never evicts resident cache, preempts a live
          table or overcommits. Blocks that do not fit are refused (the
          leading — most widely shared — part of the chain lands first).
        * **collision truncation** — a chain hash already registered under
          another block ends the import there, exactly like admission-time
          registration (``allocate``) and ``swap_in`` re-registration.

        Returns ``(imported, refused)`` block counts. Imported blocks are
        tracked so later admission hits on them surface as
        ``migration_hit_tokens`` (the fetch actually saved recompute);
        ``blocks_allocated_total`` is deliberately NOT bumped — a migrated
        page is a physical copy of existing content, not logical demand, so
        dedup_ratio stays comparable with migration on or off."""
        matched = self.radix.match(prefix_hashes)
        j = len(matched)
        imported = 0
        for i in range(j, len(prefix_hashes)):
            if not self._free:
                break                      # backpressure: free blocks only
            b = self._free.pop()
            if not self.radix.insert(prefix_hashes[i], b,
                                     prefix_hashes[i - 1] if i else None):
                self._return_free(b)       # collision: chain truncates here
                break
            self.radix.release(b)          # resident as cached, MRU
            self._migrated_in.add(b)
            imported += 1
        refused = max(0, len(prefix_hashes) - j - imported)
        self.migrated_in_blocks += imported
        self.migration_refused_blocks += refused
        return imported, refused

    def hot_chains(self, max_blocks: int) -> List[List[int]]:
        """Root-to-leaf hash chains over the registered radix content,
        hottest leaf first (live leaves, then cached leaves by descending
        recency), truncated to a total budget of ``max_blocks`` distinct
        blocks — the donor side of push-mode replica warming. Chains may
        share prefixes; the budget counts each block once, and a chain that
        overflows it is cut to a (still valid) prefix."""
        idx = self.radix
        leaves = [n for n in idx.nodes.values() if not n.children]

        def hotness(n: _RadixNode):
            s = idx._cached.get(n.block)
            return (0, 0) if s is None else (1, -s)

        leaves.sort(key=hotness)
        chains: List[List[int]] = []
        seen: set = set()
        budget = max_blocks
        for leaf in leaves:
            if budget <= 0:
                break
            chain: List[int] = []
            node: Optional[_RadixNode] = leaf
            while node is not None:
                chain.append(node.hash)
                node = node.parent
            chain.reverse()
            # unseen hashes form a suffix (shared parts are prefixes)
            new = sum(1 for h in chain if h not in seen)
            if new == 0:
                continue
            if new > budget:
                chain = chain[:len(chain) - (new - budget)]
                new = sum(1 for h in chain if h not in seen)
                if new == 0:
                    continue
            seen.update(chain)
            budget -= new
            chains.append(chain)
        return chains

    def clear_cache(self) -> int:
        """Purge every cached (refcount-0) radix block back to the free list
        — client failure/teardown semantics, where device KV is lost."""
        n = 0
        while True:
            b = self.radix.evict_one()
            if b is None:
                break
            self._return_free(b)
            n += 1
        return n

    # -- preemption: recompute ----------------------------------------------
    def drop(self, rid) -> int:
        """Discard a request's references entirely (recompute preemption)."""
        released = self.free(rid)
        self.recompute_drops += 1
        return released

    # -- reporting -----------------------------------------------------------
    def check_invariants(self):
        """Refcounts must equal the number of tables referencing each block;
        free list, live blocks and cached radix blocks must partition
        [0, num_blocks); live overflow ids must match the overflow counter."""
        expect: Counter = Counter()
        for t in self.tables.values():
            if t.on_device:
                expect.update(t.blocks)
        for pinned in self._exports.values():   # outbound-migration pins
            expect.update(pinned)
        assert dict(expect) == self.refcount, "refcount drift"
        live = sorted(b for b in expect if b < self.num_blocks)
        cached = sorted(self.radix._cached)
        assert not set(live) & set(cached), "cached block is live"
        assert sorted(self._free + live + cached) == list(range(self.num_blocks)), \
            "block leak or double allocation"
        overflow = sum(1 for b in expect if b >= self.num_blocks)
        assert overflow == self._overflow_live, "overflow accounting drift"
        for b in self.radix.by_block:
            assert b < self.num_blocks and (b in expect or b in self.radix._cached), \
                "radix entry points at a non-resident block"
        assert self._migrated_in <= set(self.radix.by_block), \
            "migrated-in set holds a non-resident block"
        for h, node in self.radix.nodes.items():
            for ch, cnode in node.children.items():
                assert self.radix.nodes.get(ch) is cnode, \
                    "child link to an unregistered node"
            if node.parent is not None:
                # cascade-unregister guarantees no orphans: a registered
                # node's parent is the *same object* still registered
                assert self.radix.nodes.get(node.parent.hash) is node.parent, \
                    "orphaned node (parent left the index)"
                assert node.parent.children.get(h) is node, \
                    "registered parent lost its child link"
        shared = sum(1 for rc in self.refcount.values() if rc > 1)
        assert shared == self._n_shared, "shared-block counter drift"

    def stats(self) -> Dict[str, float]:
        return {
            "num_blocks": self.num_blocks,
            "used_blocks": self.used_blocks,
            "free_blocks": self.free_blocks,
            "cached_blocks": self.cached_blocks,
            "peak_blocks": self.peak_blocks,
            "block_tokens": self.block_tokens,
            "utilization": self.used_blocks / max(1, self.num_blocks),
            "fragmentation_bytes": self.fragmentation_bytes(),
            "page_faults": self.page_faults,
            "admission_failures": self.admission_failures,
            "evictions": self.evictions,
            "swap_ins": self.swap_ins,
            "swap_bytes_out": self.swap_bytes_out,
            "swap_bytes_in": self.swap_bytes_in,
            "recompute_drops": self.recompute_drops,
            "overflow_blocks": self._overflow_live,
            "overcommitted_blocks": self.overcommitted_blocks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "prefix_tokens_seen": self.prefix_tokens_seen,
            "migrated_out_blocks": self.migrated_out_blocks,
            "migrated_in_blocks": self.migrated_in_blocks,
            "migration_refused_blocks": self.migration_refused_blocks,
            "migration_hit_tokens": self.migration_hit_tokens,
            "cow_forks": self.cow_forks,
            "cow_copied_blocks": self.cow_copied_blocks,
            "radix_evictions": self.radix_evictions,
            "shared_blocks": self.shared_blocks_peak,
            "block_refs_total": self.block_refs_total,
            "blocks_allocated_total": self.blocks_allocated_total,
            "dedup_ratio": (self.block_refs_total
                            / max(1, self.blocks_allocated_total)),
            "tier_used_bytes": {t.spec.name: t.used for t in self.tiers},
        }
