"""Fleet-scale routing indexes (ROADMAP item 4 groundwork).

At 100s-1000s of clients the hot per-request path must stop scanning the
fleet: ``Coordinator._dispatch`` rebuilt the candidate list with a linear
scan over every client, ``LoadBasedRouter`` ran an O(N) ``min()`` over
``Client.load``, and ``PrefixAffinityRouter`` probed every candidate's radix
cache per request. ``FleetIndex`` replaces those scans with incrementally
maintained structures:

* **stage -> members** (``StageMembers``): one insertion-ordered member map
  per stage kind (and per ``(stage, group)`` for local disaggregation),
  updated on CLIENT_ADD/REMOVE/FAIL/RECOVER instead of rebuilt per request.
* **incremental load index** (``LoadIndex``): a lazy-deletion min-heap over
  ``Client.load(metric, now)`` per (stage, metric), following the
  ``WaitQueue`` discipline — entries go stale when the coordinator touches a
  client and are re-validated at pop.
* **root-hash inverted index**: chain-root content hash -> client names,
  fed by ``RadixBlockIndex`` root registration events, so prefix-affinity
  routing probes only clients that can possibly hit.

The hard contract is **decision identity**: with the index on
(``CoordinatorConfig.fleet_index``, default) every router must choose the
same client for every request as the linear-scan baseline, tie-breaks
included. Three invariants carry that:

1. *Iteration order.* ``StageMembers`` preserves the baseline candidate
   order — ``self.clients`` dict insertion order filtered by stage. Member
   maps are append-only per add; a CLIENT_ADD that *replaces* an existing
   name keeps its dict position (Python dict overwrite semantics), so that
   rare churn event triggers a full rebuild in ``self.clients`` order.
2. *Tie-breaks.* The baseline ``min()`` returns the first minimum in
   candidate order. Heap entries are ``(value, insertion_seq, name)``, so
   equal loads resolve to the earliest-inserted live member — the same
   client.
3. *Dirty discipline.* Every load metric is invariant between
   coordinator-mediated mutations (dispatch, step completion, window
   truncation, drain, migration). The coordinator marks the touched client
   dirty at each such chokepoint; the index recomputes exactly the dirty
   set at the next query. ``tokens_remaining`` is the one time-varying
   metric (decode fast-forward windows commit virtually as ``now``
   advances), so clients with an in-flight window are re-read every query.

``tests/test_fleet_scale.py`` drives random churn + mixed stages through
every router x metric and asserts the indexed and naive arms pick identical
client sequences; ``benchmarks/fleet_scale.py --smoke --check`` re-verifies
summary bit-equality at 1000 clients in CI.
"""
from __future__ import annotations

import heapq
import itertools
from bisect import insort
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.core.client import Client


class LoadIndex:
    """Lazy-deletion min-heap over one load metric of one ``StageMembers``.

    ``best(now)`` returns the client the baseline
    ``min(candidates, key=lambda c: c.load(metric, now))`` would return.
    Entries are ``(value, insertion_seq, name)``; an entry is live iff its
    value matches the cached one, its seq matches the member's current seq,
    and the member exists and is not failed. Dirty names are recomputed (and
    re-pushed unconditionally — a recover must restore an entry that a pop
    discarded while the client was failed) at the start of every query.
    """

    __slots__ = ("struct", "metric", "heap", "val", "dirty")

    def __init__(self, struct: "StageMembers", metric: str):
        self.struct = struct
        self.metric = metric
        self.heap: List = []
        self.val: Dict[str, float] = {}
        self.dirty: Set[str] = set(struct.members)

    def touch(self, name: str):
        self.dirty.add(name)

    def drop(self, name: str):
        self.val.pop(name, None)
        self.dirty.discard(name)

    def _compact(self):
        st = self.struct
        self.heap = [(v, st.seq[n], n) for n, v in self.val.items()
                     if n in st.members]
        heapq.heapify(self.heap)

    def best(self, now: Optional[float]) -> Optional[Client]:
        st = self.struct
        if self.metric == "tokens_remaining" and st.fleet.windowed:
            # virtually-committed fast-forward windows make this metric
            # time-varying between events: re-read every windowed member
            for name in st.fleet.windowed:
                if name in st.members:
                    self.dirty.add(name)
        if self.dirty:
            for name in self.dirty:
                c = st.members.get(name)
                if c is None:
                    self.val.pop(name, None)
                    continue
                v = c.load(self.metric, now)
                self.val[name] = v
                heapq.heappush(self.heap, (v, st.seq[name], name))
            self.dirty.clear()
        if len(self.heap) > 16 + 4 * len(st.members):
            self._compact()
        while self.heap:
            v, s, name = self.heap[0]
            c = st.members.get(name)
            if (c is None or c.failed or self.val.get(name) != v
                    or st.seq.get(name) != s):
                heapq.heappop(self.heap)
                continue
            return c
        return None


class StageMembers:
    """All non-removed clients serving one stage kind (or one
    ``(stage, group)`` pair), in ``Coordinator.clients`` insertion order.
    Failed members stay in the map (mirroring the baseline dict, which keeps
    them) but are excluded from iteration, the name-sorted live list and
    load-index answers. Doubles as the candidate view handed to routers."""

    __slots__ = ("fleet", "members", "seq", "n_failed", "_sorted", "load_idx")

    def __init__(self, fleet: "FleetIndex"):
        self.fleet = fleet
        self.members: Dict[str, Client] = {}
        self.seq: Dict[str, int] = {}
        self.n_failed = 0
        self._sorted: List[str] = []       # live member names, name-sorted
        self.load_idx: Dict[str, LoadIndex] = {}

    # -- candidate-view protocol (what routers / the coordinator consume) --
    @property
    def n_live(self) -> int:
        return len(self.members) - self.n_failed

    def __len__(self) -> int:
        return self.n_live

    def __bool__(self) -> bool:
        return self.n_live > 0

    def __iter__(self):
        return (c for c in self.members.values() if not c.failed)

    def sorted_live(self) -> List[Client]:
        return [self.members[n] for n in self._sorted]

    def pick_sorted(self, k: int) -> Client:
        return self.members[self._sorted[k % len(self._sorted)]]

    def load_best(self, metric: str, now: Optional[float]) -> Client:
        li = self.load_idx.get(metric)
        if li is None:
            li = self.load_idx[metric] = LoadIndex(self, metric)
        return li.best(now)

    def windowed(self) -> List[Client]:
        """Live members with an in-flight fast-forward window, in insertion
        order — exactly the candidates whose ``_interrupt`` would not be a
        no-op, so ``_sync`` pushes the same events as the baseline's
        interrupt-everyone loop."""
        w = self.fleet.windowed
        if not w:
            return []
        hits = [(self.seq[n], self.members[n]) for n in w
                if n in self.members and not self.members[n].failed]
        hits.sort()
        return [c for _, c in hits]

    def warm_candidates(self, req) -> List[Client]:
        """Live members whose radix cache holds the root block of ``req``'s
        prefix chain — the only clients whose ``prefix_hit_tokens`` can be
        nonzero — in insertion order."""
        names = self.fleet.warm_names(req)
        if not names:
            return []
        hits = [(self.seq[n], self.members[n]) for n in names
                if n in self.members and not self.members[n].failed]
        hits.sort()
        return [c for _, c in hits]

    # -- incremental maintenance ------------------------------------------
    def add(self, c: Client):
        name = c.name
        self.members[name] = c
        self.seq[name] = self.fleet.next_seq()
        if c.failed:
            self.n_failed += 1
        else:
            insort(self._sorted, name)
        for li in self.load_idx.values():
            li.touch(name)

    def remove(self, name: str):
        c = self.members.pop(name, None)
        if c is None:
            return
        del self.seq[name]
        if c.failed:
            self.n_failed -= 1
        else:
            self._sorted.remove(name)
        for li in self.load_idx.values():
            li.drop(name)

    def set_failed(self, name: str, failed: bool):
        c = self.members.get(name)
        if c is None:
            return
        if failed:
            self.n_failed += 1
            self._sorted.remove(name)
        else:
            self.n_failed -= 1
            insort(self._sorted, name)
        for li in self.load_idx.values():
            li.touch(name)


class FleetIndex:
    """Incrementally maintained routing indexes over a coordinator's fleet.

    Owned by ``Coordinator`` (``self.fleet``); every churn event and every
    client-state mutation chokepoint notifies it. ``None`` (the
    ``fleet_index=False`` config arm) gives the linear-scan baseline the
    decision-identity checks compare against."""

    def __init__(self, coordinator):
        self.coordinator = coordinator
        self.stages: Dict[str, StageMembers] = {}
        self.groups: Dict[tuple, StageMembers] = {}
        # per-client reverse map: name -> the StageMembers containing it
        self._structs: Dict[str, List[StageMembers]] = {}
        self._seq = itertools.count()
        # clients with an in-flight decode fast-forward macro-step
        self.windowed: Set[str] = set()
        # chain-root content hash -> names of clients whose radix holds it
        self.inv: Dict[int, Set[str]] = {}
        self._block_tokens: Dict[str, int] = {}     # per attached client
        self._bt_counts: Dict[int, int] = {}        # distinct block sizes
        for c in coordinator.clients.values():
            self.add(c)

    def next_seq(self) -> int:
        return next(self._seq)

    # -- candidate lookup --------------------------------------------------
    def candidates(self, stage: str) -> Optional[StageMembers]:
        return self.stages.get(stage)

    def group_candidates(self, stage: str, group) -> Optional[StageMembers]:
        return self.groups.get((stage, group))

    # -- churn events ------------------------------------------------------
    def add(self, c: Client):
        if c.name in self._structs:
            # CLIENT_ADD over an existing name keeps its dict position in
            # self.clients; rebuilding in dict order is the only way the
            # per-stage iteration order stays baseline-identical
            self.rebuild()
            return
        structs = []
        for stage in c.stages:
            st = self.stages.get(stage)
            if st is None:
                st = self.stages[stage] = StageMembers(self)
            st.add(c)
            structs.append(st)
            g = getattr(c, "group", None)
            if g is not None:
                gk = (stage, g)
                gst = self.groups.get(gk)
                if gst is None:
                    gst = self.groups[gk] = StageMembers(self)
                gst.add(c)
                structs.append(gst)
        self._structs[c.name] = structs
        self._attach_radix(c)

    def remove(self, name: str, client: Optional[Client] = None):
        for st in self._structs.pop(name, ()):
            st.remove(name)
        self.windowed.discard(name)
        self._detach_radix(name, client)

    def set_failed(self, name: str, failed: bool):
        for st in self._structs.get(name, ()):
            st.set_failed(name, failed)
        if failed:
            self.windowed.discard(name)

    def rebuild(self):
        """Full rebuild from the coordinator's client dict (rare: only a
        CLIENT_ADD replacing an existing name needs it)."""
        for name in list(self._structs):
            self._detach_radix(name)
        self.stages.clear()
        self.groups.clear()
        self._structs.clear()
        self.inv.clear()
        self._block_tokens.clear()
        self._bt_counts.clear()
        live_windows = self.windowed
        self.windowed = set()
        for c in self.coordinator.clients.values():
            self.add(c)
            if c.name in live_windows:
                self.windowed.add(c.name)

    # -- mutation chokepoints ---------------------------------------------
    def touch(self, name: str):
        """Client state changed under the coordinator's hands: cached load
        values are stale until recomputed."""
        for st in self._structs.get(name, ()):
            for li in st.load_idx.values():
                li.touch(name)

    def set_windowed(self, name: str, active: bool):
        if active:
            self.windowed.add(name)
        else:
            self.windowed.discard(name)

    # -- root-hash inverted index -----------------------------------------
    @staticmethod
    def _kv_of(c) -> Optional[object]:
        return getattr(getattr(c, "scheduler", None), "kv", None)

    def _attach_radix(self, c: Client):
        kv = self._kv_of(c)
        radix = getattr(kv, "radix", None) if kv is not None else None
        if radix is None:
            return
        name = c.name
        radix.on_root_change = (
            lambda h, added, _n=name: self._root_change(_n, h, added))
        self._block_tokens[name] = kv.block_tokens
        self._bt_counts[kv.block_tokens] = \
            self._bt_counts.get(kv.block_tokens, 0) + 1
        for node in radix.nodes.values():
            if getattr(node, "is_root", False):
                self.inv.setdefault(node.hash, set()).add(name)

    def _detach_radix(self, name: str, client: Optional[Client] = None):
        bt = self._block_tokens.pop(name, None)
        if bt is None:
            return
        n = self._bt_counts.get(bt, 0) - 1
        if n > 0:
            self._bt_counts[bt] = n
        else:
            self._bt_counts.pop(bt, None)
        c = client if client is not None else self.coordinator.clients.get(name)
        kv = self._kv_of(c) if c is not None else None
        radix = getattr(kv, "radix", None) if kv is not None else None
        if radix is not None and radix.on_root_change is not None:
            radix.on_root_change = None
            for node in radix.nodes.values():
                if getattr(node, "is_root", False):
                    self._root_discard(node.hash, name)
        else:
            # client object already gone: sweep the inverted index
            for h in [h for h, s in self.inv.items() if name in s]:
                self._root_discard(h, name)

    def _root_change(self, name: str, h: int, added: bool):
        if added:
            self.inv.setdefault(h, set()).add(name)
        else:
            self._root_discard(h, name)

    def _root_discard(self, h: int, name: str):
        s = self.inv.get(h)
        if s is not None:
            s.discard(name)
            if not s:
                del self.inv[h]

    def warm_names(self, req) -> Set[str]:
        """Names of clients that hold the root block of ``req``'s prefix
        chain (for any block size present in the fleet) — a superset filter:
        every client outside it has ``prefix_hit_tokens(req) == 0``."""
        if not req.prefix_segments or not self.inv:
            return set()
        names: Set[str] = set()
        for bt in self._bt_counts:
            chain = req.prefix_block_hashes(bt)
            if chain:
                hit = self.inv.get(chain[0])
                if hit:
                    names |= hit
        return names
