"""Disaggregated prefill/decode serving over the shared ``EngineCore`` (twin
of ``repro.engine.workers``, name for name).

* ``PrefillWorker`` runs only admission and prefill, whole-prompt (flash
  attention, the first token sampled inline) or chunked (its graphed chunk
  pass). A request whose context is fully written leaves in the same step:
  the worker gathers its filled KV pages (``PagedKVStore.export_pages``),
  frees the table (registered prompt blocks park as evictable cache, so
  prefill-side prefix hits survive the handoff) and puts ``(request,
  export, pages)`` in its outbox.
* ``DecodeWorker`` runs only the graphed decode pass. ``ingest`` queues a
  handoff FIFO-fairly; admission imports the pages into the worker's own
  pool (``PagedKVStore.import_pages``: a resident chain prefix is aliased
  and only the unmatched tail is scattered, in place) and decode continues
  from the streamed first token. Swap preemption stays local; a recompute
  victim surfaces in ``evicted``, because only a prefill worker can rebuild
  its KV.
* ``DisaggEngine`` pairs ``n_prefill`` x ``n_decode`` workers ("local":
  prefill ``i`` to decode ``i % n_decode``; "global": the least-loaded
  decode worker) and moves each handoff's pages as a real, timed transfer
  (``move_pages``): a copy between cards when the host gives each role its
  own (``launch.mesh.handoff_devices``), through host memory otherwise.
  ``granularity="full"`` moves the payload in one transfer, ``"layerwise"``
  one layer of one cache group at a time (paper §III-B2): the same bytes,
  but only about one layer's transfer is exposed.

Every entry point runs on ``device="cuda"`` unless the caller passes
another device; each worker builds and steps with its device current
(``EngineCore._dev_scope``). One ``params`` tree serves every worker, held
once on each card. Under greedy decoding the streams equal the single
``Engine``'s: pages move verbatim, aliased pages hold equal bits, and every
decode row's result does not depend on the other rows of the pass, so
worker pairing, admission order and preemption change when a token is
computed, never what it is.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.core import (Engine, EngineConfig, EngineCore,
                                     EngineRequest, _to_device)
from repro_torch.engine.graphs import CompiledPass
from repro_torch.engine.paged_kv import PageExport
from repro_torch.launch.mesh import handoff_devices
from repro_torch.models import steps
from repro_torch.models import transformer as tf


@dataclass
class KVHandoff:
    """One prefill->decode handoff in flight: the request (its stream and
    timing ride along), the export's fields, the staged page payload (on
    the decode worker's card, or in host memory when staged) and the timed
    transfer record."""
    req: EngineRequest
    ctx: np.ndarray
    tokens: int
    chain: List[int]
    pages: Dict
    record: Dict


def _page_slice(pages, start: int):
    """The payload without its first ``start`` pages (those the importing
    store aliased)."""
    return {name: {"k": g["k"][:, start:], "v": g["v"][:, start:]}
            for name, g in pages.items()}


def _sync(device: Optional[torch.device]):
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def move_pages(pages, device: Optional[torch.device],
               granularity: str) -> Tuple[Dict, Dict]:
    """Move a gathered page payload (``{group: {"k", "v"}}``, each ``(L,
    pages, bt, kvh, hd)``) to ``device``, timing the transfer. ``None``
    means host-staged: ``.cpu()``, which returns when the copy is done.
    A device copies with ``.to(device)`` (peer to peer between cards) and
    is timed until ``torch.cuda.synchronize`` on it returns. The producer's
    device is synchronised first, so the gather's compute stays out of the
    samples.

    ``full`` moves the whole payload as one transfer; ``layerwise`` one
    layer of one cache group per transfer, its exposed stall the slowest
    layer (the others overlap the consumer's layerwise compute). Stacking
    the layers again stays out of the samples. Returns ``(staged,
    record)``; ``record`` has ``bytes, pages, layers, granularity, staged,
    total_s, exposed_s`` and ``samples``, the ``(bytes, seconds)`` of every
    timed transfer."""
    if granularity not in ("full", "layerwise"):
        raise ValueError(f"granularity={granularity!r}")
    leaves = [t for g in pages.values() for t in (g["k"], g["v"])]
    for dev in {x.device for x in leaves}:
        _sync(dev)
    nbytes = int(sum(x.numel() * x.element_size() for x in leaves))
    n_pages = int(leaves[0].shape[1]) if leaves else 0
    n_layers = int(sum(g["k"].shape[0] for g in pages.values()))

    def timed(xs):
        t0 = time.perf_counter()
        out = [x.cpu() if device is None else x.to(device) for x in xs]
        _sync(device)
        return out, time.perf_counter() - t0

    samples: List[Tuple[int, float]] = []
    if granularity == "full":
        out, dt = timed(leaves)
        staged = {name: {"k": out[2 * i], "v": out[2 * i + 1]}
                  for i, name in enumerate(pages)}
        samples.append((nbytes, dt))
        total = exposed = dt
    else:
        staged = {}
        total = exposed = 0.0
        for name, g in pages.items():
            ks, vs = [], []
            for layer in range(g["k"].shape[0]):
                sk, sv = g["k"][layer], g["v"][layer]
                (ok, ov), dt = timed([sk, sv])
                samples.append((sk.numel() * sk.element_size()
                                + sv.numel() * sv.element_size(), dt))
                total += dt
                exposed = max(exposed, dt)
                ks.append(ok)
                vs.append(ov)
            staged[name] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    record = {
        "bytes": nbytes,
        "pages": n_pages,
        "layers": n_layers,
        "granularity": granularity,
        "staged": "device" if device is not None else "host",
        "total_s": total,
        "exposed_s": exposed,
        "samples": samples,
    }
    return staged, record


class PrefillWorker(EngineCore):
    """Prefill-only role: admission plus whole or chunked prefill, then
    export. Never decodes: a request whose context is in KV leaves through
    the outbox in the step that completes it. Its only compiled pass is the
    chunk pass (chunked prefill); whole prefill runs eagerly."""

    PASSES = ("chunk",)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.outbox: List[Tuple[EngineRequest, PageExport, Dict]] = []

    def step(self) -> bool:
        """One prefill iteration: admit (whole-prompt admission prefills
        inline), advance the chunk-phase rows by one chunk pass, export
        every row whose context is complete. True when anything ran."""
        with self._dev_scope():
            self._admit()
            worked = False
            if self.chunk_size and any(
                    r is not None and not self._is_decoding(r)
                    for r in self.active):
                self._chunk_pass()
                worked = True
            return bool(self._export_ready()) or worked

    def _export_ready(self) -> int:
        n = 0
        for slot in range(self.max_batch):
            r = self.active[slot]
            if r is None or not self._is_decoding(r):
                continue
            exp = self.store.export_pages(r.rid)
            pages = steps.gather_pages(
                self.caches, self._tensor(np.asarray(exp.blocks, np.int64)))
            # free after the gather: registered prompt blocks park as
            # evictable cache, so later prompts sharing the prefix still
            # alias them
            self.store.free(r.rid)
            del self._admit_order[r.rid]
            self.active[slot] = None
            self._clear_row(slot)
            r.slot = None
            r.state = "handoff"
            self.outbox.append((r, exp, pages))
            n += 1
        return n


class DecodeWorker(EngineCore):
    """Decode-only role: imports handed-off pages into its own pool and
    continues the stream through its compiled decode pass (its only one).
    Swap preemption round-trips against this worker's pool; a recompute
    victim cannot be rebuilt here and surfaces in ``evicted`` for the
    orchestrator to send back to a prefill worker."""

    PASSES = ("decode",)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._handoffs: Dict[int, KVHandoff] = {}
        self.evicted: List[EngineRequest] = []

    def ingest(self, h: KVHandoff):
        """Queue a transferred handoff FIFO-fairly (by rid, merged with any
        swap victims waiting to come back). Its pages wait with it until
        admission finds a slot and room in the pool."""
        if h.req.state != "handoff":
            raise ValueError(f"request {h.req.rid} is {h.req.state!r}, not "
                             "a handoff")
        self._handoffs[h.req.rid] = h
        self.enqueue(h.req)

    def _admit_one(self, slot: int, r: EngineRequest) -> bool:
        if r.state != "handoff":
            if r.state != "swapped":
                raise RuntimeError(
                    f"decode worker cannot admit a {r.state!r} request (only "
                    "handoffs and its own swap victims)")
            return super()._admit_one(slot, r)
        h = self._handoffs[r.rid]
        got = self.store.import_pages(r.rid, h.tokens, h.chain)
        if got is None:
            return False                   # head-of-line wait, like any path
        blocks, n_matched = got
        if n_matched < len(blocks):
            tail = {name: {k: v.to(self.device) for k, v in g.items()}
                    for name, g in _page_slice(h.pages, n_matched).items()}
            steps.scatter_pages(
                self.caches, tail,
                self._tensor(np.asarray(blocks[n_matched:], np.int64)))
        self._set_row(slot, blocks, h.tokens)
        r.ctx = h.ctx
        r.prefilled = h.tokens
        del self._handoffs[r.rid]
        self._place(slot, r)
        return True

    def step(self) -> bool:
        """One decode iteration: admit (imports and swap-ins), grow, the
        decode pass. True when a decode pass ran."""
        with self._dev_scope():
            self._admit()
            worked = False
            if any(a is not None for a in self.active):
                self._grow_active()
                self._decode_pass()
                self._trace_step()
                worked = True
            # recompute victims need a prefill worker to rebuild their KV
            out = [r for r in self.waiting if r.state == "preempted"]
            if out:
                self.waiting = [r for r in self.waiting
                                if r.state != "preempted"]
                self.evicted.extend(out)
            return worked


class DisaggEngine:
    """Disaggregated serving: ``Engine``-compatible ``submit``/``run`` over
    prefill and decode workers with a real KV-page handoff between them
    (see the module docstring).

    * ``mode`` — "local" pins prefill worker ``i`` to decode worker ``i %
      n_decode``; "global" routes every handoff to the least-loaded decode
      worker (deterministic).
    * ``granularity`` — "full" | "layerwise" transfer (§III-B2).
    * ``prefill_blocks`` / ``decode_blocks`` — each role's pool size (None:
      no pressure); shrink them to preempt on either side of the handoff.
    * ``device`` — where the workers run; on a CUDA device the roles take
      ``devices`` (``(prefill_devices, decode_devices)``), by default
      ``launch.mesh.handoff_devices``: cards of their own when the host has
      two or more, else all on ``device`` with host-staged handoffs. A
      role whose entry is None runs on ``device``.
    * ``cuda_graphs`` — capture the workers' compiled passes (False: run
      them eagerly over the same static buffers).
    """

    def __init__(self, cfg: ModelConfig, params=None, *,
                 n_prefill: int = 1, n_decode: int = 1, mode: str = "local",
                 granularity: str = "full", max_batch: int = 4,
                 max_len: int = 512, seed: int = 0, block_tokens: int = 16,
                 prefill_blocks: Optional[int] = None,
                 decode_blocks: Optional[int] = None,
                 preemption: str = "swap",
                 config: Optional[EngineConfig] = None,
                 trace_occupancy: bool = False, devices=None,
                 device="cuda", cuda_graphs: bool = True):
        if mode not in ("local", "global"):
            raise ValueError(f"mode={mode!r}")
        if granularity not in ("full", "layerwise"):
            raise ValueError(f"granularity={granularity!r}")
        if n_prefill < 1 or n_decode < 1:
            raise ValueError("needs at least one worker of each role")
        config = config or EngineConfig()
        if config.draft_cfg is not None and config.spec_k > 0:
            raise ValueError("speculative decoding is a single-engine "
                             "feature")
        self.cfg = cfg
        self.mode = mode
        self.granularity = granularity
        self.device = torch.device(device)
        if devices is None:
            devices = (handoff_devices(n_prefill, n_decode)
                       if self.device.type == "cuda"
                       else ([None] * n_prefill, [None] * n_decode))
        pdevs, ddevs = devices
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = tf.init_model(cfg, gen, self.device)
        held: Dict[torch.device, Dict] = {}    # one copy of the weights a card

        def on(dev):
            dev = self.device if dev is None else torch.device(dev)
            if dev not in held:
                held[dev] = _to_device(params, dev)
            return dict(params=held[dev], device=dev)

        kw = dict(max_batch=max_batch, max_len=max_len,
                  block_tokens=block_tokens, preemption=preemption,
                  config=config, trace_occupancy=trace_occupancy,
                  cuda_graphs=cuda_graphs)
        self.prefill = [PrefillWorker(cfg, num_blocks=prefill_blocks,
                                      **on(d), **kw) for d in pdevs]
        self.decode = [DecodeWorker(cfg, num_blocks=decode_blocks,
                                    **on(d), **kw) for d in ddevs]
        # where each decode worker's handoffs are copied to (None: staged
        # through host memory, moved to the worker's card at admission)
        self._dst = [None if d is None else torch.device(d) for d in ddevs]
        self._next_rid = 0
        self._rr = 0
        self._home: Dict[int, int] = {}    # rid -> prefill worker index
        self.finished: List[EngineRequest] = []
        self.transfers: List[Dict] = []    # one timed record per handoff
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> EngineRequest:
        prompt = np.asarray(prompt, np.int32)
        # a request must fit both roles: it prefills (and may prefill again
        # after a decode-side recompute) on a prefill worker and decodes to
        # its stop bound on a decode worker
        self.prefill[0]._validate_submit(prompt, max_new_tokens)
        self.decode[0]._validate_submit(prompt, max_new_tokens)
        r = EngineRequest(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          submit_time=time.monotonic())
        self._next_rid += 1
        idx = self._rr % len(self.prefill)
        self._rr += 1
        self._home[r.rid] = idx
        self.prefill[idx].waiting.append(r)
        return r

    def _route(self, src_idx: int) -> int:
        if self.mode == "local":
            return src_idx % len(self.decode)
        # global: deterministic least-loaded (queued + staged + active)
        return min(range(len(self.decode)),
                   key=lambda j: (len(self.decode[j].waiting)
                                  + len(self.decode[j]._handoffs)
                                  + sum(a is not None
                                        for a in self.decode[j].active)))

    def _pending(self) -> bool:
        for w in self.prefill:
            if w.waiting or w.outbox or any(a is not None for a in w.active):
                return True
        for w in self.decode:
            if (w.waiting or w._handoffs or w.evicted
                    or any(a is not None for a in w.active)):
                return True
        return False

    def run(self, max_steps: int = 100_000) -> List[EngineRequest]:
        while self._pending() and self.steps < max_steps:
            self.steps += 1
            progress = False
            for i, pw in enumerate(self.prefill):
                if pw.step():
                    progress = True
                while pw.outbox:
                    r, exp, pages = pw.outbox.pop(0)
                    j = self._route(i)
                    staged, rec = move_pages(pages, self._dst[j],
                                             self.granularity)
                    rec.update(rid=r.rid, src=f"prefill{i}",
                               dst=f"decode{j}")
                    self.transfers.append(rec)
                    self.decode[j].ingest(KVHandoff(
                        req=r, ctx=r.ctx, tokens=exp.tokens, chain=exp.chain,
                        pages=staged, record=rec))
                    progress = True
            for dw in self.decode:
                if dw.step():
                    progress = True
                if dw.finished:
                    self.finished.extend(dw.finished)
                    dw.finished = []
                while dw.evicted:
                    r = dw.evicted.pop(0)
                    self.prefill[self._home[r.rid]].enqueue(r)
                    progress = True
            if not progress and self._pending():
                raise RuntimeError(
                    "disaggregated engine stalled: a queued request cannot "
                    "be admitted on any worker (pool too small for the "
                    "handoff?)")
        return self.finished

    # ------------------------------------------------------------------
    def passes(self) -> Dict[str, CompiledPass]:
        """Every worker's compiled passes, as ``"prefill0.chunk"``,
        ``"decode1.decode"``, ..."""
        return {f"{role}{i}.{name}": p
                for role, workers in (("prefill", self.prefill),
                                      ("decode", self.decode))
                for i, w in enumerate(workers)
                for name, p in w.passes().items()}

    def transfer_stats(self) -> Dict[str, object]:
        """Handoff telemetry: bytes and pages moved, total and exposed
        transfer seconds, the ``(bytes, seconds)`` samples to fit a link
        from, and the decode-side dedup (pool writes skipped for resident
        prefixes)."""
        recs = self.transfers
        return {
            "granularity": self.granularity,
            "mode": self.mode,
            "handoffs": len(recs),
            "bytes": int(sum(r["bytes"] for r in recs)),
            "pages": int(sum(r["pages"] for r in recs)),
            "total_s": float(sum(r["total_s"] for r in recs)),
            "exposed_s": float(sum(r["exposed_s"] for r in recs)),
            "samples": [s for r in recs for s in r["samples"]],
            "dedup_blocks": int(sum(w.store.import_dedup_blocks
                                    for w in self.decode)),
            "cross_device": any(r["staged"] == "device" for r in recs),
        }

    def kv_stats(self) -> Dict[str, Dict[str, float]]:
        return {
            **{f"prefill{i}": w.kv_stats()
               for i, w in enumerate(self.prefill)},
            **{f"decode{j}": w.kv_stats()
               for j, w in enumerate(self.decode)},
        }


def oracle_engine(cfg: ModelConfig, params=None, **kw) -> Engine:
    """The single ``Engine`` with the geometry ``DisaggEngine`` takes, for
    parity checks that build both sides from one dict of arguments."""
    for k in ("n_prefill", "n_decode", "mode", "granularity", "devices",
              "prefill_blocks", "decode_blocks"):
        kw.pop(k, None)
    return Engine(cfg, params, **kw)
