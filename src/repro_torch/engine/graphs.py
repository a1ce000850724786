"""The engine's compiled passes: the port's ``jax.jit`` of one fixed-shape
pass (decode, draft decode, verify, chunk; the ``SlotEngine``'s decode).

A ``CompiledPass`` owns the pass's static inputs (``StaticInputs``: int32
device buffers at fixed addresses, filled from one pinned host staging
buffer by one non-blocking copy). On a CUDA device it runs the pass once,
on the card's one side stream (``side_stream``), over *all-trash* inputs
(every table row on the trash page, every length and ``q_valid`` 0, so the
pass's K/V writes land only on the trash page): that builds and loads the kernel libraries, raises their
shared-memory limits and fills the ``rope_frequencies`` cache, none of
which may happen under capture. Then it captures the pass as a CUDA graph
with ``torch.cuda.graph`` and replays it for every later call; the capture
returns the static outputs that each replay overwrites. A failed capture
or replay raises; nothing falls back to eager on the card. With
``capture=False`` (``cuda_graphs=False`` on the engines) a CUDA pass runs
the same function eagerly over the same buffers, the arm graphs are held
against. On the CPU there is no capture: the function runs eagerly over the
same buffers, as the tests use it.

A graph reads the addresses it saw at capture: everything it touches (the
static inputs, the pools, the caches' table and length views) must stay
where it was for the engine's life, written in place and never rebound.
Python values taken from input *data* would be frozen at capture; the
passes take none (their checks read shapes only).

Launch counters: the kernel wrappers count in Python when they launch, so a
capture bumps them although nothing ran, and a replay does not. The
capture's bumps are taken back out (``ops.launch_counts`` /
``ops.add_launches``) and kept as the graph's own count, which every replay
adds; the warm-up's launches did run and stay counted.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

log = logging.getLogger(__name__)


class StaticInputs:
    """Named int32 device buffers carved out of one flat buffer, and their
    host twins (numpy views of one staging buffer, pinned on a CUDA
    device). Write the host arrays, then ``push()``: one non-blocking copy.
    The caller must not write the host arrays again before the copy has run
    (the engines read each pass's output with ``.cpu()``, which waits)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], device):
        device = torch.device(device)
        n = sum(math.prod(s) for s in shapes.values())
        self._host = torch.zeros(n, dtype=torch.int32,
                                 pin_memory=device.type == "cuda")
        self._dev = torch.zeros(n, dtype=torch.int32, device=device)
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        off = 0
        for name, shape in shapes.items():
            k = math.prod(shape)
            self.host[name] = self._host[off:off + k].view(shape).numpy()
            self.dev[name] = self._dev[off:off + k].view(shape)
            off += k

    def push(self):
        self._dev.copy_(self._host, non_blocking=True)


# one side stream per card for every pass's warm-up and capture: cuBLAS
# keeps a workspace (32 MiB on an H100) for each stream it has run a
# product on, for the process's life, so a new stream per pass would leave
# one workspace per pass ever built
_side_streams: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The card's one stream for warm-ups and captures."""
    device = torch.device(device)
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    if idx not in _side_streams:
        _side_streams[idx] = torch.cuda.Stream(idx)
    return _side_streams[idx]


def _capture_graph(fn, stream):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, out


class CompiledPass:
    """One fixed-shape pass: ``body(**inputs)`` over the static inputs
    ``shapes``, captured once on a CUDA device and replayed by ``run``.

    ``trash()`` sets whatever else the pass reads (the caches' table and
    length buffers) to all-trash values before the warm-up and may return a
    callable that restores it after. ``replays`` counts graph replays,
    ``warm_up_s`` and ``capture_s`` are the construction's warm-up and
    capture times, ``launches`` what one replay launches (kernel name ->
    launches)."""

    def __init__(self, name: str, body: Callable, shapes, device, *,
                 capture: bool = True,
                 trash: Optional[Callable[[], Optional[Callable]]] = None):
        self.name = name
        self.device = torch.device(device)
        self.inputs = StaticInputs(shapes, self.device)
        self._body = body
        self._trash = trash
        self.graph = None
        self.out = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.warm_up_s = self.capture_s = 0.0
        if self.device.type == "cuda":
            t0 = time.monotonic()
            stream = side_stream(self.device)
            self.warm_up(stream)
            t1 = time.monotonic()
            if capture:
                self.capture(stream)
            self.warm_up_s, self.capture_s = t1 - t0, time.monotonic() - t1
            log.info("pass %s: warm-up %.3f s, capture %.3f s", name,
                     self.warm_up_s, self.capture_s)

    def fn(self):
        """The pass, eagerly, over the static inputs as they stand."""
        return self._body(**self.inputs.dev)

    def warm_up(self, stream=None):
        """Run the pass over all-trash inputs (on ``stream`` on the card),
        then restore what ``trash`` changed. Its launches stay counted."""
        for a in self.inputs.host.values():
            a.fill(0)
        self.inputs.push()
        restore = self._trash() if self._trash is not None else None
        if self.device.type == "cuda":
            stream = stream or side_stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self.fn()
            torch.cuda.current_stream(self.device).wait_stream(stream)
        else:
            self.fn()
        if restore is not None:
            restore()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def capture(self, stream):
        """Capture the pass on ``stream``; raises if capture fails. The
        capture launches nothing, so the counter bumps it made are taken
        back out and kept as what each replay launches."""
        before = ops.launch_counts()
        self.graph, self.out = _capture_graph(self.fn, stream)
        self.launches = {k: n - before[k]
                         for k, n in ops.launch_counts().items()
                         if n != before[k]}
        ops.add_launches(self.launches, -1)

    def run(self, **arrays):
        """Write ``arrays`` into the static inputs and run the pass: a
        replay of the graph, or the function eagerly where nothing was
        captured. Returns the pass's outputs (static ones when replayed:
        read them before the next replay)."""
        for name, a in arrays.items():
            self.inputs.host[name][...] = a
        self.inputs.push()
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        self.replays += 1
        ops.add_launches(self.launches)
        return self.out
