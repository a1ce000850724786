"""Hierarchical interconnect model (the astra-sim stand-in, DESIGN.md §3).

Alpha-beta links with per-link contention queues: each transfer occupies every
link on its path serially (store-and-forward at the path level, which upper-
bounds real wormhole behaviour by < the per-hop latency sum). Layerwise
granularity (paper §III-B2) pipelines the KV-cache transfer against prefill so
only ~one layer of exposed latency remains.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.perfmodel.hardware import LinkSpec


@dataclass
class LinkState:
    spec: LinkSpec
    busy_until: float = 0.0
    bytes_moved: float = 0.0
    transfers: int = 0


class Network:
    """Named clients connected through named links."""

    def __init__(self):
        self.links: Dict[str, LinkState] = {}
        self.paths: Dict[Tuple[str, str], List[str]] = {}
        self.default_path: Optional[List[str]] = None

    def add_link(self, name: str, spec: LinkSpec):
        self.links[name] = LinkState(spec)

    def override_link(self, name: str, spec: LinkSpec):
        """Re-price an existing link in place, keeping its traffic counters
        and contention state. This is the calibration hook: fleet assembly
        wires topology with catalog LinkSpecs, then a measured fit (e.g.
        ``benchmarks/engine_disagg.py``'s timed KV-page handoffs) swaps in
        observed alpha/beta without rebuilding the Network."""
        self.links[name].spec = spec

    def connect(self, src: str, dst: str, link_names: List[str],
                bidirectional: bool = True):
        self.paths[(src, dst)] = link_names
        if bidirectional:
            self.paths[(dst, src)] = link_names

    def set_default_path(self, link_names: List[str]):
        self.default_path = link_names

    def path_for(self, src: str, dst: str) -> List[str]:
        p = self.paths.get((src, dst))
        if p is None:
            p = self.default_path or []
        return p

    @staticmethod
    def _exposed(link: LinkState, nbytes: float, granularity: str,
                 n_layers: int) -> float:
        """Exposed latency of one link traversal. Layerwise granularity is
        overlapped with producer compute: exposed cost ~ one layer of
        payload + one message latency (Splitwise layerwise mode)."""
        if granularity == "layerwise":
            return nbytes / max(1, n_layers) / link.spec.bandwidth \
                + link.spec.latency
        return nbytes / link.spec.bandwidth + link.spec.latency

    def transfer(self, src: str, dst: str, nbytes: float, now: float,
                 granularity: str = "full", n_layers: int = 1) -> float:
        """Returns the ARRIVAL time of the data at dst (with contention)."""
        path = self.path_for(src, dst)
        if not path or nbytes <= 0 or src == dst:
            return now
        t = now
        for name in path:
            link = self.links[name]
            start = max(t, link.busy_until)
            exposed = self._exposed(link, nbytes, granularity, n_layers)
            if granularity == "layerwise":
                occupy = nbytes / link.spec.bandwidth  # link carries it all
            else:
                occupy = exposed
            link.busy_until = start + occupy
            link.bytes_moved += nbytes
            link.transfers += 1
            t = start + exposed
        return t

    def estimate(self, src: str, dst: str, nbytes: float, now: float = 0.0,
                 granularity: str = "full", n_layers: int = 1) -> float:
        """Read-only exposed latency of a would-be ``transfer`` (same
        pricing, current contention included, NO link occupancy or byte
        accounting). Decision logic — e.g. the router's fetch-vs-recompute
        trade-off — uses this so probing an option never perturbs the
        links it decided against using."""
        path = self.path_for(src, dst)
        if not path or nbytes <= 0 or src == dst:
            return 0.0
        t = now
        for name in path:
            link = self.links[name]
            start = max(t, link.busy_until)
            t = start + self._exposed(link, nbytes, granularity, n_layers)
        return t - now

    def stats(self) -> Dict[str, Dict]:
        return {k: {"bytes": v.bytes_moved, "transfers": v.transfers}
                for k, v in self.links.items()}
