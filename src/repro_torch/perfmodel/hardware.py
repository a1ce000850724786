"""Hardware specs of the analytical models (paper §III-E, §IV-B, §V),
copied from ``repro.perfmodel.hardware`` so that the port imports nothing
of ``repro``; a test holds the two equal field for field.

The port prices its own cells on ``H100`` (989 TFLOP/s bf16, 3.35 TB/s,
80 GB, 700 W) and its collectives on ``NVLINK`` (``launch/dryrun.py``);
the disaggregated engine's handoffs are fitted into a ``LinkSpec``
(``perfmodel.regression.fit_link_spec``). The TPU v5e entry stays, as in
the original, for the simulator's tables; no number of the port is
priced on it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ChipSpec:
    name: str
    flops: float              # peak FLOP/s (bf16 for NPUs, fp32 for CPUs)
    mem_bw: float             # bytes/s
    mem_cap: float            # bytes
    power: float              # watts (board TDP)
    idle_power_frac: float = 0.3
    mfu_prefill: float = 0.55  # achievable fraction of peak in compute-bound
    mbu_decode: float = 0.70   # achievable fraction of peak HBM bw


@dataclass(frozen=True)
class LinkSpec:
    name: str
    bandwidth: float          # bytes/s
    latency: float            # seconds per message


H100 = ChipSpec("H100", 989e12, 3.35e12, 80e9, 700.0)
A100 = ChipSpec("A100", 312e12, 2.039e12, 80e9, 400.0)
TPU_V5E = ChipSpec("TPUv5e", 197e12, 819e9, 16e9, 250.0)
# paper §IV-B CPU configs
GRACE_CPU = ChipSpec("GraceCPU", 14.2e12, 768e9, 1e12, 500.0, mfu_prefill=0.7)
SPR_CPU = ChipSpec("SPR-CPU", 6.27e12, 307.2e9, 4e12, 350.0, mfu_prefill=0.7)
# generic memory-node "chip" for cache tiers
MEM_NODE = ChipSpec("MemNode", 1e12, 128e9, 4e12, 150.0)

CHIPS: Dict[str, ChipSpec] = {c.name: c for c in
                              (H100, A100, TPU_V5E, GRACE_CPU, SPR_CPU, MEM_NODE)}

NVLINK = LinkSpec("NVLink", 450e9, 2e-6)
ICI = LinkSpec("ICI", 50e9, 1e-6)
PCIE4_X4 = LinkSpec("PCIe4x4", 32e9, 5e-6)      # paper §IV-B figure
PCIE5 = LinkSpec("PCIe5x16", 64e9, 5e-6)
ETH_RACK = LinkSpec("RackEth", 128e9, 20e-6)
DCN = LinkSpec("DCN", 128e9, 20e-3)             # paper §V-B: ~20 ms link latency

LINKS: Dict[str, LinkSpec] = {l.name: l for l in
                              (NVLINK, ICI, PCIE4_X4, PCIE5, ETH_RACK, DCN)}


@dataclass(frozen=True)
class ClusterSpec:
    """A hardware cluster backing one client: n chips with TP within."""
    chip: ChipSpec
    n_chips: int = 1
    tp: int = 1
    intra_link: LinkSpec = NVLINK

    @property
    def total_mem(self) -> float:
        return self.chip.mem_cap * self.n_chips

    @property
    def total_flops(self) -> float:
        return self.chip.flops * self.n_chips

    @property
    def total_bw(self) -> float:
        return self.chip.mem_bw * self.n_chips


@dataclass(frozen=True)
class CacheTierSpec:
    """One level of the KV-retrieval memory hierarchy (paper Eq. 1)."""
    name: str
    capacity: float           # bytes
    lookup_latency: float     # seconds
    bandwidth: float          # bytes/s
    hit_rate: float           # stationary hit probability

    def transfer_time(self, nbytes: float) -> float:
        """The Eq. 1 hit term (``T_lookup_n + Size_KV / BW_n``) — the single
        source for pricing one deterministic traversal of this tier."""
        return self.lookup_latency + nbytes / self.bandwidth


# paper §V-B storage tiers
TIER_LOCAL_LPDDR = CacheTierSpec("per-client-LPDDR", 1e12, 100e-9, 128e9, 0.60)
TIER_PLATFORM = CacheTierSpec("platform-shared", 4e12, 1e-6, 32e9, 0.80)
TIER_RACK = CacheTierSpec("rack-shared", 32e12, 10e-6, 2e9, 0.95)

# spill tiers for the on-device paged KV allocator (HBM → host DRAM →
# remote pool). ``hit_rate`` is 1.0: a swapped page is deterministically
# where the block table says it is — only the Eq. 1 hit *term*
# (lookup + bytes/BW) prices the traversal.
TIER_HOST_DRAM = CacheTierSpec("host-DRAM", 2e12, 1e-6, PCIE5.bandwidth, 1.0)
TIER_REMOTE_POOL = CacheTierSpec("remote-pool", 64e12, ETH_RACK.latency,
                                 ETH_RACK.bandwidth, 1.0)
DEFAULT_SWAP_TIERS: Tuple[CacheTierSpec, ...] = (TIER_HOST_DRAM,
                                                 TIER_REMOTE_POOL)
