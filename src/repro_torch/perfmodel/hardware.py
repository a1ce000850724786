"""Link constants of a measured transfer, copied from
``repro.perfmodel.hardware.LinkSpec`` so that the port imports nothing of
``repro``; a test holds the two equal field for field.

Only ``LinkSpec`` is copied: the disaggregated engine's handoffs are fitted
into one (``perfmodel.regression.fit_link_spec``). The chip and cluster
specs and the simulator's link table stay in the shared simulator.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LinkSpec:
    name: str
    bandwidth: float          # bytes/s
    latency: float            # seconds per message
