"""Device assignment of the disaggregated workers: the twin of
``repro.launch.mesh.handoff_devices``, over the host's CUDA cards. The other
mesh functions (sharding over a ``DeviceMesh``) come with the distribution
slice of the port."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def handoff_devices(n_prefill: int, n_decode: int
                    ) -> Tuple[List[Optional[torch.device]],
                               List[Optional[torch.device]]]:
    """Cards for the disaggregated roles (``engine/workers.py``): prefill
    workers take the first half of the host's cards and decode workers the
    rest, round-robin within each role, so the KV handoff is a real copy
    between cards (peer to peer) whenever the host has two or more. With
    fewer than two cards, or none, both lists are all None: the workers
    then share one device and the pages travel through host memory."""
    n = torch.cuda.device_count()
    if n < 2:
        return [None] * n_prefill, [None] * n_decode
    devs = [torch.device("cuda", i) for i in range(n)]
    split = max(1, min(n - 1, n // 2))
    pd, dd = devs[:split], devs[split:]
    return ([pd[i % len(pd)] for i in range(n_prefill)],
            [dd[i % len(dd)] for i in range(n_decode)])
