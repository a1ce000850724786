"""Quickstart on the PyTorch port (the twin of ``examples/quickstart.py``):
simulate a 4-client Llama-3-70B serving system under a conversational
workload in ``repro_torch.core`` and print the latency/throughput summary.

    PYTHONPATH=src python examples/quickstart_torch.py

The simulator is host code; its pricing here is analytical, as in the
reference's quickstart, so no tensor is made and no card is needed.
"""
import json
import os
import tempfile

from repro_torch.core import (SLO, SystemSpec, WorkloadConfig, build_system,
                              generate)
from repro_torch.core.tracing import to_chrome_trace


def main():
    # 1. describe the serving system (paper Fig. 4d)
    spec = SystemSpec(
        model="llama3_70b",
        n_llm_clients=4,          # 4 clients x (2xH100, TP2)
        strategy="continuous",    # vLLM-style batching
        router_policy="load_based",
        router_metric="tokens_remaining",
    )
    coord = build_system(spec, device="cpu")

    # 2. describe the workload (Azure-conv-shaped, poisson arrivals)
    wl = WorkloadConfig(rate=2.0, n_requests=100, pipeline="regular", seed=0)
    coord.submit(generate(wl))

    # 3. run the discrete-event simulation
    metrics = coord.run()

    # 4. inspect
    print(json.dumps(metrics.summary(total_energy=coord.total_energy,
                                     slo=SLO()), indent=2, default=str))
    path = to_chrome_trace(metrics.serviced, os.path.join(
        tempfile.gettempdir(), "hermes_trace_torch.json"))
    print(f"chrome trace written to {path} (open in chrome://tracing)")


if __name__ == "__main__":
    main()
