"""The batching study on the PyTorch port (the twin of
``examples/batching_study.py``): sweep batching strategies x injection
rates on one trace in ``repro_torch.core`` and print which strategy wins
each objective.

    PYTHONPATH=src python examples/batching_study_torch.py

The simulator is host code priced analytically, as in the reference: no
tensor is made, so the study takes no device.
"""
from repro_torch.core import (SLO, SystemSpec, WorkloadConfig, build_system,
                              generate)
from repro_torch.core.workload import AZURE_CODE

STRATEGIES = ("static", "continuous", "chunked", "disaggregated")
RATES = (1.0, 3.0, 6.0)


def run_cell(strategy: str, rate: float):
    if strategy == "disaggregated":
        spec = SystemSpec(strategy="disaggregated", n_prefill=2, n_decode=2,
                          with_pre_post=False)
    else:
        spec = SystemSpec(n_llm_clients=4, strategy=strategy,
                          with_pre_post=False)
    coord = build_system(spec)
    wl = WorkloadConfig(trace=AZURE_CODE, rate=rate, n_requests=60,
                        disaggregated=(strategy == "disaggregated"),
                        postprocess=False, seed=1)
    coord.submit(generate(wl))
    m = coord.run()
    horizon = max(r.completion_time for r in m.serviced)
    return m.summary(horizon=horizon, total_energy=coord.total_energy,
                     slo=SLO())


def main():
    """Prints the table and the recommendations; returns each (strategy,
    rate) cell's summary."""
    print(f"{'strategy':15s} {'rate':>5s} {'ttft_p50':>9s} {'tpot_p50':>9s} "
          f"{'thpt':>8s} {'tok/J':>7s} {'SLO':>5s}")
    results = {}
    for strategy in STRATEGIES:
        for rate in RATES:
            s = run_cell(strategy, rate)
            results[(strategy, rate)] = s
            print(f"{strategy:15s} {rate:5.1f} "
                  f"{s['ttft_p50']*1e3:8.0f}ms {s['tpot_p50']*1e3:8.1f}ms "
                  f"{s['throughput_tok_s']:8.0f} "
                  f"{s.get('tok_per_joule', 0):7.4f} "
                  f"{str(s.get('slo_ok')):>5s}")
    # Table-III style recommendation
    for rate in RATES:
        cells = {k[0]: v for k, v in results.items() if k[1] == rate}
        best = {
            "TTFT": min(cells, key=lambda k: cells[k]["ttft_p50"]),
            "thpt": max(cells, key=lambda k: cells[k]["throughput_tok_s"]),
            "tok/J": max(cells,
                         key=lambda k: cells[k].get("tok_per_joule", 0))}
        print(f"rate={rate}: " + ", ".join(f"best {k}={v}"
                                           for k, v in best.items()))
    return results


if __name__ == "__main__":
    main()
