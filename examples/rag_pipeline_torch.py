"""RAG pipeline study on the PyTorch port (the twin of
``examples/rag_pipeline.py``): embedding-model placement and the retrieval
memory hierarchy in ``repro_torch.core``, plus a live run of the PQ scan.

    PYTHONPATH=src python examples/rag_pipeline_torch.py
    PYTHONPATH=src python examples/rag_pipeline_torch.py --device cpu

The placement study is host code (analytical pricing, as in the
reference). The live scan runs ``repro_torch.kernels.ops.pq_scan`` on
``--device``: the hand-written CUDA kernel on the card (the default), its
plain version with ``--device cpu``.
"""
import argparse

from repro_torch.core import (SystemSpec, WorkloadConfig, build_system,
                              generate)
from repro_torch.kernels import ops
from repro_torch.launch import rag

N, M, K = 200_000, 16, 256


def main(argv=None):
    """Prints the study; returns (the top-5 ids, every row's distance on
    ``--device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== RAG placement (Fig. 9 compact) ==")
    for on_npu in (False, True):
        coord = build_system(SystemSpec(
            n_llm_clients=1, with_rag=True, rag_embed_on_npu=on_npu,
            with_pre_post=False), device=args.device)
        wl = WorkloadConfig(rate=0.5, n_requests=15, pipeline="rag",
                            postprocess=False, seed=2)
        coord.submit(generate(wl))
        m = coord.run()
        s = m.summary()
        where = "A100 NPU" if on_npu else "Grace CPU"
        print(f"  embed on {where:9s}: ttft_p50={s['ttft_p50']*1e3:7.0f}ms "
              f"e2e_p50={s['e2e_p50']:.2f}s")

    print("== live IVF-PQ ADC scan (the RAG retrieval hot loop) ==")
    codes, lut = rag.make_inputs(N, M, K, seed=0, device=args.device)
    dist = ops.pq_scan(codes, lut)
    top = rag.nearest(dist)
    print(f"  scanned {N} codes x {M} subquantizers; top-5 ids={top}")
    return top, dist


if __name__ == "__main__":
    main()
