"""IVF-PQ retrieval + rerank cost model (paper §III-E2, after RAGO/Chameleon).

Stages priced on the retrieval cluster:
  1. query -> centroid distances (nlist x d fp32 matvec, compute-bound)
  2. LUT construction for probed lists (nprobe x K x dsub)
  3. ADC scan over nprobe x points_per_probe codes (memory-bound byte stream —
     this is the loop the ``pq_scan`` Pallas kernel implements on TPU)
  4. top-k + rerank of k docs

Copied from ``repro.perfmodel.rag_model`` so that the port imports nothing
of ``repro``; a test holds the configuration and the costs equal to the
original's. ``chip_smoke.py`` measures the ADC scan (the port's
``pq_scan`` kernel, ``kernels/csrc/pq_scan.cu``) on the card at these
sizes.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.perfmodel.analytical import StageCost
from repro_torch.perfmodel.hardware import ClusterSpec


@dataclass(frozen=True)
class IVFPQConfig:
    n_centroids: int = 4_000_000     # paper §IV-B: 4M centroids
    n_probe: int = 50
    points_per_probe: int = 5_000
    pq_m: int = 16                   # subquantizers per vector
    pq_k: int = 256
    dim: int = 768
    top_k: int = 20
    doc_tokens: int = 512


def retrieval_time(cfg: IVFPQConfig, cluster: ClusterSpec) -> StageCost:
    chip = cluster.chip
    # 1. coarse quantizer matvec
    fl_coarse = 2.0 * cfg.n_centroids * cfg.dim
    # 2. LUT build: K centroids per subquantizer, dsub dims
    dsub = cfg.dim // cfg.pq_m
    fl_lut = 2.0 * cfg.pq_m * cfg.pq_k * dsub
    # 3. ADC scan: one byte per (point, subquantizer) + LUT adds
    n_points = cfg.n_probe * cfg.points_per_probe
    scan_bytes = float(n_points * cfg.pq_m)
    fl_scan = float(n_points * cfg.pq_m)       # adds
    # 4. top-k selection ~ n_points log2(k)
    fl_topk = n_points * 5.0

    fl = fl_coarse + fl_lut + fl_scan + fl_topk
    by = (cfg.n_centroids * cfg.dim * 4.0      # coarse centroids (streamed)
          + scan_bytes)
    t_comp = fl / (cluster.total_flops * chip.mfu_prefill)
    t_mem = by / (cluster.total_bw * chip.mbu_decode)
    t = max(t_comp, t_mem)
    bound = "compute" if t_comp >= t_mem else "memory"
    return StageCost(t, t * chip.power * cluster.n_chips * 0.6, fl, by, bound)


def rerank_time(cfg: IVFPQConfig, cluster: ClusterSpec) -> StageCost:
    """Lightweight cross-scoring of top-k candidate docs."""
    fl = 2.0 * cfg.top_k * cfg.doc_tokens * cfg.dim
    by = cfg.top_k * cfg.doc_tokens * cfg.dim * 2.0
    t = max(fl / (cluster.total_flops * cluster.chip.mfu_prefill),
            by / (cluster.total_bw * cluster.chip.mbu_decode))
    return StageCost(t, t * cluster.chip.power * cluster.n_chips * 0.6, fl, by,
                     "memory")
