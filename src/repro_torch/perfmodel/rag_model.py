"""IVF-PQ retrieval configuration (paper §IV-B), copied from
``repro.perfmodel.rag_model.IVFPQConfig`` so that the port imports nothing
of ``repro``; a test holds the two equal field for field.

Only the configuration is copied. The retrieval and rerank cost functions
(``retrieval_time``, ``rerank_time``) stay in the shared simulator, which
prices the ADC scan at ``n_probe * points_per_probe * pq_m`` code bytes;
``chip_smoke.py`` measures that scan on the card at these sizes.
"""
from __future__ import annotations

from dataclasses import dataclass


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

