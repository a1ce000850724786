"""System assembly: builds a full HERMES serving setup (Fig. 4d) from a
compact spec — N LLM clients (any batching strategy, incl. disaggregated
prefill/decode pools), pre/post-processing, RAG and KV-retrieval clients,
wired through a hierarchical network.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.client import (
    Client, KVRetrievalClient, LLMClient, PostprocessClient, PreprocessClient,
    RAGClient)
from repro_torch.core.comm import Network
from repro_torch.core.coordinator import Coordinator, CoordinatorConfig
from repro_torch.core.llm_scheduler import ClientPerf, SchedulerLimits
from repro_torch.core.router import make_router
from repro_torch.perfmodel import rag_model
from repro_torch.perfmodel.hardware import (
    CacheTierSpec, ClusterSpec, GRACE_CPU, H100, LinkSpec, NVLINK, ETH_RACK,
    PCIE4_X4, SPR_CPU, TIER_PLATFORM, TIER_LOCAL_LPDDR, TIER_RACK)


@dataclass
class SystemSpec:
    model: str = "llama3-70b"
    n_llm_clients: int = 4
    strategy: str = "continuous"        # or "disaggregated"
    n_prefill: int = 0                  # used when strategy == "disaggregated"
    n_decode: int = 0
    tp: int = 2
    chips_per_client: int = 2
    chip: str = "H100"
    limits: SchedulerLimits = field(default_factory=SchedulerLimits)
    packing: str = "fcfs"
    router_policy: str = "load_based"
    router_metric: str = "tokens_remaining"
    disaggregation: str = "global"
    kv_transfer_granularity: str = "layerwise"
    with_rag: bool = False
    rag_colocated: bool = False
    rag_embed_on_npu: bool = False
    with_kv_retrieval: bool = False
    kv_tiers: Tuple[CacheTierSpec, ...] = (TIER_PLATFORM, TIER_RACK)
    with_pre_post: bool = True
    use_regression: bool = False
    straggler_deadline: Optional[float] = None
    embed_model: Optional[ModelConfig] = None
    # cross-client radix prefix migration
    prefix_migration: bool = False
    migration_granularity: Optional[str] = None  # default: kv_transfer_gran.
    warm_on_scale_out: bool = True
    warm_max_blocks: int = 256
    # prefix_affinity fetch policy: warm-client overload factor beyond which
    # requests route load-best and the prefix migrates (None = affinity only)
    fetch_load_factor: Optional[float] = None
    # fleet-scale routing indexes (decision-identical to the linear scan);
    # False forces the O(N) baseline — the benchmark's A/B arm
    fleet_index: bool = True


def _embed_model_small() -> ModelConfig:
    """E5-base-class embedding model (paper §IV-B)."""
    from repro_torch.configs.base import ModelConfig as MC
    return MC(name="e5-base", family="dense", num_layers=12, d_model=768,
              num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=30522,
              mlp_type="gelu", attn_type="gqa", encoder_only=True)


def _guard_model_2b() -> ModelConfig:
    """Kept as a thin alias into the config registry (the canonical home is
    ``configs/guard_2b.py``; simulator callers import it from here)."""
    from repro_torch.configs import get_config
    return get_config("guard_2b")


def build_system(spec: SystemSpec, device="cuda") -> Coordinator:
    """The ``Coordinator`` of ``spec``; ``device`` is where the clients'
    shared ``ClientPerf`` fits its ridge models when
    ``spec.use_regression`` (unused otherwise)."""
    from repro_torch.perfmodel.hardware import CHIPS
    chip = CHIPS[spec.chip]
    model_cfg = get_config(spec.model)
    cluster = ClusterSpec(chip, n_chips=spec.chips_per_client, tp=spec.tp,
                          intra_link=NVLINK)
    perf = ClientPerf(model_cfg, cluster, use_regression=spec.use_regression,
                      device=device)

    clients: List[Client] = []
    net = Network()
    net.add_link("nvlink", NVLINK)
    net.add_link("rack", ETH_RACK)
    net.add_link("pcie", PCIE4_X4)
    net.set_default_path(["rack"])

    if spec.strategy == "disaggregated":
        n_p = spec.n_prefill or max(1, spec.n_llm_clients // 2)
        n_d = spec.n_decode or max(1, spec.n_llm_clients - n_p)
        n_groups = max(1, min(n_p, n_d))
        for i in range(n_p):
            clients.append(LLMClient(f"prefill{i}", cluster, model_cfg,
                                     "prefill_only", spec.limits, spec.packing,
                                     perf, group=f"g{i % n_groups}"))
        for i in range(n_d):
            clients.append(LLMClient(f"decode{i}", cluster, model_cfg,
                                     "decode_only", spec.limits, spec.packing,
                                     perf, group=f"g{i % n_groups}"))
        # prefill->decode KV rides the rack fabric (local pairs ride nvlink)
        for i in range(n_p):
            for j in range(n_d):
                local = spec.disaggregation == "local" and (i % n_groups) == (j % n_groups)
                net.connect(f"prefill{i}", f"decode{j}",
                            ["nvlink"] if local else ["rack"])
    else:
        for i in range(spec.n_llm_clients):
            clients.append(LLMClient(f"llm{i}", cluster, model_cfg,
                                     spec.strategy, spec.limits, spec.packing,
                                     perf))

    if spec.with_pre_post:
        cpu = ClusterSpec(SPR_CPU, n_chips=1, tp=1)
        clients.append(PreprocessClient("preproc0", cpu))
        clients.append(PostprocessClient("postproc0", cpu))

    if spec.with_rag:
        ivf = rag_model.IVFPQConfig()
        emb = spec.embed_model or _embed_model_small()
        if spec.rag_colocated:
            cpu = ClusterSpec(GRACE_CPU, n_chips=1, tp=1)
            clients.append(RAGClient("rag0", cpu, emb, ivf,
                                     serve_embed=True, serve_retrieve=True))
        else:
            embed_cluster = (ClusterSpec(CHIPS["A100"], 1, 1)
                             if spec.rag_embed_on_npu
                             else ClusterSpec(GRACE_CPU, 1, 1))
            clients.append(RAGClient("rag_embed0", embed_cluster, emb, ivf,
                                     serve_embed=True, serve_retrieve=False))
            clients.append(RAGClient("rag_retrieve0",
                                     ClusterSpec(GRACE_CPU, 1, 1), emb, ivf,
                                     serve_embed=False, serve_retrieve=True))
            net.connect("rag_embed0", "rag_retrieve0", ["pcie"])
        for c in clients:
            if isinstance(c, LLMClient):
                net.connect("rag_retrieve0" if not spec.rag_colocated else "rag0",
                            c.name, ["pcie"])

    if spec.with_kv_retrieval:
        from repro_torch.perfmodel import analytical as ana
        kvb = ana.kv_bytes_per_token(model_cfg)
        recompute = lambda size: ana.prefill_time(
            model_cfg, cluster, max(1, int(size / max(kvb, 1.0)))).time
        clients.append(KVRetrievalClient(
            "kvret0", ClusterSpec(GRACE_CPU, 1, 1), spec.kv_tiers,
            kv_bytes_per_token=kvb, recompute_fn=recompute))

    # each LLM client spills preempted KV pages over its own PCIe path so
    # swap traffic contends with that client's other host-side transfers
    for c in clients:
        if isinstance(c, LLMClient):
            net.add_link(f"pcie:{c.name}", PCIE4_X4)
            net.connect(c.name, f"{c.name}:kvpool", [f"pcie:{c.name}"])

    router_kw = {}
    if spec.router_policy == "prefix_affinity" \
            and spec.fetch_load_factor is not None:
        router_kw["fetch_load_factor"] = spec.fetch_load_factor
    router = make_router(spec.router_policy, spec.router_metric, **router_kw)
    coord = Coordinator(clients, router, net, CoordinatorConfig(
        disaggregation=spec.disaggregation,
        kv_transfer_granularity=spec.kv_transfer_granularity,
        straggler_deadline=spec.straggler_deadline,
        prefix_migration=spec.prefix_migration,
        migration_granularity=spec.migration_granularity,
        warm_on_scale_out=spec.warm_on_scale_out,
        warm_max_blocks=spec.warm_max_blocks,
        fleet_index=spec.fleet_index))
    return coord
