"""PyTorch port, disaggregated serving: the port's ``DisaggEngine``
(``repro_torch.engine.workers``, on the CPU) against the JAX package at fp32
on the same perturbed weights and the JAX test's geometry and prompts.
Greedy streams must equal the JAX single ``Engine``'s and the port's
``oracle_engine``'s across pairing mode, transfer granularity, chunked
prefill workers and preemption on the decode side; handoff and pool
counters must equal the JAX ``DisaggEngine``'s. Also the pieces:
``move_pages``, ``handoff_devices``, ``fit_link_spec`` and ``LinkSpec``
against their JAX twins, and the roles' compiled passes."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.engine.workers import DisaggEngine as JDisagg
from repro.engine.workers import oracle_engine as joracle
from repro.models import transformer as jtf
from repro.perfmodel import hardware as jhw
from repro.perfmodel.regression import fit_link_spec as jfit
from repro_torch import weights
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.engine.core import EngineConfig
from repro_torch.engine.workers import (DecodeWorker, DisaggEngine,
                                        PrefillWorker, move_pages,
                                        oracle_engine)
from repro_torch.launch import mesh
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.perfmodel import hardware as thw
from repro_torch.perfmodel.regression import fit_link_spec

OUT_TOKENS = 8
GEOM = dict(max_batch=2, max_len=96, block_tokens=16)


def _fp32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    """Reduced Gemma-2B at fp32 with every leaf perturbed by seeded numpy
    noise (the JAX init zeroes the output projections), handed to both."""
    jcfg = _fp32(jgemma.reduced())
    p, _ = jtf.init_model(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    pn = jax.tree.map(lambda a: (np.asarray(a) + rng.standard_normal(
        a.shape) * 0.1).astype(np.float32), p)
    return (jcfg, jax.tree.map(jnp.asarray, pn), _fp32(tgemma.reduced()),
            weights.from_jax_params(pn, "cpu"))


@pytest.fixture(scope="module")
def prompts(models):
    """The JAX test's prompts: a shared 32-token (2-block) prefix and short
    tails of two lengths."""
    rng = np.random.default_rng(5)
    sysp = rng.integers(0, models[0].vocab_size, 32)
    return [np.concatenate([sysp, rng.integers(0, models[0].vocab_size, n)])
            .astype(np.int32) for n in (6, 11, 6, 11)]


@pytest.fixture(scope="module")
def pressure_prompts(models):
    """The JAX test's pressure prompts: no shared prefix, lengths that cross
    a block boundary mid-decode, so two rows overflow a 6-page decode pool
    when one grows."""
    rng = np.random.default_rng(23)
    return [rng.integers(0, models[0].vocab_size, n).astype(np.int32)
            for n in (44, 46, 44, 46)]


def _streams(eng, prompts):
    hs = [eng.submit(p, max_new_tokens=OUT_TOKENS) for p in prompts]
    eng.run()
    assert all(h.state == "done" for h in hs)
    return [list(h.tokens) for h in hs]


@pytest.fixture(scope="module")
def oracle(models, prompts, pressure_prompts):
    """The JAX single ``Engine``'s streams on both prompt sets (one engine
    each), and the port's ``oracle_engine``'s, which must equal them."""
    jcfg, jparams, tcfg, tparams = models
    out = {}
    for name, ps in (("plain", prompts), ("pressure", pressure_prompts)):
        want = _streams(joracle(jcfg, jparams, **GEOM), ps)
        got = _streams(oracle_engine(tcfg, tparams, device="cpu", **GEOM), ps)
        assert got == want
        out[name] = want
    return out


def _disagg(models, prompts, **kw):
    eng = DisaggEngine(models[2], models[3], device="cpu", **GEOM, **kw)
    got = _streams(eng, prompts)
    for w in eng.prefill + eng.decode:
        w.store.check_invariants()
    return got, eng


# ---------------------------------------------------------------------------
# streams: pairing mode x granularity, chunked prefill, preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("gran", ["full", "layerwise"])
def test_disagg_streams_match_jax_engine(models, prompts, oracle, mode, gran):
    got, eng = _disagg(models, prompts, n_prefill=1, n_decode=2, mode=mode,
                       granularity=gran)
    assert got == oracle["plain"]
    ts = eng.transfer_stats()
    assert ts["handoffs"] == len(prompts) and ts["bytes"] > 0
    assert ts["exposed_s"] <= ts["total_s"] and not ts["cross_device"]
    n_layers = models[2].num_layers
    assert len(ts["samples"]) == (len(prompts) * n_layers
                                  if gran == "layerwise" else len(prompts))


def test_disagg_chunked_prefill_matches_jax_engine(models, prompts, oracle):
    got, eng = _disagg(models, prompts, n_prefill=2, n_decode=1,
                       mode="global", granularity="layerwise",
                       config=EngineConfig(chunk_size=8))
    assert got == oracle["plain"]
    assert eng.transfer_stats()["handoffs"] == len(prompts)
    assert set(eng.passes()) == {"prefill0.chunk", "prefill1.chunk",
                                 "decode0.decode"}


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_disagg_preemption_matches_jax_engine(models, pressure_prompts,
                                              oracle, policy):
    """A 6-page decode pool preempts on the decode side of the handoff:
    swap victims round-trip against that pool, recompute victims go back to
    their prefill worker and hand off again; streams stay the same."""
    got, eng = _disagg(models, pressure_prompts, preemption=policy,
                       decode_blocks=6)
    assert got == oracle["pressure"]
    kv = eng.kv_stats()
    assert sum(w["page_faults"] for w in kv.values()) >= 1
    handoffs = eng.transfer_stats()["handoffs"]
    if policy == "swap":
        assert kv["decode0"]["swap_outs"] >= 1
        assert handoffs == len(pressure_prompts)
    else:
        assert kv["decode0"]["recompute_drops"] >= 1
        assert handoffs > len(pressure_prompts)


# ---------------------------------------------------------------------------
# counters against the JAX DisaggEngine
# ---------------------------------------------------------------------------

SCHEDULES = {
    "global-layerwise": ("plain", dict(n_prefill=1, n_decode=2,
                                       mode="global",
                                       granularity="layerwise")),
    "recompute": ("pressure", dict(preemption="recompute", decode_blocks=6)),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_handoff_and_pool_counters_match_jax_disagg(models, prompts,
                                                    pressure_prompts,
                                                    schedule):
    """Same schedule on both sides: handoffs, bytes (the pools are bf16 at
    every compute dtype), pages and decode-side dedup, and every worker's
    ``kv_stats()``."""
    which, kw = SCHEDULES[schedule]
    ps = prompts if which == "plain" else pressure_prompts
    jeng = JDisagg(models[0], models[1], **GEOM, **kw)
    want = _streams(jeng, ps)
    got, teng = _disagg(models, ps, **kw)
    assert got == want
    jts, tts = jeng.transfer_stats(), teng.transfer_stats()
    for key in ("handoffs", "bytes", "pages", "dedup_blocks", "granularity",
                "mode"):
        assert tts[key] == jts[key], key
    assert [b for b, _ in tts["samples"]] == [b for b, _ in jts["samples"]]
    assert teng.kv_stats() == jeng.kv_stats()


def test_decode_side_prefix_dedup(models, prompts):
    """Handoffs sharing a prefix into one decode worker alias its resident
    chain: the import skips the pool write for matched pages and counts
    them as dedup, not as prefix-cache hits."""
    _, eng = _disagg(models, prompts, n_prefill=1, n_decode=1)
    assert eng.transfer_stats()["dedup_blocks"] >= 2
    assert eng.decode[0].store.prefix_hit_blocks == 0


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gran", ["full", "layerwise"])
def test_move_pages_counts_bytes_and_keeps_values(models, gran):
    cfg = models[2]
    caches = ttf.init_paged_cache(cfg, 1, 4, 16, 4, "cpu")
    g = caches["attn"]
    gen = torch.Generator().manual_seed(0)
    for key in ("k_pool", "v_pool"):
        g[key].copy_(torch.randn(g[key].shape, generator=gen))
    pages = tsteps.gather_pages(caches, torch.tensor([0, 2]))
    staged, rec = move_pages(pages, None, gran)
    want = sum(t.numel() * t.element_size()
               for grp in pages.values() for t in grp.values())
    assert rec["bytes"] == want and rec["pages"] == 2
    assert rec["layers"] == cfg.num_layers and rec["staged"] == "host"
    assert rec["granularity"] == gran
    assert rec["exposed_s"] <= rec["total_s"]
    assert sum(b for b, _ in rec["samples"]) == want
    assert len(rec["samples"]) == (cfg.num_layers if gran == "layerwise"
                                   else 1)
    for name, grp in staged.items():
        for key in ("k", "v"):
            assert torch.equal(grp[key], pages[name][key])
            assert grp[key].device.type == "cpu"
    with pytest.raises(ValueError):
        move_pages(pages, None, "pagewise")


def test_handoff_devices_splits_the_roles(monkeypatch):
    if torch.cuda.device_count() < 2:
        assert mesh.handoff_devices(2, 3) == ([None] * 2, [None] * 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    pd, dd = mesh.handoff_devices(3, 3)
    cuda = lambda *ix: [torch.device("cuda", i) for i in ix]  # noqa: E731
    assert pd == cuda(0, 1, 0) and dd == cuda(2, 3, 2)
    assert not set(pd) & set(dd)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.handoff_devices(1, 2) == (cuda(0), cuda(1, 2))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.handoff_devices(1, 1) == ([None], [None])


@pytest.mark.parametrize("samples", [
    [(b, 2e-4 + b / 5e8) for b in (1e4, 1e5, 1e6, 4e6)],   # exact alpha-beta
    [(1e6, 1e-3)],                                         # one sample
    [(1e6, 1e-3), (1e6, 2e-3)],                            # one size
    [(1e4, 5e-3), (1e6, 1e-3)],                            # negative slope
    [(3e5, 1.1e-4), (7e5, 1.9e-4), (2e6, 6.3e-4), (9e4, 9e-5)],
])
def test_fit_link_spec_matches_jax(samples):
    got, want = fit_link_spec(samples), jfit(samples)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.bandwidth > 0 and got.latency >= 0


def test_link_spec_and_fit_edges_match_jax():
    assert ([f.name for f in dataclasses.fields(thw.LinkSpec)]
            == [f.name for f in dataclasses.fields(jhw.LinkSpec)])
    assert fit_link_spec([(1.0, 1.0)], "x").name == "x"
    for fit in (fit_link_spec, jfit):
        with pytest.raises(ValueError):
            fit([])


def test_roles_compile_only_their_passes(models):
    """A prefill worker never decodes and a decode worker never chunks:
    each compiles only its role's pass of what the configuration asks for;
    neither takes speculative decoding."""
    cfg, params = models[2], models[3]
    kw = dict(device="cpu", **GEOM)
    chunked = EngineConfig(chunk_size=8)
    assert PrefillWorker(cfg, params, **kw).passes() == {}
    assert set(PrefillWorker(cfg, params, config=chunked, **kw).passes()) \
        == {"chunk"}
    for config in (None, chunked):
        assert set(DecodeWorker(cfg, params, config=config,
                                **kw).passes()) == {"decode"}
    spec = EngineConfig(draft_cfg=cfg, spec_k=2)
    for role in (PrefillWorker, DecodeWorker):
        with pytest.raises(ValueError):
            role(cfg, params, config=spec, **kw)
    with pytest.raises(ValueError):
        DisaggEngine(cfg, params, config=spec, **kw)


def test_disagg_defaults_to_cuda():
    sig = inspect.signature(DisaggEngine.__init__).parameters
    assert sig["device"].default == "cuda" and sig["cuda_graphs"].default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):          # loud, no CPU fallback
            DisaggEngine(tgemma.reduced(), max_batch=1, max_len=64)
