"""PyTorch port, engine: the port's paged ``Engine`` (CPU) against the JAX
``Engine`` at fp32 on the same perturbed weights and the same schedule —
greedy token streams, ``kv_stats()`` and occupancy traces must be equal
under an ample, a swap-pressured and a recompute-pressured pool — the
port's dense ``SlotEngine`` against JAX's and against the port's paged
``Engine``, plus the copied ``PagedKVStore`` against JAX's on one seeded
random walk."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.engine.paged_kv import PagedKVStore as JStore
from repro.engine.paged_kv import prefix_chain as jchain
from repro.engine.runner import Engine as JEngine
from repro.engine.runner import EngineRequest as JRequest
from repro.engine.runner import SlotEngine as JSlotEngine
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import MLAConfig
from repro_torch.engine import core
from repro_torch.engine.paged_kv import PagedKVStore as TStore
from repro_torch.engine.paged_kv import prefix_chain as tchain
from repro_torch.engine.runner import (Engine, EngineConfig, SlotEngine,
                                       make_engine)
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf


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
def prompts():
    rng = np.random.default_rng(3)
    # two lengths only: every new prompt length retraces the JAX prefill
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (12, 17, 12, 17, 12)]


def _run(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run()
    return {r.rid: list(r.tokens) for r in done}


@pytest.mark.parametrize("pool", ["ample", "swap", "recompute"])
def test_engine_matches_jax_engine(models, prompts, pool):
    jcfg, jparams, tcfg, tparams = models
    if pool == "ample":
        kw = dict(max_batch=2, max_len=64, block_tokens=16)
        reqs, max_new = prompts, 5
    else:       # too small for both requests: real mid-stream preemption
        kw = dict(max_batch=2, max_len=64, block_tokens=8, num_blocks=5,
                  preemption=pool)
        reqs, max_new = prompts[:2], 12
    jeng = JEngine(jcfg, params=jparams, trace_occupancy=True, **kw)
    teng = Engine(tcfg, params=tparams, trace_occupancy=True, device="cpu",
                  **kw)
    want = _run(jeng, reqs, max_new)
    got = _run(teng, reqs, max_new)
    assert got == want
    assert all(len(t) == max_new for t in got.values())
    assert teng.kv_stats() == jeng.kv_stats()
    assert teng.occupancy == jeng.occupancy and teng.occupancy
    st = teng.kv_stats()
    if pool == "swap":
        assert st["swap_outs"] >= 1 and st["swap_ins"] >= 1
    elif pool == "recompute":
        assert st["recompute_drops"] >= 1
    if pool != "ample":
        assert any(r.preemptions for r in teng.finished)
    teng.store.check_invariants()
    assert teng.store.used_blocks == 0


@pytest.fixture(scope="module")
def slot_streams(models, prompts):
    """The port's SlotEngine streams (run once, shared by two tests)."""
    _, _, tcfg, tparams = models
    eng = SlotEngine(tcfg, params=tparams, max_batch=2, max_len=64,
                     device="cpu")
    return _run(eng, prompts, 5)


def test_slot_engine_matches_jax_slot_engine(models, prompts, slot_streams):
    jcfg, jparams, _, _ = models
    want = _run(JSlotEngine(jcfg, params=jparams, max_batch=2, max_len=64),
                prompts, 5)
    assert slot_streams == want
    assert all(len(t) == 5 for t in want.values())


def test_paged_engine_matches_slot_engine(models, prompts, slot_streams):
    """paged == dense, the JAX package's bit-exactness oracle, inside the
    port (JAX ``tests/test_paged_engine.py``)."""
    _, _, tcfg, tparams = models
    eng = Engine(tcfg, params=tparams, max_batch=2, max_len=64,
                 block_tokens=16, device="cpu")
    assert _run(eng, prompts, 5) == slot_streams
    eng.store.check_invariants()
    assert eng.store.used_blocks == 0


def test_request_itl_matches_jax_request(models, prompts):
    """``EngineRequest.itl`` on one served schedule: each finished
    request's gaps between streamed tokens equal those the JAX request
    gives for the same token times."""
    _, _, tcfg, tparams = models
    eng = Engine(tcfg, params=tparams, max_batch=2, max_len=64,
                 block_tokens=16, device="cpu")
    _run(eng, prompts, 5)
    for r in eng.finished:
        want = JRequest(rid=r.rid, prompt=r.prompt,
                        token_times=list(r.token_times)).itl
        assert r.itl == want
        assert len(r.itl) == len(r.tokens) - 1 == 4
        assert all(x >= 0 for x in r.itl)


def test_slot_engine_dense_cache_clamps_stale_lengths(models):
    """A dead slot keeps its stale length and grows it every step; the
    dense decode writes at ``min(length, S - 1)``, as JAX's
    ``dynamic_update_slice`` clamps, and its row stays finite."""
    _, _, tcfg, tparams = models
    eng = SlotEngine(tcfg, params=tparams, max_batch=2, max_len=16,
                     device="cpu")
    eng.caches["attn"]["length"][:, 1] = 15
    for _ in range(3):
        tok, logits, eng.caches = tsteps.serve_step(
            tparams, torch.zeros(2, 1, dtype=torch.int32), eng.caches, tcfg)
    assert eng.caches["attn"]["length"][:, 1].tolist() == [18, 18]
    assert torch.isfinite(logits).all() and eng.caches["attn"]["k"][
        :, 1, 15].abs().sum() > 0


def test_prefix_sharing_dedups_like_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(17)
    sysp = rng.integers(0, 512, 32)                # 2 full blocks of 16
    reqs = [np.concatenate([sysp, rng.integers(0, 512, 5)]).astype(np.int32)
            for _ in range(4)]
    kw = dict(max_batch=4, max_len=64, block_tokens=16)
    jeng = JEngine(jcfg, params=jparams, **kw)
    teng = Engine(tcfg, params=tparams, device="cpu", **kw)
    assert _run(teng, reqs, 3) == _run(jeng, reqs, 3)
    st = teng.kv_stats()
    assert st == jeng.kv_stats()
    assert st["prefix_hit_blocks"] >= 6 and st["dedup_ratio"] > 1.0
    teng.store.check_invariants()


def test_manual_preempt_keeps_tokens_and_requeues_fifo(models):
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(9)
    eng = Engine(tcfg, params=tparams, max_batch=1, max_len=64,
                 block_tokens=16, device="cpu")
    first = eng.submit(rng.integers(0, 512, 8), max_new_tokens=6)
    eng._admit()
    eng._step_decode()
    eng._step_decode()
    generated = list(first.tokens)
    later = eng.submit(rng.integers(0, 512, 8), max_new_tokens=4)
    eng.preempt_slot(0)
    assert [r.rid for r in eng.waiting] == [first.rid, later.rid]
    assert first.state == "swapped"
    done = eng.run()
    assert done[0] is first and first.tokens[:3] == generated
    assert len(first.tokens) == 6 and len(later.tokens) == 4


def test_store_matches_jax_store_on_random_walk():
    """The copied PagedKVStore and JAX's return the same blocks at every
    step of one seeded walk of allocate / grow / free / swap / swap-in."""
    rng = np.random.default_rng(0)
    bt = 4
    stores = (JStore(10, bt), TStore(10, bt))
    chains = (jchain, tchain)
    live, rid = [], 0
    for _ in range(300):
        op, arg = int(rng.integers(0, 5)), int(rng.integers(1, 30))
        outs = []
        for st, chain in zip(stores, chains):
            if op == 0:
                outs.append(st.allocate(rid, arg, chain(
                    list(range(min(arg, 3 * bt))), bt)))
            elif op == 1 and live:
                r = live[arg % len(live)]
                if st.tables[r].on_device:
                    b = st.grow(r) if st.needs_block(r) else -1
                    if b is not None:
                        st.advance(r)
                    outs.append(b)
            elif op == 2 and live:
                st.free(live[arg % len(live)])
            elif op == 3 and live:
                r = live[arg % len(live)]
                if st.tables[r].on_device:
                    got = st.swap_out(r)
                    if got is None:
                        st.drop(r)
                    outs.append(got)
            elif op == 4 and live:
                r = live[arg % len(live)]
                if not st.tables[r].on_device:
                    outs.append(st.swap_in(r))
            st.check_invariants()
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:]
        assert stores[0].stats() == stores[1].stats()
        if op == 0:
            if outs[0] is not None:
                live.append(rid)
            rid += 1
        elif op == 2 and live:
            live.pop(arg % len(live))
        elif op == 3 and live and outs and outs[0] is None:
            live.remove(live[arg % len(live)])
    st = stores[1].stats()
    assert st["swap_outs"] and st["admission_failures"]
    assert st["prefix_hit_blocks"]


def test_paths_of_later_slices_raise(models):
    """Chunked prefill, speculative decoding and dense decode run; MLA
    and the recurrent families (the reduced zamba2_7b and xlstm_1_3b) give
    the SlotEngine; a GQA MoE raises naming the later slices; training
    runs for GQA (full-sequence logits, no caches), MLA's is admitted
    (every family trains) and a GQA MoE's raises naming the later
    slices."""
    _, _, tcfg, tparams = models
    kw = dict(params=tparams, max_batch=1, max_len=64, device="cpu")
    chunked = Engine(tcfg, config=EngineConfig(chunk_size=8), **kw)
    chunked.submit(np.arange(21, dtype=np.int32), max_new_tokens=4)
    assert len(chunked.run()[0].tokens) == 4 and chunked.store.used_blocks == 0
    spec = Engine(tcfg, config=EngineConfig(draft_cfg=tcfg, spec_k=2),
                  draft_params=tparams, **kw)
    spec.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
    assert len(spec.run()[0].tokens) == 4 and spec.spec_iters > 0
    mla = tcfg.replace(attn_type="mla", mla=MLAConfig(
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16))
    assert isinstance(make_engine(mla, max_batch=1, max_len=64,
                                  block_tokens=16, device="cpu"), SlotEngine)
    for arch in ("zamba2_7b", "xlstm_1_3b"):
        rec = get_reduced_config(arch)
        assert isinstance(make_engine(rec, max_batch=1, max_len=64,
                                      block_tokens=16, device="cpu"),
                          SlotEngine)
    with pytest.raises(NotImplementedError, match="later slices"):
        make_engine(tcfg.replace(family="moe"), **kw)
    cache = ttf.init_cache(tcfg, 1, 8, "cpu")
    out, new = tattn.gqa_decode(
        ttf.layer_slice(tparams["layers"], 0)["attn"],
        torch.ones(1, 1, tcfg.d_model), tcfg, ttf.layer_slice(cache["attn"], 0))
    assert out.shape == (1, 1, tcfg.d_model) and new["length"].tolist() == [1]
    tokens = torch.zeros(1, 4, dtype=torch.int32)
    logits, caches = ttf.forward(tparams, tcfg, tokens=tokens, mode="train")
    assert logits.shape == (1, 4, tcfg.vocab_size) and caches is None
    ttf.check_train(mla)
    with pytest.raises(NotImplementedError, match="later slices"):
        ttf.forward(tparams, tcfg.replace(family="moe"), tokens=tokens,
                    mode="train")
    assert isinstance(make_engine(tcfg, **kw), Engine)


def test_entry_points_default_to_cuda():
    for fn in (core.EngineCore.__init__, core.SlotEngine.__init__,
               ttf.init_model, ttf.init_cache, ttf.init_paged_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):          # loud, no CPU fallback
            Engine(tgemma.reduced(), max_batch=1, max_len=64)


def test_serve_cli_runs_on_cpu(capsys):
    done = serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "4", "--max-len", "64"])
    assert len(done) == 3 and all(len(r.tokens) == 4 for r in done)
    assert "device=cpu" in capsys.readouterr().out
