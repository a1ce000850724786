"""PyTorch port, speculative decoding: the port's spec ``Engine`` (CPU,
fp32) against the JAX spec ``Engine`` on the same perturbed target and
draft weights (greedy streams, ``spec_stats()`` and ``kv_stats()`` equal
under an ample, a swap-pressured and a recompute-pressured pool), against
the port's plain ``Engine`` (spec == plain), and the model-layer contract:
``verify_step`` position j == sequential ``serve_step``, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.configs import guard_2b as jguard
from repro.engine.runner import Engine as JEngine
from repro.engine.runner import EngineConfig as JEngineConfig
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.configs import guard_2b as tguard
from repro_torch.engine.runner import Engine, EngineConfig
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf


def _fp32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


def _perturbed(jcfg, seed, scale=0.1):
    """JAX init + seeded numpy noise on every leaf (the JAX init zeroes the
    output projections), as numpy arrays."""
    p, _ = jtf.init_model(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + rng.standard_normal(
        a.shape) * scale).astype(np.float32), p)


@pytest.fixture(scope="module")
def models():
    """(cfg, numpy params) of the target (reduced Gemma-2B) and the draft
    (reduced Guard-2B, the JAX spec tests' draft), and a noisy copy of the
    target as a second draft that accepts some tokens and not others."""
    target = _perturbed(_fp32(jgemma.reduced()), 3)
    draft = _perturbed(_fp32(jguard.reduced()), 5)
    rng = np.random.default_rng(23)
    noisy = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.1
                                    ).astype(np.float32), target)
    return {"target": target, "guard": draft, "noisy": noisy}


CFGS = {"target": (_fp32(jgemma.reduced()), _fp32(tgemma.reduced())),
        "guard": (_fp32(jguard.reduced()), _fp32(tguard.reduced())),
        "noisy": (_fp32(jgemma.reduced()), _fp32(tgemma.reduced()))}

# ample: 3 rows, plenty of pages; swap/recompute: 2 rows and a pool too
# small for both, so requests are preempted mid-stream (and mid-fork)
POOLS = {"ample": dict(max_batch=3, max_len=64, block_tokens=8),
         "swap": dict(max_batch=2, max_len=64, block_tokens=8, num_blocks=5,
                      preemption="swap"),
         "recompute": dict(max_batch=2, max_len=64, block_tokens=8,
                           num_blocks=5, preemption="recompute")}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    # two lengths only: every new prompt length retraces the JAX prefill
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (12, 17, 12, 17, 12)]


def _reqs(prompts, pool):
    return (prompts, 10) if pool == "ample" else (prompts[:2], 12)


def _run(eng, reqs, max_new, eos_id=None):
    for p in reqs:
        eng.submit(p, max_new_tokens=max_new, eos_id=eos_id)
    done = eng.run()
    assert len(done) == len(reqs)
    eng.store.check_invariants()
    assert not eng.store.forks and eng.store.used_blocks == 0
    return {r.rid: list(r.tokens) for r in done}


def _port(models, pool, draft=None, k=0):
    tparams = weights.from_jax_params(models["target"], "cpu")
    conf, dparams = EngineConfig(), None
    if draft is not None:
        conf = EngineConfig(draft_cfg=CFGS[draft][1], spec_k=k)
        dparams = weights.from_jax_params(models[draft], "cpu")
    return Engine(CFGS["target"][1], params=tparams, config=conf,
                  draft_params=dparams, device="cpu", **POOLS[pool])


@pytest.fixture(scope="module")
def port_runs(models, prompts):
    """Port engine runs by (draft, spec_k, pool), each run once and shared
    by the tests: (streams, spec_stats or None, kv_stats)."""
    memo = {}

    def get(draft, k, pool):
        key = (draft, k, pool)
        if key not in memo:
            eng = _port(models, pool, draft, k)
            streams = _run(eng, *_reqs(prompts, pool))
            memo[key] = (streams, eng.spec_stats() if draft else None,
                         eng.kv_stats())
        return memo[key]
    return get


@pytest.mark.parametrize("draft,k,pool", [
    ("guard", 2, "ample"), ("guard", 2, "swap"), ("guard", 2, "recompute"),
    ("guard", 4, "ample"), ("guard", 4, "swap"), ("guard", 4, "recompute"),
    ("noisy", 4, "ample"),
])
def test_spec_engine_matches_jax_spec_engine(models, prompts, port_runs,
                                             draft, k, pool):
    jparams = jax.tree.map(jnp.asarray, models["target"])
    jdraft = jax.tree.map(jnp.asarray, models[draft])
    jeng = JEngine(CFGS["target"][0], params=jparams, draft_params=jdraft,
                   config=JEngineConfig(draft_cfg=CFGS[draft][0], spec_k=k),
                   **POOLS[pool])
    want = _run(jeng, *_reqs(prompts, pool))
    got, stats, kv = port_runs(draft, k, pool)
    assert got == want
    assert stats == jeng.spec_stats()
    assert kv == jeng.kv_stats()
    if pool == "swap":
        assert kv["swap_outs"] >= 1 and kv["swap_ins"] >= 1
    elif pool == "recompute":
        assert kv["recompute_drops"] >= 1
    if draft == "noisy":
        assert 0 < stats["acceptance_per_position"][0] < 1


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("pool", ["ample", "swap", "recompute"])
def test_spec_engine_equals_plain_engine(port_runs, k, pool):
    """spec == plain inside the port: the speculative streams equal plain
    greedy decode's, and every token after the first came from a verify
    pass."""
    base, _, _ = port_runs(None, 0, pool)
    got, stats, _ = port_runs("guard", k, pool)
    assert got == base
    assert stats["emitted"] == sum(len(t) - 1 for t in base.values())


def test_perfect_draft_accepts_everything(models, prompts, port_runs):
    """Draft == target: every draft token is accepted and rows commit
    k + 1 tokens per pass away from the stop bounds."""
    eng = _port(models, "ample", "target", 3)
    got = _run(eng, prompts, 10)
    assert got == port_runs(None, 0, "ample")[0]
    st = eng.spec_stats()
    assert st["acceptance_per_position"] == [1.0, 1.0, 1.0]
    assert st["conditional_acceptance_per_position"] == [1.0, 1.0, 1.0]
    assert st["tokens_per_step"] > 2.0


def test_eos_mid_acceptance_stops_the_row(models, prompts, port_runs):
    """EOS inside an accepted run truncates the stream exactly where
    sequential decode stops (a perfect draft accepts past it)."""
    base = port_runs(None, 0, "ample")[0]
    eos = base[0][3]
    outs = []
    for draft, k in ((None, 0), ("target", 4)):
        eng = _port(models, "ample", draft, k)
        outs.append(_run(eng, prompts, 10, eos_id=int(eos)))
    assert outs[0] == outs[1]
    assert outs[0][0][-1] == eos and len(outs[0][0]) <= 4


def test_verify_step_matches_sequential_decode_bitwise(models):
    """One verify pass of s fed tokens against s sequential one-token
    decode steps on the same prefilled paged cache: per-position logits
    and argmaxes bit-identical (fp32 on the CPU, where matrix products and
    reductions do not depend on the number of rows)."""
    cfg = CFGS["target"][1]
    params = weights.from_jax_params(models["target"], "cpu")
    rng = np.random.default_rng(2)
    P, s, bt, max_len = 40, 4, 16, 96
    mb, nb = max_len // bt, 2 * (max_len // bt)
    prompt = rng.integers(1, cfg.vocab_size, P).astype(np.int32)
    draft = torch.tensor(rng.integers(1, cfg.vocab_size, s).astype(np.int32))

    def fresh():
        _, dense = tsteps.prefill_step(
            params, {"tokens": torch.tensor(prompt[None])}, cfg, max_len)
        caches = ttf.init_paged_cache(cfg, 2, nb, bt, mb, "cpu")
        tsteps.write_prefill_pages(caches, dense, torch.arange(mb),
                                   block_tokens=bt)
        tabs = torch.full((2, mb), nb, dtype=torch.int32)
        tabs[0] = torch.arange(mb)             # row 0 live, row 1 dead/trash
        g = caches["attn"]
        g["block_tables"] = tabs[None].expand(cfg.num_layers, 2, mb)
        g["length"] = torch.tensor([P, 0], dtype=torch.int32)[None].expand(
            cfg.num_layers, 2)
        return caches

    caches, seq = fresh(), []
    for j in range(s):
        tok = torch.tensor([[int(draft[j])], [0]], dtype=torch.int32)
        _, logits, caches = tsteps.serve_step(params, tok, caches, cfg)
        seq.append(logits[0])
    feed = torch.zeros(2, s, dtype=torch.int32)
    feed[0] = draft
    greedy, logits, caches = tsteps.verify_step(
        params, feed, torch.tensor([s, 0], dtype=torch.int32), fresh(), cfg)
    assert logits.shape == (2, s, cfg.vocab_size)
    assert caches["attn"]["length"][0].tolist() == [P + s, 0]
    for j in range(s):
        assert torch.equal(logits[0, j], seq[j]), j
        assert int(greedy[0, j]) == int(torch.argmax(seq[j])), j
