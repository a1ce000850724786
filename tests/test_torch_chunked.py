"""PyTorch port, chunked prefill with mixed iterations: the plain
``paged_chunk_attention`` against JAX's oracle; a prompt prefilled chunk by
chunk through ``chunk_step`` against one whole ``prefill_step``, bit for
bit; ``chunk_step`` logits against JAX's; the chunked ``Engine``'s greedy
streams against the port's ``SlotEngine`` and the JAX chunked ``Engine``
across chunk size and preemption; twins of the JAX engine-layer and
store-layer tests of ``tests/test_chunked_prefill.py``.

Dtypes. Whole prefill attends over K/V in the compute dtype and writes them
to the bf16 pools; a chunk pass attends over what the pools hold. So
chunked == whole holds bit for bit where the compute dtype is bf16, as in
the JAX test (the JAX package differs there too at fp32, by the pools'
rounding). Comparisons with JAX run at fp32, where the two frameworks
differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.engine.runner import Engine as JEngine
from repro.engine.runner import EngineConfig as JEngineConfig
from repro.kernels import ref as jref
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.engine.paged_kv import PagedKVStore, prefix_chain
from repro_torch.engine.runner import Engine, EngineConfig, SlotEngine
from repro_torch.kernels import ops, ref
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

MAX_LEN = 96
BT = 16
# as tests/test_torch_models.py: fp32 differs only in summation order;
# bf16 rounds at other points in the two frameworks (four ulps at |5.7|)
LOGITS_FP32_ATOL = 1e-4
LOGITS_BF16_ATOL = 0.125


def _cfgs(dtype):
    return (jgemma.reduced().replace(param_dtype=dtype, compute_dtype=dtype),
            tgemma.reduced().replace(param_dtype=dtype, compute_dtype=dtype))


@pytest.fixture(scope="module")
def weights_np():
    """JAX init of reduced Gemma-2B plus seeded numpy noise on every leaf
    (the JAX init zeroes the output projections), as fp32 numpy arrays."""
    p, _ = jtf.init_model(_cfgs("float32")[0], jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda a: (np.asarray(a) + rng.standard_normal(
        a.shape) * 0.1).astype(np.float32), p)


def _models(weights_np, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), weights_np)
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def fp32(weights_np):
    return _models(weights_np, "float32")


@pytest.fixture(scope="module")
def bf16(weights_np):
    return _models(weights_np, "bfloat16")


# ---------------------------------------------------------------------------
# kernel layer: the plain version against JAX's oracle
# ---------------------------------------------------------------------------

def test_plain_chunk_attention_matches_jax_ref():
    """GQA, an unaligned chunk (s = 5 over bt = 4), dead table entries on
    the trash page, large garbage in unused pages and the trash page, a
    row at length 0 and one whose chunk crosses a page."""
    rng = np.random.default_rng(0)
    b, s, nh, kvh, d, bt, mb = 3, 5, 4, 2, 16, 4, 6
    nb = b * mb + 1
    q = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bt, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bt, kvh, d)).astype(np.float32)
    lengths = np.array([0, 7, 13], np.int32)
    tables = np.full((b, mb), nb - 1, np.int32)
    perm = rng.permutation(nb - 1)
    for i, n in enumerate(lengths):
        live = -(-(n + s) // bt)
        tables[i, :live] = perm[i * mb:i * mb + live]
        unused = perm[i * mb + live:(i + 1) * mb]
        kp[unused], vp[unused] = 1e4, -1e4
    kp[nb - 1], vp[nb - 1] = 1e4, -1e4
    want = np.asarray(jref.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), scale=d ** -0.5))
    args = [torch.as_tensor(a) for a in (q, kp, vp, tables, lengths)]
    got = ref.paged_chunk_attention(*args, scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert torch.equal(ops.paged_chunk_attention(*args, scale=d ** -0.5), got)


# ---------------------------------------------------------------------------
# model layer
# ---------------------------------------------------------------------------

def _set_rows(caches, tabs, lens):
    g = caches["attn"]
    L = g["block_tables"].shape[0]
    g["block_tables"] = torch.as_tensor(tabs)[None].expand(L, *tabs.shape)
    g["length"] = torch.as_tensor(lens)[None].expand(L, *lens.shape)


@pytest.mark.parametrize("chunk", [8, 13, 40])     # unaligned + whole-in-one
def test_chunk_passes_match_whole_prefill_bitwise(bf16, chunk):
    """chunk_step over a paged cache, chunk by chunk, against one whole
    prefill_step: last-position logits and every written K/V slot equal
    bit for bit (bf16, the JAX twin's dtype; see the module docstring)."""
    _, _, tcfg, tparams = bf16
    P = 40
    prompt = np.random.default_rng(0).integers(1, tcfg.vocab_size, P
                                               ).astype(np.int32)
    logits_w, dense = tsteps.prefill_step(
        tparams, {"tokens": torch.as_tensor(prompt[None])}, tcfg, MAX_LEN)
    mb, nb = MAX_LEN // BT, 2 * (MAX_LEN // BT)
    caches = ttf.init_paged_cache(tcfg, 2, nb, BT, mb, "cpu")
    tabs = np.full((2, mb), nb, np.int32)
    tabs[0] = np.arange(mb)
    got = 0
    while got < P:
        take = min(chunk, P - got)
        toks = np.zeros((2, chunk), np.int32)
        toks[0, :take] = prompt[got:got + take]
        _set_rows(caches, tabs, np.array([got, 0], np.int32))
        _, logits_c, caches = tsteps.chunk_step(
            tparams, torch.as_tensor(toks),
            torch.tensor([take, 0], dtype=torch.int32), caches, tcfg)
        got += take
    assert torch.equal(logits_c[0], logits_w[0])
    kp = caches["attn"]["k_pool"]
    kg = kp[:, torch.as_tensor(tabs[0]).long()].reshape(
        kp.shape[0], mb * BT, *kp.shape[3:])
    assert torch.equal(kg[:, :P], dense["attn"]["k"][:, 0, :P])
    vp = caches["attn"]["v_pool"]
    vg = vp[:, torch.as_tensor(tabs[0]).long()].reshape(
        vp.shape[0], mb * BT, *vp.shape[3:])
    assert torch.equal(vg[:, :P], dense["attn"]["v"][:, 0, :P])


@pytest.mark.parametrize("dtype,atol", [("float32", LOGITS_FP32_ATOL),
                                        ("bfloat16", LOGITS_BF16_ATOL)])
def test_chunk_step_logits_match_jax(weights_np, dtype, atol):
    """Two rows chunking two prompts (21 and 13 tokens, chunk 8, bt 8, the
    second row's table shuffled) through chunk_step in both packages: the
    logits of every row with a valid chunk, pass by pass."""
    jcfg, jparams, tcfg, tparams = _models(weights_np, dtype)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (21, 13)]
    chunk, bt, mb = 8, 8, 4
    nb = 2 * mb
    tabs = np.stack([np.arange(mb), 2 * mb - 1 - np.arange(mb)]
                    ).astype(np.int32)
    jc = jtf.init_paged_cache(jcfg, 2, nb, bt, mb)
    tc = ttf.init_paged_cache(tcfg, 2, nb, bt, mb, "cpu")
    jchunk = jax.jit(jsteps.chunk_step, static_argnums=(4,))
    lens = np.zeros(2, np.int32)
    passes = 0
    while any(lens[i] < len(p) for i, p in enumerate(prompts)):
        toks = np.zeros((2, chunk), np.int32)
        qv = np.zeros(2, np.int32)
        for i, p in enumerate(prompts):
            take = min(chunk, len(p) - lens[i])
            toks[i, :take] = p[lens[i]:lens[i] + take]
            qv[i] = take
        for g in jc.values():
            L = g["block_tables"].shape[0]
            g["block_tables"] = jnp.broadcast_to(jnp.asarray(tabs)[None],
                                                 (L, *tabs.shape))
            g["length"] = jnp.broadcast_to(jnp.asarray(lens)[None],
                                           (L, *lens.shape))
        _, want, jc = jchunk(jparams, jnp.asarray(toks), jnp.asarray(qv), jc,
                             jcfg)
        _set_rows(tc, tabs, lens)
        _, got, tc = tsteps.chunk_step(tparams, torch.as_tensor(toks),
                                       torch.as_tensor(qv), tc, tcfg)
        assert got.shape == (2, tcfg.vocab_size)
        for i in np.flatnonzero(qv):
            np.testing.assert_allclose(got[i].float().numpy(),
                                       np.asarray(want[i], np.float32),
                                       atol=atol, rtol=0)
        lens = lens + qv
        passes += 1
    assert passes == 3


# ---------------------------------------------------------------------------
# engine layer
# ---------------------------------------------------------------------------

def _prompts(lengths, vocab, seed=3, share=True):
    """Prompts of ``lengths`` tokens; those longer than two blocks share
    their first two blocks (prefix sharing)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 2 * BT).astype(np.int32)
    out = []
    for n in lengths:
        body = rng.integers(1, vocab, n).astype(np.int32)
        if share and n > 2 * BT:
            body[:2 * BT] = shared
        out.append(body)
    return out


def _streams(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run(max_steps=5000)
    return {tuple(r.prompt.tolist()): list(r.tokens) for r in done}


_SLOT: dict = {}


def _slot_streams(tcfg, tparams, prompts, max_new, max_len=MAX_LEN):
    """The port's SlotEngine streams, cached by request set."""
    key = (tcfg.compute_dtype, tuple(tuple(p.tolist()) for p in prompts),
           max_new, max_len)
    if key not in _SLOT:
        _SLOT[key] = _streams(SlotEngine(tcfg, params=tparams, max_batch=2,
                                         max_len=max_len, device="cpu"),
                              prompts, max_new)
    return _SLOT[key]


@pytest.mark.parametrize("policy", ["swap", "recompute"])
@pytest.mark.parametrize("chunk", [4, 16, 96])
def test_chunked_streams_match_slot_engine_and_jax(fp32, chunk, policy):
    """Chunk size x preemption, prefix-shared prompts, under a pool of 5
    pages, too tight for both rows, so growth preempts victims mid-stream
    (and mid-chunk): the port's chunked streams equal its SlotEngine's and
    the JAX chunked Engine's, and its kv_stats() equal JAX's."""
    jcfg, jparams, tcfg, tparams = fp32
    prompts = _prompts([50, 12, 33], tcfg.vocab_size)
    kw = dict(max_batch=2, max_len=MAX_LEN, block_tokens=BT, num_blocks=5,
              preemption=policy)
    jeng = JEngine(jcfg, params=jparams,
                   config=JEngineConfig(chunk_size=chunk), **kw)
    want = _streams(jeng, prompts, 16)
    teng = Engine(tcfg, params=tparams, config=EngineConfig(chunk_size=chunk),
                  device="cpu", **kw)
    got = _streams(teng, prompts, 16)
    assert got == want == _slot_streams(tcfg, tparams, prompts, 16)
    st = teng.kv_stats()
    assert st == jeng.kv_stats()
    assert st["swap_outs" if policy == "swap" else "recompute_drops"] >= 1
    teng.store.check_invariants()
    assert teng.store.used_blocks == 0


def test_mid_chunk_preemption_swap_and_recompute(bf16):
    """Preempt a request whose prefill is mid-flight (0 < prefilled <
    len(ctx), mid-block): swap round-trips the partial fill front through
    host memory, recompute restarts it; neither perturbs the stream."""
    _, _, tcfg, tparams = bf16
    long_p = np.random.default_rng(21).integers(1, tcfg.vocab_size, 60
                                                ).astype(np.int32)
    want = _slot_streams(tcfg, tparams, [long_p], 6)
    for policy in ("swap", "recompute"):
        eng = Engine(tcfg, params=tparams, max_batch=2, max_len=MAX_LEN,
                     block_tokens=BT, preemption=policy, device="cpu",
                     config=EngineConfig(chunk_size=12))
        r = eng.submit(long_p, max_new_tokens=6)
        eng._admit()
        eng._step_mixed()
        eng._step_mixed()
        assert r.prefilled == 24
        eng.preempt_slot(r.slot)
        assert r.state == ("swapped" if policy == "swap" else "preempted")
        done = eng.run()
        assert {tuple(q.prompt.tolist()): list(q.tokens)
                for q in done} == want, policy
        assert r.preemptions == 1
        eng.store.check_invariants()


def test_chunked_accounting_matches_whole_path(bf16):
    """Unpressured and prefix-shared: the chunked engine's dedup and
    allocation counters equal the whole-prefill engine's, its peak
    occupancy is no higher, and the streams are equal."""
    _, _, tcfg, tparams = bf16
    prompts = _prompts([50, 50, 33, 40], tcfg.vocab_size)
    stats, streams = {}, {}
    for mode, kw in (("whole", {}),
                     ("chunk", {"config": EngineConfig(chunk_size=16)})):
        eng = Engine(tcfg, params=tparams, max_batch=2, max_len=MAX_LEN,
                     block_tokens=BT, device="cpu", **kw)
        streams[mode] = _streams(eng, prompts, 6)
        stats[mode] = eng.kv_stats()
        eng.store.check_invariants()
    assert streams["chunk"] == streams["whole"]
    for k in ("prefix_hit_blocks", "prefix_hit_tokens",
              "blocks_allocated_total"):
        assert stats["chunk"][k] == stats["whole"][k], k
    assert stats["chunk"]["prefix_hit_blocks"] > 0
    assert stats["chunk"]["peak_blocks"] <= stats["whole"]["peak_blocks"]


def test_long_context_prompt_beyond_max_len(bf16):
    """A prompt ~3x max_len completes through the chunked engine with the
    stream of a SlotEngine sized to max_context; the whole-prefill engine
    rejects it at submit."""
    _, _, tcfg, tparams = bf16
    prompt = np.random.default_rng(7).integers(1, tcfg.vocab_size, 300
                                               ).astype(np.int32)
    eng = Engine(tcfg, params=tparams, max_batch=2, max_len=MAX_LEN,
                 block_tokens=BT, device="cpu",
                 config=EngineConfig(chunk_size=32, max_context=384))
    got = _streams(eng, [prompt], 6)
    assert got == _slot_streams(tcfg, tparams, [prompt], 6, max_len=384)
    assert len(got[tuple(prompt.tolist())]) == 6
    whole = Engine(tcfg, params=tparams, max_batch=2, max_len=MAX_LEN,
                   block_tokens=BT, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        whole.submit(prompt)


def test_submit_validates_eagerly(bf16):
    """The JAX twin's bounds; the configuration errors the JAX engine
    asserts raise ValueError here (an assert vanishes under -O)."""
    _, _, tcfg, tparams = bf16
    kw = dict(params=tparams, max_batch=1, max_len=MAX_LEN, block_tokens=BT,
              device="cpu")
    eng = Engine(tcfg, **kw)
    eng.submit(np.arange(MAX_LEN - 2, dtype=np.int32))     # boundary: fits
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(MAX_LEN - 1, dtype=np.int32))
    chunked = Engine(tcfg, config=EngineConfig(chunk_size=16,
                                               max_context=192), **kw)
    chunked.submit(np.arange(MAX_LEN + 10, dtype=np.int32))  # past max_len
    with pytest.raises(ValueError, match="max_context"):
        chunked.submit(np.arange(191, dtype=np.int32))
    with pytest.raises(ValueError, match="needs chunked prefill"):
        Engine(tcfg, config=EngineConfig(max_context=192), **kw)
    with pytest.raises(ValueError, match="multiple of block_tokens"):
        Engine(tcfg, config=EngineConfig(chunk_size=16, max_context=200),
               **kw)
    with pytest.raises(ValueError, match="whole-prefill"):
        Engine(tcfg, config=EngineConfig(chunk_size=16, draft_cfg=tcfg,
                                         spec_k=2),
               draft_params=tparams, **kw)


def test_decode_share_knob_starves_or_feeds_prefill(bf16):
    """At decode_share 1.0 a running decode takes the whole budget and a
    waiting prompt makes no prefill progress; at 0.0 the same iteration
    advances it by a full chunk."""
    _, _, tcfg, tparams = bf16
    rng = np.random.default_rng(31)
    short = rng.integers(1, tcfg.vocab_size, 12).astype(np.int32)
    long_p = rng.integers(1, tcfg.vocab_size, 60).astype(np.int32)
    for share, expect_progress in ((1.0, 0), (0.0, 16)):
        eng = Engine(tcfg, params=tparams, max_batch=2, max_len=MAX_LEN,
                     block_tokens=BT, device="cpu",
                     config=EngineConfig(chunk_size=16, decode_share=share))
        a = eng.submit(short, max_new_tokens=30)
        eng._admit()
        while not eng._is_decoding(a):             # finish a's prefill
            eng._step_mixed()
        b = eng.submit(long_p, max_new_tokens=4)
        eng._admit()
        n_tok = len(a.tokens)
        eng._step_mixed()
        assert len(a.tokens) == n_tok + 1          # decode always advances
        assert b.prefilled == expect_progress, share


# ---------------------------------------------------------------------------
# store layer: the chunked paths of the port's PagedKVStore
# ---------------------------------------------------------------------------

def test_store_chunked_allocate_grow_advance():
    st = PagedKVStore(num_blocks=8, block_tokens=4)
    chain = prefix_chain(list(range(16)), 4)       # 4 full blocks
    blocks, m = st.allocate(0, 4, chain, filled=0, context_tokens=16)
    assert m == 0 and len(blocks) == 1             # first chunk only
    assert st.tables[0].tokens == 0
    st.advance(0, 4)
    for _ in range(3):                             # fill-front growth
        assert st.grow(0) is not None
        st.advance(0, 4)
    assert st.tables[0].tokens == 16
    assert st.tables[0].hashes == chain            # registered as it filled
    st.check_invariants()
    # a second chunked admission of the same prompt aliases all 4 blocks up
    # front (the matched prefix claimed to the full context)
    blocks2, m2 = st.allocate(1, 4, chain, filled=0, context_tokens=16)
    assert m2 == 4 and blocks2 == st.tables[0].blocks
    st.free(0)
    st.free(1)
    st.check_invariants()


def test_store_grow_aliases_chain_registered_after_admission():
    """Concurrent chunked prefills of a shared prefix: the later request's
    fill-front growth aliases blocks the earlier one registered after the
    later one was admitted."""
    st = PagedKVStore(num_blocks=8, block_tokens=4)
    chain = prefix_chain(list(range(12)), 4)
    st.allocate(0, 4, chain, filled=0, context_tokens=12)
    st.allocate(1, 4, chain[:1], filled=0, context_tokens=12)
    st.tables[1].chain = list(chain)               # same prompt, full chain
    st.advance(0, 4)
    st.grow(0)
    st.advance(0, 4)                               # 0 registered chain[1]
    st.advance(1, 4)
    b = st.grow(1)                                 # 1's fill front, block 1
    assert b == st.tables[0].blocks[1] and st.refcount[b] == 2
    st.free(0)
    st.free(1)
    st.check_invariants()


def test_store_swap_out_trims_unfilled_tail():
    st = PagedKVStore(num_blocks=8, block_tokens=4)
    chain = prefix_chain(list(range(16)), 4)
    st.allocate(0, 4, chain, filled=0, context_tokens=16)
    st.advance(0, 4)
    st.grow(0)
    st.advance(0, 2)                               # mid-chunk: 6 filled
    st.grow(0)                                     # one unfilled block
    assert len(st.tables[0].blocks) == 3
    kept = st.swap_out(0)
    assert kept is not None and len(kept) == 2     # blocks_for(6) == 2
    st.check_invariants()
    back = st.swap_in(0)
    assert len(back) == 2 and st.tables[0].tokens == 6
    st.free(0)
    st.check_invariants()
