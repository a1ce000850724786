"""PyTorch port, MLA and MoE on one card: MiniCPM3-4B (dense, MLA with query
compression), DeepSeek-V2-Lite-16B (MoE, MLA without it) and
DeepSeek-V2-236B (MoE, MLA with it), reduced. The JAX package and the port
run on the same perturbed numpy weights at fp32 (the JAX init zeroes the
output projections): configs and parameter trees equal; each MLA layer's
prefill and decode (naive and absorbed) and each MoE formulation within
1e-5; prefill plus decode logits within LOGITS_FP32_ATOL, and at bf16
within LOGITS_BF16_ATOL; the port's ``SlotEngine`` streams equal to the JAX
``SlotEngine``'s; ``make_engine`` handing MLA to the ``SlotEngine``; and
the SlotEngine's decode pass free of data-dependent ops (capturable as a
CUDA graph on the card)."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.core import SlotEngine as JSlotEngine
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import ARCH_IDS
from repro_torch.engine.core import Engine, SlotEngine, make_engine
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

from test_torch_graphs import DataDependentOps

LATENT = ("minicpm3_4b", "deepseek_v2_lite_16b", "deepseek_v2_236b")
# fp32: same arithmetic, summation order differs between XLA and PyTorch
LAYER_ATOL = 1e-5
LOGITS_FP32_ATOL = 1e-4
# bf16: the two frameworks round matmul outputs and fused elementwise
# chains to bf16 at different points; a bf16 ulp at |logit| ~ 4-8 is
# 2**-5, so allow four ulps (tests/test_torch_models.py)
LOGITS_BF16_ATOL = 0.125
N_DECODE = 4
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _configs(arch, **kw):
    """(JAX reduced config, port reduced config) with ``kw`` replaced."""
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    return jmod.reduced().replace(**kw), tmod.reduced().replace(**kw)


def _absorb(cfg):
    return cfg.replace(mla=dataclasses.replace(cfg.mla, absorb=True))


@functools.lru_cache(maxsize=None)
def _perturbed(arch):
    """The reduced config's JAX init (fp32) + seeded numpy noise on every
    leaf, as fp32 numpy arrays; every test of an arch shares them."""
    jcfg, _ = _configs(arch, **FP32)
    p, _ = jtf.init_model(jcfg, jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.1
                   ).astype(np.float32), p)


@pytest.fixture(scope="module", params=LATENT)
def latent(request):
    """(arch, JAX cfg, JAX params, port cfg, port params) at fp32."""
    jcfg, tcfg = _configs(request.param, **FP32)
    pn = _perturbed(request.param)
    return (request.param, jcfg, jax.tree.map(jnp.asarray, pn), tcfg,
            weights.from_jax_params(pn, "cpu"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("arch", LATENT)
def test_configs_match_jax(arch):
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    assert arch in ARCH_IDS
    assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(tmod.reduced()) == dataclasses.asdict(
        jmod.reduced())


@pytest.mark.parametrize("arch", LATENT)
def test_init_model_matches_jax_tree(arch):
    """Same keys, shapes and dtypes as the JAX pytree: the MLA projections,
    and for the moe family ``dense_layers`` with an ``mlp`` and ``layers``
    with a ``moe``."""
    jcfg, tcfg = _configs(arch)
    tp = _flat(ttf.init_model(tcfg, torch.Generator().manual_seed(0),
                              "cpu"))
    jp = _flat(jtf.abstract_model(jcfg)[0])
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(v.shape) == tuple(tp[k].shape), k
        assert str(v.dtype) == str(tp[k].dtype).replace("torch.", ""), k
    assert "layers.attn.wuk" in tp and not tp["layers.attn.wo"].any()
    assert ("layers.moe.wi" in tp) == (jcfg.family == "moe")
    assert ("dense_layers.mlp.wi" in tp) == (jcfg.family == "moe")


def _mla_layer(arch, absorb):
    """Layer 0's attention params of the perturbed model, JAX and port."""
    jcfg, tcfg = _configs(arch, **FP32)
    if absorb:
        jcfg, tcfg = _absorb(jcfg), _absorb(tcfg)
    lp = jax.tree.map(lambda a: a[0], _perturbed(arch)["layers"]["attn"])
    return jcfg, tcfg, lp, weights.from_jax_params(lp, "cpu")


@pytest.mark.parametrize("arch", ("minicpm3_4b", "deepseek_v2_lite_16b"))
def test_mla_prefill_matches_jax(arch):
    """Output and the written latent cache of ``mla_prefill``."""
    jcfg, tcfg, jp, tp = _mla_layer(arch, False)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    pos = np.arange(13, dtype=np.int32)[None]
    spec = jattn.cache_spec(jcfg, 2, 20, jnp.float32)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in spec.items()}
    want, wc = jax.jit(lambda *a: jattn.mla_prefill(*a[:3], jcfg, a[3]))(
        jp, jnp.asarray(x), jnp.asarray(pos), jc)
    tc = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
          tattn.cache_spec(tcfg, 2, 20, torch.float32).items()}
    got, gc = tattn.mla_prefill(tp, torch.tensor(x), torch.tensor(pos),
                                tcfg, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)
    for k in ("c_kv", "k_rope", "length"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                   atol=LAYER_ATOL, rtol=0)
    assert gc["c_kv"] is tc["c_kv"]                   # written in place


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("arch", ("minicpm3_4b", "deepseek_v2_lite_16b"))
def test_mla_decode_matches_jax(arch, absorb):
    """One decode step over a bf16 latent cache (the cache default) at
    per-row lengths, one of them at the last position: output, the cache
    written at ``length`` and the new lengths."""
    jcfg, tcfg, jp, tp = _mla_layer(arch, absorb)
    m = jcfg.mla
    rng = np.random.default_rng(12)
    b, S = 3, 16
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    c = rng.standard_normal((b, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, S, m.qk_rope_head_dim)).astype(np.float32)
    lens = np.array([5, 0, S - 1], np.int32)
    # eager: under jit XLA keeps the absorbed path's bf16 o_lat in fp32
    want, wc = jattn.mla_decode(jp, jnp.asarray(x), jcfg, {
        "c_kv": jnp.asarray(c, jnp.bfloat16),
        "k_rope": jnp.asarray(kr, jnp.bfloat16), "length": jnp.asarray(lens)})
    tc = {"c_kv": torch.tensor(c).bfloat16(),
          "k_rope": torch.tensor(kr).bfloat16(), "length": torch.tensor(lens)}
    got, gc = tattn.mla_decode(tp, torch.tensor(x), tcfg, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(gc[k].float().numpy(),
                                   np.asarray(wc[k], np.float32),
                                   atol=LAYER_ATOL, rtol=0)
    assert gc["length"].tolist() == (lens + 1).tolist()


def _moe_case(arch="deepseek_v2_lite_16b", **moe_kw):
    jcfg, tcfg = _configs(arch, **FP32)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_kw))
    mp = jax.tree.map(lambda a: a[0], _perturbed(arch)["layers"]["moe"])
    x = np.random.default_rng(13).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, mp, weights.from_jax_params(mp, "cpu"), x


@pytest.mark.parametrize("impl,slack", [("ragged_ep", 2.0),
                                        ("ragged_ep", 0.5),
                                        ("dispatch_einsum", 2.0),
                                        ("dispatch_einsum", 1.0)])
def test_apply_moe_matches_jax(impl, slack):
    """``apply_moe`` (shared experts added) and its aux loss. At slack 2.0
    nothing drops; ``moe_dispatch_einsum`` at 1.0 and ``moe_ragged`` at 0.5
    drop the rows past an expert's (or the step's) capacity, the same rows
    as JAX: the drops are checked to change the output."""
    jcfg, tcfg, jp, tp, x = _moe_case(impl=impl, capacity_slack=slack)
    want, waux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg))(
        jp, jnp.asarray(x))
    got, gaux = tmoe.apply_moe(tp, torch.tensor(x), tcfg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    full = tmoe.moe_reference(tp, torch.tensor(x), tcfg)
    dropped = float((got - full).abs().max())
    assert (dropped > 1e-3) == (slack < 2.0), dropped


def test_moe_reference_matches_jax():
    jcfg, tcfg, jp, tp, x = _moe_case()
    want = jax.jit(lambda p, x: jmoe.moe_reference(p, x, jcfg))(
        jp, jnp.asarray(x))
    got = tmoe.moe_reference(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=0)
    ragged, _ = tmoe.apply_moe(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(ragged.numpy(), got.numpy(),
                               atol=LAYER_ATOL, rtol=0)


class _StubMesh:
    """A mesh as ``ShardingRules`` reads it: axis names, a device array."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def test_moe_refuses_a_mesh():
    """Expert parallelism runs under a mesh (``tests/test_torch_
    distributed.py``); a mesh whose "model" axis does not divide the
    experts still raises, naming the leaf and its spec."""
    _, tcfg, _, tp, x = _moe_case()
    with pytest.raises(NotImplementedError, match="wi: spec .*experts"):
        tmoe.moe_ragged(tp, torch.tensor(x), tcfg,
                        mesh=_StubMesh((1, 3), ("data", "model")))


def _jax_logits(params, cfg, prompt, cache_dtype):
    """Prefill into ``cache_dtype`` caches, then N_DECODE greedy steps.
    Returns (logits of every step, the fed tokens)."""
    spec, _ = jtf.init_cache_spec(cfg, 1, 32)
    caches = jax.tree.map(lambda s: jnp.zeros(
        s.shape, cache_dtype if s.dtype == jnp.bfloat16 else s.dtype), spec)
    fwd = jax.jit(lambda p, t, c, mode: jtf.forward(
        p, cfg, tokens=t, mode=mode, caches=c)[:2], static_argnums=(3,))
    logits, caches = fwd(params, jnp.asarray(prompt[None]), caches,
                         "prefill")
    out, fed = [np.asarray(logits[0], np.float32)], []
    for _ in range(N_DECODE):
        fed.append(int(np.argmax(out[-1])))
        logits, caches = fwd(params, jnp.asarray([[fed[-1]]], jnp.int32),
                             caches, "decode")
        out.append(np.asarray(logits[0], np.float32))
    return out, fed


def _torch_logits(params, cfg, prompt, fed, cache_dtype):
    caches = ttf.init_cache(cfg, 1, 32, "cpu")
    caches = {g: {k: v.to(cache_dtype) if v.is_floating_point() else v
                  for k, v in c.items()} for g, c in caches.items()}
    logits, caches = ttf.forward(params, cfg, mode="prefill", caches=caches,
                                 tokens=torch.as_tensor(prompt[None]))
    out = [logits[0].float().numpy()]
    for tok in fed:
        logits, caches = ttf.forward(
            params, cfg, mode="decode", caches=caches,
            tokens=torch.tensor([[tok]], dtype=torch.int32))
        out.append(logits[0].float().numpy())
    assert sorted(caches) == (["attn", "dense_attn"] if cfg.family == "moe"
                              else ["attn"])
    assert all(c["length"].eq(len(prompt) + len(fed)).all()
               for c in caches.values())
    return out


def test_prefill_and_decode_logits_match_jax(latent):
    """Prefill of 21 tokens and N_DECODE decode steps (fed JAX's greedy
    tokens). The caches are fp32 here: over the default bf16 cache a
    one-ulp difference of an fp32 sum can round a cache entry to the other
    bf16 neighbour, which moves the logits by ~2e-4 at these widths in
    either framework."""
    arch, jcfg, jparams, tcfg, tparams = latent
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, 21
                                               ).astype(np.int32)
    want, fed = _jax_logits(jparams, jcfg, prompt, jnp.float32)
    got = _torch_logits(tparams, tcfg, prompt, fed, torch.float32)
    assert len(got) == N_DECODE + 1
    for w, g in zip(want, got):
        assert g.shape == (jcfg.vocab_size,)
        np.testing.assert_allclose(g, w, atol=LOGITS_FP32_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ("minicpm3_4b", "deepseek_v2_lite_16b"))
def test_bf16_logits_match_jax(arch):
    """The bf16 default (params, compute and caches)."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, tcfg = _configs(arch, **bf16)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                           _perturbed(arch))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, 21
                                               ).astype(np.int32)
    want, fed = _jax_logits(jparams, jcfg, prompt, jnp.bfloat16)
    got = _torch_logits(tparams, tcfg, prompt, fed, torch.bfloat16)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=LOGITS_BF16_ATOL, rtol=0)


def _streams(eng, prompts, max_new=5):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: list(r.tokens) for r in eng.run()}


def _slot_streams(jcfg, jparams, tcfg, tparams):
    """(JAX SlotEngine streams, the port's, the port's engine): three
    requests through two slots, the port's engine from ``make_engine``."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, 12).astype(np.int32)
               for _ in range(3)]
    kw = dict(max_batch=2, max_len=64)
    want = _streams(JSlotEngine(jcfg, params=jparams, **kw), prompts)
    eng = make_engine(tcfg, params=tparams, device="cpu", block_tokens=16,
                      **kw)
    assert isinstance(eng, SlotEngine)
    got = _streams(eng, prompts)
    assert all(len(t) == 5 for t in got.values())
    return want, got, eng


def test_slot_engine_streams_match_jax(latent):
    """Greedy streams of the port's SlotEngine == the JAX SlotEngine's;
    the decode pass advanced every cache group's lengths alike."""
    arch, jcfg, jparams, tcfg, tparams = latent
    want, got, eng = _slot_streams(jcfg, jparams, tcfg, tparams)
    assert got == want
    lengths = {g: c["length"] for g, c in eng.caches.items()}
    assert sorted(lengths) == (["attn", "dense_attn"]
                               if tcfg.family == "moe" else ["attn"])
    assert all(torch.equal(v[0], lengths["attn"][0])
               for v in lengths.values())


def test_slot_engine_absorbed_streams_match_jax():
    """MiniCPM3 with the absorbed decode (``MLAConfig.absorb``)."""
    jcfg, tcfg = _configs("minicpm3_4b", **FP32)
    pn = _perturbed("minicpm3_4b")
    want, got, _ = _slot_streams(_absorb(jcfg), jax.tree.map(jnp.asarray, pn),
                                 _absorb(tcfg),
                                 weights.from_jax_params(pn, "cpu"))
    assert got == want


def test_make_engine_gives_slot_engine_for_mla():
    """MLA's latent cache is not paged (as in JAX): the factory hands MLA
    configs the dense SlotEngine and drops the paged-only keywords; GQA
    still gets the paged Engine; the recurrent families (the reduced
    zamba2_7b and xlstm_1_3b) get the SlotEngine too; a GQA MoE raises,
    and an encoder-only config, which has no serving path (as JAX's serve
    launcher refuses it)."""
    kw = dict(max_batch=1, max_len=64, device="cpu")
    gqa = importlib.import_module("repro_torch.configs.gemma_2b").reduced()
    assert isinstance(make_engine(gqa, block_tokens=16, **kw), Engine)
    for arch in LATENT:
        _, cfg = _configs(arch)
        eng = make_engine(cfg, block_tokens=16, num_blocks=8,
                          preemption="swap", **kw)
        assert isinstance(eng, SlotEngine) and eng.cfg is cfg
    for arch in ("zamba2_7b", "xlstm_1_3b"):
        rec = importlib.import_module(f"repro_torch.configs.{arch}")
        assert isinstance(make_engine(rec.reduced(), block_tokens=16, **kw),
                          SlotEngine)
    with pytest.raises(NotImplementedError, match="later slices"):
        make_engine(gqa.replace(family="moe"), **kw)
    with pytest.raises(ValueError, match="encoder-only; no serving path"):
        make_engine(gqa.replace(family="audio", encoder_only=True), **kw)
    with pytest.raises(NotImplementedError, match="paged KV"):
        ttf.init_paged_cache(_configs("minicpm3_4b")[1], 1, 4, 16, 4, "cpu")


@pytest.mark.parametrize("arch", ("minicpm3_4b", "deepseek_v2_lite_16b"))
def test_mla_chunk_and_verify_raise(arch):
    _, cfg = _configs(arch)
    params = ttf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.zeros(1, 4, dtype=torch.int32)
    for mode, what in (("chunk", "chunked prefill"),
                       ("verify", "speculative verify")):
        with pytest.raises(NotImplementedError, match=what):
            ttf.forward(params, cfg, tokens=tok, mode=mode, caches=None,
                        q_valid=torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("arch,absorb", [("minicpm3_4b", False),
                                         ("minicpm3_4b", True),
                                         ("deepseek_v2_lite_16b", False)])
def test_slot_decode_pass_is_free_of_data_dependent_ops(arch, absorb):
    """The MLA and the MoE SlotEngine's decode pass, after its warm-up,
    over a run's real inputs: no op whose output shape or host value
    depends on data (each would sync the host and could not be captured
    as a CUDA graph on the card)."""
    _, cfg = _configs(arch)
    if absorb:
        cfg = _absorb(cfg)
    eng = SlotEngine(cfg, max_batch=2, max_len=64, device="cpu", seed=3)
    p = eng.passes()["decode"]
    p.warm_up()
    mode = DataDependentOps()

    def recorded(*a, _body=p._body, **k):
        with mode:
            return _body(*a, **k)
    p._body = recorded
    rng = np.random.default_rng(1)
    _streams(eng, [rng.integers(0, 512, n).astype(np.int32)
                   for n in (12, 30, 7)], max_new=6)
    assert mode.seen and mode.bad == [], mode.bad


@pytest.mark.parametrize("arch", LATENT)
def test_serve_cli_runs_each_latent_config_on_cpu(arch, capsys):
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--max-len", "64"])
    assert len(done) == 2 and all(len(r.tokens) == 3 for r in done)
    assert f"arch={arch} device=cpu" in capsys.readouterr().out
