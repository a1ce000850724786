"""PyTorch port, the recurrent families: Zamba2-7B (hybrid: Mamba2 layers
with one shared GQA block applied every ``shared_attn_every`` layers) and
xLSTM-1.3B (ssm: groups of mLSTM layers, each followed by an sLSTM), both
reduced. The JAX package and the port run on the same perturbed numpy
weights and seeded numpy inputs at fp32 (the JAX init zeroes the output
projections, the norms and the conv bias, so unperturbed blocks would add
nothing): configs and parameter trees equal; each block (causal conv,
Mamba2 prefill, decode and reference, mLSTM prefill and decode, sLSTM from
zero and from a given state) within BLOCK_ATOL of JAX's; the port's
chunked prefill against its own token-by-token recurrence; prefill plus
decode logits within LOGITS_FP32_ATOL of JAX's and every cache leaf within
STATE_REL of its largest magnitude; at bf16 zamba2's logits within
LOGITS_BF16_ATOL, xLSTM's layers on JAX's own input; the port's
``SlotEngine`` streams equal to
the JAX ``SlotEngine``'s with slots reused; the prompt lengths JAX's
chunked scan refuses refused by both; ``make_engine`` giving the
``SlotEngine``; the decode pass free of data-dependent ops, its warm-up
leaving the recurrent state as it was; and the serve CLI."""
import dataclasses
import functools
import gc
import importlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.core import SlotEngine as JSlotEngine
from repro.models import layers as jlayers
from repro.models import mamba2 as jm2
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.models import xlstm as jxl
from repro_torch import weights
from repro_torch.configs import ARCH_IDS
from repro_torch.engine.core import Engine, SlotEngine, make_engine
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm2
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as txl

from test_torch_graphs import DataDependentOps

RECURRENT = ("zamba2_7b", "xlstm_1_3b")
# fp32: same arithmetic, summation order differs between XLA and PyTorch
BLOCK_ATOL = BLOCK_RTOL = 1e-5
LOGITS_FP32_ATOL = 1e-4
# fp32 recurrent states (|x| up to ~20 here) whose small entries are
# differences of large terms: each leaf within STATE_REL of its largest
# magnitude
STATE_REL = 1e-4
# bf16: the two frameworks round matmul outputs and fused elementwise
# chains to bf16 at different points; a bf16 ulp at |logit| ~ 4-8 is
# 2**-5, so allow four ulps (tests/test_torch_models.py)
LOGITS_BF16_ATOL = 0.125
N_DECODE = 3
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _configs(arch, **kw):
    """(JAX reduced config, port reduced config) with ``kw`` replaced."""
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    return jmod.reduced().replace(**kw), tmod.reduced().replace(**kw)


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


def _both(arch):
    """(JAX cfg, JAX params, port cfg, port params) at fp32."""
    jcfg, tcfg = _configs(arch, **FP32)
    pn = _perturbed(arch)
    return (jcfg, jax.tree.map(jnp.asarray, pn), tcfg,
            weights.from_jax_params(pn, "cpu"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_configs_match_jax(arch):
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    assert arch in ARCH_IDS
    assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(tmod.reduced()) == dataclasses.asdict(
        jmod.reduced())


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_model_matches_jax_tree(arch):
    """Same keys, shapes and dtypes as the JAX pytree (the hybrid's
    ``mamba`` stack and ``shared`` block, the ssm's ``mlstm`` and ``slstm``
    stacks), the same leaves zeroed and the same constants."""
    jcfg, tcfg = _configs(arch)
    tp = _flat(ttf.init_model(tcfg, torch.Generator().manual_seed(0),
                              "cpu"))
    jp = _flat(jax.tree.map(np.asarray, jtf.init_model(
        jcfg, jax.random.PRNGKey(0))[0]))
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(v.shape) == tuple(tp[k].shape), k
        assert str(v.dtype) == str(tp[k].dtype).replace("torch.", ""), k
        zero = not np.asarray(v, np.float32).any()
        assert zero == (not tp[k].any()), k
    if arch == "zamba2_7b":
        assert "shared.attn.wq" in tp and "mamba.conv_w" in tp
        for k in ("mamba.A_log", "mamba.D"):
            assert np.array_equal(_np(tp[k]), np.asarray(jp[k], np.float32))
    else:
        assert "mlstm.wif" in tp and "slstm.r" in tp
        for k in ("mlstm.b_if", "slstm.b"):
            assert np.array_equal(_np(tp[k]), np.asarray(jp[k], np.float32))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _layer(params, key, i=0):
    """Layer ``i`` of a stacked subtree of the numpy params, as (JAX, port)
    trees."""
    one = {k: v[i] for k, v in params[key].items()}
    return jax.tree.map(jnp.asarray, one), weights.from_jax_params(one,
                                                                   "cpu")


def _x(shape, seed=1):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5
         ).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def _state(spec_shapes, seed, m_key=None):
    """Seeded random fp32 state leaves, as (JAX, port) dicts (the port's a
    copy: its decode writes in place)."""
    rng = np.random.default_rng(seed)
    s = {k: (rng.standard_normal(shape) * 0.5).astype(np.float32)
         for k, shape in spec_shapes.items()}
    if m_key:
        s[m_key] = np.abs(s[m_key])
    return ({k: jnp.asarray(v) for k, v in s.items()},
            {k: torch.tensor(v) for k, v in s.items()})


def _mamba_blocks():
    cfg_j, _, cfg_t, _ = _both("zamba2_7b")
    jp, tp = _layer(_perturbed("zamba2_7b"), "mamba")
    d_in, nh, n, hd, cw = jm2._dims(cfg_j)
    conv_dim = d_in + 2 * n
    xj, xt = _x((2, 64, cfg_j.d_model))
    x1j, x1t = xj[:, :1], xt[:, :1]
    sj, st = _state({"conv": (2, cw - 1, conv_dim), "ssm": (2, nh, n, hd)},
                    3)
    xbc_j, xbc_t = _x((2, 64, conv_dim), seed=4)

    def conv(state):
        cj = None if state is None else sj["conv"]
        ct = None if state is None else st["conv"]
        want = jm2._causal_conv(xbc_j, jp["conv_w"], jp["conv_b"], cj)
        got = tm2._causal_conv(xbc_t, tp["conv_w"], tp["conv_b"], ct)
        return got, want
    return {
        "causal_conv": lambda: conv(None),
        "causal_conv_with_state": lambda: conv(sj),
        "mamba2_forward": lambda: (
            tm2.mamba2_forward(tp, xt, cfg_t, return_state=True),
            jm2.mamba2_forward(jp, xj, cfg_j, return_state=True)),
        "mamba2_decode": lambda: (
            tm2.mamba2_decode(tp, x1t, cfg_t, st),
            jm2.mamba2_decode(jp, x1j, cfg_j, sj)),
        "mamba2_reference": lambda: (
            tm2.mamba2_reference(tp, xt[:, :40], cfg_t),
            jm2.mamba2_reference(jp, xj[:, :40], cfg_j)),
    }


def _xlstm_blocks():
    cfg_j, _, cfg_t, _ = _both("xlstm_1_3b")
    mj, mt = _layer(_perturbed("xlstm_1_3b"), "mlstm")
    sj_p, st_p = _layer(_perturbed("xlstm_1_3b"), "slstm")
    d_in, nh, hd = jxl._mlstm_dims(cfg_j)
    d = cfg_j.d_model
    xj, xt = _x((2, 64, d))
    x1j, x1t = xj[:, :1], xt[:, :1]
    msj, mst = _state({"C": (2, nh, hd, hd), "n": (2, nh, hd),
                       "m": (2, nh)}, 5)
    shape = (2, nh, d // nh)
    ssj, sst = _state({k: shape for k in "cnhm"}, 6, m_key="n")
    return {
        "mlstm_forward": lambda: (
            txl.mlstm_forward(mt, xt, cfg_t, return_state=True),
            jxl.mlstm_forward(mj, xj, cfg_j, return_state=True)),
        "mlstm_decode": lambda: (txl.mlstm_decode(mt, x1t, cfg_t, mst),
                                 jxl.mlstm_decode(mj, x1j, cfg_j, msj)),
        "slstm_forward_zero_state": lambda: (
            txl.slstm_forward(st_p, xt[:, :24], cfg_t, return_state=True),
            jxl.slstm_forward(sj_p, xj[:, :24], cfg_j, return_state=True)),
        "slstm_forward_given_state": lambda: (
            txl.slstm_forward(st_p, xt[:, :24], cfg_t, state=sst),
            jxl.slstm_forward(sj_p, xj[:, :24], cfg_j, state=ssj)),
    }


BLOCKS = {"zamba2_7b": ("causal_conv", "causal_conv_with_state",
                        "mamba2_forward", "mamba2_decode",
                        "mamba2_reference"),
          "xlstm_1_3b": ("mlstm_forward", "mlstm_decode",
                         "slstm_forward_zero_state",
                         "slstm_forward_given_state")}


@pytest.mark.parametrize("block", [b for bs in BLOCKS.values() for b in bs])
def test_block_matches_jax(block):
    """Each block of the port within BLOCK_ATOL / BLOCK_RTOL of the JAX
    package's on the same perturbed layer and seeded inputs (two 32-token
    chunks for the chunked prefills), its outputs and every state leaf."""
    cases = (_mamba_blocks() if block in BLOCKS["zamba2_7b"]
             else _xlstm_blocks())
    got, want = cases[block]()
    if isinstance(want, tuple):
        (got, got_st), (want, want_st) = got, want
        if isinstance(want_st, dict):
            assert sorted(got_st) == sorted(want_st)
            for k in want_st:
                _close(got_st[k], want_st[k], what=f"{block} state {k}")
        else:
            _close(got_st, want_st, what=f"{block} window")
    assert tuple(got.shape) == tuple(want.shape)
    assert np.abs(_np(want)).max() > 1e-2          # the block adds something
    _close(got, want, what=block)


@pytest.mark.parametrize("arch", RECURRENT)
def test_chunked_prefill_matches_recurrence(arch):
    """Inside the port: the chunked prefill (two chunks) against its own
    token-by-token recurrence, outputs and final state (twins of the JAX
    package's block oracles, at their tolerance)."""
    _, _, tcfg, _ = _both(arch)
    _, xt = _x((2, 64, tcfg.d_model), seed=2)
    if arch == "zamba2_7b":
        _, p = _layer(_perturbed(arch), "mamba", 1)
        y, st = tm2.mamba2_forward(p, xt, tcfg, return_state=True)
        d_in, nh, n, hd, cw = tm2._dims(tcfg)
        state = {"conv": torch.zeros(2, cw - 1, d_in + 2 * n),
                 "ssm": torch.zeros(2, nh, n, hd)}
        step = tm2.mamba2_decode
    else:
        _, p = _layer(_perturbed(arch), "mlstm", 1)
        y, st = txl.mlstm_forward(p, xt, tcfg, return_state=True)
        d_in, nh, hd = txl._mlstm_dims(tcfg)
        state = {"C": torch.zeros(2, nh, hd, hd), "n": torch.zeros(2, nh, hd),
                 "m": torch.full((2, nh), -1e30)}
        step = txl.mlstm_decode
    outs = [step(p, xt[:, t:t + 1], tcfg, state)[0] for t in range(64)]
    _close(y, torch.cat(outs, 1), atol=1e-4, rtol=1e-4)
    for k in st:
        _close(st[k], state[k], atol=1e-4, rtol=1e-4, what=k)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _jax_run(params, cfg, prompt, max_len, cache_dtype):
    """JAX prefill into caches whose bf16 leaves are ``cache_dtype``, then
    N_DECODE greedy steps. Returns (logits of every step, fed tokens, final
    caches)."""
    spec, _ = jtf.init_cache_spec(cfg, 1, max_len)
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
    return out, fed, caches


def _torch_run(params, cfg, prompt, fed, max_len, cache_dtype):
    """The port's twin of ``_jax_run``, fed JAX's greedy tokens."""
    caches = ttf.init_cache(cfg, 1, max_len, "cpu")
    caches = {g: {k: v.to(cache_dtype) if v.dtype == torch.bfloat16 else v
                  for k, v in c.items()} for g, c in caches.items()}
    logits, caches = ttf.forward(params, cfg, mode="prefill", caches=caches,
                                 tokens=torch.as_tensor(prompt[None]))
    out = [logits[0].float().numpy()]
    for tok in fed:
        logits, caches = ttf.forward(
            params, cfg, mode="decode", caches=caches,
            tokens=torch.tensor([[tok]], dtype=torch.int32))
        out.append(logits[0].float().numpy())
    return out, caches


@pytest.mark.parametrize("plen", (24, 64))
@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_and_decode_match_jax(arch, plen):
    """Prefill of one chunk (24 tokens) or two (64) and N_DECODE decode
    steps (fed JAX's greedy tokens): logits within LOGITS_FP32_ATOL of
    JAX's, and every cache leaf against JAX's final caches, each within
    STATE_REL of its largest magnitude, lengths equal. The shared block's K/V caches
    are fp32 here: over the default bf16 cache a one-ulp difference of an
    fp32 sum can round an entry to the other bf16 neighbour, which moves
    the logits by ~1e-4 in either framework (tests/test_torch_latent.py).
    The conv window is held at fp32: both frameworks keep it in the
    compute dtype after prefill (``mamba2_state_spec``)."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    prompt = np.random.default_rng(plen).integers(
        0, jcfg.vocab_size, plen).astype(np.int32)
    want, fed, jc = _jax_run(jparams, jcfg, prompt, 96, jnp.float32)
    got, tc = _torch_run(tparams, tcfg, prompt, fed, 96, torch.float32)
    assert len(got) == N_DECODE + 1
    for w, g in zip(want, got):
        assert g.shape == (jcfg.vocab_size,)
        np.testing.assert_allclose(g, w, atol=LOGITS_FP32_ATOL, rtol=0)
    jflat, tflat = _flat(jc), _flat(tc)
    assert sorted(jflat) == sorted(tflat)
    for k, w in jflat.items():
        g = tflat[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype) == f"torch.{w.dtype}", k
        if k.endswith("length"):
            assert np.array_equal(g.numpy(), np.asarray(w)), k
            assert (g == plen + N_DECODE).all()
        else:
            _close(g, w, atol=STATE_REL * float(np.abs(_np(w)).max()),
                   rtol=0, what=k)


def _bf16_params(arch):
    pn = _perturbed(arch)
    return (jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pn),
            weights.from_jax_params(pn, "cpu", torch.bfloat16))


def test_bf16_hybrid_logits_match_jax():
    """zamba2 at the served dtype (bf16 weights, compute and K/V caches):
    prefill and decode logits within LOGITS_BF16_ATOL of JAX's, and the
    caches' dtypes those of JAX's spec (the conv window bf16, the SSM
    state fp32)."""
    jcfg, tcfg = _configs("zamba2_7b")
    jparams, tparams = _bf16_params("zamba2_7b")
    prompt = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, 64).astype(np.int32)
    want, fed, _ = _jax_run(jparams, jcfg, prompt, 96, jnp.bfloat16)
    got, tc = _torch_run(tparams, tcfg, prompt, fed, 96, torch.bfloat16)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=LOGITS_BF16_ATOL, rtol=0)
    spec, _ = jtf.init_cache_spec(jcfg, 1, 96)
    for k, s in _flat(spec).items():
        assert str(_flat(tc)[k].dtype) == f"torch.{s.dtype}", k


def test_bf16_ssm_layers_and_logits_match_jax():
    """xLSTM at bf16, each layer on JAX's own input. At these perturbed
    weights the mLSTM is ill-conditioned in bf16 (its output divides by
    max(|q n|, exp(-m)), and q n comes near 0): noise of 0.01 on a
    layer's input moves JAX's own output by ~1.6, and JAX's bf16 differs
    from its fp32 by ~0.6, so two frameworks rounding at different points
    part ways within a layer or two. Holding each layer on the same input
    keeps the comparison about the port: every layer's output within one
    bf16 ulp of its magnitude (2**-7 x max |y|) of JAX's, the logits from
    JAX's last hidden state within LOGITS_BF16_ATOL, every state leaf
    fp32 as JAX's spec."""
    jcfg, tcfg = _configs("xlstm_1_3b")
    jparams, tparams = _bf16_params("xlstm_1_3b")
    prompt = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, 64).astype(np.int32)
    x = (jparams["embed"][jnp.asarray(prompt[None])]
         * jnp.asarray(jcfg.d_model ** 0.5, jnp.bfloat16))
    got_x = (tparams["embed"][torch.as_tensor(prompt[None])]
             * ttf.embed_scale(tcfg))
    assert np.array_equal(_np(got_x), _np(x))
    n_groups, n_m_per, _ = jtf._ssm_layout(jcfg)
    sspec = jxl.slstm_state_spec(jcfg, 1)
    layers = []
    for g in range(n_groups):
        layers += [("mlstm", i) for i in range(g * n_m_per,
                                               (g + 1) * n_m_per)]
        layers.append(("slstm", g))
    for key, i in layers:
        jp = jax.tree.map(lambda t: t[i], jparams[key])
        tp = ttf.layer_slice(tparams[key], i)
        xt = torch.as_tensor(_np(x)).to(torch.bfloat16)
        if key == "mlstm":
            want, jst = jxl.mlstm_forward(jp, x, jcfg, return_state=True)
            got, tst = txl.mlstm_forward(tp, xt, tcfg, return_state=True)
        else:
            zeros = {k: jnp.zeros(v.shape, v.dtype) for k, v in sspec.items()}
            want, jst = jxl.slstm_forward(jp, x, jcfg, state=zeros)
            got, tst = txl.slstm_forward(tp, xt, tcfg, state={
                k: torch.zeros(v.shape) for k, v in sspec.items()})
        assert got.dtype == torch.bfloat16
        assert all(v.dtype == torch.float32 for v in tst.values())
        ulp = 2 ** -7 * float(np.abs(_np(want)).max())
        _close(got, want, atol=ulp, rtol=0, what=f"{key} {i}")
        x = x + want
    # the head on JAX's last hidden state
    want = (jlayers.apply_norm(jparams["final_norm"], x, jcfg)[:, -1]
            @ jparams["head"]).astype(jnp.float32)
    xt = torch.as_tensor(_np(x)).to(torch.bfloat16)
    got = (tlayers.apply_norm(tparams["final_norm"], xt, tcfg)[:, -1]
           @ tparams["head"]).float()
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGITS_BF16_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: list(r.tokens) for r in eng.run()}


@pytest.mark.parametrize("arch", RECURRENT)
def test_slot_engine_streams_match_jax(arch):
    """Six requests (one chunk, two, three) through two slots, so slots are
    reused and a finished request's state is overwritten whole on
    admission: the port's SlotEngine streams == the JAX SlotEngine's."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (24, 64, 13, 96, 24, 64)]
    kw = dict(max_batch=2, max_len=128)
    want = _serve(JSlotEngine(jcfg, params=jparams, **kw), prompts)
    eng = SlotEngine(tcfg, params=tparams, device="cpu", **kw)
    got = _serve(eng, prompts)
    assert got == want and len(got) == 6
    assert eng.steps > 6


@pytest.mark.parametrize("arch", RECURRENT)
def test_prompt_lengths_jax_refuses_raise(arch):
    """A 40-token prompt is neither within one 32-token chunk nor a
    multiple of it: JAX's chunked scan asserts, the port raises (its
    SlotEngine at submit, before the request is queued)."""
    jcfg, jparams, tcfg, tparams = _both(arch)
    prompt = np.arange(40, dtype=np.int32)
    jeng = JSlotEngine(jcfg, params=jparams, max_batch=1, max_len=64)
    jeng.submit(prompt, max_new_tokens=2)
    with pytest.raises(AssertionError):
        jeng.run()
    eng = SlotEngine(tcfg, params=tparams, max_batch=1, max_len=64,
                     device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        eng.submit(prompt, max_new_tokens=2)
    assert not eng.waiting
    with pytest.raises(ValueError, match="multiple of 32"):
        tsteps.prefill_step(tparams, {"tokens": torch.as_tensor(
            prompt[None])}, tcfg, 64)
    ttf.check_prompt(tcfg, 32)
    ttf.check_prompt(tcfg, 96)


@pytest.mark.parametrize("arch", RECURRENT)
def test_make_engine_gives_slot_engine(arch):
    """As in JAX: the SlotEngine, the paged-only keywords dropped; no
    paged cache, no paged Engine, no chunk or verify pass."""
    _, tcfg = _configs(arch)
    jcfg, _ = _configs(arch)
    from repro.engine.core import make_engine as jmake
    assert isinstance(jmake(jcfg, max_batch=1, max_len=64), JSlotEngine)
    eng = make_engine(tcfg, max_batch=1, max_len=64, block_tokens=16,
                      num_blocks=8, preemption="swap", device="cpu")
    assert isinstance(eng, SlotEngine) and eng.cfg is tcfg
    # no reference cycle keeps a dropped engine's weights and state alive
    # until the cyclic collector runs (on the card: one model's memory)
    gc.disable()
    try:
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()
    eng = make_engine(tcfg, max_batch=1, max_len=64, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        ttf.init_paged_cache(tcfg, 1, 4, 16, 4, "cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        Engine(tcfg, max_batch=1, max_len=64, device="cpu")
    for mode in ("chunk", "verify"):
        with pytest.raises(NotImplementedError, match="not paged"):
            ttf.forward(eng.params, tcfg, tokens=torch.zeros(
                1, 4, dtype=torch.int32), mode=mode, caches=eng.caches,
                q_valid=torch.ones(1, dtype=torch.int32))


def _state_leaves(eng):
    return {f"{g}.{k}": t for g, c in eng.caches.items() if "length" not in c
            for k, t in c.items()}


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_pass_capturable_and_warm_up_restores_state(arch):
    """The SlotEngine's decode pass: a fresh engine's warm-up leaves the
    recurrent state all zeros (it restores by zeroing, keeping no copy);
    after its warm-up, over a run's real inputs, no op whose output shape
    or host value depends on data; the state written in place (its
    ``data_ptr()``s fixed); and a warm-up on a live engine mid-run changes
    no state and no stream."""
    _, tcfg = _configs(arch, **FP32)
    _, _, _, tparams = _both(arch)
    kw = dict(params=tparams, max_batch=2, max_len=128, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (24, 64, 32)]
    want = _serve(SlotEngine(tcfg, **kw), prompts)

    eng = SlotEngine(tcfg, **kw)
    leaves = _state_leaves(eng)
    assert leaves and not any(t.any() for t in leaves.values())
    ptrs = {k: t.data_ptr() for k, t in leaves.items()}
    p = eng.passes()["decode"]
    p.warm_up()
    assert not any(t.any() for t in leaves.values())
    mode = DataDependentOps()

    def recorded(*a, _body=p._body, **k):
        with mode:
            return _body(*a, **k)
    p._body = recorded
    for q in prompts:
        eng.submit(q, max_new_tokens=6)
    eng._admit()
    for _ in range(3):
        eng._step_decode()
    assert mode.seen and mode.bad == []
    live = _state_leaves(eng)
    assert {k: t.data_ptr() for k, t in live.items()} == ptrs
    assert any(t.any() for t in live.values())
    before = {k: t.clone() for k, t in live.items()}
    lengths = {g: c["length"].clone() for g, c in eng.caches.items()
               if "length" in c}
    p.warm_up()
    for k, t in live.items():
        assert torch.equal(t, before[k]), k
    for g, ln in lengths.items():
        assert torch.equal(eng.caches[g]["length"], ln), g
    eng.run()
    assert {r.rid: r.tokens for r in eng.finished} == want


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_cli_runs_on_cpu(arch, capsys):
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "3", "--max-len", "64"])
    assert len(done) == 3 and all(len(r.tokens) == 3 for r in done)
    assert f"arch={arch} device=cpu" in capsys.readouterr().out
