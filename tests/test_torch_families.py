"""PyTorch port, the other dense-attention configs: Llama-3-70B,
InternLM2-20B, Nemotron-4-340B (dense GQA, head dim 8 when reduced) and
Pixtral-12B (the vlm, on its text path and from stub-frontend embeddings).
Each reduced config runs through the JAX package and the port on the same
perturbed numpy weights at fp32: configs and parameter trees equal, prefill
and decode logits over dense and paged caches, the paged ``Engine``'s
greedy streams against the JAX ``Engine``'s and the port's ``SlotEngine``'s;
the layer-by-layer ``init_model`` against stacking whole block trees; the
serve CLI; and the audio encoder's refusal to serve, as in JAX."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hubert_xlarge as jhubert
from repro.engine.runner import Engine as JEngine
from repro.launch import serve as jserve
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import ARCH_IDS
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.runner import Engine, SlotEngine, make_engine
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

FAMILIES = ("llama3_70b", "internlm2_20b", "nemotron_4_340b", "pixtral_12b")
# fp32: same arithmetic, summation order differs between XLA and PyTorch
LOGITS_FP32_ATOL = 1e-4
BT, MB = 8, 4                    # paged caches: 4 pages of 8 tokens a row
N_DECODE = 3


def _configs(arch):
    """(JAX reduced config, port reduced config), both at fp32."""
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    return jmod.reduced().replace(**fp32), tmod.reduced().replace(**fp32)


def _perturbed(jcfg, seed):
    """JAX init + seeded numpy noise on every leaf (the JAX init zeroes the
    output projections and norm gammas), as numpy arrays."""
    p, _ = jtf.init_model(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.1
                   ).astype(np.float32), p)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(arch, JAX cfg, JAX params, port cfg, port params) at fp32."""
    jcfg, tcfg = _configs(request.param)
    pn = _perturbed(jcfg, seed=7)
    return (request.param, jcfg, jax.tree.map(jnp.asarray, pn), tcfg,
            weights.from_jax_params(pn, "cpu"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_match_jax(arch):
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    assert arch in ARCH_IDS
    assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(tmod.reduced()) == dataclasses.asdict(
        jmod.reduced())


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_model_matches_jax_tree(arch):
    """Same keys, shapes and dtypes as the JAX pytree, ``frontend_proj``
    included for the stub-frontend vlm."""
    jmod = importlib.import_module(f"repro.configs.{arch}")
    tmod = importlib.import_module(f"repro_torch.configs.{arch}")
    tp = _flat(ttf.init_model(tmod.reduced(),
                              torch.Generator().manual_seed(0), "cpu"))
    jp = _flat(jtf.init_model(jmod.reduced(), jax.random.PRNGKey(0))[0])
    assert sorted(tp) == sorted(jp)
    assert ("frontend_proj" in tp) == (arch == "pixtral_12b")
    for k, v in jp.items():
        assert tuple(v.shape) == tuple(tp[k].shape), k
        assert str(v.dtype) == str(tp[k].dtype).replace("torch.", ""), k
    assert not tp["layers.attn.wo"].any() and tp["embed"].float().std() > 0


def _stacked_init(cfg, gen):
    """The parameters as ``init_model`` drew them before it filled the
    layers in place: every block tree drawn, then ``torch.stack``ed."""
    init = tlayers.Initializer(cfg, gen, "cpu")
    d = cfg.d_model
    p = {"embed": init.w((cfg.vocab_size, d), scale=d ** -0.5)}
    if cfg.stub_frontend:
        p["frontend_proj"] = init.w((cfg.frontend_dim, d))
    p["final_norm"] = tlayers.init_norm(init, cfg, d)
    if not cfg.tie_embeddings:
        p["head"] = init.w((d, cfg.vocab_size), scale=d ** -0.5)
    blocks = [_flat(ttf._init_block(init, cfg))
              for _ in range(cfg.num_layers)]
    p = _flat(p)
    p.update({f"layers.{k}": torch.stack([b[k] for b in blocks])
              for k in blocks[0]})
    return p


@pytest.mark.parametrize("arch", FAMILIES + ("gemma_2b",))
def test_layer_by_layer_init_equals_stacked_blocks(arch):
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").reduced()
    cfg = cfg.replace(num_layers=3)
    got = _flat(ttf.init_model(cfg, torch.Generator().manual_seed(11),
                               "cpu"))
    want = _stacked_init(cfg, torch.Generator().manual_seed(11))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _jax_logits(params, cfg, prompt):
    """Prefill, then N_DECODE greedy steps over the dense prefill cache and
    the same steps (fed the same tokens) over paged caches, row 0 of 2.
    Returns (prefill logits, dense decode logits, paged decode logits,
    fed tokens)."""
    prefill = jax.jit(jsteps.prefill_step, static_argnums=(2, 3))
    serve_ = jax.jit(jsteps.serve_step, static_argnums=(3,))
    logits, dense = prefill(params, {"tokens": jnp.asarray(prompt[None])},
                            cfg, MB * BT)
    first = np.asarray(logits[0])
    fed, dense_out = [int(np.argmax(first))], []
    c = dense
    for _ in range(N_DECODE):
        new, lg, c = serve_(params, jnp.asarray([[fed[-1]]], jnp.int32), c,
                            cfg)
        dense_out.append(np.asarray(lg[0]))
        fed.append(int(new[0]))
    fed = fed[:N_DECODE]
    num_blocks = 2 * MB
    caches = jtf.init_paged_cache(cfg, 2, num_blocks, BT, MB)
    n = -(-len(prompt) // BT)
    ids = np.full((MB,), num_blocks, np.int32)
    ids[:n] = np.arange(3, 3 + n)
    caches = jsteps.write_prefill_pages(caches, dense, jnp.asarray(ids),
                                        max_blocks=MB, block_tokens=BT)
    tabs = np.full((2, MB), num_blocks, np.int32)
    tabs[0] = np.arange(3, 3 + MB)
    lens = np.array([len(prompt), 0], np.int32)
    paged_out = []
    for tok in fed:
        g = caches["attn"]
        L = g["block_tables"].shape[0]
        g["block_tables"] = jnp.broadcast_to(jnp.asarray(tabs)[None],
                                             (L, *tabs.shape))
        g["length"] = jnp.broadcast_to(jnp.asarray(lens)[None],
                                       (L, *lens.shape))
        _, lg, caches = serve_(params, jnp.asarray([[tok], [0]], jnp.int32),
                               caches, cfg)
        paged_out.append(np.asarray(lg[0]))
        lens[0] += 1
    return first, dense_out, paged_out, fed


def _torch_logits(params, cfg, prompt, fed):
    """The port's twin of ``_jax_logits``, fed the JAX greedy tokens."""
    logits, dense = tsteps.prefill_step(
        params, {"tokens": torch.as_tensor(prompt[None])}, cfg, MB * BT)
    first = logits[0].numpy()
    dense_out, paged_out = [], []
    num_blocks = 2 * MB
    caches = ttf.init_paged_cache(cfg, 2, num_blocks, BT, MB, "cpu")
    n = -(-len(prompt) // BT)
    tsteps.write_prefill_pages(caches, dense, torch.arange(3, 3 + n),
                               block_tokens=BT)
    for tok in fed:
        _, lg, dense = tsteps.serve_step(
            params, torch.tensor([[tok]], dtype=torch.int32), dense, cfg)
        dense_out.append(lg[0].numpy())
    tabs = np.full((2, MB), num_blocks, np.int32)
    tabs[0] = np.arange(3, 3 + MB)
    lens = np.array([len(prompt), 0], np.int32)
    for tok in fed:
        g = caches["attn"]
        L = g["block_tables"].shape[0]
        g["block_tables"] = torch.as_tensor(tabs)[None].expand(L, 2, MB)
        g["length"] = torch.as_tensor(lens)[None].expand(L, 2)
        _, lg, caches = tsteps.serve_step(
            params, torch.tensor([[tok], [0]], dtype=torch.int32), caches,
            cfg)
        paged_out.append(lg[0].numpy())
        lens[0] += 1
    return first, dense_out, paged_out


def test_prefill_and_decode_logits_match_jax(family):
    """Prefill logits and N_DECODE decode steps over dense and over paged
    caches within LOGITS_FP32_ATOL of JAX's; for the vlm also prefill from
    stub-frontend embeddings."""
    arch, jcfg, jparams, tcfg, tparams = family
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, 21
                                               ).astype(np.int32)
    jfirst, jdense, jpaged, fed = _jax_logits(jparams, jcfg, prompt)
    tfirst, tdense, tpaged = _torch_logits(tparams, tcfg, prompt, fed)
    assert len(tdense) == len(tpaged) == N_DECODE
    for w, g in zip([jfirst, *jdense, *jpaged], [tfirst, *tdense, *tpaged]):
        assert g.shape == (jcfg.vocab_size,)
        np.testing.assert_allclose(g, w, atol=LOGITS_FP32_ATOL, rtol=0)
    if jcfg.stub_frontend:
        emb = np.random.default_rng(3).standard_normal(
            (2, 21, jcfg.frontend_dim)).astype(np.float32)
        want, _ = jsteps.prefill_step(jparams, {"embeds": jnp.asarray(emb)},
                                      jcfg, MB * BT)
        got, caches = tsteps.prefill_step(
            tparams, {"embeds": torch.as_tensor(emb)}, tcfg, MB * BT)
        assert got.shape == (2, jcfg.vocab_size)
        assert caches["attn"]["length"].eq(21).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_FP32_ATOL, rtol=0)


def _streams(eng, prompts, max_new=5):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: list(r.tokens) for r in eng.run()}


def test_engine_streams_match_jax_and_slot_engine(family):
    """Greedy streams of the port's paged Engine == the JAX Engine's == the
    port's SlotEngine's, three requests through two slots."""
    arch, jcfg, jparams, tcfg, tparams = family
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, 12).astype(np.int32)
               for _ in range(3)]
    kw = dict(max_batch=2, max_len=64)
    want = _streams(JEngine(jcfg, params=jparams, block_tokens=16, **kw),
                    prompts)
    eng = Engine(tcfg, params=tparams, block_tokens=16, device="cpu", **kw)
    got = _streams(eng, prompts)
    slot = _streams(SlotEngine(tcfg, params=tparams, device="cpu", **kw),
                    prompts)
    assert got == want == slot
    assert all(len(t) == 5 for t in got.values())
    assert eng.store.used_blocks == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_runs_each_family_on_cpu(arch, capsys):
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--max-len", "64"])
    assert len(done) == 2 and all(len(r.tokens) == 3 for r in done)
    assert f"arch={arch} device=cpu" in capsys.readouterr().out


def test_audio_encoder_has_no_serving_path_as_in_jax():
    """HuBERT is encoder-only (``supports_decode`` is false): its decode,
    its caches and ``make_engine`` refuse, and ``serve --arch
    hubert_xlarge`` exits with the JAX launcher's message. Its serving
    entry, ``prefill_step``'s encoder forward, is held against JAX in
    tests/test_torch_train.py."""
    cfg = ModelConfig(**dataclasses.asdict(jhubert.reduced()))
    assert not cfg.supports_decode and not jhubert.reduced().supports_decode
    params = ttf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    msg = "encoder-only; no serving path"
    tok = torch.zeros(1, 1, dtype=torch.int32)
    for fn in (lambda: make_engine(cfg, max_batch=1, max_len=16,
                                   device="cpu"),
               lambda: ttf.init_cache(cfg, 1, 16, "cpu"),
               lambda: ttf.init_paged_cache(cfg, 1, 4, 8, 2, "cpu"),
               lambda: ttf.forward(params, cfg, tokens=tok, mode="decode",
                                   caches={}),
               lambda: ttf.forward(params, cfg, tokens=tok)):
        with pytest.raises(ValueError, match=msg):
            fn()
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", "hubert_xlarge", "--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jserve.main(["--arch", "hubert_xlarge"])
    assert str(got.value) == str(want.value) == f"hubert_xlarge is {msg}"
