"""PyTorch port, model: reduced Gemma-2B with every weight perturbed (the
JAX init zeroes both output projections, which would hide attention) run
through the JAX package and the port on the same numpy weights; layer
units; the weight bridge; and the port's isolation from JAX and ``repro``."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.configs import guard_2b as jguard
from repro.models import layers as jlayers
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.configs import guard_2b as tguard
from repro_torch.models import layers as tlayers
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

SRC = Path(__file__).resolve().parents[1] / "src"

# fp32: same arithmetic, summation order differs between XLA and PyTorch
LOGITS_FP32_ATOL = 1e-4
# bf16: the two frameworks round matmul outputs and fused elementwise
# chains to bf16 at different points; logits here reach |5.7| where a bf16
# ulp is 2**-5, so allow four ulps
LOGITS_BF16_ATOL = 0.125


def _fp32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


def perturbed_params(cfg, seed=0, scale=0.1):
    """JAX init + seeded numpy noise on every leaf, as numpy arrays."""
    p, _ = jtf.init_model(_fp32(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * scale
                   ).astype(np.float32), p)


def _jax_paged(params, cfg, prompt, n_decode, bt, mb, feed=None):
    num_blocks = 2 * mb
    prefill = jax.jit(jsteps.prefill_step, static_argnums=(2, 3))
    serve = jax.jit(jsteps.serve_step, static_argnums=(3,))
    logits, dense = prefill(params, {"tokens": jnp.asarray(prompt[None])},
                            cfg, mb * bt)
    caches = jtf.init_paged_cache(cfg, 2, num_blocks, bt, mb)
    n = -(-len(prompt) // bt)
    ids = np.full((mb,), num_blocks, np.int32)
    ids[:n] = np.arange(5, 5 + n)                 # non-trivial page ids
    caches = jsteps.write_prefill_pages(caches, dense, jnp.asarray(ids),
                                        max_blocks=mb, block_tokens=bt)
    tabs = np.full((2, mb), num_blocks, np.int32)
    tabs[0] = ids
    tabs[0, n:] = np.arange(5 + n, 5 + mb)        # decode grows into these
    lens = np.array([len(prompt), 0], np.int32)
    out = [np.asarray(logits[0])]
    fed = []
    tok = int(np.argmax(out[0]))
    for i in range(n_decode):
        tok = feed[i] if feed is not None else tok
        fed.append(tok)
        g = caches["attn"]
        L = g["block_tables"].shape[0]
        g["block_tables"] = jnp.broadcast_to(jnp.asarray(tabs)[None],
                                             (L, *tabs.shape))
        g["length"] = jnp.broadcast_to(jnp.asarray(lens)[None],
                                       (L, *lens.shape))
        new, lg, caches = serve(
            params, jnp.asarray([[tok], [0]], jnp.int32), caches, cfg)
        out.append(np.asarray(lg[0]))
        lens[0] += 1
        tok = int(new[0])
    return out, fed


def _torch_paged(params, cfg, prompt, n_decode, bt, mb, feed):
    num_blocks = 2 * mb
    logits, dense = tsteps.prefill_step(params, {"tokens": torch.as_tensor(
        prompt[None])}, cfg, mb * bt)
    caches = ttf.init_paged_cache(cfg, 2, num_blocks, bt, mb, "cpu")
    n = -(-len(prompt) // bt)
    tsteps.write_prefill_pages(caches, dense, torch.arange(5, 5 + n),
                               block_tokens=bt)
    tabs = np.full((2, mb), num_blocks, np.int32)
    tabs[0] = np.arange(5, 5 + mb)
    lens = np.array([len(prompt), 0], np.int32)
    out = [logits[0].float().numpy()]
    for i in range(n_decode):
        g = caches["attn"]
        L = g["block_tables"].shape[0]
        g["block_tables"] = torch.as_tensor(tabs)[None].expand(L, 2, mb)
        g["length"] = torch.as_tensor(lens)[None].expand(L, 2)
        _, lg, caches = tsteps.serve_step(
            params, torch.tensor([[feed[i]], [0]], dtype=torch.int32),
            caches, cfg)
        out.append(lg[0].float().numpy())
        lens[0] += 1
    return out


@pytest.mark.parametrize("dtype,atol", [("float32", LOGITS_FP32_ATOL),
                                        ("bfloat16", LOGITS_BF16_ATOL)])
def test_prefill_and_decode_logits_match_jax(dtype, atol):
    """Prefill logits plus 4 paged decode steps (fed the JAX greedy
    tokens), reduced Gemma-2B with perturbed weights."""
    jcfg = jgemma.reduced().replace(param_dtype=dtype, compute_dtype=dtype)
    tcfg = tgemma.reduced().replace(param_dtype=dtype, compute_dtype=dtype)
    pn = perturbed_params(jgemma.reduced(), seed=1)
    assert np.abs(pn["layers"]["attn"]["wo"]).min() > 0
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), pn)
    tparams = weights.from_jax_params(
        jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, 21
                                               ).astype(np.int32)
    want, fed = _jax_paged(jparams, jcfg, prompt, 4, bt=8, mb=4)
    got = _torch_paged(tparams, tcfg, prompt, 4, 8, 4, fed)
    assert len(got) == 5
    for w, g in zip(want, got):
        assert g.shape == (jcfg.vocab_size,)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def test_init_model_matches_jax_tree():
    """Same keys, shapes and dtypes as the JAX pytree; output projections
    and norm gammas start at zero, as there."""
    cfg = tgemma.reduced()
    tp = ttf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jp, _ = jtf.init_model(jgemma.reduced(), jax.random.PRNGKey(0))
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"['{k}']")
        else:
            tflat[path] = t
    walk(tp, "")
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert tuple(v.shape) == tuple(tflat[k].shape), k
        assert str(v.dtype) == str(tflat[k].dtype).replace("torch.", ""), k
    assert not tp["layers"]["attn"]["wo"].any()
    assert not tp["layers"]["mlp"]["wo"].any()
    assert tp["embed"].float().std() > 0


def test_configs_match_jax():
    for tmod, jmod in ((tgemma, jgemma), (tguard, jguard)):
        assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(
            jmod.CONFIG)
        assert dataclasses.asdict(tmod.reduced()) == dataclasses.asdict(
            jmod.reduced())
    assert tguard.reduced().vocab_size == tgemma.reduced().vocab_size


# ---------------------------------------------------------------------------
# layer units
# ---------------------------------------------------------------------------

def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = tlayers.gelu(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6)
    one = torch.tensor([1.0])
    assert abs(float(tlayers.gelu(one)) - 0.84119) < 1e-5
    assert abs(float(torch.nn.functional.gelu(one)) - 0.84134) < 1e-5


def test_embed_scale_rounds_to_bf16_first():
    """JAX multiplies bf16 embeddings by the scale already rounded to bf16;
    a Python-float scale rounds differently on some values."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray((xj * jnp.asarray(2048 ** 0.5, jnp.bfloat16)
                       ).astype(jnp.float32))
    xt = torch.tensor(x).to(torch.bfloat16)
    got = (xt * ttf.embed_scale(tgemma.CONFIG)).float()
    np.testing.assert_array_equal(got.numpy(), want)
    assert (xt * 2048 ** 0.5).float().ne(got).any()


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_layers_match_jax(mlp_type):
    cfg = _fp32(tgemma.reduced()).replace(mlp_type=mlp_type)
    jcfg = _fp32(jgemma.reduced()).replace(mlp_type=mlp_type)
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, gamma, beta = f(2, 5, 64), f(64), f(64)
    tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.tensor(x), torch.tensor(gamma), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm(x, gamma, 1e-5)), **tol)
    np.testing.assert_allclose(
        tlayers.layer_norm(torch.tensor(x), torch.tensor(gamma),
                           torch.tensor(beta), 1e-5).numpy(),
        np.asarray(jlayers.layer_norm(x, gamma, beta, 1e-5)), **tol)
    h, pos = f(2, 5, 4, 16), np.arange(10, dtype=np.int32).reshape(2, 5)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.tensor(h), torch.tensor(pos), 1e4).numpy(),
        np.asarray(jlayers.apply_rope(h, pos, 1e4)), **tol)
    wi = f(64, 2, 256) if mlp_type in ("swiglu", "geglu") else f(64, 256)
    p = {"wi": wi * 0.1, "wo": f(256, 64) * 0.1}
    np.testing.assert_allclose(
        tlayers.apply_mlp({k: torch.tensor(v) for k, v in p.items()},
                          torch.tensor(x), cfg).numpy(),
        np.asarray(jlayers.apply_mlp(p, x, jcfg)), **tol)
    np.testing.assert_allclose(
        tlayers.softcap(torch.tensor(x), 3.0).numpy(),
        np.asarray(jlayers.softcap(x, 3.0)), **tol)


def test_weight_bridge_roundtrip_is_bit_exact():
    p, _ = jtf.init_model(jgemma.reduced(), jax.random.PRNGKey(4))
    pn = jax.tree.map(np.asarray, p)                         # bf16 numpy
    tp = weights.from_jax_params(pn, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    back = weights.to_numpy(tp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a, np.float32), b), pn, back)
    t32 = weights.from_jax_params(pn, "cpu", torch.float32)
    assert t32["layers"]["attn"]["wq"].dtype == torch.float32


def test_guard_draft_tree_crosses_the_bridge():
    """The speculative draft's tree (reduced Guard-2B, untied head) crosses
    bit for bit, with the keys and shapes of the port's own init."""
    p, _ = jtf.init_model(jguard.reduced(), jax.random.PRNGKey(5))
    pn = jax.tree.map(np.asarray, p)
    tp = weights.from_jax_params(pn, "cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a, np.float32), b), pn, weights.to_numpy(tp))
    own = ttf.init_model(tguard.reduced(), torch.Generator().manual_seed(0),
                         "cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else
                        (tuple(v.shape), v.dtype) for k, v in t.items()}
    assert shapes(tp) == shapes(own) and "head" in own


# ---------------------------------------------------------------------------
# isolation: the port imports neither jax nor anything of repro
# ---------------------------------------------------------------------------

def _port_modules():
    root = SRC / "repro_torch"
    return sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  .replace(".__init__", "")
                  for p in root.rglob("*.py"))


def test_port_imports_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.engine.core" in mods and len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.') "
        "or n == 'msgpack' or n.startswith('msgpack.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_never_name_jax_or_repro_imports():
    """Nor msgpack: the card machine has no msgpack package, so the
    checkpoints' msgpack is written and read in plain Python."""
    import re
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"|import\s+repro\.|from\s+repro\b|from\s+repro\."
                     r"|import\s+msgpack\b|from\s+msgpack\b)", re.M)
    hits = [str(p) for p in (SRC / "repro_torch").rglob("*.py")
            if pat.search(p.read_text())]
    assert hits == []
    smoke = (SRC.parent / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and not pat.search(smoke)
    # the card's tools (tools/dist_cards.py serves over four cards)
    tools = [str(p) for p in (SRC.parent / "tools").glob("*.py")
             if pat.search(p.read_text())]
    assert tools == []
    # the port's examples (serve_e2e_torch.py replays in repro_torch.core)
    examples = sorted((SRC.parent / "examples").glob("*_torch.py"))
    assert examples
    assert [str(p) for p in examples if pat.search(p.read_text())] == []
