"""PyTorch port, the recurrent families served under a mesh and
sequence-sharded decode on the CPU, held against the JAX package.

As in ``tests/test_torch_dist_serve.py`` the sharded runs are gloo ranks
spawned once for the module (``repro_torch.launch.mesh.spawn`` running
``_torch_dist_jobs.run``), beside one JAX subprocess that computes the
references: JAX's single-device steps under jit, in fp32 at the reduced
configs (JAX's own sharded steps equal them within 2.4e-6 for these
configs and meshes). Held:

(a) the params' and caches' layouts of zamba2_7b (hybrid) and xlstm_1_3b
    (ssm) under ``ShardingRules`` on the (2, 2), (1, 4), (2, 2, 2) and
    (2, 4) stub meshes, with and without ``seq_sharded``: the port's
    (``transformer.param_specs``, ``cache_specs``) == JAX's ``tree_specs``
    but where the port's Mamba2 entry (``distributed.Mamba2Read``: a
    rank's heads' channels, B and C whole) stands for JAX's contiguous
    "model" split; on the ranks, every rank's shards gather back to the
    whole leaves bit for bit;
(b) the sharded ``prefill_step`` (fp32 caches) and 4 ``serve_step``s at
    fp32, batch 4 x 16 == JAX's single-device steps: zamba2_7b on (2, 2)
    and (2, 2, 2), xlstm_1_3b on (2, 2) and (1, 4) (one head a rank):
    logits within 1e-5 of their largest, greedy tokens equal, the
    gathered states and K/V within 1e-5 of each leaf's largest;
(c) decode under ``seq_sharded`` (batch 1, the cache's 32 positions split
    over 2 data ranks) for zamba2_7b and llama3_70b (GQA through the same
    path) on (2, 2), as (b): a 14-token prompt whose steps cross from data
    rank 0's slice into rank 1's, a 5-token prompt that leaves rank 1's
    slice empty, and a 32-token prompt that fills the cache, so that each
    step writes at the clamp S - 1;
(d) the merge alone, no ranks: the plain ``decode_attention``'s outputs
    and log-sum-exps over a cache cut into 1-4 slices, one of them empty,
    merged by ``attention.merge_stacked`` (``merge_slices``' arithmetic),
    equal the whole cache's within 1e-6 at fp32; an empty row's lse is
    -inf.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_jobs as jobs
from repro.configs import get_config as jget
from repro.configs import get_reduced_config as jreduced
from repro.models import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch import distributed as D
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels import ref
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as ttf
from test_torch_dist_serve import (FP32, STEPS, _flat, _perturbed_params,
                                   _serving_close, _StubMesh, _sub)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, PROMPT, MAX_LEN = 4, 16, 24
SEQ_LEN = 32
MESH22 = dict(mesh=[2, 2], axes=["data", "model"])
MESHES = {(2, 2): ("data", "model"), (1, 4): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model"), (2, 4): ("data", "model")}
RECURRENT = ("zamba2_7b", "xlstm_1_3b")
# (b): each case's arch, mesh; the inputs are the arch's
SERVE = {
    "zamba2_7b_22": dict(arch="zamba2_7b", **MESH22),
    "zamba2_7b_222": dict(arch="zamba2_7b", mesh=[2, 2, 2],
                          axes=["pod", "data", "model"]),
    "xlstm_1_3b_22": dict(arch="xlstm_1_3b", **MESH22),
    "xlstm_1_3b_14": dict(arch="xlstm_1_3b", mesh=[1, 4],
                          axes=["data", "model"]),
}
# (c): prompt lengths in a SEQ_LEN-position cache over 2 data ranks
SEQ_PROMPTS = {"cross": 14, "empty": 5, "clamp": SEQ_LEN}
SEQ_ARCHS = ("zamba2_7b", "llama3_70b")
SEEDS = {"zamba2_7b": 0, "xlstm_1_3b": 1, "llama3_70b": 2}
RTOL = 1e-5                # of the largest entry: fp32, other sum orders
# xLSTM at these weights is ill-conditioned in fp32 (as in
# tests/test_torch_train_families.py): JAX's own fp32 steps lie up to
# 1.4e-4 (sLSTM state) and 2.2e-5 (logits) of each leaf's largest from its
# float64 steps, so two fp32 sum orders part by more than RTOL. Its cases
# are held against JAX's float64 steps, within the larger of RTOL and
# F64_FACTOR x JAX's own fp32 error (measured: the sharded port's error
# is at most 1.3 x JAX's)
F64 = ("xlstm_1_3b",)
F64_FACTOR = 2


def _inputs(arch, b, n):
    """The name of the inputs of ``arch`` at a batch of ``b`` x ``n``."""
    return f"{arch}_{b}x{n}"


# JAX's single-device references in one subprocess: for each input set,
# the prefill (``forward`` in mode "prefill" over fp32 caches) and STEPS
# serve_steps fed their own greedy tokens, each jitted once a config
_JAX = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced_config
from repro.models import steps, transformer as tf

d = sys.argv[1]
runs = json.load(open(f"{d}/jax_runs.json"))

def load(path):
    out = {}
    with np.load(path) as z:
        for k in z.files:
            node = out
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(z[k])
    return out

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out

def serve(arch, name, max_len, replace, n_steps, dtype, feed=None):
    cfg = get_reduced_config(arch).replace(**replace)
    key = (arch, str(dtype))
    if key not in jitted:
        jitted[key] = (
            jax.jit(lambda p, c, t, cfg=cfg: tf.forward(
                p, cfg, mode="prefill", caches=c, tokens=t)[:2]),
            jax.jit(lambda p, t, c, cfg=cfg: steps.serve_step(p, t, c, cfg)))
    pre, step = jitted[key]
    params = jax.tree.map(lambda a: a.astype(dtype),
                          load(f"{d}/{name}_params.npz"))
    tokens = load(f"{d}/{name}_batch.npz")["tokens"]
    cspec, _ = tf.init_cache_spec(cfg, tokens.shape[0], max_len)
    caches = jax.tree.map(lambda s: jnp.zeros(s.shape, dtype if jnp.issubdtype(
        s.dtype, jnp.floating) else s.dtype), cspec)
    logits, caches = pre(params, caches, tokens)
    res = {"prefill": logits, **{f"cache_prefill/{k}": v
                                 for k, v in flat(caches).items()}}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(n_steps):
        if feed is not None:
            tok = jnp.asarray(feed[f"tokens{i - 1}"] if i else
                              np.argmax(feed["prefill"], -1).astype(np.int32))
        tok, logits, caches = step(params, tok[:, None], caches)
        res[f"logits{i}"], res[f"tokens{i}"] = logits, tok
    res.update({f"cache/{k}": v for k, v in flat(caches).items()})
    return {k: np.asarray(v) for k, v in res.items()}

jitted = {}
out = {}
for run in runs:
    arch, name = run["arch"], run["name"]
    res = serve(arch, name, run["max_len"], run["replace"], run["steps"],
                jnp.float32)
    out.update({f"{name}/{k}": v for k, v in res.items()})
    if run.get("f64"):
        # the same steps in float64, fed the fp32 run's tokens
        with jax.enable_x64(True):
            f64 = serve(arch, name, run["max_len"],
                        {**run["replace"], "param_dtype": "float64",
                         "compute_dtype": "float64",
                         "logits_dtype": "float64"},
                        run["steps"], jnp.float64, feed=res)
        out.update({f"{name}/f64/{k}": v for k, v in f64.items()})
np.savez(f"{d}/jax.npz", **out)
"""


def _write_inputs(d, arch, b, n):
    """Seeded params (the arch's, shared by its cases) and a b x n batch
    of tokens; returns the inputs' name."""
    name = _inputs(arch, b, n)
    tcfg = get_reduced_config(arch).replace(**FP32)
    path = f"{d}/{name}_params.npz"
    if not os.path.exists(path):
        np.savez(path, **_perturbed_params(tcfg, SEEDS[arch]))
        rng = np.random.default_rng(100 + SEEDS[arch] + 7 * n + b)
        np.savez(f"{d}/{name}_batch.npz", tokens=rng.integers(
            0, tcfg.vocab_size, (b, n)).astype(np.int32))
    return name


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes every case's inputs, then runs the JAX subprocess and the 8
    torch ranks side by side. Returns (directory, JAX's results)."""
    d = str(tmp_path_factory.mktemp("dist_recurrent"))
    specs, runs = [], {}
    for name, case in SERVE.items():
        data = _write_inputs(d, case["arch"], BATCH, PROMPT)
        runs[data] = dict(arch=case["arch"], name=data, max_len=MAX_LEN,
                          f64=case["arch"] in F64)
        specs.append({"job": "serve", "name": name, "data": data,
                      "replace": FP32, "max_len": MAX_LEN, "steps": STEPS,
                      **case})
    for arch in SEQ_ARCHS:
        for tag, n in SEQ_PROMPTS.items():
            data = _write_inputs(d, arch, 1, n)
            runs[data] = dict(arch=arch, name=data, max_len=SEQ_LEN)
            specs.append({"job": "serve", "name": f"{arch}_seq_{tag}",
                          "data": data, "arch": arch, "replace": FP32,
                          "max_len": SEQ_LEN, "steps": STEPS,
                          "seq_sharded": True, **MESH22})
    with open(f"{d}/jobs.json", "w") as f:
        json.dump(specs, f)
    with open(f"{d}/jax_runs.json", "w") as f:
        json.dump([{**r, "replace": FP32, "steps": STEPS}
                   for r in runs.values()], f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX, d], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        tmesh.spawn(jobs.run, 8, (d,), device="cpu")
    finally:
        err = proc.communicate(timeout=300)[1]
    assert proc.returncode == 0, err[-4000:]
    return d, dict(np.load(f"{d}/jax.npz"))


def _out(d, name):
    return dict(np.load(f"{d}/out_{name}.npz"))


# ---------------------------------------------------------------------------
# (a): layouts (no ranks)
# ---------------------------------------------------------------------------

def _pair(arch, reduced):
    return ((jreduced(arch), get_reduced_config(arch)) if reduced
            else (jget(arch), get_config(arch)))


def _port_entry_matches(got, want, where):
    """One spec of the port's layout against JAX's: equal entry for entry,
    but a ``Mamba2Read`` where JAX has "model"."""
    assert len(got) == len(want), where
    for e, w in zip(got, want):
        if isinstance(e, D.Mamba2Read):
            assert w == "model", where
        else:
            assert e == w, where


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_param_layout_is_jaxs_but_the_mamba2_entry(arch, seq):
    """``transformer.param_specs`` == JAX's spec of every leaf (its
    ``ShardingRules.spec`` over ``init_model``'s axes, the tests of
    ``tests/test_torch_distributed.py`` hold ``param_axes`` equal), but
    a Mamba2 leaf's concatenated channels: in_proj, conv_w and conv_b
    carry ``Mamba2Read`` wherever JAX splits them over "model"."""
    for reduced in (True, False):
        _, tcfg = _pair(arch, reduced)
        axes, shapes = ttf.param_axes(tcfg), ttf.param_shapes(tcfg)
        for shape, names in MESHES.items():
            jr = jsharding.ShardingRules(_StubMesh(shape, names),
                                         seq_sharded=seq)
            got = ttf.param_specs(tcfg, tsharding.ShardingRules(
                _StubMesh(shape, names), seq_sharded=seq))
            reads = 0
            for path, spec in got.items():
                want = tuple(jr.spec(shapes[path], axes[path]))
                _port_entry_matches(tuple(spec), want, (arch, shape, path))
                reads += any(isinstance(e, D.Mamba2Read) for e in spec)
            if arch == "zamba2_7b" and shape[-1] in (2, 4):
                assert reads == 3, (reduced, shape)


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_cache_layout_is_jaxs_but_the_port_entries(arch, seq, v2):
    """``transformer.cache_specs`` == JAX's ``tree_specs`` of its
    ``init_cache_spec``, but the Mamba2 conv window's channels
    (``Mamba2Read``) and the shared block's kv heads where JAX splits the
    head dim (``HeadsRead``, as for the dense families); under
    ``seq_sharded`` the batch is replicated and the shared block's K/V
    sequence is on the data axes; under ``shard_v2`` (its ``cache_seq``)
    also on "model" where the kv heads do not take it, every kv head then
    whole on a model rank, as in JAX."""
    for reduced in (True, False):
        jcfg, tcfg = _pair(arch, reduced)
        if v2:
            jcfg, tcfg = jcfg.replace(shard_v2=True), tcfg.replace(
                shard_v2=True)
        jspec, jaxes = jtf.init_cache_spec(jcfg, BATCH, SEQ_LEN)
        for shape, names in MESHES.items():
            jr = jsharding.ShardingRules(_StubMesh(shape, names),
                                         seq_sharded=seq)
            want = _flat(jsharding.tree_specs(jr, jspec, jaxes))
            got = _flat(ttf.cache_specs(tcfg, tsharding.ShardingRules(
                _StubMesh(shape, names), seq_sharded=seq), BATCH, SEQ_LEN))
            assert sorted(got) == sorted(want)
            for path, spec in got.items():
                w = tuple(want[path])
                if path.startswith("attn/") and path != "attn/length":
                    assert spec[3] in (w[3], D.HeadsRead(
                        tcfg.num_heads, tcfg.num_kv_heads)), path
                    assert spec[4] is None and spec[:3] == w[:3], path
                else:
                    _port_entry_matches(tuple(spec), w, (arch, shape, path))
                if seq:
                    assert spec[1] is None, path       # the batch whole
            if seq and arch == "zamba2_7b" and not v2:
                data = tuple(a for a in ("pod", "data") if a in names)
                want_seq = data if len(data) > 1 else data[0]
                assert got["attn/k"][2] == want_seq
            if arch == "zamba2_7b" and "model" in D.group_of(
                    got["attn/k"][2]):
                assert got["attn/k"][3] is None       # every kv head


def test_mamba2_read_takes_a_ranks_heads():
    """``Mamba2Read`` of in_proj (d_in 8, state 2, 4 heads): rank 1 of 2
    holds z and x of its d_in / 2 channels, B and C whole and dt of its
    heads, in the leaf's order."""
    read = D.Mamba2Read.in_proj(8, 2, 4)
    t = torch.arange(8 + 8 + 4 + 4, dtype=torch.float32)[None]
    ax = D.Axis(None, 2, 1, ("model",))
    assert read.take(t, 1, ax).tolist() == [[4, 5, 6, 7, 12, 13, 14, 15, 16,
                                             17, 18, 19, 22, 23]]
    assert read.local_size(ax) == 14
    assert D.Mamba2Read.conv(8, 2).take(t[:, :12], 1, ax).tolist() == [
        [4, 5, 6, 7, 8, 9, 10, 11]]


# ---------------------------------------------------------------------------
# (d): the merge of sequence slices (no ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cuts", [(), (9,), (0, 17), (5, 5, 30), (3, 11, 20)])
def test_merged_slices_equal_the_whole_cache(cuts):
    """The plain decode over each slice of a 32-position cache (rows of
    lengths 32, 21, 9, 1), with its lse, merged == the plain decode over
    the whole cache within 1e-6 at fp32; a slice past a row's length
    (empty for it, ``cuts`` has empty ones) gives lse -inf and weight 0."""
    gen = torch.Generator().manual_seed(len(cuts))
    b, S, nh, kvh, d = 4, 32, 4, 2, 16
    q = torch.randn(b, 1, nh, d, generator=gen)
    k, v = (torch.randn(b, S, kvh, d, generator=gen) for _ in range(2))
    lens = torch.tensor([32, 21, 9, 1], dtype=torch.int32)
    whole = ref.decode_attention(q, k, v, lens)
    bounds = [0, *cuts, S]
    outs, lses = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        local = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
        o, lse = ref.decode_attention(q, k[:, lo:hi], v[:, lo:hi], local,
                                      return_lse=True)
        dead = local == 0
        assert torch.isneginf(lse[dead]).all()
        assert torch.isfinite(lse[~dead]).all()
        outs.append(o)
        lses.append(lse)
    got = tattn.merge_stacked(outs, lses)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


def test_plain_lse_is_the_rows_logsumexp():
    """``ref.decode_attention(return_lse=True)``: the same output as
    without it, and each row's log-sum-exp of its scaled scores over its
    valid positions."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, 4, 8, generator=gen)
    k, v = (torch.randn(2, 10, 1, 8, generator=gen) for _ in range(2))
    lens = torch.tensor([10, 0], dtype=torch.int32)
    out, lse = ref.decode_attention(q, k, v, lens, return_lse=True)
    assert torch.equal(out, ref.decode_attention(q, k, v, lens))
    want = torch.logsumexp(torch.einsum("bqhd,bsd->bhs", q[:1],
                                        k[:1, :, 0]) * 8 ** -0.5, -1)
    np.testing.assert_allclose(lse[:1].numpy(), want.numpy(), rtol=1e-6)
    assert torch.isneginf(lse[1]).all()


# ---------------------------------------------------------------------------
# (b), (c): the ranks' results
# ---------------------------------------------------------------------------

def _held_to_f64(out, j32, j64, what):
    """xLSTM's ``job_serve`` outputs: tokens equal JAX's fp32 steps', and
    each pass's logits and each cache leaf within the larger of RTOL and
    F64_FACTOR x JAX's own fp32 error of JAX's float64 steps (fed JAX's
    fp32 tokens), as shares of the float64 leaf's largest entry. Returns
    the largest share of JAX's own fp32 error."""
    for i in range(STEPS):
        np.testing.assert_array_equal(out[f"tokens{i}"], j32[f"tokens{i}"],
                                      err_msg=f"{what} tokens {i}")
    own_max = 0.0
    for k, w in j64.items():
        if k.startswith("tokens") or k.endswith("length"):
            continue
        top = np.abs(w).max()
        own = np.abs(j32[k] - w).max() / top
        got = np.abs(out[k] - w).max() / top
        own_max = max(own_max, own)
        assert got <= max(RTOL, F64_FACTOR * own), (what, k, got, own)
    return own_max


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_recurrent_serving_matches_jax(world, name):
    d, ref_ = world
    case = SERVE[name]
    out = _out(d, name)
    assert float(out["roundtrip"]) == 1.0
    inputs = _inputs(case["arch"], BATCH, PROMPT)
    if case["arch"] in F64:
        own = _held_to_f64(out, _sub(ref_, inputs),
                           _sub(ref_, f"{inputs}/f64"), name)
        assert own > RTOL       # the conditioning that widens the bound
    else:
        _serving_close(out, _sub(ref_, inputs), name)


@pytest.mark.parametrize("tag", list(SEQ_PROMPTS))
@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_seq_sharded_decode_matches_jax(world, arch, tag):
    d, ref_ = world
    name = f"{arch}_seq_{tag}"
    out = _out(d, name)
    assert float(out["roundtrip"]) == 1.0
    _serving_close(out, _sub(ref_, _inputs(arch, 1, SEQ_PROMPTS[tag])),
                   name)


def test_seq_sharded_caches_hold_the_ranks_positions(world):
    """Rank 0's K cache under ``seq_sharded`` on (2, 2): (apps or layers,
    the whole batch of 1, half the positions, its kv heads, the whole
    head dim)."""
    d, _ = world
    assert _out(d, "zamba2_7b_seq_cross")["local_k_shape"].tolist() == [
        2, 1, SEQ_LEN // 2, 2, 16]
    assert _out(d, "llama3_70b_seq_cross")["local_k_shape"].tolist() == [
        2, 1, SEQ_LEN // 2, 1, 8]
