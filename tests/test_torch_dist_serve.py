"""PyTorch port, serving under a mesh on the CPU: the dense caches' logical
axes and layout, and the sharded ``prefill_step`` / ``serve_step``, held
against the JAX package.

As in ``tests/test_torch_distributed.py`` the sharded runs are gloo ranks
spawned once for the module (``repro_torch.launch.mesh.spawn`` running
``_torch_dist_jobs.run``), beside JAX subprocesses with 8 host devices
that compute every reference: JAX's single-device steps and, for what
needs JAX's own sharding (its ``shard_map`` MoE dropping rows past each
data shard's capacity), its sharded steps. Held:

(a) ``attention.cache_axes`` and ``transformer.init_cache_spec`` == JAX's
    (shapes, dtypes, axes) for every registered config, reduced and full,
    also under ``shard_v2``; their specs under ``ShardingRules`` == JAX's
    ``tree_specs`` on the (16, 16), (2, 16, 16), (2, 2, 2) and (2, 4) stub
    meshes, and the port's layout (``transformer.cache_specs``) == JAX's
    but where it keeps the head dim or the latent whole;
(b) the sharded ``prefill_step`` (fp32 caches) and 4 ``serve_step``s at
    fp32 == JAX's single-device steps: reduced gemma_2b on (2, 2) (one kv
    head, whole head dim), llama3_70b on (2, 2, 2) (kv heads split) and on
    (2, 4) (2 kv heads on a model axis of 4: JAX puts "model" on the head
    dim), pixtral_12b (2, 2) prefilled from embeds, deepseek_v2_lite_16b
    (2, 2) naive and absorbed (MLA and expert parallelism, no drops at
    capacity slack 8): logits within 1e-5 of their largest, greedy tokens
    equal, the gathered caches within 1e-5;
(c) hubert_xlarge's sharded ``prefill_step`` and train step == JAX's;
(d) v2-lite at capacity slack 1.0, where each data shard drops rows past
    its own capacity: the sharded steps == JAX's sharded steps, and apart
    from its single-device ones;
(e) what serving under a mesh does not run raises, naming leaf and spec:
    paged caches, ``chunk_step`` and ``verify_step`` (the recurrent
    families and ``seq_sharded`` run: their tests are in
    ``tests/test_torch_dist_recurrent.py``); a cache whose length its
    positions' group does not divide raises ``ValueError``;
(f) the layouts that split the caches' positions or shard the weights
    over the data axes in serving, each == JAX's sharded steps on the
    case's mesh and rules (its params placed by JAX's ``tree_shardings``),
    as (b): gemma_2b (one kv head) on (2, 2) and llama3_70b (2 kv heads
    on "model" 4) on (2, 4) under ``shard_v2`` (the positions over
    "model", every kv head on each model rank, the query heads gathered),
    ``seq_sharded`` (over the data axes) and both (over ("data",
    "model")); v2-lite's MLA, naive and absorbed, under the same three;
    zamba2_7b under ``shard_v2`` (2 kv heads on "model" 4) and under
    FSDP; gemma_2b and v2-lite (expert parallelism) under FSDP; v2-lite
    with the dispatch einsum (experts over "model", capacity slack 1.0:
    the slots of the whole batch), without and with FSDP; and
    ``attn_in_seqshard``, JAX's layout hint, which moves no value: the
    port's steps with it on and off are bit for bit equal.

Both packages' ``prefill_step`` allocate bf16 caches; at fp32 one ulp of
a K/V entry can round it to the other bf16 neighbour. So the JAX
references run its body (``forward`` in mode "prefill") over fp32 caches,
and the ranks run the port's ``prefill_step`` with ``init_cache`` giving
fp32 leaves (``_torch_dist_jobs._fp32_caches``).
"""
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_jobs as jobs
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.configs import get_reduced_config as jreduced
from repro.models import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch import distributed as D
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding as tsharding
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
RTOL = 1e-5                # of the largest entry: fp32, other sum orders
STEPS = 4
BATCH, PROMPT, MAX_LEN = 4, 16, 24
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2, 2): ("pod", "data", "model"), (2, 4): ("data", "model")}
MESH22 = dict(mesh=[2, 2], axes=["data", "model"])
NO_DROPS = {"capacity_slack": 8.0}
MESH24 = dict(mesh=[2, 4], axes=["data", "model"])
V2, SEQ, FSDP = {"shard_v2": True}, {"seq_sharded": True}, {"fsdp": True}
ABSORB = {"absorb": True}
DISPATCH = {"impl": "dispatch_einsum", "capacity_slack": 1.0}
SERVE = {
    "gemma_2b": dict(arch="gemma_2b", **MESH22),
    "llama3_70b_222": dict(arch="llama3_70b", mesh=[2, 2, 2],
                           axes=["pod", "data", "model"]),
    "llama3_70b_24": dict(arch="llama3_70b", mesh=[2, 4],
                          axes=["data", "model"]),
    "pixtral_12b": dict(arch="pixtral_12b", embeds=True, **MESH22),
    "deepseek_v2_lite_16b": dict(arch="deepseek_v2_lite_16b", moe=NO_DROPS,
                                 **MESH22),
    "deepseek_v2_lite_16b_absorbed": dict(
        arch="deepseek_v2_lite_16b", moe=NO_DROPS, mla={"absorb": True},
        **MESH22),
    # (d): rows dropped past each data shard's capacity
    "deepseek_v2_lite_16b_drops": dict(
        arch="deepseek_v2_lite_16b", moe={"capacity_slack": 1.0},
        sharded=True, **MESH22),
}
# (f): each held against JAX's sharded steps only; "data" names the case
# whose weights and prompts it takes (default its own)
LAYOUTS = {
    # a 10-token prompt: the steps cross from model rank 0's 12 positions
    # into rank 1's
    "gemma_2b_v2": dict(arch="gemma_2b", cfg=V2, prompt=10, **MESH22),
    "gemma_2b_seq": dict(arch="gemma_2b", rules=SEQ, data="gemma_2b",
                         **MESH22),
    "gemma_2b_v2_seq": dict(arch="gemma_2b", cfg=V2, rules=SEQ,
                            data="gemma_2b", **MESH22),
    "llama3_70b_v2": dict(arch="llama3_70b", cfg=V2, data="llama3_70b_24",
                          **MESH24),
    "llama3_70b_seq": dict(arch="llama3_70b", rules=SEQ,
                           data="llama3_70b_24", **MESH24),
    "llama3_70b_v2_seq": dict(arch="llama3_70b", cfg=V2, rules=SEQ,
                              data="llama3_70b_24", **MESH24),
    **{f"deepseek_v2_lite_16b_{tag}{'_absorbed' if mla else ''}": dict(
        arch="deepseek_v2_lite_16b", moe=NO_DROPS, mla=mla, cfg=cfg,
        rules=rules, data="deepseek_v2_lite_16b", **MESH22)
       for tag, cfg, rules in (("v2", V2, {}), ("seq", {}, SEQ),
                               ("v2_seq", V2, SEQ))
       for mla in ({}, ABSORB)},
    "zamba2_7b_v2": dict(arch="zamba2_7b", cfg={**V2, "num_kv_heads": 2},
                         **MESH24),
    "zamba2_7b_fsdp": dict(arch="zamba2_7b", rules=FSDP, **MESH22),
    "gemma_2b_fsdp": dict(arch="gemma_2b", rules=FSDP, data="gemma_2b",
                          **MESH22),
    "deepseek_v2_lite_16b_fsdp": dict(arch="deepseek_v2_lite_16b",
                                      moe=NO_DROPS, rules=FSDP,
                                      data="deepseek_v2_lite_16b", **MESH22),
    "deepseek_v2_lite_16b_dispatch": dict(arch="deepseek_v2_lite_16b",
                                          moe=DISPATCH, **MESH22),
    "deepseek_v2_lite_16b_dispatch_fsdp": dict(
        arch="deepseek_v2_lite_16b", moe=DISPATCH, rules=FSDP,
        data="deepseek_v2_lite_16b_dispatch", **MESH22),
    # 6 query heads on "model" 4: JAX's attn_in_seqshard constrains the
    # attention's input there
    "llama3_70b_qseq": dict(arch="llama3_70b", cfg={
        "num_heads": 6, "attn_in_seqshard": True}, mesh=[1, 4],
        axes=["data", "model"]),
    "llama3_70b_qseq_off": dict(arch="llama3_70b", cfg={"num_heads": 6},
                                mesh=[1, 4], axes=["data", "model"],
                                data="llama3_70b_qseq", jax=False),
}
# the JAX references are computed by this many subprocesses side by side,
# each taking every JAX_PARTS-th job (their compiles dominate the module)
JAX_PARTS = 3
ENCODER = dict(name="hubert_xlarge", arch="hubert_xlarge",
               opt=dict(lr=3e-3, warmup_steps=2, total_steps=3), **MESH22)


class _StubMesh:
    """JAX's mesh as ``ShardingRules`` reads it: axis names and a device
    array's shape."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _perturbed_params(tcfg, seed):
    """The port's init plus seeded noise on every leaf (the init zeroes the
    output projections and norm gammas), as numpy arrays by path."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    return {k: (v.numpy() + rng.standard_normal(v.shape) * 0.1
                ).astype(np.float32)
            for k, v in _flat(ttf.init_model(tcfg, gen, "cpu")).items()}


# JAX's references, in JAX_PARTS subprocesses with 8 host devices: for
# each serving case its single-device steps (and, with "sharded", its
# sharded steps on the case's mesh and rules), and the encoder's
# prefill_step and train step
_JAX = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced_config
from repro.models import optim, steps, transformer as tf
from repro.models.sharding import ShardingRules, tree_shardings

d, part, parts = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
specs = json.load(open(f"{d}/jobs.json"))[part::parts]

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

def cfg_of(spec):
    cfg = get_reduced_config(spec["arch"]).replace(**spec["replace"])
    for sub in ("moe", "mla"):
        if sub in spec:
            cfg = cfg.replace(**{sub: dataclasses.replace(
                getattr(cfg, sub), **spec[sub])})
    return cfg

def placed(params, cfg, rules):
    # the params laid out by JAX's rules (FSDP's data axes among them)
    abstract, axes = tf.abstract_model(cfg)
    return jax.device_put(params, tree_shardings(
        rules, abstract, tf.axes_tree(abstract, axes)))

def serve(cfg, params, batch, spec, rules=None, mesh=None):
    # prefill_step's body over fp32 caches, then serve_steps fed their own
    # greedy tokens
    b = next(iter(batch.values())).shape[0]
    cspec, _ = tf.init_cache_spec(cfg, b, spec["max_len"])
    caches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32
                          if s.dtype == jnp.bfloat16 else s.dtype), cspec)
    pre = jax.jit(lambda p, c, bt: tf.forward(
        p, cfg, mode="prefill", caches=c, rules=rules, mesh=mesh, **bt)[:2])
    step = jax.jit(lambda p, t, c: steps.serve_step(p, t, c, cfg, rules,
                                                    mesh))
    logits, caches = pre(params, caches, batch)
    out = {"prefill": logits, **{f"cache_prefill/{k}": v
                                 for k, v in flat(caches).items()}}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(spec["steps"]):
        tok, logits, caches = step(params, tok[:, None], caches)
        out[f"logits{i}"], out[f"tokens{i}"] = logits, tok
    out.update({f"cache/{k}": v for k, v in flat(caches).items()})
    return out

out = {}
devs = np.array(jax.devices())
for spec in specs:
    name, cfg = spec["name"], cfg_of(spec)
    data = spec.get("data", name)
    params = load(f"{d}/{data}_params.npz")
    batch = load(f"{d}/{data}_batch.npz")
    if spec["job"] == "serve":
        got = {}
        if spec.get("single", True):
            got["single"] = serve(cfg, params, batch, spec)
        if spec.get("sharded"):
            n = int(np.prod(spec["mesh"]))
            mesh = Mesh(devs[:n].reshape(spec["mesh"]), tuple(spec["axes"]))
            rules = ShardingRules(mesh, **spec.get("rules", {}))
            with mesh:
                got["sharded"] = serve(cfg, placed(params, cfg, rules),
                                       batch, spec, rules, mesh)
    else:
        pre, _ = steps.prefill_step(params, {"embeds": batch["embeds"]}, cfg,
                                    spec["max_len"])
        state = {"params": params, "opt": optim.init_opt_state(params)}
        state, met = jax.jit(lambda s, b: steps.train_step(
            s, b, cfg, optim.OptConfig(**spec["opt"])))(state, batch)
        got = {"encoder": {"prefill": pre,
                           **{f"met_{k}": v for k, v in met.items()},
                           **{f"state/{k}": v
                              for k, v in flat(state).items()}}}
    for tag, res in got.items():
        out.update({f"{name}/{tag}/{k}": np.asarray(v)
                    for k, v in res.items()})
np.savez(f"{d}/jax{part}.npz", **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes every job's inputs, then runs the JAX subprocess and the 8
    torch ranks side by side. Returns (directory, JAX's results)."""
    d = str(tmp_path_factory.mktemp("dist_serve"))
    specs = []
    layouts = {k: {**c, "single": False, "sharded": c.get("jax", True)}
               for k, c in LAYOUTS.items()}
    for seed, (name, case) in enumerate({**SERVE, **layouts}.items()):
        replace = {**FP32, **case.get("cfg", {})}
        if "data" not in case:
            tcfg = jobs._cfg({**case, "replace": replace})
            np.savez(f"{d}/{name}_params.npz",
                     **_perturbed_params(tcfg, seed))
            rng = np.random.default_rng(100 + seed)
            prompt = case.get("prompt", PROMPT)
            batch = ({"embeds": rng.standard_normal(
                (BATCH, prompt, tcfg.frontend_dim)).astype(np.float32)}
                if case.get("embeds") else
                {"tokens": rng.integers(0, tcfg.vocab_size, (BATCH, prompt)
                                        ).astype(np.int32)})
            np.savez(f"{d}/{name}_batch.npz", **batch)
        specs.append({"job": "serve", "name": name, "max_len": MAX_LEN,
                      "steps": STEPS, **case, "replace": replace})
    tcfg = get_reduced_config("hubert_xlarge").replace(**FP32)
    np.savez(f"{d}/hubert_xlarge_params.npz", **_perturbed_params(tcfg, 50))
    rng = np.random.default_rng(51)
    np.savez(f"{d}/hubert_xlarge_batch.npz", embeds=rng.standard_normal(
        (BATCH, PROMPT, tcfg.frontend_dim)).astype(np.float32),
        labels=rng.integers(0, tcfg.vocab_size, (BATCH, PROMPT)
                            ).astype(np.int32))
    specs.append({"job": "encoder", "replace": FP32, "max_len": MAX_LEN,
                  **ENCODER})
    with open(f"{d}/jobs.json", "w") as f:
        json.dump(specs, f)

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, d, str(i),
                               str(JAX_PARTS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(JAX_PARTS)]
    try:
        tmesh.spawn(jobs.run, 8, (d,), device="cpu")
    finally:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    ref = {}
    for i in range(JAX_PARTS):
        ref.update(np.load(f"{d}/jax{i}.npz"))
    return d, ref


def _sub(flat, prefix):
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


def _close(got, want, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def _serving_close(out, want, what):
    """``job_serve``'s outputs against a reference run's: logits within
    RTOL of their largest, tokens equal, caches within RTOL."""
    _close({k: out[k] for k in want if k.startswith(("prefill", "logits"))},
           {k: v for k, v in want.items()
            if k.startswith(("prefill", "logits"))}, what)
    for i in range(STEPS):
        np.testing.assert_array_equal(out[f"tokens{i}"], want[f"tokens{i}"],
                                      err_msg=f"{what} tokens {i}")
    for tag in ("cache_prefill", "cache"):
        got, ref = _sub(out, tag), _sub(want, tag)
        assert sorted(got) == sorted(ref), (what, tag)
        _close(got, ref, f"{what} {tag}")


# ---------------------------------------------------------------------------
# (a): cache axes, specs and layout (no ranks)
# ---------------------------------------------------------------------------

def _configs(arch, reduced, v2):
    jcfg, tcfg = ((jreduced(arch), get_reduced_config(arch)) if reduced
                  else (jget(arch), get_config(arch)))
    if v2:
        jcfg, tcfg = jcfg.replace(shard_v2=True), tcfg.replace(shard_v2=True)
    return jcfg, tcfg


def _variants():
    return [(r, v2) for r in (True, False) for v2 in (False, True)]


@functools.lru_cache(maxsize=None)
def _specs(arch, reduced, v2):
    """(JAX's init_cache_spec flattened to {path: (shape, dtype name)} and
    {path: axes}, the port's alike, the port's config)."""
    jcfg, tcfg = _configs(arch, reduced, v2)
    jspec, jaxes = jtf.init_cache_spec(jcfg, BATCH, MAX_LEN)
    tspec, taxes = ttf.init_cache_spec(tcfg, BATCH, MAX_LEN)
    j = {k: (tuple(s.shape), np.dtype(s.dtype).name)
         for k, s in _flat(jspec).items()}
    t = {k: (tuple(shape), str(dt).split(".")[-1])
         for k, (shape, dt) in _flat(tspec).items()}
    return (j, _flat(jaxes), jspec, jaxes), (t, _flat(taxes)), tcfg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_spec_and_axes_equal_jax(arch):
    for reduced, v2 in _variants():
        (j, jaxes, _, _), (t, taxes), _ = _specs(arch, reduced, v2)
        assert t == j, (arch, reduced, v2)
        assert taxes == {k: tuple(a) for k, a in jaxes.items()}, \
            (arch, reduced, v2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_under_rules_equal_jax(arch):
    """JAX's ``tree_specs`` of its cache spec == the port's
    ``ShardingRules`` on the same axes, with and without ``seq_sharded``;
    the port's layout (``cache_specs``) == it but where it keeps a dim
    whole: "model" taken off the head dim and the latent, and put on the
    kv heads as ``HeadsRead`` where the query heads divide "model" and
    the positions do not take it (``shard_v2``'s ``cache_seq`` does where
    the kv heads do not: every kv head is then whole on a model rank, as
    in JAX)."""
    for reduced, v2 in _variants():
        (j, jaxes, jspec, jaxes_tree), (t, taxes), tcfg = _specs(
            arch, reduced, v2)
        for (shape, names), kw in itertools.product(
                MESHES.items(), ({}, {"seq_sharded": True})):
            jr = jsharding.ShardingRules(_StubMesh(shape, names), **kw)
            tr = tsharding.ShardingRules(_StubMesh(shape, names), **kw)
            want = _flat(jsharding.tree_specs(jr, jspec, jaxes_tree))
            shapes = {g: {k: s for k, (s, _) in leaves.items()}
                      for g, leaves in ttf.init_cache_spec(
                          tcfg, BATCH, MAX_LEN)[0].items()}
            got = _flat(tsharding.tree_specs(tr, shapes, {
                k.replace("/", "."): a for k, a in taxes.items()}))
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (arch, shape)
            if tcfg.family in ("hybrid", "ssm"):
                continue     # tests/test_torch_dist_recurrent.py
            m = shape[-1]
            layout = _flat(ttf.cache_specs(tcfg, tr, BATCH, MAX_LEN))
            for path, spec in layout.items():
                seq_model = any("model" in D.group_of(w) for w, a in zip(
                    want[path], taxes[path]) if a in ("seq", "cache_seq"))
                for e, w, a in zip(spec, want[path], taxes[path]):
                    if a in ("head_dim_shard", "kv_lora"):
                        assert e is None
                    elif a == "kv_heads" and w is None \
                            and tcfg.num_heads % m == 0 and not seq_model:
                        assert e == D.HeadsRead(tcfg.num_heads,
                                                tcfg.num_kv_heads)
                    else:
                        assert e == w, (arch, shape, path)


def test_cache_groups_follow_the_cache_leaf_spec():
    """``distributed.cache_groups``, the axes the rows and the attention
    caches' positions split over, as JAX's rules resolve the cache leaf:
    gemma_2b's one kv head leaves "model" to ``shard_v2``'s ``cache_seq``;
    llama3_70b's 2 kv heads take it on (2, 2) and not on (2, 4); MLA's
    ``cache_seq`` comes before its ``kv_lora``."""
    def groups(arch, shape, v2, **kw):
        cfg = get_reduced_config(arch).replace(shard_v2=v2)
        rules = tsharding.ShardingRules(_StubMesh(
            shape, ("data", "model")), **kw)
        return D.cache_groups(cfg, rules)
    seq = {"seq_sharded": True}
    assert groups("gemma_2b", (2, 2), False) == (("data",), ())
    assert groups("gemma_2b", (2, 2), True) == (("data",), ("model",))
    assert groups("gemma_2b", (2, 2), False, **seq) == ((), ("data",))
    assert groups("gemma_2b", (2, 2), True, **seq) == (
        (), ("data", "model"))
    assert groups("llama3_70b", (2, 2), True) == (("data",), ())
    assert groups("llama3_70b", (2, 2), True, **seq) == ((), ())
    assert groups("llama3_70b", (2, 4), True) == (("data",), ("model",))
    assert groups("deepseek_v2_lite_16b", (2, 2), True) == (
        ("data",), ("model",))
    assert groups("deepseek_v2_lite_16b", (2, 2), False, **seq) == (
        (), ("data",))


def test_cache_layouts_of_the_served_cases():
    """The layouts (b) runs: gemma's one kv head whole on every model
    rank, llama3_70b's kv heads split on (2, 2, 2) and read in pairs of
    ranks on a model axis of 4 (where JAX splits the head dim), v2-lite's
    whole latent."""
    def layout(arch, shape, names):
        rules = tsharding.ShardingRules(_StubMesh(shape, names))
        return ttf.cache_specs(get_reduced_config(arch), rules, BATCH,
                               MAX_LEN)
    read = D.HeadsRead
    assert tuple(layout("gemma_2b", (2, 2), ("data", "model"))["attn"]["k"]
                 ) == (None, "data", None, read(4, 1), None)
    assert tuple(layout("llama3_70b", (2, 2, 2), ("pod", "data", "model"))[
        "attn"]["v"]) == (None, ("pod", "data"), None, "model", None)
    assert tuple(layout("llama3_70b", (2, 4), ("data", "model"))["attn"][
        "k"]) == (None, "data", None, read(8, 2), None)
    v2 = layout("deepseek_v2_lite_16b", (2, 2), ("data", "model"))
    for g in ("dense_attn", "attn"):
        assert tuple(v2[g]["c_kv"]) == (None, "data", None, None)
        assert tuple(v2[g]["length"]) == (None, "data")


@pytest.mark.parametrize("nh,kvh,m", [(8, 2, 4), (4, 1, 2), (64, 8, 4),
                                      (24, 8, 3), (8, 8, 2), (16, 2, 8)])
def test_heads_read_meets_each_query_heads_kv_head(nh, kvh, m):
    """``HeadsRead``: on every model rank, local query head i meets local
    kv head i // (n / local kv heads), which is global kv head (h0 + i)
    // (nh / kvh); every kv head is held by some rank."""
    read, n, group = D.HeadsRead(nh, kvh), nh // m, nh // kvh
    held = set()
    for r in range(m):
        heads = read.heads(r, m)
        assert n % len(heads) == 0
        per = n // len(heads)
        for i in range(n):
            assert heads[i // per] == (r * n + i) // group, (r, i)
        held.update(heads)
    assert held == set(range(kvh))


# ---------------------------------------------------------------------------
# (e): what serving under a mesh does not run (no ranks: each raises
# before any collective)
# ---------------------------------------------------------------------------

def _raising(what):
    """(a call that must raise, what the message names) for the paged
    layouts: a paged cache in ``serve_step``, ``chunk_step`` and
    ``verify_step``."""
    cfg = get_reduced_config("llama3_70b")
    rules = tsharding.ShardingRules(_StubMesh((2, 2), ("data", "model")))
    tokens = torch.zeros((4, 1), dtype=torch.int32)
    paged = ttf.init_paged_cache(cfg, 4, 8, 4, 4, "cpu")
    q_valid = torch.ones(4, dtype=torch.int32)
    call = {"paged": lambda: tsteps.serve_step(None, tokens, paged, cfg,
                                               rules),
            "chunk_step": lambda: tsteps.chunk_step(
                None, tokens, q_valid, paged, cfg, rules),
            "verify_step": lambda: tsteps.verify_step(
                None, tokens, q_valid, paged, cfg, rules)}[what]
    return call, "attn.k_pool: spec None"


@pytest.mark.parametrize("what", ["paged", "chunk_step", "verify_step"])
def test_unrun_serving_layouts_raise_naming_leaf_and_spec(what):
    """The recurrent families, ``seq_sharded``, ``shard_v2``, FSDP and the
    dispatch einsum serve under a mesh ((f), and
    ``tests/test_torch_dist_recurrent.py``); the paged layouts, which JAX
    runs sharded nowhere, still raise."""
    call, want = _raising(what)
    with pytest.raises(NotImplementedError) as e:
        call()
    msg = str(e.value)
    assert "spec " in msg and "later slice" in msg, msg
    assert want in msg, msg


@pytest.mark.parametrize("arch,kw,v2", [
    ("gemma_2b", {}, True), ("gemma_2b", {"seq_sharded": True}, True),
    ("deepseek_v2_lite_16b", {"seq_sharded": True}, False)])
def test_cache_factory_refuses_a_length_its_group_does_not_divide(arch, kw,
                                                                  v2):
    """A cache of 7 positions over a positions group of 2 or 4 ranks: JAX's
    rules fall back to fewer axes there; ``init_cache`` raises before any
    collective."""
    cfg = get_reduced_config(arch).replace(shard_v2=v2)
    rules = tsharding.ShardingRules(_StubMesh((2, 2), ("data", "model")),
                                    **kw)
    with pytest.raises(ValueError, match="does not divide"):
        ttf.init_cache(cfg, 4, 7, "cpu", rules)


# ---------------------------------------------------------------------------
# (b)-(d): the ranks' results
# ---------------------------------------------------------------------------

def _out(d, name):
    return dict(np.load(f"{d}/out_{name}.npz"))


@pytest.mark.parametrize("name", [n for n, c in SERVE.items()
                                  if not c.get("sharded")])
def test_sharded_serving_matches_jax_single_device(world, name):
    d, ref = world
    _serving_close(_out(d, name), _sub(ref, f"{name}/single"), name)


def test_local_caches_hold_the_ranks_heads_and_rows(world):
    """(L, rows, S, kv heads, hd) of rank 0's K cache: gemma's one kv head
    and llama3_70b's on (2, 4) at the whole head dim; on (2, 2, 2) one of
    2 kv heads; v2-lite's whole latent on 2 of 4 rows."""
    d, _ = world
    assert _out(d, "gemma_2b")["local_k_shape"].tolist() == [
        2, 2, MAX_LEN, 1, 16]
    assert _out(d, "llama3_70b_24")["local_k_shape"].tolist() == [
        2, 2, MAX_LEN, 1, 8]
    assert _out(d, "llama3_70b_222")["local_k_shape"].tolist() == [
        2, 1, MAX_LEN, 1, 8]
    assert _out(d, "deepseek_v2_lite_16b")["local_k_shape"].tolist() == [
        2, 2, MAX_LEN, 32]


def test_drops_match_jax_sharded_steps(world):
    """Capacity slack 1.0: each data shard cuts its own capacity from its
    rows, as JAX's shard map does, so the sharded steps equal JAX's
    sharded steps and part from its single-device ones."""
    d, ref = world
    name = "deepseek_v2_lite_16b_drops"
    out = _out(d, name)
    _serving_close(out, _sub(ref, f"{name}/sharded"), name)
    single = _sub(ref, f"{name}/single")
    assert np.abs(out["prefill"] - single["prefill"]).max() > \
        1e-3 * np.abs(single["prefill"]).max()


def test_encoder_prefill_step_matches_jax(world):
    """hubert_xlarge's ``prefill_step`` is its forward: logits (b, s, V)
    at every position, whole on every rank."""
    d, ref = world
    out, want = _out(d, "hubert_xlarge"), _sub(ref, "hubert_xlarge/encoder")
    assert out["prefill"].shape == (BATCH, PROMPT, 128)
    _close({"prefill": out["prefill"]}, {"prefill": want["prefill"]},
           "hubert prefill")


def test_encoder_train_step_matches_jax(world):
    """One sharded train step of hubert_xlarge from moments at 0: loss,
    grad norm and AdamW's m (the gradient scaled) and v within RTOL; the
    params where the step's sign is not decided by fp32 noise (|m| above
    1e-3 of the leaf's largest), within RTOL of the leaf's largest."""
    d, ref = world
    out, want = _out(d, "hubert_xlarge"), _sub(ref, "hubert_xlarge/encoder")
    for k in ("loss", "grad_norm", "aux_loss"):
        np.testing.assert_allclose(out[f"met_{k}"], want[f"met_{k}"],
                                   rtol=RTOL, err_msg=k)
    got, st = _sub(out, "state"), _sub(want, "state")
    for m in ("m", "v"):
        _close(_sub(got, f"opt/{m}"), _sub(st, f"opt/{m}"), m)
    for k, w in _sub(st, "params").items():
        mom = np.abs(st[f"opt/m/{k}"])
        sure = mom > 1e-3 * mom.max()
        np.testing.assert_allclose(got[f"params/{k}"][sure], w[sure],
                                   rtol=0, atol=RTOL * np.abs(w).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (f): the layouts that split the positions or FSDP-shard the weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n, c in LAYOUTS.items()
                                  if c.get("jax", True)])
def test_split_and_fsdp_layouts_match_jax_sharded_steps(world, name):
    d, ref = world
    out = _out(d, name)
    assert float(out["roundtrip"]) == 1.0
    _serving_close(out, _sub(ref, f"{name}/sharded"), name)


def test_split_positions_caches_hold_the_ranks_slices(world):
    """(L, rows, positions, kv heads, head dim) of rank 0's K cache (MLA:
    its latent): the positions over "model" (2 or 4 ranks), the data axes
    or both; every kv head where "model" splits the positions (gemma's
    one, llama3's and zamba2's two), the kv heads its query heads read
    otherwise."""
    d, _ = world
    want = {"gemma_2b_v2": [2, 2, 12, 1, 16],
            "gemma_2b_seq": [2, 4, 12, 1, 16],
            "gemma_2b_v2_seq": [2, 4, 6, 1, 16],
            "llama3_70b_v2": [2, 2, 6, 2, 8],
            "llama3_70b_seq": [2, 4, 12, 1, 8],
            "llama3_70b_v2_seq": [2, 4, 3, 2, 8],
            "deepseek_v2_lite_16b_v2": [2, 2, 12, 32],
            "deepseek_v2_lite_16b_seq": [2, 4, 12, 32],
            "deepseek_v2_lite_16b_v2_seq": [2, 4, 6, 32],
            "zamba2_7b_v2": [2, 2, 6, 2, 16],
            "deepseek_v2_lite_16b_dispatch_fsdp": [2, 2, MAX_LEN, 32]}
    for name, shape in want.items():
        assert _out(d, name)["local_k_shape"].tolist() == shape, name


def test_attn_in_seqshard_moves_no_value(world):
    """JAX's ``attn_in_seqshard`` constrains the layout of the attention's
    input where the query heads do not divide "model" (6 on 4 here); the
    port's steps with it on equal those with it off bit for bit (and
    JAX's sharded steps with it on: the parametrized test above)."""
    d, _ = world
    on, off = _out(d, "llama3_70b_qseq"), _out(d, "llama3_70b_qseq_off")
    assert sorted(on) == sorted(off)
    for k in on:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
