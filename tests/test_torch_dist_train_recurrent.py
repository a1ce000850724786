"""PyTorch port, the sharded train step of the recurrent families and
under FSDP on the CPU, held against the JAX package.

As in ``tests/test_torch_distributed.py`` the sharded runs are gloo ranks
spawned once for the module (``repro_torch.launch.mesh.spawn`` running
``_torch_dist_jobs.run``), beside one JAX subprocess that computes the
references: JAX's single-device ``train_step`` under jit, in fp32 at the
reduced configs, from weights perturbed by 0.02 noise (JAX's init zeroes
the output projections). JAX's own sharded steps equal its single-device
ones for these configs and meshes, with FSDP on or off (within 1.43e-6 in
loss; grad norms alike to 6 digits). Held:

(a) two sharded ``train_step``s of 8 x 32 tokens each == JAX's: zamba2_7b
    (hybrid) on (2, 2) and (2, 2, 2), xlstm_1_3b (ssm) on (2, 2) and (1,
    4) (one head a rank); under ``fsdp=True`` internlm2_20b on (2, 2, 2),
    zamba2_7b, deepseek_v2_lite_16b (expert parallelism with FSDP; JAX's
    reference step takes the routers' aux as the mean over the data
    shards, the reference fact of ``tests/test_torch_distributed.py``)
    and xlstm_1_3b on (2, 2); zamba2_7b under FSDP with remat "full":
    loss, grad norm and aux within STEP_RTOL (x ``FP32_COND`` of
    ``tests/test_torch_train_families.py`` for the ill-conditioned
    zamba2 and xlstm), params by ``_params_close`` and m and v within
    STEP_RTOL of each leaf's largest entry (read: 4.5e-6 at most), after
    step 1 and after a step 2 taken from JAX's state after step 1; and
    v2-lite with the dispatch einsum under FSDP (its experts over
    "model", rows dropped at capacity slack 1.0) == JAX's sharded step
    under ``fsdp=True``, its state laid out by JAX's rules;
(b) under FSDP every rank's m and v have its shard's shape, and every
    rank's shards gather back to the whole leaves bit for bit;
(c) the FSDP layout: ``transformer.param_specs`` under ``fsdp=True`` ==
    JAX's ``tree_specs`` on every leaf but where the port's Mamba2 entry
    (``distributed.Mamba2Read``) stands for JAX's "model", on the (2, 2)
    and (2, 2, 2) stub meshes, reduced and full configs; the leaves JAX's
    rules put "data" on at full width.
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
from repro_torch.launch import mesh as tmesh
from repro_torch.models import optim
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as ttf
from test_torch_distributed import (OPT, STEP_RTOL, _close_to_max, _flat,
                                    _StubMesh, _sub)
from test_torch_train_families import FP32_COND

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
BATCH = (8, 32)
NOISE = 0.02
MESH22 = dict(mesh=[2, 2], axes=["data", "model"])
MESH222 = dict(mesh=[2, 2, 2], axes=["pod", "data", "model"])
SEEDS = {"zamba2_7b": 60, "xlstm_1_3b": 61, "internlm2_20b": 62,
         "deepseek_v2_lite_16b": 63}
SLACK = {"deepseek_v2_lite_16b": {"capacity_slack": 8.0}}
DISPATCH = {"capacity_slack": 1.0, "impl": "dispatch_einsum"}
# (a): each case's arch, mesh, FSDP and remat; the inputs are the arch's
TRAIN = {
    "zamba2_7b_22": dict(arch="zamba2_7b", **MESH22),
    "zamba2_7b_222": dict(arch="zamba2_7b", **MESH222),
    "xlstm_1_3b_22": dict(arch="xlstm_1_3b", **MESH22),
    "xlstm_1_3b_14": dict(arch="xlstm_1_3b", mesh=[1, 4],
                          axes=["data", "model"]),
    "internlm2_20b_222_fsdp": dict(arch="internlm2_20b", fsdp=True,
                                   **MESH222),
    "zamba2_7b_22_fsdp": dict(arch="zamba2_7b", fsdp=True, **MESH22),
    "deepseek_v2_lite_16b_22_fsdp": dict(arch="deepseek_v2_lite_16b",
                                         fsdp=True, **MESH22),
    "xlstm_1_3b_22_fsdp": dict(arch="xlstm_1_3b", fsdp=True, **MESH22),
    "zamba2_7b_22_fsdp_full": dict(arch="zamba2_7b", fsdp=True,
                                   remat="full", **MESH22),
    # the dispatch einsum with its experts over "model" under FSDP, rows
    # dropped at capacity slack 1.0: held against JAX's sharded step
    # under fsdp=True
    "deepseek_v2_lite_16b_22_dispatch_fsdp": dict(
        arch="deepseek_v2_lite_16b", fsdp=True, moe=DISPATCH, **MESH22),
}


def _ref(case) -> str:
    """The name of a case's JAX reference: one per arch and remat, and one
    for each case whose MoE differs from the arch's."""
    return (f"{case['arch']}_{case.get('remat', 'none')}"
            + ("_dispatch" if "moe" in case else ""))


# JAX's single-device references in one subprocess: two train steps from
# each reference's state, jitted once a reference; the state after step 1
# written first (the ranks wait for it). MoE: the routers' aux as the mean
# over the data shards, each routed on its own (``_jax_shard_aux_step`` of
# tests/test_torch_distributed.py)
_JAX = """
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced_config
from repro.models import optim, steps, transformer as tf
from repro.models.sharding import ShardingRules, tree_shardings
from jax.sharding import Mesh
import dataclasses

d = sys.argv[1]
refs = json.load(open(f"{d}/jax_refs.json"))

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

def shard_aux_step(cfg, opt, n_data):
    def loss(params, batch):
        per = batch["tokens"].shape[0] // n_data
        outs = [tf.forward(params, cfg, tokens=batch["tokens"][
            i * per:(i + 1) * per], mode="train") for i in range(n_data)]
        ce = steps.cross_entropy(jnp.concatenate([o[0] for o in outs]),
                                 batch["labels"], batch.get("mask"))
        aux = jnp.mean(jnp.stack([o[2] for o in outs]))
        return ce + aux, (ce, aux)

    def step(state, batch):
        (_, (ce, aux)), g = jax.value_and_grad(loss, has_aux=True)(
            state["params"], batch)
        p, o, gn = optim.adamw_update(state["params"], g, state["opt"], opt)
        return {"params": p, "opt": o}, {"loss": ce, "aux_loss": aux,
                                         "grad_norm": gn}
    return step

def placed(tree, cfg, rules):
    abstract, axes = tf.abstract_model(cfg)
    return jax.device_put(tree, tree_shardings(
        rules, abstract, tf.axes_tree(abstract, axes)))

def sharded_step(cfg, opt, ref, state):
    # JAX's sharded step on the case's mesh under fsdp=True, the state
    # laid out by its rules (the dispatch einsum is one program over the
    # whole batch: its aux is the whole batch's)
    n = int(np.prod(ref["mesh"]))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(ref["mesh"]),
                tuple(ref["axes"]))
    rules = ShardingRules(mesh, fsdp=True)
    state = {"params": placed(state["params"], cfg, rules),
             "opt": {**state["opt"], "m": placed(state["opt"]["m"], cfg,
                                                 rules),
                     "v": placed(state["opt"]["v"], cfg, rules)}}
    step = jax.jit(lambda s, b: steps.train_step(s, b, cfg, opt,
                                                 rules=rules, mesh=mesh))
    def run(s, b):
        with mesh:
            return step(s, b)
    return run, state

out = {}
for ref in refs:
    cfg = get_reduced_config(ref["arch"]).replace(**ref["replace"])
    if ref.get("moe"):
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **ref["moe"]))
    opt = optim.OptConfig(**ref["opt"])
    state = load(f"{d}/{ref['data']}_state0.npz")
    state["opt"]["step"] = state["opt"]["step"].astype(jnp.int32)
    if ref.get("sharded"):
        step, state = sharded_step(cfg, opt, ref, state)
    else:
        step = jax.jit(shard_aux_step(cfg, opt, ref["n_data"])
                       if cfg.family == "moe"
                       else lambda s, b: steps.train_step(s, b, cfg, opt))
    name = ref["name"]
    for i in range(2):
        state, met = step(state, load(f"{d}/{ref['data']}_batch{i}.npz"))
        out.update({f"{name}_met{i}_{k}": v for k, v in met.items()})
        out.update({f"{name}_state{i + 1}/{k}": v
                    for k, v in flat(state).items()})
        if i == 0:
            np.savez(f"{d}/{name}_tmp.npz", **flat(state))
            os.replace(f"{d}/{name}_tmp.npz", f"{d}/{name}_jstate1.npz")
np.savez(f"{d}/jax.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


def _state(tcfg, seed):
    """A train state of numpy arrays: the port's init plus NOISE x N(0, 1)
    on every leaf, AdamW's moments at 0, step 0."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    params = {k: (v.numpy() + rng.standard_normal(v.shape) * NOISE
                  ).astype(np.float32)
              for k, v in _flat(ttf.init_model(tcfg, gen, "cpu")).items()}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    return {**{f"params/{k}": v for k, v in params.items()},
            **{f"opt/m/{k}": v for k, v in zeros.items()},
            **{f"opt/v/{k}": v for k, v in zeros.items()},
            "opt/step": np.zeros((), np.int32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes every arch's state and batches, then runs the JAX subprocess
    and the 8 torch ranks side by side. Returns (directory, JAX's
    results)."""
    d = str(tmp_path_factory.mktemp("dist_train_recurrent"))
    specs, refs = [], {}
    for name, case in TRAIN.items():
        arch = case["arch"]
        tcfg = get_reduced_config(arch).replace(**FP32)
        if not os.path.exists(f"{d}/{arch}_state0.npz"):
            np.savez(f"{d}/{arch}_state0.npz", **_state(tcfg, SEEDS[arch]))
            for i in range(2):
                rng = np.random.default_rng(SEEDS[arch] * 10 + i)
                np.savez(f"{d}/{arch}_batch{i}.npz", **{
                    k: rng.integers(0, tcfg.vocab_size, BATCH).astype(
                        np.int32) for k in ("tokens", "labels")})
        replace = {**FP32, "remat": case.get("remat", "none")}
        moe = case.get("moe", SLACK.get(arch, {}))
        refs[_ref(case)] = dict(name=_ref(case), arch=arch, data=arch,
                                replace=replace, opt=OPT, moe=moe,
                                n_data=int(np.prod(case["mesh"][:-1])),
                                sharded="moe" in case, mesh=case["mesh"],
                                axes=case["axes"])
        specs.append({"job": "train", "name": name, "arch": arch,
                      "data": arch, "ref": _ref(case), "replace": replace,
                      "mesh": case["mesh"], "axes": case["axes"],
                      "fsdp": case.get("fsdp", False), "opt": OPT,
                      **({"moe": moe} if moe else {})})
    with open(f"{d}/jobs.json", "w") as f:
        json.dump(specs, f)
    with open(f"{d}/jax_refs.json", "w") as f:
        json.dump(list(refs.values()), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
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


def _params_close(got, want, step, rtol, what):
    """``tests/test_torch_distributed.py``'s rule for params after an
    AdamW step from one state: within ``rtol`` of each leaf's largest
    entry, plus what the two states' differences in m and v make through
    AdamW's normalised step (first-order propagation, doubled)."""
    opt = optim.OptConfig(**OPT)
    lr = float(optim.lr_at(opt, step))
    c1, c2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
    for k, w in _sub(want, "params").items():
        m = want[f"opt/m/{k}"].astype(np.float64) / c1
        v = want[f"opt/v/{k}"].astype(np.float64) / c2
        dm = np.abs(got[f"opt/m/{k}"] / c1 - m)
        dv = np.abs(got[f"opt/v/{k}"] / c2 - v)
        sq = np.sqrt(v)
        slack = lr * (dm / (sq + opt.eps) + np.abs(m) * dv / (
            2 * np.maximum(sq, 1e-30) * (sq + opt.eps) ** 2))
        err = np.abs(got[f"params/{k}"] - w)
        bad = err > rtol * np.abs(w).max() + 2 * slack
        assert not bad.any(), (what, k, int(bad.sum()), float(err.max()))


# ---------------------------------------------------------------------------
# (a), (b): the ranks' results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_step_matches_jax(world, name):
    """Two steps of each package's chain from the same state: loss, grad
    norm and aux at each step; params, m and v after step 1, and after a
    step 2 taken from JAX's state after step 1 (carried across: AdamW's
    normalised step turns the fp32 noise of near-zero gradients into
    steps of order lr, so two chains part at a few entries)."""
    d, ref_ = world
    case = TRAIN[name]
    rtol = STEP_RTOL * FP32_COND.get(case["arch"], 1)
    out, jname = _out(d, name), _ref(case)
    for i in range(2):
        for k in ("loss", "grad_norm", "aux_loss"):
            want = ref_[f"{jname}_met{i}_{k}"]
            np.testing.assert_allclose(out[f"chain{i}_{k}"], want,
                                       rtol=rtol, err_msg=f"{k} {i}")
            if i == 1:
                np.testing.assert_allclose(out[f"carried_{k}"], want,
                                           rtol=rtol, err_msg=k)
        got = _sub(out, f"state{i + 1}")
        want = _sub(ref_, f"{jname}_state{i + 1}")
        _params_close(got, want, i + 1, STEP_RTOL, f"params {i + 1}")
        for m in ("m", "v"):
            _close_to_max(_sub(got, f"opt/{m}"), _sub(want, f"opt/{m}"),
                          STEP_RTOL, m)
        assert int(got["opt/step"]) == int(want["opt/step"]) == i + 1
    assert (float(out["chain0_aux_loss"]) > 0) == (
        case["arch"] == "deepseek_v2_lite_16b")


@pytest.mark.parametrize("name", list(TRAIN))
def test_shards_gather_back_and_moments_are_the_shards(world, name):
    """Every rank's shards of the initial state gather back to the whole
    leaves bit for bit, and every rank's m and v have its shard's shape
    (``distributed.local_shape`` of the leaf's spec)."""
    d, _ = world
    out = _out(d, name)
    assert float(out["roundtrip"]) == 1.0
    assert float(out["moments_shaped"]) == 1.0


# ---------------------------------------------------------------------------
# (c): the FSDP layout (no ranks)
# ---------------------------------------------------------------------------

FSDP_ARCHS = ("zamba2_7b", "xlstm_1_3b", "internlm2_20b",
              "deepseek_v2_lite_16b")
FSDP_MESHES = {(2, 2): ("data", "model"),
               (2, 2, 2): ("pod", "data", "model")}


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_layout_is_jaxs_but_the_mamba2_entry(arch):
    """``transformer.param_specs`` under ``fsdp=True`` == JAX's spec of
    every leaf, but a ``Mamba2Read`` where JAX's rules put "model" on a
    Mamba2 leaf's concatenated channels; FSDP puts the data axes on some
    leaf of every config."""
    for jcfg, tcfg in ((jreduced(arch), get_reduced_config(arch)),
                       (jget(arch), get_config(arch))):
        shapes = ttf.param_shapes(tcfg)
        jaxes = jtf.abstract_model(jcfg)[1]
        for shape, names in FSDP_MESHES.items():
            jr = jsharding.ShardingRules(_StubMesh(shape, names), fsdp=True)
            got = ttf.param_specs(tcfg, tsharding.ShardingRules(
                _StubMesh(shape, names), fsdp=True))
            data = 0
            for path, spec in got.items():
                want = tuple(jr.spec(shapes[path], jaxes[path]))
                assert len(spec) == len(want), path
                for e, w in zip(spec, want):
                    if isinstance(e, D.Mamba2Read):
                        assert w == "model", (arch, shape, path)
                    else:
                        assert e == w, (arch, shape, path)
                data += any(e not in (None, "model")
                            and not isinstance(e, D.Mamba2Read)
                            for e in spec)
            assert data > 0, (arch, shape)


def test_fsdp_puts_data_where_jax_does_at_full_width():
    """The leaves JAX's rules give "data" under ``fsdp=True`` on (2, 2)
    at full width, as the port lays them out."""
    rules = tsharding.ShardingRules(_StubMesh((2, 2), ("data", "model")),
                                    fsdp=True)
    z = ttf.param_specs(get_config("zamba2_7b"), rules)
    assert tuple(z["embed"]) == ("model", "data")
    assert tuple(z["head"]) == ("data", "model")
    assert tuple(z["mamba.in_proj"])[:2] == (None, "data")
    assert isinstance(z["mamba.in_proj"][2], D.Mamba2Read)
    assert tuple(z["mamba.out_proj"]) == (None, "model", "data")
    for leaf in ("attn.wq", "attn.wk", "attn.wv", "mlp.wi"):
        assert tuple(z[f"shared.{leaf}"])[0] == "data", leaf
    assert tuple(z["shared.attn.wo"])[-1] == "data"
    assert tuple(z["shared.mlp.wo"])[-1] == "data"
    x = ttf.param_specs(get_config("xlstm_1_3b"), rules)
    assert tuple(x["slstm.ff_wi"]) == (None, "data", None, None)
    for leaf in ("mlstm.up", "mlstm.down", "slstm.wx", "slstm.ff_wo"):
        assert "data" in tuple(x[leaf]), leaf
    i = ttf.param_specs(get_config("internlm2_20b"), rules)
    assert tuple(i["embed"]) == ("model", "data")
    assert tuple(i["layers.attn.wq"])[1] == "data"
    assert tuple(i["layers.mlp.wo"])[-1] == "data"
