"""PyTorch port, distribution on the CPU: the mesh, the logical sharding
rules, expert parallelism and the sharded train step, held against the
JAX package.

The sharded runs are gloo ranks spawned once for the module
(``repro_torch.launch.mesh.spawn`` running ``_torch_dist_jobs.run``); the
JAX references are the single-device functions in this process and, for
what needs JAX's own sharding (its ``shard_map`` MoE with drops, the aux
of its sharded step under data shards), one subprocess with 8 host
devices, as ``tests/test_distributed.py`` runs them. Held:

(a) ``ShardingRules.spec`` == JAX's on every leaf of every registered
    config (reduced and full) on the (16, 16), (2, 16, 16), (2, 2, 2) and
    (2, 4) meshes, each also under ``fsdp`` and ``seq_sharded`` (stub
    meshes: no devices);
(b) ``transformer.param_axes`` == JAX's ``init_model`` axes;
(c) the mesh's shrink rule == JAX's at world sizes 1, 2, 3 and 8;
(d) ``shard_params`` then ``gather_params`` is the identity;
(e) ``apply_moe`` with expert parallelism on (2, 4) == JAX's single
    device (no drops, 2e-3 as JAX's test and 1e-5 here), == JAX's
    ``shard_map`` at capacity slack 1.0 (drops), and every expert over 8
    data ranks == JAX's single device with its one capacity cut; the
    dispatch einsum alike == JAX's one program at group sizes 4096 and
    32 (groups that a rank's rows fill or straddle);
(f) the sharded ``train_step`` == JAX's single-device one over 2 steps on
    reduced internlm2_20b (2, 2, 2), gemma_2b (MQA: K/V on the head dim,
    tied vocabulary) and deepseek_v2_lite_16b (MLA + EP + aux) on (2, 2),
    and == JAX's sharded one for v2-lite with the dispatch einsum (its
    experts over "model", rows dropped at capacity slack 1.0; its aux the
    whole batch's on every device):
    loss, grad norm and aux within 1e-5, m and v within 1e-5 of each
    leaf's largest entry, params within ``tests/test_torch_train_families
    .py``'s rule (1e-5 plus what the m and v differences make through
    AdamW's normalised step);
(g) unequal masks across data ranks give JAX's global mean;
(h) ``seq_sharded`` in training raises, naming leaf and spec (serving
    under a mesh: ``tests/test_torch_dist_serve.py``; the recurrent
    families and FSDP train: ``tests/test_torch_dist_train_
    recurrent.py``).

The aux under data shards is a reference fact: JAX's sharded step leaves
each data shard's own aux on its devices (``out_specs`` ``P()`` with the
replication check off), so the value it reports depends on the device;
the port's is their mean, and v2-lite's reference step here is JAX's
single-device step with that mean (``_jax_shard_aux_step``).
"""
import dataclasses
import functools
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
from repro.launch import mesh as jmesh
from repro.models import sharding as jsharding
from repro.models import transformer as jtf
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models import optim
from repro_torch.models.layers import Initializer
from repro_torch.models import sharding as tsharding
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
STEP_RTOL = 1e-5           # fp32 both sides; sums in other orders
EP_TOL = 1e-5              # JAX's own test holds EP to 2e-3
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=3)
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2, 2): ("pod", "data", "model"), (2, 4): ("data", "model")}
TRAIN = {
    "internlm2_20b": dict(mesh=[2, 2, 2], axes=["pod", "data", "model"],
                          batch=(8, 16)),
    "gemma_2b": dict(mesh=[2, 2], axes=["data", "model"], batch=(4, 16),
                     mask=True),
    "deepseek_v2_lite_16b": dict(mesh=[2, 2], axes=["data", "model"],
                                 batch=(4, 16), moe={"capacity_slack": 8.0}),
    # the dispatch einsum with its experts over "model" at capacity slack
    # 1.0 (rows dropped past the slots of the whole batch's one group),
    # held against JAX's sharded step
    "deepseek_v2_lite_16b_dispatch": dict(
        arch="deepseek_v2_lite_16b", mesh=[2, 2], axes=["data", "model"],
        batch=(4, 16), moe={"capacity_slack": 1.0,
                            "impl": "dispatch_einsum"}, jax_sharded=True),
}
# the dispatch einsum's group sizes in (e): one group of the whole batch
# (128 rows), and groups of 32 that a rank's rows fill (2 data ranks) or
# straddle (8)
GROUPS = (4096, 32)


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


def _perturbed_state(tcfg, seed):
    """A train state of numpy arrays: the port's init plus seeded noise on
    every leaf (the init zeroes the output projections and norm gammas),
    AdamW's moments at 0, step 0."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    params = {k: (v.numpy() + rng.standard_normal(v.shape) * 0.1
                  ).astype(np.float32)
              for k, v in _flat(ttf.init_model(tcfg, gen, "cpu")).items()}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    return {**{f"params/{k}": v for k, v in params.items()},
            **{f"opt/m/{k}": v for k, v in zeros.items()},
            **{f"opt/v/{k}": v for k, v in zeros.items()},
            "opt/step": np.zeros((), np.int32)}


def _batch(cfg, seed, b, s, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if mask:
        # the first data shard (rows 0 .. b/2 - 1) keeps far fewer tokens
        m = (rng.random((b, s)) < 0.9).astype(np.float32)
        m[: b // 2, 3:] = 0.0
        out["mask"] = m
    return out


# JAX's references, in a subprocess (``sys.argv[2]``): "single" runs the
# single-device functions, "sharded" what needs JAX's own sharding over 8
# host devices (its shard_map MoE, the aux of its sharded step)
_JAX = """
import dataclasses, json, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced_config
from repro.models import moe as moe_mod, optim, steps, transformer as tf
from repro.models.sharding import ShardingRules, tree_shardings

d, mode = sys.argv[1], sys.argv[2]
specs = json.load(open(f"{d}/jobs.json"))

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

def placed(tree, cfg, rules):
    # a params-shaped tree laid out by JAX's rules
    abstract, axes = tf.abstract_model(cfg)
    return jax.device_put(tree, tree_shardings(
        rules, abstract, tf.axes_tree(abstract, axes)))

def cfg_of(spec, **moe):
    cfg = get_reduced_config(spec["arch"]).replace(**spec["replace"])
    moe = {**spec.get("moe", {}), **moe}
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg

def shard_aux_step(cfg, opt, n_data):
    # JAX's single-device step with the sharded step's aux: each data
    # shard's rows routed on their own, the aux the mean over the shards
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

out = {}
devs = np.array(jax.devices())
# the train steps first: the ranks wait for JAX's state after step 1
for spec in sorted(specs, key=lambda s: s["job"] != "train"):
    if spec["job"] == "ep":
        p, x = load(f"{d}/ep_params.npz"), jnp.asarray(np.load(f"{d}/ep_x.npy"))
        for slack in spec["slacks"]:
            cfg = cfg_of(spec, capacity_slack=slack)
            if mode == "sharded":
                mesh = Mesh(devs[:8].reshape(2, 4), ("data", "model"))
                y, _ = jax.jit(lambda p, x: moe_mod.apply_moe(
                    p, x, cfg, mesh=mesh))(p, x)
                out[f"shard_map_{slack}_y"] = y
                continue
            run = jax.jit(lambda p, x: moe_mod.apply_moe(p, x, cfg))
            out[f"single_{slack}_y"], out[f"single_{slack}_aux"] = run(p, x)
            for g in spec["groups"]:
                out[f"dispatch_{g}_{slack}_y"], out[
                    f"dispatch_{g}_{slack}_aux"] = jax.jit(
                    lambda p, x: moe_mod.moe_dispatch_einsum(
                        p, x, cfg, group_size=g))(p, x)
            # each data shard's aux on (2, 4), as the shard map routes it
            out[f"shard_{slack}_aux"] = jnp.stack(
                [run(p, x[4 * i:4 * i + 4])[1] for i in range(2)])
    elif spec["job"] == "train":
        name = spec["name"]
        cfg, opt = cfg_of(spec), optim.OptConfig(**spec["opt"])
        state = load(f"{d}/{name}_state0.npz")
        state["opt"]["step"] = state["opt"]["step"].astype(jnp.int32)
        batches = [load(f"{d}/{name}_batch{i}.npz") for i in range(2)]
        if spec.get("jax_sharded"):
            # the chain itself is JAX's sharded step (the "single" process
            # leaves it to this one)
            if mode != "sharded":
                continue
            mesh = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
            rules = ShardingRules(mesh)
            step = jax.jit(lambda s, b: steps.train_step(
                s, b, cfg, opt, rules=rules, mesh=mesh))
            state = {"params": placed(state["params"], cfg, rules),
                     "opt": {**state["opt"],
                             "m": placed(state["opt"]["m"], cfg, rules),
                             "v": placed(state["opt"]["v"], cfg, rules)}}
            with mesh:
                for i, b in enumerate(batches):
                    state, met = step(state, b)
                    out.update({f"{name}_met{i}_{k}": v
                                for k, v in met.items()})
                    out.update({f"{name}_state{i + 1}/{k}": v
                                for k, v in flat(state).items()})
                    if i == 0:
                        out[f"{name}_aux_devices"] = np.array(
                            [float(x.data) for x in
                             met["aux_loss"].addressable_shards])
                        np.savez(f"{d}/{name}_tmp.npz", **flat(state))
                        os.replace(f"{d}/{name}_tmp.npz",
                                   f"{d}/{name}_jstate1.npz")
            continue
        if mode == "sharded":
            if cfg.family != "moe":
                continue
            mesh = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
            rules = ShardingRules(mesh)
            with mesh:
                _, m = jax.jit(lambda s, b: steps.train_step(
                    s, b, cfg, rules=rules, mesh=mesh))(state, batches[0])
            for k in ("aux_loss", "loss"):
                shards = sorted((s.device.id, float(s.data))
                                for s in m[k].addressable_shards)
                out[f"sharded_{k}"] = np.array([v for _, v in shards])
                out[f"sharded_{k}_read"] = np.array(float(m[k]))
            continue
        n_data = int(np.prod(spec["mesh"][:-1]))
        step = jax.jit(shard_aux_step(cfg, opt, n_data) if cfg.family == "moe"
                       else lambda s, b: steps.train_step(s, b, cfg, opt))
        for i, b in enumerate(batches):
            state, met = step(state, b)
            out.update({f"{name}_met{i}_{k}": v for k, v in met.items()})
            out.update({f"{name}_state{i + 1}/{k}": v
                        for k, v in flat(state).items()})
            if i == 0:
                np.savez(f"{d}/{name}_tmp.npz", **flat(state))
                os.replace(f"{d}/{name}_tmp.npz", f"{d}/{name}_jstate1.npz")
    elif spec["job"] == "mask" and mode == "single":
        cfg = cfg_of(spec)
        out["mask_loss"] = steps.loss_fn(load(f"{d}/mask_params.npz"),
                                         load(f"{d}/mask_batch.npz"),
                                         cfg)[1][0]
np.savez(f"{d}/jax_{mode}.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes every job's inputs, then runs the two JAX subprocesses and
    the 8 torch ranks side by side. Returns (directory, JAX's single-device
    results, JAX's sharded results)."""
    d = str(tmp_path_factory.mktemp("dist"))
    specs = []
    # (e) expert parallelism: one MoE layer's params and input
    tcfg = get_reduced_config("deepseek_v2_lite_16b").replace(**FP32)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(Initializer(tcfg, gen, "cpu"), tcfg)
    rng = np.random.default_rng(0)
    np.savez(f"{d}/ep_params.npz", **{
        k: (v.numpy() + rng.standard_normal(v.shape) * 0.1).astype(
            np.float32) for k, v in _flat(p).items()})
    np.save(f"{d}/ep_x.npy", rng.standard_normal(
        (8, 16, tcfg.d_model)).astype(np.float32))
    specs.append({"job": "ep", "arch": "deepseek_v2_lite_16b",
                  "replace": FP32, "slacks": [8.0, 1.0],
                  "groups": list(GROUPS)})
    # (f) the sharded train step
    for seed, (name, t) in enumerate(TRAIN.items()):
        arch = t.get("arch", name)
        tcfg = get_reduced_config(arch).replace(**FP32)
        np.savez(f"{d}/{name}_state0.npz", **_perturbed_state(tcfg, 30 + seed))
        for i in range(2):
            np.savez(f"{d}/{name}_batch{i}.npz", **_batch(
                tcfg, 40 + seed * 2 + i, *t["batch"],
                mask=t.get("mask", False)))
        specs.append({"job": "train", "name": name, "arch": arch,
                      "replace": FP32, "mesh": t["mesh"], "axes": t["axes"],
                      "opt": OPT, "jax_sharded": t.get("jax_sharded", False),
                      **({"moe": t["moe"]} if "moe" in t else {})})
    # (g) the global mean under unequal masks
    tcfg = get_reduced_config("internlm2_20b").replace(**FP32)
    state = _perturbed_state(tcfg, 50)
    np.savez(f"{d}/mask_params.npz", **{k[7:]: v for k, v in state.items()
                                        if k.startswith("params/")})
    np.savez(f"{d}/mask_batch.npz", **_batch(tcfg, 51, 8, 16, mask=True))
    specs.append({"job": "mask", "arch": "internlm2_20b", "replace": FP32,
                  "mesh": [2, 2, 2], "axes": ["pod", "data", "model"]})
    specs.append({"job": "heads", "arch": "internlm2_20b", "replace": FP32,
                  "mesh": [2, 4], "axes": ["data", "model"],
                  "heads": [[8, 2], [8, 1]]})
    with open(f"{d}/jobs.json", "w") as f:
        json.dump(specs, f)

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, d, mode], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for mode in ("single", "sharded")]
    try:
        tmesh.spawn(jobs.run, 8, (d,), device="cpu")
    finally:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    return (d, dict(np.load(f"{d}/jax_single.npz")),
            dict(np.load(f"{d}/jax_sharded.npz")))


def _out(d, name):
    return dict(np.load(f"{d}/out_{name}.npz"))


def _sub(flat, prefix):
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# (a), (b), (c): rules, axes, shrink (no ranks)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_abstract(arch, reduced):
    """JAX's abstract params and init_model axes (``eval_shape``: nothing
    allocated), and the port's config."""
    jcfg, tcfg = ((jreduced(arch), get_reduced_config(arch)) if reduced
                  else (jget(arch), get_config(arch)))
    return jtf.abstract_model(jcfg), tcfg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax_on_every_leaf(arch):
    for reduced in (True, False):
        (abstract, jaxes), tcfg = _jax_abstract(arch, reduced)
        shapes = {".".join(str(k.key) for k in kp): tuple(leaf.shape)
                  for kp, leaf in jax.tree_util.tree_flatten_with_path(
                      abstract)[0]}
        assert ttf.param_shapes(tcfg) == shapes
        for shape, names in MESHES.items():
            for kw in ({}, {"fsdp": True}, {"seq_sharded": True}):
                jr = jsharding.ShardingRules(_StubMesh(shape, names), **kw)
                tr = tsharding.ShardingRules(_StubMesh(shape, names), **kw)
                got = tsharding.tree_specs(tr, ttf.param_shapes(tcfg),
                                           ttf.param_axes(tcfg))
                for path, s in shapes.items():
                    want = tuple(jr.spec(s, jaxes[path]))
                    assert tuple(got[path]) == want, (arch, shape, kw, path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_jax(arch):
    for reduced in (True, False):
        (_, jaxes), tcfg = _jax_abstract(arch, reduced)
        assert ttf.param_axes(tcfg) == jaxes


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_shrink_rule_matches_jax(n, monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: n)
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes, **kw: shape)
    for shape in ((2, 4), (16, 16), (2, 16, 16), (2, 2, 2), (8,), (3, 1)):
        want = jmesh.compat_make_mesh(shape, ("a",) * len(shape),
                                      shrink=True)
        assert tmesh.shrink_shape(shape, n) == tuple(want), (shape, n)
        assert np.prod(want) <= max(n, 1) or max(want) == 1


# ---------------------------------------------------------------------------
# (h): the refusals (no ranks: they raise before any collective)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["seq_sharded", "zamba2_7b_seq_sharded",
                                  "xlstm_1_3b_seq_sharded"])
def test_unrun_layouts_raise_naming_leaf_and_spec(what):
    """The audio, hybrid and ssm families, FSDP and the MoE dispatch einsum
    with sharded experts train under a mesh (here, ``tests/test_torch_
    dist_serve.py``, ``tests/test_torch_dist_train_recurrent.py``);
    ``seq_sharded`` in mode "train" (also for the hybrid and ssm
    families), which JAX's dry run sets for decode only, still raises."""
    arch = next((a for a in ARCH_IDS if what.startswith(a)),
                "internlm2_20b")
    cfg = get_reduced_config(arch)
    rules = tsharding.ShardingRules(
        _StubMesh((2, 2), ("data", "model")), seq_sharded=True)
    with pytest.raises(NotImplementedError) as e:
        tsteps.train_step(None, None, cfg, rules=rules, mesh=rules.mesh)
    msg = str(e.value)
    assert "spec (" in msg and "later slice" in msg, msg
    assert "'seq'" in msg, msg


# ---------------------------------------------------------------------------
# the ranks' results
# ---------------------------------------------------------------------------

def test_shard_then_gather_is_the_identity(world):
    d, _, _ = world
    for arch in TRAIN:
        assert float(_out(d, arch)["roundtrip"]) == 1.0, arch


def test_ep_moe_matches_jax_single_device(world):
    d, single, _ = world
    out = _out(d, "ep")
    np.testing.assert_allclose(out["ep_8.0_y"], single["single_8.0_y"],
                               atol=EP_TOL, rtol=0)
    # each data shard's aux, as JAX's shard map computes it
    np.testing.assert_allclose(out["ep_8.0_aux"], single["shard_8.0_aux"],
                               rtol=EP_TOL)


def test_ep_moe_with_drops_matches_jax_shard_map(world):
    d, single, sharded = world
    out = _out(d, "ep")
    np.testing.assert_allclose(out["ep_1.0_y"], sharded["shard_map_1.0_y"],
                               atol=EP_TOL, rtol=0)
    np.testing.assert_allclose(sharded["shard_map_8.0_y"],
                               single["single_8.0_y"], atol=2e-3, rtol=0)
    # slack 1.0 drops rows: the per-shard capacity differs from one device's
    assert np.abs(out["ep_1.0_y"] - single["single_1.0_y"]).max() > 1e-3


def test_every_expert_over_data_ranks_cuts_like_one_program(world):
    d, single, _ = world
    out = _out(d, "ep")
    for slack in (8.0, 1.0):
        np.testing.assert_allclose(out[f"cut_{slack}_y"],
                                   single[f"single_{slack}_y"],
                                   atol=EP_TOL, rtol=0)
        np.testing.assert_allclose(out[f"cut_{slack}_aux"],
                                   single[f"single_{slack}_aux"],
                                   rtol=EP_TOL)


@pytest.mark.parametrize("group", GROUPS)
def test_dispatch_einsum_over_ranks_is_one_program(world, group):
    """The dispatch einsum on the ranks' rows == JAX's one program over the
    whole batch (``moe_dispatch_einsum`` at the same group size), with its
    experts split over "model" on (2, 4) and every expert over 8 data
    ranks, with and without drops: each assignment's slot counts the
    assignments of the lower ranks in its group; the aux is the whole
    batch's on every rank."""
    d, single, _ = world
    out = _out(d, "ep")
    for tag in ("ep", "cut"):
        for slack in (8.0, 1.0):
            key = f"dispatch_{group}_{slack}"
            np.testing.assert_allclose(out[f"{tag}_{key}_y"],
                                       single[f"{key}_y"], atol=EP_TOL,
                                       rtol=0, err_msg=f"{tag} {key}")
            np.testing.assert_allclose(out[f"{tag}_{key}_aux"],
                                       np.full(out[f"{tag}_{key}_aux"].shape,
                                               single[f"{key}_aux"]),
                                       rtol=EP_TOL, err_msg=f"{tag} {key}")
    # slack 1.0 drops rows, so the slots of the lower ranks matter
    assert np.abs(single[f"dispatch_{group}_1.0_y"]
                  - single[f"dispatch_{group}_8.0_y"]).max() > 1e-3


def _close_to_max(got, want, rtol, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rtol * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def _params_close(got, want, got_before, want_before, step, what):
    """``tests/test_torch_train_families.py``'s rule for params after an
    AdamW step: within STEP_RTOL of each leaf's largest entry, plus what
    the two states' differences in m and v make through the normalised
    step ``lr · m̂ / (√v̂ + eps)`` (first-order propagation, doubled), plus
    the difference the two params had before the step (carried through
    ``p · (1 - lr · wd)``). Where a gradient is at fp32 noise, v̂ is tiny
    and the step follows the noise. ``got``/``want`` are flat states."""
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
        carried = np.abs(got_before[f"params/{k}"]
                         - want_before[f"params/{k}"])
        err = np.abs(got[f"params/{k}"] - w)
        bad = err > STEP_RTOL * np.abs(w).max() + 2 * slack + carried
        assert not bad.any(), (what, k, int(bad.sum()), float(err.max()))


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_step_matches_jax(world, name):
    """Two steps of each package's chain from the same state: loss, grad
    norm and aux at each step; params, m and v after step 1, and after a
    step 2 taken from JAX's state after step 1 (carried across, as
    ``tests/test_torch_train.py`` does: AdamW's normalised step turns the
    fp32 noise of near-zero gradients into steps of order lr, so two
    chains part at a few entries). The dispatch einsum's chain is JAX's
    sharded step."""
    d, single, sharded = world
    arch = TRAIN[name].get("arch", name)
    out = _out(d, name)
    state0 = dict(np.load(f"{d}/{name}_state0.npz"))
    if TRAIN[name].get("jax_sharded"):
        single = sharded
    for i in range(2):
        for k in ("loss", "grad_norm", "aux_loss"):
            want = single[f"{name}_met{i}_{k}"]
            np.testing.assert_allclose(out[f"chain{i}_{k}"], want,
                                       rtol=STEP_RTOL, err_msg=f"{k} {i}")
            if i == 1:
                np.testing.assert_allclose(out[f"carried_{k}"], want,
                                           rtol=STEP_RTOL, err_msg=k)
        got = _sub(out, f"state{i + 1}")
        want = _sub(single, f"{name}_state{i + 1}")
        before = state0 if i == 0 else _sub(single, f"{name}_state1")
        _params_close(got, want, before, before, i + 1, f"params {i + 1}")
        for m in ("m", "v"):
            _close_to_max(_sub(got, f"opt/{m}"), _sub(want, f"opt/{m}"),
                          STEP_RTOL, m)
        assert int(got["opt/step"]) == int(want["opt/step"]) == i + 1
    # the layouts this model exercises, as JAX's rules give them
    rules = tsharding.ShardingRules(_StubMesh(
        tuple(TRAIN[name]["mesh"]), TRAIN[name]["axes"]))
    cfg = get_reduced_config(arch)
    specs = tsharding.tree_specs(rules, ttf.param_shapes(cfg),
                                 ttf.param_axes(cfg))
    assert tuple(specs["embed"]) == ("model", None)
    if arch == "gemma_2b":      # one kv head: its head dim takes "model"
        assert tuple(specs["layers.attn.wk"]) == (None, None, None, "model")
    if arch == "deepseek_v2_lite_16b":
        assert tuple(specs["layers.attn.wdkv"]) == (None, None, "model")
        assert tuple(specs["layers.moe.router"]) == (None, None, "model")
        assert tuple(specs["layers.moe.wi"]) == (None, "model", None, None)
        assert float(out["chain0_aux_loss"]) > 0


def test_dispatch_einsum_aux_is_the_whole_batchs_on_every_device(world):
    """Reference fact: JAX's dispatch einsum is one program over the whole
    batch (no shard map), so its sharded step's aux is the whole batch's
    and the same on every device, unlike the ragged path's per-shard aux
    below; the port's sharded dispatch reports that one value."""
    d, _, sharded = world
    name = "deepseek_v2_lite_16b_dispatch"
    per_device = sharded[f"{name}_aux_devices"]
    assert len(per_device) == 4 and (per_device == per_device[0]).all()
    np.testing.assert_allclose(_out(d, name)["chain0_aux_loss"],
                               per_device[0], rtol=STEP_RTOL)


def test_aux_under_data_shards_is_the_mean_of_jax_devices(world):
    """Reference fact: JAX's sharded step leaves data shard i's own aux on
    its devices (devices 0, 1: shard 0; 2, 3: shard 1), and reports device
    0's; the two shards' differ. The port's aux is their mean, and its
    loss equals JAX's on every device."""
    d, _, sharded = world
    per_device = sharded["sharded_aux_loss"]
    assert per_device[0] == per_device[1] and per_device[2] == per_device[3]
    assert per_device[0] != per_device[2]
    assert float(sharded["sharded_aux_loss_read"]) == per_device[0]
    out = _out(d, "deepseek_v2_lite_16b")
    np.testing.assert_allclose(out["chain0_aux_loss"],
                               np.mean(per_device[::2]), rtol=STEP_RTOL)
    np.testing.assert_allclose(out["chain0_loss"],
                               sharded["sharded_loss"], rtol=STEP_RTOL)


def test_global_mean_with_unequal_masks(world):
    d, single, _ = world
    np.testing.assert_allclose(_out(d, "mask")["loss"], single["mask_loss"],
                               rtol=STEP_RTOL)


def test_local_query_heads_meet_their_kv_heads(world):
    """8 query heads over 2 and over 1 kv heads on "model" = 4 (2 query
    heads a rank; K/V's head dim split over "model" and gathered): the
    sharded gradient equals the one-process one."""
    d, _, _ = world
    out = _out(d, "heads")
    for nh, kvh in ((8, 2), (8, 1)):
        loss = out[f"{nh}_{kvh}_loss"]
        np.testing.assert_allclose(loss[0], loss[1], rtol=STEP_RTOL)
        assert float(out[f"{nh}_{kvh}_grad_err"]) < 1e-5
        assert out[f"{nh}_{kvh}_wk_spec"].tolist() == [False, False, False,
                                                      True]


def test_tree_shardings_give_each_spec_as_dtensor_placements():
    """Under fsdp on (2, 2, 2): the embedding's vocabulary on "model" and
    its d_model on ("pod", "data"), one placement a mesh axis in the
    mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    rules = tsharding.ShardingRules(
        _StubMesh((2, 2, 2), ("pod", "data", "model")), fsdp=True)
    cfg = get_reduced_config("internlm2_20b")
    got = tsharding.tree_shardings(rules, ttf.param_shapes(cfg),
                                   ttf.param_axes(cfg))
    assert got["embed"] == (Shard(1), Shard(1), Shard(0))
    assert got["layers.attn.wq"] == (Shard(1), Shard(1), Shard(2))
    assert got["final_norm.gamma"] == (Replicate(),) * 3
