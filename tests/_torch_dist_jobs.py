"""Rank side of ``tests/test_torch_distributed.py`` and
``tests/test_torch_dist_serve.py``: each rank of a gloo process group on
the CPU runs these jobs of the port's sharded path (imports torch and
``repro_torch`` only). Inputs and outputs are ``.npz``
files of flattened trees ("/"-joined paths) in a directory the test
gives; rank 0 writes the outputs."""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch


def save_tree(path, tree):
    from repro_torch import tree as T
    np.savez(path, **{k: (v.detach().float().numpy() if torch.is_tensor(v)
                          else np.asarray(v))
                      for k, v in T.flatten(tree).items()})


def load_tree(path, dtype=None):
    out = {}
    with np.load(path) as z:
        for k in z.files:
            node = out
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            t = torch.from_numpy(np.array(z[k]))
            node[last] = t.to(dtype) if dtype is not None and \
                t.is_floating_point() else t
    return out


def _cfg(spec):
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(spec["arch"]).replace(**spec.get("replace", {}))
    if "moe" in spec:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **spec["moe"]))
    if "mla" in spec:
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, **spec["mla"]))
    return cfg


def _mesh(shape, axes):
    """The mesh over ranks 0 .. prod(shape) - 1, its axis groups made on
    every rank (a rank outside it gets None): "model", the data axes, and
    all of them (the caches' positions under ``shard_v2`` with
    ``seq_sharded``)."""
    from repro_torch import distributed as D
    from repro_torch.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh(shape, axes, device="cpu")
    model = D.axis(mesh, ("model",))
    data = D.axis(mesh, ("pod", "data"))
    D.axis(mesh, ("pod", "data", "model"))   # a positions group
    return mesh, model is not None and data is not None


def _moe_specs(layout, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _moe_specs(layout, v, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    return layout.specs[prefix]


def job_ep(rank, d, spec):
    """apply_moe on the rank's shards: EP on (2, 4) at each capacity
    slack, and every expert on 8 data ranks (mesh ("data",)) at each; the
    dispatch einsum alike at each of ``spec["groups"]`` (its group size:
    one group of the whole batch, or groups that a rank's rows fill or
    straddle)."""
    from repro_torch import distributed as D
    from repro_torch import weights
    from repro_torch.models import moe
    p = load_tree(f"{d}/ep_params.npz")
    x = torch.from_numpy(np.load(f"{d}/ep_x.npy"))
    out = {}
    for tag, shape, axes in (("ep", (2, 4), ("data", "model")),
                             ("cut", (8,), ("data",))):
        mesh, member = _mesh(shape, axes)
        for slack in spec["slacks"]:
            cfg = _cfg({**spec, "moe": {"capacity_slack": slack}})
            lay = D.moe_layout(cfg, mesh)
            local = weights.shard_params(p, _moe_specs(lay, p), mesh)
            rows = D.local_slice(x, 0, lay.data)
            with torch.no_grad():
                y, aux = moe.apply_moe(local, rows, cfg, mesh=mesh)
                out[f"{tag}_{slack}_y"] = D.gather(y, 0, lay.data)
                out[f"{tag}_{slack}_aux"] = D.gather(aux.reshape(1), 0,
                                                     lay.data)
                for g in spec["groups"]:
                    y, aux = moe.moe_dispatch_einsum(local, rows, cfg,
                                                     group_size=g, tp=lay)
                    out[f"{tag}_dispatch_{g}_{slack}_y"] = D.gather(
                        y, 0, lay.data)
                    out[f"{tag}_dispatch_{g}_{slack}_aux"] = D.gather(
                        aux.reshape(1), 0, lay.data)
    if rank == 0:
        save_tree(f"{d}/out_ep.npz", out)


def job_train(rank, d, spec):
    """Two sharded train steps from the given state (their metrics), the
    state after step 1 gathered, and step 2 again from JAX's state after
    step 1 (its metrics and the state after it, gathered). Also the round
    trip of the initial state through shard_params / gather_params, and
    whether every rank's m and v have the shapes of its shards. Inputs
    are ``{spec["data"]}_*.npz`` (default the case's name), JAX's state
    ``{spec["ref"]}_jstate1.npz`` (default the data's); ``spec["fsdp"]``
    sets the rules' flag. The params are laid out by
    ``transformer.param_specs``."""
    from repro_torch import distributed as D
    from repro_torch import tree as T
    from repro_torch import weights
    from repro_torch.models import optim, sharding, steps
    from repro_torch.models import transformer as tf
    name = spec["name"]
    data = spec.get("data", name)
    mesh, member = _mesh(tuple(spec["mesh"]), tuple(spec["axes"]))
    if not member:
        return
    cfg = _cfg(spec)
    rules = sharding.ShardingRules(mesh, fsdp=spec.get("fsdp", False))
    pspecs = tf.param_specs(cfg, rules)
    sspecs = steps.state_specs(_nest(pspecs))
    full = load_tree(f"{d}/{data}_state0.npz")
    full["opt"]["step"] = full["opt"]["step"].to(torch.int32)
    opt = optim.OptConfig(**spec["opt"])
    batches = [load_tree(f"{d}/{data}_batch{i}.npz") for i in range(2)]
    state = weights.shard_params(full, sspecs, mesh)
    back = weights.gather_params(state, sspecs, mesh)
    out = {"roundtrip": torch.tensor(float(all(
        torch.equal(a, T.flatten(full)[k])
        for k, a in T.flatten(back).items())))}
    shapes = tf.param_shapes(cfg)
    bad = torch.tensor([float(not all(
        tuple(t.shape) == D.local_shape(shapes[k.replace("/", ".")],
                                        pspecs[k.replace("/", ".")], mesh)
        for mv in ("m", "v") for k, t in T.flatten(state["opt"][mv]).items()
    ))])
    for ax in (("model",), ("pod", "data")):
        D.all_reduce(bad, D.axis(mesh, ax), "max")
    out["moments_shaped"] = 1.0 - bad[0]
    for i, batch in enumerate(batches):
        state, met = steps.train_step(state, batch, cfg, opt, rules=rules,
                                      mesh=mesh)
        for k, v in met.items():
            out[f"chain{i}_{k}"] = v
        if i == 0:
            out["state1"] = weights.gather_params(state, sspecs, mesh)
    # step 2 again from JAX's state after step 1, which the JAX process
    # writes while the ranks run
    path = f"{d}/{spec.get('ref', data)}_jstate1.npz"
    for _ in range(3000):
        if os.path.exists(path):
            break
        time.sleep(0.1)
    carried = load_tree(path)
    carried["opt"]["step"] = carried["opt"]["step"].to(torch.int32)
    st = weights.shard_params(carried, sspecs, mesh)
    st, met = steps.train_step(st, batches[1], cfg, opt, rules=rules,
                               mesh=mesh)
    for k, v in met.items():
        out[f"carried_{k}"] = v
    out["state2"] = weights.gather_params(st, sspecs, mesh)
    if rank == 0:
        save_tree(f"{d}/out_{name}.npz", out)


def _nest(flat_dotted):
    """A dotted-path dict -> the nested tree."""
    if not isinstance(flat_dotted, dict) or not any(
            "." in k for k in flat_dotted):
        return flat_dotted
    out = {}
    for k, v in flat_dotted.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def job_heads(rank, d, spec):
    """Sharded value_and_grad == the one-process port's at the head counts
    of ``spec["heads"]`` (a local query head meets the right kv head)."""
    from repro_torch import tree as T
    from repro_torch import weights
    from repro_torch.models import sharding, steps
    from repro_torch.models import transformer as tf
    mesh, member = _mesh(tuple(spec["mesh"]), tuple(spec["axes"]))
    out = {}
    for nh, kvh in spec["heads"]:
        cfg = _cfg({**spec, "replace": {**spec["replace"], "num_heads": nh,
                                        "num_kv_heads": kvh}})
        gen = torch.Generator().manual_seed(nh * 10 + kvh)
        p = tf.init_model(cfg, gen, "cpu")
        p = T.map_tree(lambda t: t + 0.1 * torch.randn(t.shape,
                                                       generator=gen), p)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 12),
                                         generator=gen),
                 "labels": torch.randint(0, cfg.vocab_size, (8, 12),
                                         generator=gen)}
        rules = sharding.ShardingRules(mesh)
        pspecs = _nest(sharding.tree_specs(rules, tf.param_shapes(cfg),
                                           tf.param_axes(cfg)))
        local = weights.shard_params(p, pspecs, mesh)
        (_, (loss, _)), g = steps.value_and_grad(local, batch, cfg, rules,
                                                 mesh)
        g = weights.gather_params(g, pspecs, mesh)
        if rank == 0:
            (_, (loss1, _)), g1 = steps.value_and_grad(p, batch, cfg)
            g1 = T.flatten(g1)
            out[f"{nh}_{kvh}_loss"] = torch.stack([loss, loss1])
            out[f"{nh}_{kvh}_grad_err"] = torch.tensor(max(
                float((a - g1[k]).abs().max() / g1[k].abs().max())
                for k, a in T.flatten(g).items()))
            out[f"{nh}_{kvh}_wk_spec"] = torch.tensor(
                [e == "model" for e in pspecs["layers"]["attn"]["wk"]])
    if rank == 0:
        save_tree(f"{d}/out_heads.npz", out)


def job_whole(rank, d, spec):
    """A config whose heads do not divide "model" (its MLA attention or
    mLSTM/sLSTM layers run whole on every model rank,
    ``transformer.param_specs``): the sharded ``value_and_grad`` and the
    sharded ``prefill_step`` + ``spec["steps"]`` ``serve_step``s against
    the one-process port's on the same weights and inputs; with the
    whole blocks' leaves' specs (none may name "model")."""
    from repro_torch import tree as T
    from repro_torch import weights
    from repro_torch.models import sharding, steps
    from repro_torch.models import transformer as tf
    mesh, member = _mesh(tuple(spec["mesh"]), tuple(spec["axes"]))
    if not member:
        return
    cfg = _cfg(spec)
    gen = torch.Generator().manual_seed(spec["seed"])
    p = tf.init_model(cfg, gen, "cpu")
    p = T.map_tree(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen),
                   p)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, spec["seq"]),
                              generator=gen) for k in ("tokens", "labels")}
    rules = sharding.ShardingRules(mesh)
    flat_specs = tf.param_specs(cfg, rules)
    pspecs = _nest(flat_specs)
    local = weights.shard_params(p, pspecs, mesh)
    (_, (loss, _)), g = steps.value_and_grad(local, batch, cfg, rules, mesh)
    g = T.flatten(weights.gather_params(g, pspecs, mesh))
    with torch.no_grad():
        prompt = {"tokens": batch["tokens"]}
        logits, caches = steps.prefill_step(local, prompt, cfg,
                                            spec["max_len"], rules, mesh)
        outs = [logits]
        tok = torch.argmax(logits, -1).to(torch.int32)
        for _ in range(spec["steps"]):
            tok, logits, caches = steps.serve_step(local, tok[:, None],
                                                   caches, cfg, rules, mesh)
            outs.append(logits)
    if rank != 0:
        return
    (_, (loss1, _)), g1 = steps.value_and_grad(p, batch, cfg)
    g1 = T.flatten(g1)
    with torch.no_grad():
        logits, caches = steps.prefill_step(p, prompt, cfg, spec["max_len"])
        ones = [logits]
        tok = torch.argmax(logits, -1).to(torch.int32)
        for _ in range(spec["steps"]):
            tok, logits, caches = steps.serve_step(p, tok[:, None], caches,
                                                   cfg)
            ones.append(logits)
    whole = [k for k in flat_specs if k.startswith(tuple(spec["whole"]))]
    save_tree(f"{d}/out_whole_{spec['name']}.npz", {
        "loss": torch.stack([loss, loss1]),
        "grad_err": torch.tensor(max(
            float((a - g1[k]).abs().max() / g1[k].abs().max().clamp(
                min=1e-30)) for k, a in g.items())),
        "logit_err": torch.tensor(max(
            float((a - b).abs().max() / b.abs().max())
            for a, b in zip(outs, ones))),
        "whole_leaves": torch.tensor(len(whole)),
        "whole_model": torch.tensor(sum("model" in flat_specs[k]
                                        for k in whole)),
        "split_model": torch.tensor(sum("model" in v for k, v in
                                        flat_specs.items()
                                        if k not in whole))})


def job_mask(rank, d, spec):
    """loss_fn on a batch whose masks differ across the data ranks."""
    from repro_torch.models import sharding, steps
    from repro_torch.models import transformer as tf
    mesh, member = _mesh(tuple(spec["mesh"]), tuple(spec["axes"]))
    cfg = _cfg(spec)
    rules = sharding.ShardingRules(mesh)
    from repro_torch import weights
    pspecs = _nest(sharding.tree_specs(rules, tf.param_shapes(cfg),
                                       tf.param_axes(cfg)))
    p = weights.shard_params(load_tree(f"{d}/mask_params.npz"), pspecs, mesh)
    batch = load_tree(f"{d}/mask_batch.npz")
    with torch.no_grad():
        total, (loss, aux) = steps.loss_fn(p, batch, cfg, rules, mesh)
    if rank == 0:
        save_tree(f"{d}/out_mask.npz", {"loss": loss})


def _local_params(d, name, cfg, mesh, rules_kw=None, full=None):
    """(rules, this rank's shards of ``{name}_params.npz``, or of
    ``full``, laid out by ``transformer.param_specs``); ``rules_kw``: the
    rules' flags (``seq_sharded``, ``fsdp``)."""
    from repro_torch import weights
    from repro_torch.models import sharding
    from repro_torch.models import transformer as tf
    rules = sharding.ShardingRules(mesh, **(rules_kw or {}))
    pspecs = _nest(tf.param_specs(cfg, rules))
    if full is None:
        full = load_tree(f"{d}/{name}_params.npz")
    return rules, weights.shard_params(full, pspecs, mesh)


def _fp32_caches(init_cache):
    """``transformer.init_cache`` with its bf16 leaves in fp32 (over bf16
    caches one fp32 ulp can round an entry to the other bf16 neighbour;
    the JAX references run over fp32 caches too)."""
    def init(*args, **kw):
        return {g: {k: v.float() if v.dtype == torch.bfloat16 else v
                    for k, v in c.items()}
                for g, c in init_cache(*args, **kw).items()}
    return init


def job_serve(rank, d, spec):
    """The sharded ``prefill_step`` (over fp32 caches) then
    ``spec["steps"]`` ``serve_step``s, each fed its own greedy tokens:
    every step's logits and tokens, and the caches gathered
    (``gather_params`` with ``cache_specs``) after the prefill and after
    the last step; whether the params' shards gather back to the whole
    leaves bit for bit. Inputs are ``{spec["data"]}_*.npz`` (default the
    case's name); ``spec["rules"]`` holds the rules' flags, and
    ``spec["seq_sharded"]`` sets that one."""
    from repro_torch import tree as T
    from repro_torch import weights
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    name = spec["name"]
    mesh, member = _mesh(tuple(spec["mesh"]), tuple(spec["axes"]))
    if not member:
        return
    cfg = _cfg(spec)
    data = spec.get("data", name)
    full = load_tree(f"{d}/{data}_params.npz")
    rules_kw = dict(spec.get("rules", {}))
    if spec.get("seq_sharded"):
        rules_kw["seq_sharded"] = True
    rules, local = _local_params(d, data, cfg, mesh, rules_kw, full)
    back = weights.gather_params(local, _nest(tf.param_specs(cfg, rules)),
                                 mesh)
    flat = T.flatten(full)
    roundtrip = all(torch.equal(a, flat[k])
                    for k, a in T.flatten(back).items())
    batch = load_tree(f"{d}/{data}_batch.npz")
    b = next(iter(batch.values())).shape[0]
    cspecs = tf.cache_specs(cfg, rules, b, spec["max_len"])
    out = {}
    init_cache, tf.init_cache = tf.init_cache, _fp32_caches(tf.init_cache)
    try:
        with torch.no_grad():
            logits, caches = steps.prefill_step(local, batch, cfg,
                                                spec["max_len"], rules, mesh)
    finally:
        tf.init_cache = init_cache
    with torch.no_grad():
        out["prefill"] = logits
        out["cache_prefill"] = weights.gather_params(caches, cspecs, mesh)
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i in range(spec["steps"]):
            tok, logits, caches = steps.serve_step(local, tok[:, None],
                                                   caches, cfg, rules, mesh)
            out[f"logits{i}"], out[f"tokens{i}"] = logits, tok
        out["cache"] = weights.gather_params(caches, cspecs, mesh)
    out["roundtrip"] = torch.tensor(float(roundtrip))
    if "attn" in caches:
        out["local_k_shape"] = torch.tensor(
            caches["attn"]["c_kv" if cfg.attn_type == "mla" else "k"].shape)
    if rank == 0:
        save_tree(f"{d}/out_{name}.npz", out)


def job_encoder(rank, d, spec):
    """An encoder-only config's sharded ``prefill_step`` (its forward,
    logits whole on every rank) and one sharded ``train_step`` from the
    params with AdamW's moments at 0: the metrics and the state after it,
    gathered."""
    from repro_torch import weights
    from repro_torch.models import optim, sharding, steps
    from repro_torch.models import transformer as tf
    name = spec["name"]
    mesh, member = _mesh(tuple(spec["mesh"]), tuple(spec["axes"]))
    if not member:
        return
    cfg = _cfg(spec)
    rules, local = _local_params(d, name, cfg, mesh)
    batch = load_tree(f"{d}/{name}_batch.npz")
    out = {}
    with torch.no_grad():
        out["prefill"], caches = steps.prefill_step(
            local, {"embeds": batch["embeds"]}, cfg, spec["max_len"], rules,
            mesh)
    assert caches is None
    sspecs = steps.state_specs(_nest(sharding.tree_specs(
        rules, tf.param_shapes(cfg), tf.param_axes(cfg))))
    state = {"params": local, "opt": optim.init_opt_state(local)}
    state, met = steps.train_step(state, batch, cfg,
                                  optim.OptConfig(**spec["opt"]),
                                  rules=rules, mesh=mesh)
    out.update({f"met_{k}": v for k, v in met.items()})
    out["state"] = weights.gather_params(state, sspecs, mesh)
    if rank == 0:
        save_tree(f"{d}/out_{name}.npz", out)


def card(rank, world, d, shape):
    """On the card: reduced gemma_2b (bf16) on mesh ("data", "model") =
    ``shape``, its sharded gradient and train step against the same in
    one process (rank 0) from the same weights and batch, the flash
    kernels counted; rank 0 writes ``card.json``."""
    from repro_torch import tree as T
    from repro_torch import weights
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import optim, sharding, steps
    from repro_torch.models import transformer as tf
    mesh = compat_make_mesh(shape, ("data", "model"))
    cfg = get_reduced_config("gemma_2b").replace(remat="none")
    gen = torch.Generator(device="cuda").manual_seed(3)
    full = T.map_tree(lambda t: t + (0.1 * torch.randn(
        t.shape, generator=gen, device="cuda")).to(t.dtype),
        tf.init_model(cfg, gen, "cuda"))
    batch = {k: torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                              device="cuda") for k in ("tokens", "labels")}
    rules = sharding.ShardingRules(mesh)
    specs = sharding.tree_specs(rules, full, tf.param_axes(cfg))
    local = weights.shard_params(full, specs, mesh)
    ops.reset_launches()
    (_, (loss, _)), g = steps.value_and_grad(local, batch, cfg, rules, mesh)
    counts = ops.launch_counts()
    g = T.flatten(weights.gather_params(g, specs, mesh))
    state = {"params": local, "opt": optim.init_opt_state(local)}
    _, met = steps.train_step(state, batch, cfg, rules=rules, mesh=mesh)
    if rank == 0:
        (_, (loss1, _)), g1 = steps.value_and_grad(full, batch, cfg)
        one = {"params": full, "opt": optim.init_opt_state(full)}
        _, met1 = steps.train_step(one, batch, cfg)
        g1 = T.flatten(g1)
        cos = {k: float((a.float().flatten() @ g1[k].float().flatten())
                        / (a.float().norm() * g1[k].float().norm()))
               for k, a in g.items()}
        with open(os.path.join(d, "card.json"), "w") as f:
            json.dump({"loss": [float(loss), float(loss1)],
                       "step_loss": [float(met["loss"]),
                                     float(met1["loss"])],
                       "cos": cos, "fwd": counts["flash_attention"],
                       "bwd": counts["flash_attention_bwd"]}, f)


def run(rank, world, d):
    """Every job of ``jobs.json`` in order, on every rank."""
    torch.set_num_threads(1)
    with open(os.path.join(d, "jobs.json")) as f:
        jobs = json.load(f)
    for spec in jobs:
        globals()[f"job_{spec['job']}"](rank, d, spec)
