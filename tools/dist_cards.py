#!/usr/bin/env python3
"""The sharded steps on four cards, one rank a card over NCCL:

    python3 tools/dist_cards.py [train] [serve] [long] [probe] [train_whole]
        [v2] [long_mla] [dispatch] [fsdp]

With no argument it runs train and serve.

``train``: ``chip_smoke.py``'s phase dist on a host with four H100s: for
each mesh ("data", "model") of MESHES, gemma_2b and deepseek_v2_lite_16b
at full width (``chip_smoke.DIST_RUNS``: depth the only cut), DIST_STEPS
steps of 4 x 1024 tokens in bf16 through ``steps.train_step(..., rules=,
mesh=)``, each rank's exit code checked, and phase dist's gates
(``chip_smoke.dist_report``): flash forward and backward launches on
every rank, every flash call of step 1 held against its plain version,
the replicated loss, aux and grad norm equal on every rank, the loss
against the same steps in one process on card 0, every gathered gradient
leaf's cosine to the one-process gradient. On (1, 4) v2-lite holds 16 of
its 64 experts a rank.

``serve``: llama3_70b served over the four cards on mesh (1, 4), 16 of
its 64 query heads and 2 of its 8 kv heads a rank. First at 16 layers,
phase dist_serve's gates against one process on card 0
(``chip_smoke._dist_serve_rank``, ``dist_serve_report``); then whole, all
80 layers at full width (``_serve_rank``): each rank makes only its own
shards of the seeded weights, leaf by leaf and layer by layer
(``chip_smoke.seeded_params``), so no rank holds the 141 GB whole; a
warm-up, then ``prefill_step`` of SERVE_BATCH prompts of SERVE_PROMPT
tokens and SERVE_NEW ``serve_step``s: TTFT (the prefill step's wall
time), TPOT (a step's), peak memory a card and the time in all-reduce
(CUDA events around each collective on the compute stream); the
launches; and, for layers 1, 40 and 80 (GATE_LAYERS), the sharded
block's output against the same block run unsharded on card 0 from its
gathered weights on the same input (``compare``, the elementwise bound
of the largest entry).

``long``: JAX's long_500k cell (524,288 tokens, batch 1, decode, its dry
run's ``seq_sharded`` rule) on the four-card analogue of its ("data",
"model") mesh: zamba2_7b whole (81 Mamba2 layers, 6 shared-block
applications, full width, bf16) on (2, 2) under ``seq_sharded``, the
shared block's K/V cache of LONG_S positions (JAX's seq_len + 8) split
over the two data ranks and its 32 kv heads over the two model ranks
(``_long_rank``). The cache is seeded, not prefilled (neither package
prefills 512k tokens on these cards: the chunked scan's intra-chunk fp32
tensor alone would be 2,048 chunks x 256^2 x 112 heads x 4 B ~ 60 GB):
its K/V and Mamba2 states are drawn from seeded generators at the scale
(each application's and layer's rms) that a real 1,024-token prefill of
the same weights gives them, filled to LONG_FILLED, then LONG_STEPS
``serve_step``s to 524,288. Decode time does not depend on the values.
Printed: TPOT (mean, median, range), the byte bound a card ((weights +
K/V + states on the card) / 3.35 TB/s), all-reduce ms a step, peak GiB a
card; beside them one process on card 0 at the same shape (whole weights
and cache) and its TPOT against its own bound. Gates: each
application's merged decode attention of one step against the
``decode_attention`` kernel over the cache gathered from the data ranks,
in one process (ROW_RTOL); Mamba2 layers 1, 40 and 81 against the
unsharded layer on the same input and state; the logits of the
LONG_STEPS steps against the one process's, fed the ranks' tokens: sure
first tokens equal, and within LOGIT_TOL in a first run at 14 layers
(one shared-block application, LONG_RUNS); whole, within the larger of
LOGIT_TOL and twice the largest move of the one process's own logits
when it sums where the ranks split a sum (``_sums_in_halves``): at 81
layers the seeded model carries a rounding-level change past LOGIT_TOL
(PERF.md §6). Every number is printed before the gates raise.

``probe`` (not run by default): where a sharded decode step's all-reduce
time goes (``_probe_rank``).

``train_whole`` (not run by default): training whole models that one card
cannot hold, on (2, 2), bf16, remat "full", one NCCL rank a card, each
rank making only its own shards of the seeded weights
(``chip_smoke._dist_train_rank``): zamba2_7b (81 layers, 6 shared-block
applications; 6.747e9 parameters, 81.0 GB of train state at 12 B a
parameter) without FSDP, as JAX's dry run gives a train cell under 30e9
parameters, and internlm2_20b (48 layers; 19.86e9 parameters, 238 GB)
under ``fsdp=True`` (each leaf's d_model over the data ranks, gathered in
each layer's remat body: 59.6 GB a card, 119 GB without it). First a run
at a depth one card holds (zamba2_7b 14 layers, internlm2_20b 8), with
phase dist_train_all's gates against the same steps in one process on
card 0 (``chip_smoke.dist_train_report``); then whole, TRAIN_WHOLE_STEPS
steps of 4 x 1024 tokens: step s (median of steps 2-6), tokens/s, TFLOP/s
and its share of 989 (``chip_smoke._train_flops``), peak GiB a card,
all-reduce ms a step, the train state's bytes a card beside what one card
would need; gated: the replicated loss and grad norm equal on every rank,
every (leaf, layer) moved (but ``chip_smoke.TRAIN_STUCK``'s), flash
launches on every rank, each rank's m and v of its shards' shape, and
layers 1, 40 and the last, each body's forward of step 1 against the
unsharded layer on card 0 from its gathered weights on the same input
(``compare``).

``v2``, ``long_mla``, ``dispatch``, ``fsdp`` (not run by default;
``layouts``):
the layouts that split the caches' positions, FSDP and the dispatch
einsum in serving, on (2, 2), bf16, full width, each rank making only
its shards of the seeded weights.
``v2``: JAX's decode_32k cell (128 rows, 32,768 positions) for gemma_2b
under ``shard_v2``, whose ``cache_seq`` puts the cache's positions on the
model ranks (its one kv head cannot take "model"): the K/V cache seeded
as ``long`` seeds it (at the rms of an 8 x 1024 prefill under the mesh,
``_seed_cache``), then 32 ``serve_step``s; at 4 layers against one process
on card 0 (17.2 GB of cache; logits within LOGIT_TOL), then whole (18
layers, 19.3 GB of K/V a card). ``long_mla``: JAX's long_500k cell on
deepseek_v2_lite_16b, naive MLA, under ``seq_sharded`` (the latent
cache's 524,288 positions over the data ranks, the batch of 1 whole on
each), seeded, 64 steps; at 4 layers (one process's logits printed, not
gated: rounding re-routes MoE tokens), then whole (27). ``dispatch``:
deepseek_v2_lite_16b with the dispatch einsum (its experts over "model",
the slots of the whole batch's groups), first at 6 layers with phase
dist_serve's gates against one process (``DISPATCH_CHECK``), then whole:
a real prefill of 8 x 1024 tokens (TTFT) and 32 steps. ``fsdp``: gemma_2b
whole served alike without and with ``fsdp=True``, what FSDP's gathers
cost a step in serving. Each prints TPOT
(mean, median, range), all-reduce ms and calls a step, peak GiB a card,
the launches, and the byte bound a card: the weights a step reads (the
ragged MoE path only the local experts its rows route to; the dispatch
einsum every local expert) and the card's cache, over 3.35 TB/s; and
holds three blocks of one step (the first, the middle, the last) against
the unsharded block on card 0 from their gathered weights, cache and
input, routed as the ranks routed (``_layout_gates``).

Every number is printed beside the card's name and power limit: these
are the card's collective times (phase dist's and dist_serve's gloo ranks
stage every collective through host memory). Needs four cards.
"""
import contextlib
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MESHES = ((2, 2), (1, 4))
SERVE_MESH = (1, 4)
CHECK_RUNS = (("llama3_70b", 16, SERVE_MESH, False),)
SERVE_LAYERS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 80, 8, 1024, 64
GATE_LAYERS = (0, 39, 79)


@contextlib.contextmanager
def _blocks_captured(which):
    """(input, output) of the attention blocks whose call index is in
    ``which`` while open."""
    from repro_torch.models import transformer as tf
    saved, got, calls = tf._block_fwd, {}, [0]

    def block(p, x, *args, **kw):
        out = saved(p, x, *args, **kw)
        if calls[0] in which:
            got[calls[0]] = (x.clone(), out[0].clone())
        calls[0] += 1
        return out
    tf._block_fwd = block
    try:
        yield got
    finally:
        tf._block_fwd = saved


def _serve_rank(rank, world, out_dir):
    """One rank of the whole-model run (see the module docstring); rank 0
    writes ``serve.json``."""
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import PartitionSpec
    mesh = compat_make_mesh(SERVE_MESH, ("data", "model"))
    rules = sharding.ShardingRules(mesh)
    cfg = cs._serve_cfg("llama3_70b", SERVE_LAYERS)
    t0 = time.perf_counter()
    params = cs.seeded_params(cfg, cs.DIST_SEED, rules, mesh)
    torch.cuda.synchronize()
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device(),
           "build_s": time.perf_counter() - t0,
           "weights_gib": torch.cuda.memory_allocated() / 2 ** 30}
    prompts = cs._serve_prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
    max_len = SERVE_PROMPT + SERVE_NEW
    with torch.no_grad():
        # warm-up: cuBLAS, NCCL and the kernels' first launches
        lg, caches = steps.prefill_step(params, {"tokens": prompts[:, :128]},
                                        cfg, 256, rules, mesh)
        for _ in range(2):
            tok = torch.argmax(lg, -1).to(torch.int32)
            _, lg, caches = steps.serve_step(params, tok[:, None], caches,
                                             cfg, rules, mesh)
        del caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with cs._allreduce_timed() as pre_ar:
            t0 = time.perf_counter()
            lg, caches = steps.prefill_step(params, {"tokens": prompts}, cfg,
                                            max_len, rules, mesh)
            torch.cuda.synchronize()
            ttft = time.perf_counter() - t0
        step_s, logits = [], [lg]
        with cs._allreduce_timed() as dec_ar:
            for _ in range(SERVE_NEW):
                tok = torch.argmax(lg, -1).to(torch.int32)
                t0 = time.perf_counter()
                _, lg, caches = steps.serve_step(params, tok[:, None],
                                                 caches, cfg, rules, mesh)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                logits.append(lg)
        counts = ops.launch_counts()
        out.update({
            "ttft_s": ttft, "step_s": step_s,
            "prefill_allreduce_ms": cs._ms(pre_ar),
            "prefill_allreduces": len(pre_ar),
            "decode_allreduce_ms": cs._ms(dec_ar) / SERVE_NEW,
            "decode_allreduces": len(dec_ar) / SERVE_NEW,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: counts[k] for k in ("flash_attention",
                                                "decode_attention")},
            "logits_ok": all(x.shape == (SERVE_BATCH, cfg.vocab_size)
                             and bool(torch.isfinite(x).all())
                             for x in logits)})
        del caches, logits
        # the layer gates: the blocks' inputs and outputs in a prefill
        with _blocks_captured(GATE_LAYERS) as got:
            steps.prefill_step(params, {"tokens": prompts}, cfg, max_len,
                               rules, mesh)
    axes = tf.param_axes(cfg)
    shapes = tf.param_shapes(cfg)
    gates = {}
    for i in GATE_LAYERS:
        layer = tf.layer_slice(params["layers"], i)
        specs = cs._nested({
            p[len("layers."):]: PartitionSpec(*rules.spec(shapes[p],
                                                          axes[p])[1:])
            for p in axes if p.startswith("layers.")})
        whole = weights.gather_params(layer, specs, mesh)
        if rank == 0:
            x, y = got[i]
            pos = torch.arange(x.shape[1], dtype=torch.int32,
                               device=x.device)[None, :]
            with torch.no_grad():
                want = tf._block_fwd(whole, x, pos, cfg, "prefill", None)[0]
            gates[i + 1] = cs.compare(f"llama3_70b layer {i + 1}", y, want,
                                      of_max=True)
        del whole
    out["gates"] = gates
    dist.barrier()
    if rank == 0:
        with open(Path(out_dir) / "serve.json", "w") as f:
            json.dump(out, f)
    with open(Path(out_dir) / f"serve_rank{rank}.json", "w") as f:
        json.dump({"peak_gib": out["peak_gib"],
                   "weights_gib": out["weights_gib"],
                   "device": out["device"], "launches": out["launches"]}, f)


def _out_dir(name):
    d = ROOT / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def train(card):
    from repro_torch.launch import mesh
    for shape in MESHES:
        t0 = time.monotonic()
        out_dir = _out_dir("dist_cards")
        mesh.spawn(cs._dist_rank, 4, (str(out_dir), shape))
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                 for r in range(4)]
        if sorted(r["device"] for r in ranks) != [0, 1, 2, 3]:
            raise AssertionError(f"ranks' cards {[r['device'] for r in ranks]}")
        cs.dist_report(f"cards {shape}", card, shape, ranks,
                       f"4 ranks, one a card, over {ranks[0]['backend']}")
        cs.log(f"[cards] mesh {shape}: {time.monotonic() - t0:.1f} s")


def serve(card):
    from repro_torch.launch import mesh
    t0 = time.monotonic()
    out_dir = _out_dir("dist_cards_serve")
    mesh.spawn(cs._dist_serve_rank, 4, (str(out_dir), CHECK_RUNS))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(4)]
    cs.dist_serve_report("cards serve", card, ranks,
                         f"4 ranks, one a card, over {ranks[0]['backend']}",
                         CHECK_RUNS)
    cs.log(f"[cards] serve at 16 layers: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    out_dir = _out_dir("dist_cards_serve")
    mesh.spawn(_serve_rank, 4, (str(out_dir),))
    r = json.loads((out_dir / "serve.json").read_text())
    per = [json.loads((out_dir / f"serve_rank{i}.json").read_text())
           for i in range(4)]
    if sorted(x["device"] for x in per) != [0, 1, 2, 3]:
        raise AssertionError(f"ranks' cards {[x['device'] for x in per]}")
    layers = SERVE_LAYERS
    want = {"flash_attention": layers,
            "decode_attention": layers * SERVE_NEW}
    if any(x["launches"] != want for x in per) or not r["logits_ok"] \
            or sorted(int(k) for k in r["gates"]) != [i + 1 for i in
                                                     GATE_LAYERS]:
        raise AssertionError(f"serve: launches {[x['launches'] for x in per]}"
                             f" (want {want}), logits ok {r['logits_ok']}, "
                             f"gates {r['gates']}")
    steps_ms = np.array(r["step_s"]) * 1e3
    cs.log(
        f"[cards] llama3_70b whole ({layers} layers, full width, bf16, mesh "
        f"(data, model) = {SERVE_MESH}, 4 ranks, one a card, over "
        f"{r['backend']}): prefill {SERVE_BATCH} x {SERVE_PROMPT} then "
        f"{SERVE_NEW} serve_steps; TTFT {r['ttft_s']:.4f} s; TPOT mean "
        f"{steps_ms.mean():.3f} ms, median {np.median(steps_ms):.3f}, min "
        f"{steps_ms.min():.3f}, max {steps_ms.max():.3f}; all-reduce "
        f"{r['prefill_allreduce_ms']:.2f} ms of the prefill "
        f"({r['prefill_allreduces']} calls), {r['decode_allreduce_ms']:.3f} "
        f"ms a step ({r['decode_allreduces']:.0f} calls); weights GiB a card "
        + " ".join(f"{x['weights_gib']:.2f}" for x in per)
        + "; peak GiB a card " + " ".join(f"{x['peak_gib']:.2f}"
                                          for x in per)
        + f"; launches a rank {want}; weights made in {r['build_s']:.1f} s "
        f"on rank 0; layers "
        + ", ".join(f"{k}: max_abs_err={e:.3g} max_row_rel_err={row:.3g}"
                    for k, (e, row) in r["gates"].items())
        + f" against the unsharded block on card 0 (atol {cs.ATOL} of max, "
        f"rtol {cs.RTOL}, row {cs.ROW_RTOL}); {card}")
    cs.log(f"[cards] serve whole: {time.monotonic() - t0:.1f} s")


LONG_MESH = (2, 2)
LONG_S = 524_296                 # JAX's long_500k seq_len + 8
LONG_FILLED = 524_224            # LONG_STEPS steps end at 524,288
LONG_STEPS = 64
LONG_SCALE_PROMPT = 1024         # the prefill whose rms seeds the cache
LONG_BLOCK = 65_537              # positions a seeded K/V block (S / 8)
# the depths run: one shared-block application (14 layers), where the
# logits are gated against one process's at LOGIT_TOL, then whole (81)
LONG_RUNS = (14, 81)


def _gate_layers(n: int):
    """The Mamba2 layers held against the unsharded layer: the first, the
    middle and the last (1, 40 and 81 of 81)."""
    return tuple(sorted({0, max(0, round(n / 2) - 1), n - 1}))


def _cache_rms(caches):
    """{leaf: [rms of each layer or application]} of a prefill's K/V and
    Mamba2 states: sums of squares and counts summed over every rank (a
    replicated entry counts once a rank holding it)."""
    import torch.distributed as dist
    out = {}
    for g, leaves in caches.items():
        for k, v in leaves.items():
            if k == "length":
                continue
            x = v.float().flatten(1)
            t = torch.stack([x.square().sum(1),
                             torch.full((x.shape[0],), float(x.shape[1]),
                                        device=x.device)])
            dist.all_reduce(t)
            out[f"{g}.{k}"] = (t[0] / t[1]).sqrt().tolist()
    return out


def _fill_long(caches, cfg, rms, specs, mesh):
    """Seed the long cache in place: each application's K/V in blocks of
    LONG_BLOCK positions, block j of leaf k of application g drawn whole
    (every kv head) from a generator seeded by (k, g, j) at ``rms[k][g]``,
    and each Mamba2 layer's conv window and SSM state whole at its rms;
    with ``specs`` (the port's cache layout) a rank draws only the blocks
    its positions hold and keeps its shards, without (one process) every
    block. Lengths LONG_FILLED."""
    from repro_torch import distributed as D
    from repro_torch import weights
    from repro_torch.models.sharding import PartitionSpec

    def seeded(shape, sd, key, dtype):
        gen = torch.Generator(device="cuda").manual_seed(cs._seed_of(*key))
        return (torch.randn(shape, generator=gen, device="cuda")
                * sd).to(dtype)
    attn = caches["attn"]
    n_loc = attn["k"].shape[2]
    lo = 0
    if specs is not None:
        lo = D.axis(mesh, ("pod", "data")).index * n_loc
    for k in ("k", "v"):
        leaf = attn[k]
        for g in range(leaf.shape[0]):
            for j in range(LONG_S // LONG_BLOCK):
                a, b = j * LONG_BLOCK, (j + 1) * LONG_BLOCK
                if b <= lo or a >= lo + n_loc:
                    continue
                block = seeded((1, LONG_BLOCK, cfg.num_kv_heads,
                                cfg.resolved_head_dim), rms[f"attn.{k}"][g],
                               ("long", k, g, j), leaf.dtype)
                if specs is not None:
                    e = specs["attn"][k]
                    block = weights.shard_params(
                        block, PartitionSpec(None, None, e[3], None), mesh)
                leaf[g, :, a - lo:b - lo] = block
    attn["length"].fill_(LONG_FILLED)
    for k, leaf in caches["mamba"].items():
        for i in range(leaf.shape[0]):
            whole = seeded(leaf.shape[1:] if specs is None else
                           _whole_shape(cfg, k), rms[f"mamba.{k}"][i],
                           ("long", "mamba", k, i), leaf.dtype)
            if specs is not None:
                whole = weights.shard_params(
                    whole, PartitionSpec(*specs["mamba"][k][1:]), mesh)
            leaf[i] = whole


def _whole_shape(cfg, leaf):
    from repro_torch.models import mamba2 as m2
    return m2.mamba2_state_spec(cfg, 1)[leaf][0]


def _long_rank(rank, world, out_dir, layers):
    """One rank of ``long`` at ``layers`` of zamba2_7b (see the module
    docstring); rank 0 then runs the one process on card 0 and writes
    ``long{layers}.json``."""
    import gc
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding, steps
    from repro_torch.models import transformer as tf
    mesh = compat_make_mesh(LONG_MESH, ("data", "model"))
    rules = sharding.ShardingRules(mesh, seq_sharded=True)
    cfg = get_config("zamba2_7b").replace(num_layers=layers)
    t0 = time.perf_counter()
    params = cs.seeded_params(cfg, cs.DIST_SEED, rules, mesh)
    torch.cuda.synchronize()
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device(),
           "build_s": time.perf_counter() - t0,
           "weights_bytes": sum(v.numel() * v.element_size()
                                for v in cs._leaves(params))}
    with torch.no_grad():
        _, small = steps.prefill_step(
            params, {"tokens": cs._serve_prompts(cfg, 1, LONG_SCALE_PROMPT)},
            cfg, LONG_SCALE_PROMPT, rules, mesh)
        rms = _cache_rms(small)
        del small
        cspecs = tf.cache_specs(cfg, rules, 1, LONG_S)
        caches = tf.init_cache(cfg, 1, LONG_S, "cuda", rules, mesh)
        _fill_long(caches, cfg, rms, cspecs, mesh)
    out["rms"] = rms
    out["kv_bytes"] = sum(caches["attn"][k].numel() * 2 for k in ("k", "v"))
    out["state_bytes"] = sum(v.numel() * v.element_size()
                             for v in caches["mamba"].values())
    saved = {k: v.clone() for k, v in caches["mamba"].items()}

    def restore():
        for k, v in saved.items():
            caches["mamba"][k].copy_(v)
        caches["attn"]["length"].fill_(LONG_FILLED)
    tok0 = torch.tensor([cs._seed_of("long token") % cfg.vocab_size],
                        dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for _ in range(2):                      # warm-up
            steps.serve_step(params, tok0[:, None], caches, cfg, rules, mesh)
        restore()
        gates = _long_gate_step(params, caches, cfg, rules, mesh, tok0)
        restore()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        tok, fed, logits, step_s = tok0, [], [], []
        with cs._allreduce_timed() as ar:
            for _ in range(LONG_STEPS):
                fed.append(tok)
                t0 = time.perf_counter()
                tok, lg, caches = steps.serve_step(params, tok[:, None],
                                                   caches, cfg, rules, mesh)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                logits.append(lg.float().cpu())
        counts = ops.launch_counts()
    out.update({
        "step_s": step_s, "allreduce_ms": cs._ms(ar) / LONG_STEPS,
        "allreduces": len(ar) / LONG_STEPS,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": {k: counts[k] for k in ("flash_attention",
                                            "decode_attention")},
        "lengths": caches["attn"]["length"].flatten().tolist()})
    out["mamba_gates"] = _mamba_gates(rank, gates.pop("mamba"), cfg, rules,
                                      cspecs, mesh)
    out["attn_gates"] = gates["attn"]
    del params, caches, saved, gates
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        out["one"] = _long_one_process(cfg, rms, fed, logits)
        with open(Path(out_dir) / f"long{layers}.json", "w") as f:
            json.dump(out, f)
    dist.barrier()
    with open(Path(out_dir) / f"long{layers}_rank{rank}.json", "w") as f:
        json.dump({k: out[k] for k in ("device", "peak_gib", "launches",
                                       "weights_bytes", "kv_bytes",
                                       "state_bytes", "attn_gates",
                                       "lengths")}, f)


def _mamba_gates(rank, captured, cfg, rules, cspecs, mesh):
    """Each captured Mamba2 layer's weights and state before the step
    gathered whole, and on rank 0 the unsharded layer on the same input
    against the sharded output (``compare``, the elementwise bound of the
    largest entry): {layer (from 1): (max abs error, max row error)}."""
    from repro_torch import weights
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import PartitionSpec
    pspecs = tf.param_specs(cfg, rules)
    out = {}
    for i, (p, x, state, y) in sorted(captured.items()):
        p = weights.gather_params(p, {k: PartitionSpec(
            *pspecs[f"mamba.{k}"][1:]) for k in p}, mesh)
        state = weights.gather_params(state, {k: PartitionSpec(
            *cspecs["mamba"][k][1:]) for k in state}, mesh)
        if rank == 0:
            with torch.no_grad():
                want, _ = m2.mamba2_decode(p, x, cfg, state)
            out[i + 1] = cs.compare(f"zamba2_7b Mamba2 layer {i + 1}", y,
                                    want, of_max=True)
    return out


def _long_gate_step(params, caches, cfg, rules, mesh, tok):
    """One ``serve_step`` with its gates captured: each application's
    merged decode attention against the ``decode_attention`` kernel over
    the K/V gathered whole from the data ranks (the rank's heads, in this
    one process; ``compare``), and the input, state before and output of
    the Mamba2 layers ``_gate_layers``. Returns {"attn": [(max abs error, max
    row error)], "mamba": {layer: (params, x, state, y)}}."""
    from repro_torch import distributed as D
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import attention as attn
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import steps
    merge, decode = attn.seq_decode_attention, m2.mamba2_decode
    got = {"attn": [], "mamba": {}}
    calls = [0]

    def held_merge(q, k_cache, v_cache, lengths, scale, ax):
        out = merge(q, k_cache, v_cache, lengths, scale, ax)
        k_all = D.gather(k_cache, 1, ax)
        v_all = D.gather(v_cache, 1, ax)
        total = D.all_reduce(lengths.clone(), ax)
        want = da.decode_attention(q, k_all, v_all, total, scale=scale)
        got["attn"].append(cs.compare(
            f"zamba2_7b merged decode attention {len(got['attn'])}", out,
            want))
        del k_all, v_all
        return out

    def held_mamba(p, x, cfg_, state, tp=None):
        i = calls[0]
        calls[0] += 1
        before = ({k: v.clone() for k, v in state.items()}
                  if i in _gate_layers(cfg.num_layers) else None)
        y, st = decode(p, x, cfg_, state, tp=tp)
        if before is not None:
            got["mamba"][i] = (p, x.clone(), before, y.clone())
        return y, st
    attn.seq_decode_attention, m2.mamba2_decode = held_merge, held_mamba
    try:
        steps.serve_step(params, tok[:, None], caches, cfg, rules, mesh)
    finally:
        attn.seq_decode_attention, m2.mamba2_decode = merge, decode
    return got


def _halves_mm(a, w):
    """``a @ w`` as two ranks of "model" sum it: each half of the
    contracted dim's fp32 product, summed in fp32 and rounded once
    (``Layout.row_parallel``'s arithmetic, in one process)."""
    from repro_torch.models.layers import mm_fp32
    n = a.shape[-1] // 2
    return (mm_fp32(a[..., :n].contiguous(), w[:n])
            + mm_fp32(a[..., n:].contiguous(), w[n:])).to(a.dtype)


@contextlib.contextmanager
def _sums_in_halves():
    """While open, the one process sums where the (2, 2) ranks split a sum,
    in their order: each row-parallel product (Mamba2's ``out_proj``, the
    shared block's ``wo`` and MLP ``wo``) as two halves (``_halves_mm``),
    and dense decode attention over the cache's two halves, each with its
    lse, merged (``attention.merge_stacked``). A rounding-level change at
    the places the sharded step rounds differently, which shows how far this
    model at this depth carries such a change to its logits."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import layers
    from repro_torch.models import mamba2 as m2
    saved = (ops.decode_attention, m2._out, layers._mlp, attn._proj_out)

    def halves(q, k, v, lengths, *, scale=None, return_lse=False):
        n = k.shape[1] // 2
        outs, lses = [], []
        for lo, hi in ((0, n), (n, k.shape[1])):
            o, lse = saved[0](q, k[:, lo:hi], v[:, lo:hi],
                              torch.clamp(lengths - lo, 0, hi - lo).to(
                                  torch.int32), scale=scale, return_lse=True)
            outs.append(o)
            lses.append(lse)
        return attn.merge_stacked(outs, lses)

    def out(params, y, z, x, cfg, tp=None):
        y = y.reshape(*x.shape[:2], m2._dims(cfg)[0]).to(x.dtype)
        y = layers.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
        return _halves_mm(y, params["out_proj"])

    def mlp(params, x, cfg):
        return _halves_mm(layers._mlp_hidden(params, x, cfg), params["wo"])

    def proj_out(o, w):
        return _halves_mm(o.flatten(-2), w.reshape(-1, w.shape[-1]))
    ops.decode_attention, m2._out, layers._mlp, attn._proj_out = (
        halves, out, mlp, proj_out)
    try:
        yield
    finally:
        (ops.decode_attention, m2._out, layers._mlp,
         attn._proj_out) = saved


def _long_one_process(cfg, rms, fed, logits):
    """The same steps in one process on card 0: the whole seeded weights
    and the whole seeded cache (every block, every kv head), a warm-up,
    then LONG_STEPS steps fed the ranks' tokens, timed; the logits
    against the ranks' (``chip_smoke._logit_agreement``). Then the same
    steps again from the same cache with its sums split where the ranks
    split them (``_sums_in_halves``): how far a rounding-level change
    moves this model's logits at this depth (``own``: each step's share
    of max |logit|). Where it does not fit the card, the reason and the
    peak instead."""
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    torch.cuda.reset_peak_memory_stats()
    one = {}
    try:
        params = cs.seeded_params(cfg, cs.DIST_SEED)
        caches = tf.init_cache(cfg, 1, LONG_S, "cuda")
        with torch.no_grad():
            _fill_long(caches, cfg, rms, None, None)
    except torch.cuda.OutOfMemoryError as e:
        return {"fits": False, "why": str(e).splitlines()[0],
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    one["weights_bytes"] = sum(v.numel() * v.element_size()
                               for v in cs._leaves(params))
    one["kv_bytes"] = sum(caches["attn"][k].numel() * 2 for k in ("k", "v"))
    one["state_bytes"] = sum(v.numel() * v.element_size()
                             for v in caches["mamba"].values())
    saved = {k: v.clone() for k, v in caches["mamba"].items()}

    def restore():
        for k, v in saved.items():
            caches["mamba"][k].copy_(v)
        caches["attn"]["length"].fill_(LONG_FILLED)

    def run():
        mine, secs = [], []
        for tok in fed:
            t0 = time.perf_counter()
            _, lg, _ = steps.serve_step(params, tok[:, None], caches, cfg)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            mine.append(lg.float().cpu())
        restore()
        return mine, secs
    with torch.no_grad():
        for _ in range(2):
            steps.serve_step(params, fed[0][:, None], caches, cfg)
        restore()
        mine, secs = run()
        with _sums_in_halves():
            halves, _ = run()
    one.update(cs._logit_agreement(logits, mine, fed[1:]))
    one["own"] = [float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(halves, mine)]
    one.update(fits=True, step_s=secs,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, caches, saved
    torch.cuda.empty_cache()
    return one


def long(card):
    for layers in LONG_RUNS:
        _long_run(card, layers)


def _long_run(card, layers):
    """``_long_rank`` at ``layers`` on the four cards, its gates and its
    lines."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    from repro_torch.models import transformer as tf
    t0 = time.monotonic()
    out_dir = _out_dir("dist_cards_long")
    mesh.spawn(_long_rank, 4, (str(out_dir), layers))
    r = json.loads((out_dir / f"long{layers}.json").read_text())
    per = [json.loads((out_dir / f"long{layers}_rank{i}.json").read_text())
           for i in range(4)]
    if sorted(x["device"] for x in per) != [0, 1, 2, 3]:
        raise AssertionError(f"ranks' cards {[x['device'] for x in per]}")
    cfg = get_config("zamba2_7b").replace(num_layers=layers)
    apps = tf._n_apps(cfg)
    whole = layers == get_config("zamba2_7b").num_layers
    want = {"flash_attention": 0, "decode_attention": apps * LONG_STEPS}
    one = r["one"]
    if any(x["launches"] != want for x in per) or \
            any(len(x["attn_gates"]) != apps for x in per) or \
            sorted(int(k) for k in r["mamba_gates"]) != [
                i + 1 for i in _gate_layers(layers)] or \
            any(x["lengths"] != [LONG_FILLED + LONG_STEPS] * apps
                for x in per) or not one.get("fits"):
        raise AssertionError(
            f"long: launches {[x['launches'] for x in per]} (want {want}), "
            f"attention gates {[len(x['attn_gates']) for x in per]}, Mamba2 "
            f"gates {sorted(r['mamba_gates'])}, lengths "
            f"{[x['lengths'] for x in per]}, one process {one}")
    steps_ms = np.array(r["step_s"]) * 1e3
    one_ms = np.array(one["step_s"]) * 1e3
    gb = lambda x: (x["weights_bytes"] + x["kv_bytes"]  # noqa: E731
                    + x["state_bytes"])
    card_bound = max(gb(x) for x in per) / cs.PEAK_BYTES_PER_S * 1e3
    one_bound = gb(one) / cs.PEAK_BYTES_PER_S * 1e3
    attn_err = max(max(e for e, _ in x["attn_gates"]) for x in per)
    attn_row = max(max(rw for _, rw in x["attn_gates"]) for x in per)
    what = (f"whole ({layers} layers" if whole else
            f"at {layers} of 81 layers")
    # the logits gate: LOGIT_TOL at the first depth; whole, where the one
    # process's own logits move by more with its sums split where the
    # ranks split them (rounding compounds through 81 layers), twice that
    tol = (max(cs.LOGIT_TOL, 2 * max(one["own"])) if whole
           else cs.LOGIT_TOL)
    cs.log(
        f"[cards] long_500k: zamba2_7b {what}, {apps} shared-block "
        f"application(s), full width, bf16), mesh (data, model) = "
        f"{LONG_MESH} under seq_sharded, 4 ranks, one a card, over "
        f"{r['backend']}: batch 1, a {LONG_S}-position cache seeded to "
        f"{LONG_FILLED} at a {LONG_SCALE_PROMPT}-token prefill's rms, "
        f"{LONG_STEPS} serve_steps to {LONG_FILLED + LONG_STEPS}; TPOT mean "
        f"{steps_ms.mean():.3f} ms, median {np.median(steps_ms):.3f}, min "
        f"{steps_ms.min():.3f}, max {steps_ms.max():.3f}; byte bound a card "
        f"{card_bound:.3f} ms (weights {per[0]['weights_bytes'] / 1e9:.2f} "
        f"GB + K/V {per[0]['kv_bytes'] / 1e9:.2f} GB + states "
        f"{per[0]['state_bytes'] / 1e9:.3f} GB on a card, at "
        f"{cs.PEAK_BYTES_PER_S / 1e12:.2f} TB/s), TPOT / bound "
        f"{steps_ms.mean() / card_bound:.2f}; all-reduce "
        f"{r['allreduce_ms']:.3f} ms a step ({r['allreduces']:.0f} calls); "
        f"peak GiB a card " + " ".join(f"{x['peak_gib']:.2f}" for x in per)
        + f"; launches a rank {want}; weights made in {r['build_s']:.1f} s "
        f"on rank 0; gates: merged decode attention of each application vs "
        f"the kernel over the gathered cache max_abs_err={attn_err:.3g} "
        f"max_row_rel_err={attn_row:.3g} (atol {cs.ATOL}, rtol {cs.RTOL}, "
        f"row {cs.ROW_RTOL}); Mamba2 layers "
        + ", ".join(f"{k}: max_abs_err={e:.3g} max_row_rel_err={rw:.3g}"
                    for k, (e, rw) in r["mamba_gates"].items())
        + f" vs the unsharded layer (atol {cs.ATOL} of max); logits vs one "
        f"process over {LONG_STEPS} steps: largest share of max |logit| "
        f"{max(one['share']):.4g} (limit {tol:.4g}"
        + (f": twice the one process's own largest move, past "
           f"{cs.LOGIT_TOL} at this depth" if tol > cs.LOGIT_TOL else "")
        + ")"
        + ", by step " + " ".join(f"{x:.3f}" for x in one["share"])
        + "; the one process's own move with its sums split where the "
        "ranks split them, by step " + " ".join(
            f"{x:.3f}" for x in one["own"])
        + f"; first tokens {one['first_sure_equal']} of "
        f"{one['first_sure']} sure rows equal; stream tokens equal "
        f"{one['stream_equal']}/{one['stream_tokens']}; {card}")
    cs.log(
        f"[cards] long_500k on one card (card 0, one process, {layers} "
        f"layers, the whole weights {one['weights_bytes'] / 1e9:.2f} GB "
        f"and K/V {one['kv_bytes'] / 1e9:.2f} GB): TPOT mean "
        f"{one_ms.mean():.3f} ms, median {np.median(one_ms):.3f}, min "
        f"{one_ms.min():.3f}, max {one_ms.max():.3f}; its byte bound "
        f"{one_bound:.3f} ms, TPOT / bound {one_ms.mean() / one_bound:.2f}; "
        f"peak {one['peak_gib']:.2f} GiB; four cards' TPOT / one card's "
        f"{steps_ms.mean() / one_ms.mean():.3f}; {card}")
    cs.log(f"[cards] long at {layers} layers: {time.monotonic() - t0:.1f} s")
    if not one["finite"] or one["first_sure_equal"] != one["first_sure"] \
            or max(one["share"]) > tol:
        raise AssertionError(
            f"long at {layers} layers: logits off one process by "
            f"{max(one['share'])} of max |logit| (limit {tol}), first "
            f"tokens {one['first_sure_equal']} of {one['first_sure']} sure "
            f"rows equal, finite {one['finite']}")


PROBE_CALLS = 200
PROBE_LAYERS, PROBE_STEPS = 16, 3


def _probe_rank(rank, world, out_dir):
    """Where a sharded decode step's all-reduce time goes: PROBE_CALLS
    back-to-back all-reduces over "model" on (1, 4) at the decode and the
    prefill sizes of llama3_70b (device time between CUDA events over the
    run, and the host's time to issue them), then PROBE_STEPS decode steps
    at PROBE_LAYERS layers: the host's time to issue each and its wall
    time, on every rank; then as many under ``torch.profiler``: wall time,
    the card's kernel time (NCCL's and the rest) and the host time of the
    all-reduce calls. Each rank writes ``probe{rank}.json``."""
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding, steps
    mesh = compat_make_mesh(SERVE_MESH, ("data", "model"))
    ax = D.axis(mesh, ("model",))
    out = {}
    for name, shape, dtype in (
            ("decode fp32 (8, 1, 8192)", (8, 1, 8192), torch.float32),
            ("decode bf16 (8, 1, 8192)", (8, 1, 8192), torch.bfloat16),
            ("prefill fp32 (8, 1024, 8192)", (8, 1024, 8192),
             torch.float32)):
        x = torch.ones(shape, dtype=dtype, device="cuda")
        for _ in range(10):
            D.all_reduce(x, ax)
        torch.cuda.synchronize()
        dist.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(PROBE_CALLS):
            D.all_reduce(x, ax)
        b.record()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name] = {"device_us": a.elapsed_time(b) * 1e3 / PROBE_CALLS,
                     "host_us": host * 1e6 / PROBE_CALLS}
    rules = sharding.ShardingRules(mesh)
    cfg = cs._serve_cfg("llama3_70b", PROBE_LAYERS)
    params = cs.seeded_params(cfg, cs.DIST_SEED, rules, mesh)
    prompts = cs._serve_prompts(cfg, SERVE_BATCH, 512)
    with torch.no_grad():
        lg, caches = steps.prefill_step(params, {"tokens": prompts}, cfg,
                                        512 + 8, rules, mesh)

        def step():
            nonlocal lg, caches
            tok = torch.argmax(lg, -1).to(torch.int32)
            _, lg, caches = steps.serve_step(params, tok[:, None], caches,
                                             cfg, rules, mesh)
        for _ in range(2):
            step()
        # the host's time to issue a step (no sync inside it) against the
        # step's wall time: equal where the host paces the card
        issue, wall = [], []
        for _ in range(PROBE_STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            step()
            issue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        dist.barrier()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            for _ in range(PROBE_STEPS):
                step()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    kernels = {"nccl": 0.0, "other": 0.0}
    calls = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # kernels and copies on the card, each counted once
            kernels["nccl" if "nccl" in e.key.lower() else "other"] += \
                e.self_device_time_total
        elif e.key == "c10d::allreduce_":
            calls[e.key] = {"count": e.count, "cpu_us": e.cpu_time_total}
    out["profile"] = {"wall_ms": prof_wall * 1e3 / PROBE_STEPS,
                      "kernel_ms": {k: v / 1e3 / PROBE_STEPS
                                    for k, v in kernels.items()},
                      "allreduce_calls": calls,
                      "issue_ms": [t * 1e3 for t in issue],
                      "step_ms": [t * 1e3 for t in wall]}
    with open(Path(out_dir) / f"probe{rank}.json", "w") as f:
        json.dump(out, f)


def probe(card):
    from repro_torch.launch import mesh
    out_dir = _out_dir("dist_cards_probe")
    mesh.spawn(_probe_rank, 4, (str(out_dir),))
    ranks = [json.loads((out_dir / f"probe{i}.json").read_text())
             for i in range(4)]
    r = ranks[0]
    for name, v in r.items():
        if name != "profile":
            cs.log(f"[cards probe] all-reduce over 'model' (1, 4), {name}: "
                   f"{v['device_us']:.1f} us of device time and "
                   f"{v['host_us']:.1f} us of host time a call "
                   f"({PROBE_CALLS} back to back); {card}")
    p = r["profile"]
    cs.log(f"[cards probe] llama3_70b {PROBE_LAYERS} layers, a decode step "
           f"on (1, 4) under torch.profiler (rank 0): wall "
           f"{p['wall_ms']:.2f} ms, kernels nccl "
           f"{p['kernel_ms']['nccl']:.2f} ms, other "
           f"{p['kernel_ms']['other']:.2f} ms; all-reduce ops "
           + "; ".join(f"{k}: {v['count'] / PROBE_STEPS:.0f} a step, "
                       f"{v['cpu_us'] / max(1, v['count']):.1f} us host each"
                       for k, v in p["allreduce_calls"].items())
           + "; unprofiled, the host's time to issue a step / the step's "
           "wall ms, by rank: " + "; ".join(
               " ".join(f"{a:.2f}/{b:.2f}" for a, b in zip(
                   x["profile"]["issue_ms"], x["profile"]["step_ms"]))
               for x in ranks)
           + f"; {card}")


CHECK_TRAIN_RUNS = (("zamba2_7b", 14, (2, 2), False, 4, 1024),
                    ("internlm2_20b", 8, (2, 2), True, 4, 1024))
WHOLE_TRAIN_RUNS = (("zamba2_7b", 81, (2, 2), False, 4, 1024),
                    ("internlm2_20b", 48, (2, 2), True, 4, 1024))
TRAIN_WHOLE_STEPS = 6


def _train_ranks(runs, n_steps, gates):
    from repro_torch.launch import mesh
    out_dir = _out_dir("dist_cards_train")
    mesh.spawn(cs._dist_train_rank, 4, (str(out_dir), runs, n_steps, gates))
    ranks = [json.loads((out_dir / f"train_rank{r}.json").read_text())
             for r in range(4)]
    if sorted(r["device"] for r in ranks) != [0, 1, 2, 3]:
        raise AssertionError(f"ranks' cards {[r['device'] for r in ranks]}")
    return ranks


def train_whole(card):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    t0 = time.monotonic()
    ranks = _train_ranks(CHECK_TRAIN_RUNS, cs.DIST_STEPS, False)
    cs.dist_train_report("cards train_whole check", card, ranks,
                         f"4 ranks, one a card, over {ranks[0]['backend']}",
                         CHECK_TRAIN_RUNS)
    cs.log(f"[cards] train_whole check: {time.monotonic() - t0:.1f} s")
    for run in WHOLE_TRAIN_RUNS:
        t0 = time.monotonic()
        arch, layers, shape, fsdp, b, s = run
        ranks = _train_ranks((run,), TRAIN_WHOLE_STEPS, True)
        per = [r[cs._train_tag(*run[:4])] for r in ranks]
        cfg = get_config(arch).replace(num_layers=layers)
        n = sum(int(np.prod(v)) for v in tf.param_shapes(cfg).values())
        step_s = float(np.median([x for r in per for x in r["secs"][1:]]))
        flops = cs._train_flops(cfg, b, s)
        tflops = flops / step_s / 1e12 / 4
        ar = float(np.median([x for r in per for x in r["allreduce_ms"][1:]]))
        cs.log(
            f"[cards] {arch} whole ({layers} layers, {n / 1e9:.3f}B "
            f"parameters, full width, bf16, remat {cfg.remat}, mesh (data, "
            f"model) = {shape}{', fsdp=True' if fsdp else ''}, 4 ranks, one "
            f"a card, over {ranks[0]['backend']}, {TRAIN_WHOLE_STEPS} steps "
            f"of {b} x {s}): step s {step_s:.4f} (median of steps 2-"
            f"{TRAIN_WHOLE_STEPS} over the ranks); tokens/s "
            f"{b * s / step_s:.1f}; TFLOP/s a card {tflops:.1f} (share of "
            f"989: {tflops / 989:.3f}); all-reduce ms a step {ar:.1f} "
            f"(median; calls {per[0]['allreduces'][1]}); peak GiB a card "
            + " ".join(f"{r['peak_gib']:.2f}" for r in per)
            + "; train state (params, m, v) GB a card "
            + " ".join(f"{r['state_bytes'] / 1e9:.2f}" for r in per)
            + ", with a bf16 gradient " + " ".join(
                f"{(r['state_bytes'] + 2 * r['local_params']) / 1e9:.2f}"
                for r in per)
            + f" (one card would need {12 * n / 1e9:.1f} GB at 12 B a "
            f"parameter)")
        cs.dist_train_report(f"cards {arch} whole", card, ranks,
                             f"4 ranks, one a card, over "
                             f"{ranks[0]['backend']}", (run,),
                             TRAIN_WHOLE_STEPS, one_process=False)
        cs.log(f"[cards] {arch} whole: {time.monotonic() - t0:.1f} s")


# v2, long_mla, dispatch, fsdp: those layouts over four cards, (2, 2),
# one NCCL rank a card. A run: (name, arch, layers, flags, batch, cache
# positions, positions seeded (0: a real prefill of ``prompt`` tokens
# instead), prompt, steps, seeding block, compared with one process)
LAYOUT_GATES = 3                 # layers held against the unsharded block
V2 = ("gemma_2b", ("shard_v2",), 128, 32_768, 32_736, 1024, 32, 4_096)
LONG_MLA = ("deepseek_v2_lite_16b", ("seq_sharded",), 1, 524_288, 524_224,
            1024, 64, 65_536)
LAYOUT_RUNS = {
    # JAX's decode_32k cell (batch 128, 32,768 positions): gemma_2b's one
    # kv head leaves "model" to cache_seq, so each model rank holds half
    # the positions of its data rank's 64 rows
    "v2": (("v2", V2[0], 4, *V2[1:], True),
           ("v2", V2[0], 18, *V2[1:], False)),
    # JAX's long_500k cell on an MLA arch (naive): the latent cache's
    # positions over the data ranks, the batch of 1 whole on each
    "long_mla": (("long_mla", LONG_MLA[0], 4, *LONG_MLA[1:], True),
                 ("long_mla", LONG_MLA[0], 27, *LONG_MLA[1:], False)),
    # v2-lite whole with the dispatch einsum (experts over "model"): a real
    # prefill of 8 x 1024 (two groups of 4096, one a data rank), 32 steps
    "dispatch": (("dispatch", "deepseek_v2_lite_16b", 27, ("dispatch",), 8,
                  1056, 0, 1024, 32, 0, False),),
    # FSDP in serving: gemma_2b whole, 8 x 1024 then 32 steps, without and
    # with fsdp=True (each layer's weights gathered over the data ranks in
    # every pass): the difference is what the gathers cost a step
    "fsdp": (("fsdp", "gemma_2b", 18, (), 8, 1056, 0, 1024, 32, 0, False),
             ("fsdp", "gemma_2b", 18, ("fsdp",), 8, 1056, 0, 1024, 32, 0,
              False)),
}
# the dispatch einsum first at a depth one card holds, against one process
# (phase dist_serve's gates): 8 x 512 prompts, one group of 4096 over both
# data ranks (the lower rank's slots counted first)
DISPATCH_CHECK = (("deepseek_v2_lite_16b", 6, (2, 2), False, ("dispatch",)),)


def _seed_cache(caches, cfg, rms, cspecs, mesh, run):
    """Seed the attention caches in place: each leaf's layer i in blocks of
    the run's block positions, block j drawn whole (every row, kv head or
    latent channel) from a generator seeded by (run, group, leaf, i, j) at
    ``rms``; with ``cspecs`` (the port's layout) a rank draws only the
    blocks its positions hold and keeps its rows and heads, without (one
    process) every block. Lengths: the positions seeded."""
    from repro_torch import distributed as D
    from repro_torch import weights
    from repro_torch.models import attention as attn
    from repro_torch.models.sharding import PartitionSpec
    name, _, _, _, batch, S, filled, _, _, block, _ = run
    whole = attn.cache_spec(cfg, batch, S)
    for g, leaves in caches.items():
        for k, leaf in leaves.items():
            if k == "length":
                continue
            spec = None if cspecs is None else cspecs[g][k]
            n_loc = leaf.shape[2]
            lo = 0
            if spec is not None and spec[2] is not None:
                lo = D.axis(mesh, D.group_of(spec[2])).index * n_loc
            for i in range(leaf.shape[0]):
                for j in range(S // block):
                    a, b = j * block, (j + 1) * block
                    if b <= lo or a >= lo + n_loc:
                        continue
                    gen = torch.Generator(device="cuda").manual_seed(
                        cs._seed_of(name, g, k, i, j))
                    blk = (torch.randn((batch, block, *whole[k][0][2:]),
                                       generator=gen, device="cuda")
                           * rms[f"{g}.{k}"][i]).to(leaf.dtype)
                    if spec is not None:
                        blk = weights.shard_params(
                            blk, PartitionSpec(spec[1], None, *spec[3:]),
                            mesh)
                    leaf[i, :, a - lo:b - lo] = blk
        leaves["length"].fill_(filled)


def _attn_layers(cfg):
    """(params key, cache key, index) of each attention block, in forward
    order."""
    from repro_torch.models import transformer as tf
    return [(pkey, ckey, i) for pkey, ckey, n in tf._groups(cfg)
            for i in range(n)]


def _layout_gates(rank, params, caches, cfg, rules, mesh, tok, which):
    """One ``serve_step`` with the blocks ``which`` (forward order)
    captured: each one's input, output, its cache before the step and its
    MoE routing; then, gathered whole, rank 0 runs the unsharded block on
    card 0 (routed as the ranks routed) against the ranks' output
    (``compare``, the elementwise bound of the largest entry). Returns
    {block (from 1): (max abs error, max row error)}."""
    from repro_torch import weights
    from repro_torch.kernels import ops
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import PartitionSpec
    layers = _attn_layers(cfg)
    pspecs = tf.param_specs(cfg, rules)
    cspecs = tf.cache_specs(cfg, rules, tok.shape[0],
                            _global_len(cfg, rules, caches))
    before = {j: {k: v[layers[j][2]].clone()
                  for k, v in caches[layers[j][1]].items()} for j in which}
    rows = None if cs._rows_whole(cfg, rules) else ("pod", "data")
    with _blocks_captured(which) as got, cs._routes_recorded() as routes:
        steps.serve_step(params, tok[:, None], caches, cfg, rules, mesh)
    moe_at = [j for j, (pkey, _, _) in enumerate(layers)
              if pkey == "layers" and cfg.family == "moe"]
    out = {}
    for j in which:
        pkey, ckey, i = layers[j]
        p = weights.gather_params(tf.layer_slice(params[pkey], i), cs._nested({
            path[len(pkey) + 1:]: PartitionSpec(*pspecs[path][1:])
            for path in pspecs if path.startswith(pkey + ".")}), mesh)
        c = weights.gather_params(before.pop(j), {
            k: PartitionSpec(*cspecs[ckey][k][1:]) for k in cspecs[ckey]},
            mesh)
        x, y = (weights.gather_params(t, (rows, None, None), mesh)
                for t in got[j])
        route = ([weights.gather_params(routes[moe_at.index(j)],
                                        (rows, None), mesh)]
                 if j in moe_at else None)
        if rank == 0:
            ctx = (cs._routed_as(route) if route
                   else contextlib.nullcontext())
            n0 = ops.launch_counts()
            with torch.no_grad(), ctx:
                want = tf._block_fwd(p, x, None, cfg, "decode", c)[0]
            # the reference's launches are not the run's
            n1 = ops.launch_counts()
            ops.add_launches({k: n1[k] - n0[k] for k in n1}, -1)
            out[j + 1] = cs.compare(f"{cfg.name} block {j + 1}", y, want,
                                    of_max=True)
        del p, c, x, y
    return out


def _global_len(cfg, rules, caches):
    """The whole cache's positions from a rank's (its positions' group)."""
    from repro_torch import distributed as D
    leaf = caches["attn"]["c_kv" if cfg.attn_type == "mla" else "k"]
    seq = D.cache_groups(cfg, rules)[1]
    n = int(np.prod([rules.axis_sizes[a] for a in seq])) if seq else 1
    return leaf.shape[2] * n


def _cache_bytes(caches):
    return sum(v.numel() * v.element_size() for g in caches.values()
               for k, v in g.items() if k != "length")


def _layout_rank(rank, world, out_dir, run):
    """One rank of a run of LAYOUT_RUNS (see ``layouts``); rank 0 writes
    ``{name}{layers}.json`` (with, where the run says, one process on card
    0 fed the ranks' tokens), every rank ``{name}{layers}_rank{r}.json``."""
    import gc
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    name, arch, layers, flags, batch, S, filled, prompt, n_steps, block, \
        one = run
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    D.axis(mesh, ("pod", "data", "model"))
    rules = cs._serve_rules(mesh, flags)
    cfg = cs._serve_cfg(arch, layers, flags=flags)
    t0 = time.perf_counter()
    params = cs.seeded_params(cfg, cs.DIST_SEED, rules, mesh)
    torch.cuda.synchronize()
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device(),
           "build_s": time.perf_counter() - t0,
           "weights_bytes": sum(v.numel() * v.element_size()
                                for v in cs._leaves(params))}
    prompts = cs._serve_prompts(cfg, batch if not filled else
                                min(batch, 8), prompt)
    with torch.no_grad():
        # warm-up: cuBLAS, NCCL and the kernels' first launches
        lg, small = steps.prefill_step(params, {"tokens": prompts[:, :128]},
                                       cfg, 256, rules, mesh)
        steps.serve_step(params, torch.argmax(lg, -1).to(torch.int32)[
            :, None], small, cfg, rules, mesh)
        del small
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with cs._allreduce_timed() as pre_ar:
            t0 = time.perf_counter()
            lg, caches = steps.prefill_step(
                params, {"tokens": prompts}, cfg, prompt if filled else S,
                rules, mesh)
            torch.cuda.synchronize()
            out["ttft_s"] = time.perf_counter() - t0
        out["prefill_allreduce_ms"] = cs._ms(pre_ar)
        out["prefill_allreduces"] = len(pre_ar)
        out["prefill_tokens"] = list(prompts.shape)
        if filled:
            # the cache seeded at the rms this prefill gives it
            rms = _cache_rms(caches)
            del caches
            caches = tf.init_cache(cfg, batch, S, "cuda", rules, mesh)
            _seed_cache(caches, cfg, rms, tf.cache_specs(
                cfg, rules, batch, S), mesh, run)
            tok = torch.tensor([cs._seed_of(name, "token", r) % cfg.vocab_size
                                for r in range(batch)], dtype=torch.int32,
                               device="cuda")
        else:
            rms = None
            tok = torch.argmax(lg, -1).to(torch.int32)
        start = filled or prompt
        out["cache_bytes"] = _cache_bytes(caches)
        gates = _layout_gates(rank, params, caches, cfg, rules, mesh, tok,
                              _gate_blocks(cfg))
        for g in caches.values():
            g["length"].fill_(start)
        fed, logits, step_s = [], [], []
        with cs._allreduce_timed() as ar, cs._routes_recorded() as routes:
            for _ in range(n_steps):
                fed.append(tok)
                t0 = time.perf_counter()
                tok, lg, caches = steps.serve_step(params, tok[:, None],
                                                   caches, cfg, rules, mesh)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                logits.append(lg.float().cpu())
        counts = ops.launch_counts()
    out["read_bytes"] = _weights_read(params, cfg, mesh, routes, n_steps,
                                      out["weights_bytes"])
    out.update({
        "step_s": step_s, "allreduce_ms": cs._ms(ar) / n_steps,
        "allreduces": len(ar) / n_steps, "gates": gates,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": {k: counts[k] for k in ("flash_attention",
                                            "decode_attention")},
        "lengths": caches["attn"]["length"].flatten().tolist()[:4],
        "finite": all(bool(torch.isfinite(x).all()) for x in logits)})
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        if one:
            out["one"] = _layout_one_process(cfg, run, rms, fed, logits)
        with open(Path(out_dir) / f"{name}{layers}.json", "w") as f:
            json.dump(out, f)
    dist.barrier()
    with open(Path(out_dir) / f"{name}{layers}_rank{rank}.json", "w") as f:
        json.dump({k: out[k] for k in ("device", "peak_gib", "launches",
                                       "weights_bytes", "read_bytes",
                                       "cache_bytes", "lengths")}, f)


def _weights_read(params, cfg, mesh, routes, n_steps, weights_bytes):
    """The weight bytes a decode step reads on a card: every local weight,
    but for the ragged MoE path only the local experts that the step's
    rows route to (``routes``: each MoE layer's expert choices of the
    rank's rows in the timed steps); the dispatch einsum reads every local
    expert."""
    from repro_torch import distributed as D
    if cfg.family != "moe" or cfg.moe.impl == "dispatch_einsum":
        return weights_bytes
    wi, wo = params["layers"]["moe"]["wi"], params["layers"]["moe"]["wo"]
    n_loc = wi.shape[1]
    lo = D.axis(mesh, ("model",)).index * n_loc
    per_expert = (wi[0, 0].numel() * wi.element_size()
                  + wo[0, 0].numel() * wo.element_size())
    hit = sum(int(torch.unique(idx[(idx >= lo) & (idx < lo + n_loc)])
                  .numel()) for idx in routes)
    return (weights_bytes - per_expert * n_loc * wi.shape[0]
            + per_expert * hit / n_steps)


def _gate_blocks(cfg):
    """The attention blocks held against the unsharded block: the first,
    one in the middle and the last, LAYOUT_GATES of them at most."""
    n = cfg.num_layers
    return tuple(sorted({0, n // 2, n - 1}))[:LAYOUT_GATES]


def _layout_one_process(cfg, run, rms, fed, logits):
    """The same steps in one process on card 0: the whole seeded weights,
    the whole cache seeded alike, the ranks' tokens fed; the logits
    against the ranks' (``chip_smoke._logit_agreement``), the steps
    timed."""
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    _, _, _, _, batch, S, filled, _, _, _, _ = run
    torch.cuda.reset_peak_memory_stats()
    params = cs.seeded_params(cfg, cs.DIST_SEED)
    caches = tf.init_cache(cfg, batch, S, "cuda")
    with torch.no_grad():
        _seed_cache(caches, cfg, rms, None, None, run)
        mine, secs = [], []
        for tok in fed:
            t0 = time.perf_counter()
            _, lg, _ = steps.serve_step(params, tok[:, None], caches, cfg)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            mine.append(lg.float().cpu())
    one = cs._logit_agreement(logits, mine, fed[1:])
    one.update(step_s=secs, cache_bytes=_cache_bytes(caches),
               weights_bytes=sum(v.numel() * v.element_size()
                                 for v in cs._leaves(params)),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del params, caches
    torch.cuda.empty_cache()
    return one


def layouts(card, names=("v2", "long_mla", "dispatch", "fsdp")):
    """The runs of LAYOUT_RUNS named, each at its depths (the dispatch
    einsum first at DISPATCH_CHECK's depth with phase dist_serve's gates);
    gated: launches, the blocks against the unsharded block, finite
    logits, and where the run compares with one process (GQA) its logits
    within LOGIT_TOL and its sure first tokens equal; MoE runs print the
    one process's logits, not gated (rounding re-routes tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh
    for name in names:
        if name == "dispatch":
            t0 = time.monotonic()
            out_dir = _out_dir("dist_cards_dispatch")
            mesh.spawn(cs._dist_serve_rank, 4, (str(out_dir),
                                                 DISPATCH_CHECK))
            ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                     for r in range(4)]
            cs.dist_serve_report("cards dispatch", card, ranks,
                                 f"4 ranks, one a card, over "
                                 f"{ranks[0]['backend']}", DISPATCH_CHECK)
            cs.log(f"[cards] dispatch at 6 layers: "
                   f"{time.monotonic() - t0:.1f} s")
        for run in LAYOUT_RUNS[name]:
            t0 = time.monotonic()
            _, arch, layers, flags, batch, S, filled, prompt, n_steps, _, \
                one = run
            out_dir = _out_dir(f"dist_cards_{name}")
            mesh.spawn(_layout_rank, 4, (str(out_dir), run))
            r = json.loads((out_dir / f"{name}{layers}.json").read_text())
            per = [json.loads((out_dir / f"{name}{layers}_rank{i}.json"
                               ).read_text()) for i in range(4)]
            cfg = cs._serve_cfg(arch, layers, flags=flags)
            mla = cfg.attn_type == "mla"
            # the prefill's flash calls, and the dense decode calls of the
            # gate step and the timed steps
            want = {"flash_attention": layers,
                    "decode_attention": 0 if mla else layers * (n_steps + 1)}
            end = (filled or prompt) + n_steps
            ok = (sorted(x["device"] for x in per) == [0, 1, 2, 3]
                  and all(x["launches"] == want for x in per)
                  and all(x["lengths"] == [end] * len(x["lengths"])
                          for x in per) and r["finite"]
                  and sorted(int(k) for k in r["gates"]) == [
                      i + 1 for i in _gate_blocks(cfg)])
            steps_ms = np.array(r["step_s"]) * 1e3
            # what a decode step reads on a card: its weights and its
            # cache (every entry of its slice: the rows are at their ends)
            bound = (max(x["read_bytes"] + x["cache_bytes"] for x in per)
                     / cs.PEAK_BYTES_PER_S * 1e3)
            whole = layers == get_config(arch).num_layers
            one = r.get("one")
            cs.log(
                f"[cards] {name}: {arch} "
                + (f"whole ({layers} layers" if whole else
                   f"at {layers} of {get_config(arch).num_layers} layers")
                + f", full width, bf16), mesh (data, model) = (2, 2), "
                f"{cs._layout_text(arch, layers, False, (2, 2), flags)}, 4 "
                f"ranks, one a card, over {r['backend']}: batch {batch}, a "
                f"{S}-position cache "
                + (f"seeded to {filled} at the rms of a "
                   f"{r['prefill_tokens'][0]} x {r['prefill_tokens'][1]} "
                   f"prefill (its wall time {r['ttft_s']:.4f} s)"
                   if filled else
                   f"prefilled with {batch} x {prompt} tokens: TTFT "
                   f"{r['ttft_s']:.4f} s, all-reduce "
                   f"{r['prefill_allreduce_ms']:.2f} ms of it "
                   f"({r['prefill_allreduces']} calls)")
                + f", {n_steps} serve_steps to {end}; TPOT mean "
                f"{steps_ms.mean():.3f} ms, median {np.median(steps_ms):.3f}, "
                f"min {steps_ms.min():.3f}, max {steps_ms.max():.3f}; byte "
                f"bound a card {bound:.3f} ms (weights read "
                f"{per[0]['read_bytes'] / 1e9:.2f} GB of "
                f"{per[0]['weights_bytes'] / 1e9:.2f} + cache "
                f"{per[0]['cache_bytes'] / 1e9:.2f} GB on a card at "
                f"{cs.PEAK_BYTES_PER_S / 1e12:.2f} TB/s), TPOT / bound "
                f"{steps_ms.mean() / bound:.2f}; all-reduce "
                f"{r['allreduce_ms']:.3f} ms a step ({r['allreduces']:.0f} "
                f"calls); peak GiB a card "
                + " ".join(f"{x['peak_gib']:.2f}" for x in per)
                + f"; launches a rank {per[0]['launches']} (want {want}); "
                f"weights made in {r['build_s']:.1f} s on rank 0; blocks "
                + ", ".join(f"{k}: max_abs_err={e:.3g} max_row_rel_err="
                            f"{rw:.3g}" for k, (e, rw) in r["gates"].items())
                + f" against the unsharded block on card 0 (atol {cs.ATOL} "
                f"of max, rtol {cs.RTOL}, row {cs.ROW_RTOL})"
                + ("" if not one else
                   f"; logits vs one process (card 0, whole weights "
                   f"{one['weights_bytes'] / 1e9:.2f} GB and cache "
                   f"{one['cache_bytes'] / 1e9:.2f} GB, TPOT mean "
                   f"{np.mean(one['step_s']) * 1e3:.3f} ms, peak "
                   f"{one['peak_gib']:.2f} GiB) over {n_steps} steps: "
                   f"largest share of max |logit| {max(one['share']):.4g}"
                   + (f" (limit {cs.LOGIT_TOL})" if not mla else
                      " (not gated: rounding re-routes MoE tokens)")
                   + f"; first tokens {one['first_sure_equal']} of "
                   f"{one['first_sure']} sure rows equal; stream tokens "
                   f"equal {one['stream_equal']}/{one['stream_tokens']}")
                + f"; {card}")
            cs.log(f"[cards] {name} at {layers} layers: "
                   f"{time.monotonic() - t0:.1f} s")
            if not ok or (one and not mla and (
                    max(one["share"]) > cs.LOGIT_TOL
                    or one["first_sure_equal"] != one["first_sure"])):
                raise AssertionError(
                    f"{name} at {layers} layers: cards "
                    f"{[x['device'] for x in per]}, launches "
                    f"{[x['launches'] for x in per]} (want {want}), lengths "
                    f"{[x['lengths'] for x in per]} (want {end}), finite "
                    f"{r['finite']}, gates {sorted(r['gates'])}, one "
                    f"process {one and max(one['share'])}")


def main():
    parts = sys.argv[1:] or ["train", "serve"]
    known = ("train", "serve", "long", "probe", "train_whole",
             *LAYOUT_RUNS)
    if any(p not in known for p in parts):
        raise SystemExit(f"parts: {', '.join(known)} (got {parts})")
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"needs four cards, found {n}")
    card = cs.card_line()
    cs.log(f"[cards] {n} cards: " + ", ".join(
        torch.cuda.get_device_name(i) for i in range(n)))
    cs.log(card)
    cs.phase_build()
    for part in parts:
        if part in LAYOUT_RUNS:
            layouts(card, (part,))
            continue
        {"train": train, "serve": serve, "long": long, "probe": probe,
         "train_whole": train_whole}[part](card)
    cs.log("[cards] ok")


if __name__ == "__main__":
    main()
