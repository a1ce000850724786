#!/usr/bin/env python3
"""The sharded steps on four cards, one rank a card over NCCL:

    python3 tools/dist_cards.py [train] [serve] [probe]

With no argument it runs both parts.

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

``probe`` (not run by default): where a sharded decode step's all-reduce
time goes (``_probe_rank``).

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
def _allreduce_timed():
    """CUDA event pairs around each outermost ``distributed.all_reduce``
    while open (a bf16 sum over more than two ranks calls it again in
    fp32: counted once)."""
    from repro_torch import distributed as D
    saved, pairs, depth = D.all_reduce, [], [0]

    def timed(t, ax, op="sum"):
        if ax.size == 1 or depth[0]:
            return saved(t, ax, op)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        depth[0] += 1
        a.record()
        try:
            return saved(t, ax, op)
        finally:
            b.record()
            depth[0] -= 1
            pairs.append((a, b))
    D.all_reduce = timed
    try:
        yield pairs
    finally:
        D.all_reduce = saved


def _ms(pairs) -> float:
    torch.cuda.synchronize()
    return float(sum(a.elapsed_time(b) for a, b in pairs))


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
        with _allreduce_timed() as pre_ar:
            t0 = time.perf_counter()
            lg, caches = steps.prefill_step(params, {"tokens": prompts}, cfg,
                                            max_len, rules, mesh)
            torch.cuda.synchronize()
            ttft = time.perf_counter() - t0
        step_s, logits = [], [lg]
        with _allreduce_timed() as dec_ar:
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
            "prefill_allreduce_ms": _ms(pre_ar),
            "prefill_allreduces": len(pre_ar),
            "decode_allreduce_ms": _ms(dec_ar) / SERVE_NEW,
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


def main():
    parts = sys.argv[1:] or ["train", "serve"]
    if any(p not in ("train", "serve", "probe") for p in parts):
        raise SystemExit(f"parts: train, serve, probe (got {parts})")
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"needs four cards, found {n}")
    card = cs.card_line()
    cs.log(f"[cards] {n} cards: " + ", ".join(
        torch.cuda.get_device_name(i) for i in range(n)))
    cs.log(card)
    cs.phase_build()
    for part in parts:
        {"train": train, "serve": serve, "probe": probe}[part](card)
    cs.log("[cards] ok")


if __name__ == "__main__":
    main()
