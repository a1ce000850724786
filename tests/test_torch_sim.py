"""The port's simulator (``repro_torch.core``) against the JAX package's
(``repro.core``).

Seeded runs with analytical pricing must be equal to the reference's, not
close: the summary (NaN-aware ``==``), every request's token timestamps,
the total energy, each scheduler's ``step_events``, the chrome trace and,
for the autoscaler, its actions and fleet trace. Request ids come from a
module-global counter in each package, so they are compared relative to
each run's first. Inside the port: fast-forward on == off, the fleet
index on == off (decision sequences too, under churn), and the
autoscaler's actions with fast-forward on and off. Unit twins: the paged
allocator and its radix index on one seeded walk, the network's pricing,
Eq. 1's closed form and sampled mean. The regression path prices from
JAX's fitted weights carried across (``fitted_from_numpy``) within a
tolerance derived from the fp32 dot product."""
import importlib
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.llm_scheduler import ClientPerf as JClientPerf
from repro_torch.core.llm_scheduler import ClientPerf
from repro_torch.core.router import Router
from repro_torch.perfmodel import regression as reg

_MODULES = ("core.system", "core.workload", "core.llm_scheduler",
            "core.client", "core.autoscaler", "core.request", "core.tracing",
            "core.metrics", "core.memory", "core.comm", "configs",
            "perfmodel.hardware")


def _ns(pkg: str) -> SimpleNamespace:
    mods = {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}")
            for n in _MODULES}
    return SimpleNamespace(port=pkg == "repro_torch", **mods)


REF, PORT = _ns("repro"), _ns("repro_torch")


def _same(a, b) -> bool:
    """``==`` with NaN equal to NaN, through dicts, lists and tuples."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def _first_difference(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return path, sorted(a.keys() ^ b.keys())
        for k in a:
            if not _same(a[k], b[k]):
                return _first_difference(a[k], b[k], f"{path}.{k}")
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
            and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if not _same(x, y):
                return _first_difference(x, y, f"{path}[{i}]")
    return path, a, b


def _assert_same(a, b):
    assert _same(a, b), _first_difference(a, b)


def _build(m, device="cpu", **spec_kw):
    spec = m.system.SystemSpec(**spec_kw)
    if m.port:
        return m.system.build_system(spec, device=device)
    return m.system.build_system(spec)


def _limits(m, **kw):
    return m.llm_scheduler.SchedulerLimits(**kw)


def _generate(m, **wl):
    if isinstance(wl.get("trace"), dict):
        wl["trace"] = m.workload.TraceSpec(**wl["trace"])
    return m.workload.generate(m.workload.WorkloadConfig(**wl))


def _request_rows(reqs, rid0):
    return sorted((r.rid - rid0, r.arrival, r.first_token_time,
                   r.completion_time, r.decoded_tokens, r.preemptions,
                   tuple(r.token_times)) for r in reqs)


def _observe(m, coord, reqs, tmp, **extra):
    """Everything a seeded run must reproduce, ids relative to its first."""
    met = coord.metrics
    rid0 = min(r.rid for r in reqs)
    path = m.tracing.to_chrome_trace(met.serviced, str(tmp / "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    for e in trace["traceEvents"]:
        e["tid"] -= rid0
    return {
        "summary": met.summary(total_energy=coord.total_energy,
                               slo=m.metrics.SLO()),
        "energy": coord.total_energy,
        "serviced": _request_rows(met.serviced, rid0),
        "dropped": _request_rows(met.dropped, rid0),
        "step_events": {n: c.scheduler.step_events
                        for n, c in coord.clients.items()
                        if isinstance(c, m.client.LLMClient)},
        "trace": trace, **extra}


def _system_run(m, tmp, spec_kw, wl_kw, fail=None):
    coord = _build(m, **spec_kw)
    for name, at, recover in fail or ():
        coord.schedule_failure(name, at=at, recover_at=recover)
    reqs = _generate(m, **wl_kw)
    coord.submit(reqs)
    coord.run()
    return _observe(m, coord, reqs, tmp)


# ---------------------------------------------------------------------------
# seeded scenarios, analytical pricing, each built as the reference's own
# tests build it
# ---------------------------------------------------------------------------

def _strategy(strategy):
    """One scheduler alone (``test_simulator.py``'s drive: 9 requests of
    512 + 8 tokens); the coalescing strategies also end to end."""
    def run(m, tmp):
        cfg = m.configs.get_config("llama3_70b")
        hw = m.hardware
        cluster = hw.ClusterSpec(hw.H100, n_chips=2, tp=2)
        sched = m.llm_scheduler.LLMScheduler(
            strategy, cfg, cluster,
            limits=_limits(m, max_batch=4, chunk_size=256))
        kind = {"prefill_only": m.request.PREFILL,
                "decode_only": m.request.DECODE}.get(strategy,
                                                     m.request.LLM)
        reqs = [m.request.Request(arrival=0.0, input_tokens=512,
                                  output_tokens=8,
                                  stages=[m.request.Stage(kind)])
                for _ in range(9)]
        for r in reqs:
            sched.add(r)
        now, finished, steps = 0.0, [], []
        while sched.has_work() and len(steps) < 10_000:
            step = sched.plan_step()
            steps.append((step.kind, step.duration, step.energy, step.flops,
                          step.n_steps, len(step.prefill), len(step.decode)))
            now += step.duration
            finished += sched.finish_step(step, now)
        rid0 = min(r.rid for r in reqs)
        out = {"steps": steps, "finished": _request_rows(finished, rid0),
               "kv": sched.kv.stats(), "step_events": sched.step_events}
        if strategy in ("static", "continuous", "chunked", "mixed"):
            out["system"] = _system_run(
                m, tmp, dict(n_llm_clients=2, strategy=strategy),
                dict(n_requests=30, rate=3.0, seed=42))
        return out
    return run


def _disagg(disaggregation, granularity):
    def run(m, tmp):
        return _system_run(
            m, tmp, dict(strategy="disaggregated", n_prefill=2, n_decode=2,
                         disaggregation=disaggregation,
                         kv_transfer_granularity=granularity),
            dict(n_requests=20, rate=2.0, seed=7, disaggregated=True))
    return run


def _pipeline(pipeline):
    """The rag, kv and reasoning (2 branches) pipelines, 4 clients."""
    def run(m, tmp):
        wl = dict(n_requests=40, rate=2.0, seed=0, pipeline=pipeline)
        if pipeline == "reasoning":
            wl.update(n_requests=20, reasoning_branches=2,
                      reasoning_scale=3.0)
        return _system_run(m, tmp, dict(with_rag=pipeline == "rag",
                                        with_kv_retrieval=pipeline == "kv"),
                           wl)
    return run


MIG_TRACE = dict(name="mig", input_mean=384, input_std=0.3,
                 output_mean=160, output_std=0.2, input_max=600,
                 output_max=320)


def _prefix_migration(m, tmp, fast_forward=True):
    """``test_prefix_migration.py``'s scaled-out system: a shared-prefix
    pool, ``prefix_affinity`` routing and ``prefix_migration``, a cold
    replica added at 4 s."""
    limits = _limits(m, max_batch=32, fast_forward=fast_forward)
    coord = _build(m, n_llm_clients=1, strategy="continuous", limits=limits,
                   with_pre_post=False, router_policy="prefix_affinity",
                   prefix_migration=True, fetch_load_factor=1.5)
    warm = coord.clients["llm0"]
    cold = m.client.LLMClient("llm1", warm.cluster, warm.model_cfg,
                              "continuous", limits, "fcfs",
                              warm.scheduler.perf)
    coord.network.add_link("pcie:llm1", m.hardware.PCIE4_X4)
    coord.network.connect("llm1", "llm1:kvpool", ["pcie:llm1"])
    coord.schedule_add_client(cold, at=4.0)
    reqs = _generate(m, trace=dict(MIG_TRACE), rate=4.0, n_requests=40,
                     seed=3, shared_prefix_pool=4, shared_prefix_tokens=512,
                     prefix_reuse_rate=1.0, postprocess=False,
                     rate_ramp_at=4.0, rate_ramp=2.0)
    coord.submit(reqs)
    coord.run()
    return _observe(m, coord, reqs, tmp)


SMALL_TRACE = dict(name="t", input_mean=400, input_std=0.3, output_mean=96,
                   output_std=0.3, input_max=800, output_max=192)


def _preemption(policy):
    """``test_kv_paging.py``'s pressured fleet (``kv_capacity_frac``
    0.02, routing on kv pressure)."""
    def run(m, tmp):
        return _system_run(
            m, tmp, dict(n_llm_clients=2, with_pre_post=False,
                         router_policy="load_based",
                         router_metric="kv_pressure",
                         limits=_limits(m, max_batch=16,
                                        kv_capacity_frac=0.02,
                                        preemption=policy)),
            dict(trace=dict(SMALL_TRACE), n_requests=25, rate=4.0, seed=3,
                 postprocess=False))
    return run


def _spec_decode(m, tmp):
    """``test_spec_decode.py``'s SPEC_DECODE stage: ``spec_k=4``."""
    return _system_run(
        m, tmp, dict(n_llm_clients=2, strategy="continuous",
                     with_pre_post=False,
                     limits=_limits(m, spec_k=4, spec_acceptance=0.8)),
        dict(trace=m.workload.AZURE_CODE, rate=2.0, n_requests=30,
             postprocess=False, seed=41))


def _fault(m, tmp):
    """``test_simulator.py``'s fault and recovery: llm0 fails at 1 s and
    recovers at 30 s, llm1 fails at 5 s for good."""
    return _system_run(m, tmp, dict(n_llm_clients=3),
                       dict(n_requests=30, rate=3.0, seed=11),
                       fail=(("llm0", 1.0, 30.0), ("llm1", 5.0, None)))


AUTO_PHASES = ((0.3, 4.0), (0.9, 0.5), (1.5, 2.0))


def _autoscaled(m, tmp, fast_forward=True, policy="threshold"):
    """``test_autoscale.py``'s closed loop over ``rate_phases``, two SLO
    tiers."""
    a = m.autoscaler
    coord = _build(m, n_llm_clients=2, with_pre_post=False,
                   limits=_limits(m, max_batch=8, fast_forward=fast_forward))
    reqs = _generate(m, trace=dict(name="t", input_mean=192, input_std=0.4,
                                   output_mean=24, output_std=0.2),
                     rate=30.0, n_requests=24, process="poisson",
                     postprocess=False, seed=3, rate_phases=AUTO_PHASES)
    for i, r in enumerate(reqs):
        r.tier = "interactive" if i % 2 else "batch"
    base = next(c for c in coord.clients.values()
                if c.stages == (m.request.LLM,))
    slos = {"interactive": m.metrics.SLO(),
            "batch": m.metrics.SLO(ttft_base=2.0, tpot_base=0.100)}
    scaler = a.Autoscaler(
        a.ClientTemplate.from_client(base), policy=a.make_policy(policy),
        cfg=a.AutoscalerConfig(interval=0.2, window=0.6, min_clients=1,
                               max_clients=4, cooldown_out=0.4,
                               cooldown_in=0.8), slos=slos)
    coord.attach_autoscaler(scaler)
    coord.submit(reqs)
    coord.run()
    return _observe(m, coord, reqs, tmp, actions=scaler.actions,
                    fleet_trace=scaler.fleet_trace,
                    client_seconds=scaler.client_seconds)


def _history_off(m, tmp):
    """``history_limit=0``: no step dict kept, ``step_events`` still
    counted."""
    return _system_run(
        m, tmp, dict(n_llm_clients=2, with_pre_post=False,
                     limits=_limits(m, max_batch=8, history_limit=0)),
        dict(rate=20.0, n_requests=20, postprocess=False, seed=7))


SCENARIOS = {
    **{f"strategy-{s}": _strategy(s)
       for s in ("static", "continuous", "chunked", "mixed", "prefill_only",
                 "decode_only")},
    "disagg-global-layerwise": _disagg("global", "layerwise"),
    "disagg-global-full": _disagg("global", "full"),
    "disagg-local-layerwise": _disagg("local", "layerwise"),
    "pipeline-rag": _pipeline("rag"),
    "pipeline-kv": _pipeline("kv"),
    "pipeline-reasoning": _pipeline("reasoning"),
    "prefix-migration": _prefix_migration,
    "preempt-swap": _preemption("swap"),
    "preempt-recompute": _preemption("recompute"),
    "spec-k4": _spec_decode,
    "fault-recover": _fault,
    "autoscale": _autoscaled,
    "history-off": _history_off,
}


def test_strategies_cover_the_reference():
    assert PORT.llm_scheduler.STRATEGIES == REF.llm_scheduler.STRATEGIES
    assert {k.split("-", 1)[1] for k in SCENARIOS
            if k.startswith("strategy-")} \
        == set(REF.llm_scheduler.STRATEGIES)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_seeded_run_equals_reference(name, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = SCENARIOS[name](REF, tmp_path / "ref")
    got = SCENARIOS[name](PORT, tmp_path / "port")
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# the contracts inside the port
# ---------------------------------------------------------------------------

FF_CASES = {
    "swap-pressure-prefix": (
        dict(n_llm_clients=2, strategy="chunked"),
        dict(preemption="swap", kv_capacity_frac=0.04),
        dict(n_requests=14, rate=4.0, seed=5, shared_prefix_pool=2)),
    "recompute-reasoning": (
        dict(n_llm_clients=2, strategy="continuous"),
        dict(preemption="recompute", kv_capacity_frac=0.04),
        dict(n_requests=10, rate=3.0, seed=9, pipeline="reasoning",
             reasoning_branches=3, reasoning_scale=3.0)),
    "disaggregated": (
        dict(strategy="disaggregated", n_prefill=2, n_decode=2),
        dict(), dict(n_requests=18, rate=2.0, seed=7, disaggregated=True)),
}


@pytest.mark.parametrize("case", list(FF_CASES))
def test_port_fast_forward_on_equals_off(case, tmp_path):
    spec, limits, wl = FF_CASES[case]
    runs = []
    for ff in (True, False):
        (tmp_path / str(ff)).mkdir()
        runs.append(_system_run(
            PORT, tmp_path / str(ff),
            dict(spec, limits=_limits(PORT, fast_forward=ff, **limits)),
            dict(wl)))
    on, off = runs
    # simulator cost differs by design: the macro windows pop fewer events
    on.pop("step_events"), off.pop("step_events")
    _assert_same(on, off)


def test_port_prefix_migration_fast_forward_on_equals_off(tmp_path):
    (tmp_path / "on").mkdir()
    (tmp_path / "off").mkdir()
    on = _prefix_migration(PORT, tmp_path / "on", fast_forward=True)
    off = _prefix_migration(PORT, tmp_path / "off", fast_forward=False)
    assert on["summary"]["kv_migrations"] > 0
    on.pop("step_events"), off.pop("step_events")
    _assert_same(on, off)


@pytest.mark.parametrize("policy", ["threshold", "target_tracking"])
def test_port_autoscaler_actions_equal_fast_forward_on_and_off(policy,
                                                               tmp_path):
    (tmp_path / "on").mkdir()
    (tmp_path / "off").mkdir()
    on = _autoscaled(PORT, tmp_path / "on", True, policy)
    off = _autoscaled(PORT, tmp_path / "off", False, policy)
    assert on["actions"], "the scaler never acted: the case is vacuous"
    on.pop("step_events"), off.pop("step_events")
    _assert_same(on, off)


class _Recording(Router):
    """Wraps a router and logs every (stage, chosen client) decision."""

    def __init__(self, inner, log):
        self.inner = inner
        self.log = log

    @property
    def metric(self):
        return getattr(self.inner, "metric", None)

    def bind(self, coordinator):
        self.coordinator = coordinator
        self.inner.bind(coordinator)

    def route(self, req, candidates, now):
        c = self.inner.route(req, candidates, now)
        self.log.append((req.current_stage.kind, c.name))
        return c


FIXED_CHURN = [("add", 0, 0.1), ("fail_recover", 1, 0.2),
               ("remove", 2, 0.6), ("fail_recover", 0, 0.8)]


def _churn_arm(indexed, policy, metric, migration):
    """``test_fleet_scale.py``'s arm: 4 clients under ``FIXED_CHURN``."""
    coord = _build(PORT, n_llm_clients=4, router_policy=policy,
                   router_metric=metric,
                   limits=_limits(PORT, max_batch=8), with_pre_post=False,
                   prefix_migration=migration,
                   straggler_deadline=0.05 if migration else None,
                   fetch_load_factor=1.5 if migration else None,
                   fleet_index=indexed)
    log = []
    coord.router = _Recording(coord.router, log)
    coord.router.bind(coord)
    coord.submit(_generate(
        PORT, trace=dict(name="t", input_mean=192, input_std=0.4,
                         output_mean=24, output_std=0.2),
        rate=40.0, n_requests=30, process="poisson", postprocess=False,
        seed=3, shared_prefix_pool=4, shared_prefix_tokens=128))
    names = list(coord.clients)
    for i, (kind, tgt, frac) in enumerate(FIXED_CHURN):
        t = 0.2 + 2.0 * frac
        target = names[tgt % len(names)]
        if kind == "add":
            base = coord.clients[names[0]]
            coord.schedule_add_client(PORT.client.LLMClient(
                f"extra{i}", base.cluster, base.model_cfg, base.strategy,
                base.scheduler.limits, perf=base.scheduler.perf,
                group=base.group), t)
        elif kind == "fail_recover":
            coord.schedule_failure(target, t, recover_at=t + 0.4)
        else:
            coord.schedule_remove_client(target, t)
    coord.run()
    return log, coord.metrics.summary()


@pytest.mark.parametrize("policy,metric,migration", [
    ("round_robin", "queue", False), ("load_based", "kv_pressure", False),
    ("heavy_light", "tokens_remaining", False),
    ("prefix_affinity", "queue", True)])
def test_port_fleet_index_on_equals_off_under_churn(policy, metric,
                                                    migration):
    log_i, s_i = _churn_arm(True, policy, metric, migration)
    log_s, s_s = _churn_arm(False, policy, metric, migration)
    assert log_i and log_i == log_s
    _assert_same(s_i, s_s)


# ---------------------------------------------------------------------------
# unit twins
# ---------------------------------------------------------------------------

def _chain(tag, n):
    out, h = [], 0
    for i in range(n):
        h = hash((h, tag, i))
        out.append(h)
    return out


def _allocator_walk(m, seed=0, steps=600):
    """One seeded walk over the paged allocator: admissions with shared
    prefixes (radix hits), growth, forks, swaps, frees, exports and
    imports; every call's result and the counters after each."""
    hw = m.hardware
    kv = m.memory.PagedKVAllocator(capacity_bytes=160.0 * 4,
                                   bytes_per_token=1.0, block_tokens=4,
                                   swap_tiers=(hw.TIER_HOST_DRAM,))
    rng = np.random.default_rng(seed)
    chains = [_chain(f"p{i}", 12) for i in range(4)]
    live, swapped, handles, out = [], set(), [], []
    for step in range(steps):
        op = int(rng.integers(0, 8))
        if op == 0 or not live:
            rid = step
            n = int(rng.integers(1, 60))
            pre = chains[int(rng.integers(0, 4))][:int(rng.integers(0, 12))]
            res = kv.allocate(rid, n, prefix_hashes=pre)
            if res:
                live.append(rid)
        else:
            rid = live[int(rng.integers(0, len(live)))]
            if op == 1 and rid not in swapped:
                res = kv.grow_request([rid], int(rng.integers(1, 6)))
            elif op == 2 and rid not in swapped:
                child = (rid, step)
                kv.fork(rid, child)
                live.append(child)
                res = "fork"
            elif op == 3:
                if rid in swapped:
                    res = kv.swap_in(rid)
                    if res is not None:
                        swapped.discard(rid)
                else:
                    res = kv.swap_out(rid)
                    if res is not None:
                        swapped.add(rid)
            elif op == 4:
                res = kv.free(rid)
                live.remove(rid)
                swapped.discard(rid)
            elif op == 5:
                res = kv.export_chain(chains[int(rng.integers(0, 4))])
                if res is not None:
                    handles.append(res[0])
            elif op == 6 and handles:
                kv.release_export(handles.pop(0))
                res = "released"
            else:
                res = kv.import_chain(_chain(f"m{step % 5}", 6))
        kv.check_invariants()
        out.append((op, res, sorted(kv.stats().items()),
                    kv.radix.cached_count()))
    out.append(kv.clear_cache())
    out.append(sorted(kv.stats().items()))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_allocator_and_radix_walk_equal_reference(seed):
    got = _allocator_walk(PORT, seed)
    want = _allocator_walk(REF, seed)
    _assert_same(got, want)
    ops = {o for o, *_ in got[:-2]}
    assert ops == set(range(8))


def _radix_walk(m):
    r = m.memory.RadixBlockIndex()
    rng = np.random.default_rng(5)
    chain = _chain("r", 40)
    out = []
    for i, h in enumerate(chain):
        out.append(r.insert(h, i, chain[i - 1] if i else None))
    for step in range(200):
        op = int(rng.integers(0, 4))
        b = int(rng.integers(0, 40))
        if op == 0:
            out.append(r.match(chain[:int(rng.integers(0, 41))]))
        elif op == 1 and r.holds_block(b):
            r.acquire(b)
            out.append(("acq", b))
        elif op == 2 and r.holds_block(b):
            r.release(b)
            out.append(("rel", b, r.peek_seq(b)))
        else:
            out.append(("evict", r.evict_one(), r.cached_count()))
    out.append(r.unregister_subtree(0) if r.holds_block(0) else None)
    return out


def test_radix_index_walk_equals_reference():
    _assert_same(_radix_walk(PORT), _radix_walk(REF))


def _network(m):
    hw = m.hardware
    net = m.comm.Network()
    net.add_link("nvlink", hw.NVLINK)
    net.add_link("rack", hw.ETH_RACK)
    net.add_link("pcie", hw.PCIE4_X4)
    net.set_default_path(["rack"])
    net.connect("a", "b", ["nvlink", "rack"])
    net.connect("a", "c", ["pcie"], bidirectional=False)
    out = []
    for i, nbytes in enumerate((1e6, 3e8, 0.0, 7.5e9, 2e4)):
        for gran, layers in (("full", 1), ("layerwise", 80)):
            now = 0.01 * i
            out.append(net.estimate("a", "b", nbytes, now, gran, layers))
            out.append(net.transfer("a", "b", nbytes, now, gran, layers))
            out.append(net.transfer("c", "a", nbytes, now, gran, layers))
            out.append(net.transfer("a", "c", nbytes, now, gran, layers))
    net.override_link("rack", hw.LinkSpec("fit", 1e10, 5e-6))
    out.append(net.transfer("b", "a", 1e9, 1.0, "full", 1))
    out.append(net.stats())
    return out


def test_network_pricing_equals_reference():
    _assert_same(_network(PORT), _network(REF))


def test_retrieval_eq1_closed_form_and_sampled_mean_equal_reference():
    out = []
    for m in (PORT, REF):
        hw = m.hardware
        tiers = [hw.CacheTierSpec("l1", 1e12, 1e-6, 1e9, 0.3),
                 hw.CacheTierSpec("l2", 1e12, 1e-5, 1e8, 0.5)]
        want = [m.memory.expected_retrieval_latency(s, tiers, miss)
                for s in (2e6, 5e8) for miss in (0.0, 0.25, 1.0)]
        rng = np.random.default_rng(7)
        samples = [m.memory.sample_retrieval_latency(2e6, tiers, 0.25, rng)
                   for _ in range(2000)]
        out.append((want, samples,
                    m.memory.tier_transfer_time(3e7, tiers[1])))
    _assert_same(out[0], out[1])
    assert abs(np.mean(out[0][1]) - out[0][0][1]) / out[0][0][1] < 0.05


# ---------------------------------------------------------------------------
# the regression path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_perf():
    """JAX's fitted ``ClientPerf`` (llama3_70b on its 2 x H100 TP2
    client): about 6 s of jnp op dispatch, built once."""
    cfg = REF.configs.get_config("llama3_70b")
    hw = REF.hardware
    return JClientPerf(cfg, hw.ClusterSpec(hw.H100, n_chips=2, tp=2,
                                           intra_link=hw.NVLINK))


def _carried(coord, jperf):
    """Point the port fleet's one ``ClientPerf`` at JAX's weights."""
    perf = next(c.scheduler.perf for c in coord.clients.values()
                if isinstance(c, PORT.client.LLMClient))
    for attr, kind in (("decode_model", "decode"),
                       ("prefill_model", "prefill")):
        w = np.asarray(getattr(jperf, attr).weights)
        setattr(perf, attr, reg.fitted_from_numpy(w, kind, "cpu"))
    return perf


def _dot_bound(perf) -> float:
    """The largest relative difference two fp32 evaluations of one
    prediction ``x . w`` may show at the points this run priced: each is
    within gamma_n * sum |x_i w_i| of the exact product (n terms, unit
    roundoff u = 2^-24, gamma_n = n u / (1 - n u)), so two differ by at
    most twice that, over |x . w|. The features themselves round alike in
    both (IEEE products of the same integers)."""
    u = 2.0 ** -24
    worst = 0.0
    for key in perf._memo:
        if key[0] == "p":
            model, args = perf.prefill_model, ([key[3]], [key[1]], [key[2]])
        elif key[0] == "d":
            model, args = perf.decode_model, ([key[1]], [key[2]])
        else:
            continue
        x = model.feature_fn(*[torch.as_tensor(a) for a in args])[0]
        x, w = x.double(), model.weights.double()
        n = len(w)
        gamma = n * u / (1 - n * u)
        y = float(x @ w)
        if y > 0:
            worst = max(worst, 2 * gamma * float((x * w).abs().sum()) / y)
    return worst


def _close(got, want, tol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _close(g, w, tol)
        elif isinstance(w, float) and not math.isnan(w):
            assert abs(g - w) <= tol(w), (k, g, w, tol(w))
        else:
            assert _same(g, w), (k, g, w)


@pytest.mark.parametrize("pipeline,n", [("regular", 30), ("reasoning", 8)])
def test_regression_pricing_on_jax_weights_within_fp32_dot(jax_perf,
                                                           pipeline, n):
    """Both simulators price every pass from JAX's ridge weights; counts
    are equal and the floats within the run's fp32 dot-product bound r
    (``_dot_bound``). Every timestamp t is a maximum of sums of exact
    arrivals and priced durations, each duration within r of itself, so t
    moves by at most r t. A latency is a difference of two timestamps
    (a TTFT, a TPOT span over its tokens), and so are its percentiles and
    means: each moves by at most 2 r T, T the run's last timestamp. A
    rate or an energy is a ratio or a sum of such terms: within 2 r of
    itself. So each summary float w is held to 2 r max(|w|, T)."""
    spec = dict(n_llm_clients=4, use_regression=False)
    wl = dict(rate=2.0, n_requests=n, seed=0, pipeline=pipeline)
    ref = _build(REF, **spec)
    ref_perf = next(c.scheduler.perf for c in ref.clients.values()
                    if isinstance(c, REF.client.LLMClient))
    ref_perf.decode_model = jax_perf.decode_model
    ref_perf.prefill_model = jax_perf.prefill_model
    ref_reqs = _generate(REF, **wl)
    ref.submit(ref_reqs)
    want = ref.run().summary(total_energy=ref.total_energy)
    port = _build(PORT, **spec)
    perf = _carried(port, jax_perf)
    reqs = _generate(PORT, **wl)
    port.submit(reqs)
    got = port.run().summary(total_energy=port.total_energy)
    assert got["n_serviced"] == n
    r = _dot_bound(perf)
    assert 0 < r < 1e-3, r
    rows = _request_rows(port.metrics.serviced, min(x.rid for x in reqs))
    ref_rows = _request_rows(ref.metrics.serviced,
                             min(x.rid for x in ref_reqs))
    assert [row[0] for row in rows] == [row[0] for row in ref_rows]
    for row, ref_row in zip(rows, ref_rows):
        assert row[4:6] == ref_row[4:6]          # tokens, preemptions
        times = (row[2], row[3], *row[6])
        ref_times = (ref_row[2], ref_row[3], *ref_row[6])
        assert len(times) == len(ref_times)
        for t, u in zip(times, ref_times):
            assert abs(t - u) <= r * u, (row[0], t, u, r)
    last = max(x.completion_time for x in ref.metrics.serviced)
    _close(got, want, lambda w: 2 * r * max(abs(w), last))


def test_regression_fit_on_cpu_completes_every_request():
    coord = _build(PORT, "cpu", n_llm_clients=4, use_regression=True)
    perf = next(c.scheduler.perf for c in coord.clients.values()
                if isinstance(c, PORT.client.LLMClient))
    assert perf.decode_model.weights.device.type == "cpu"
    coord.submit(_generate(PORT, rate=2.0, n_requests=30, seed=0))
    s = coord.run().summary()
    assert s["n_serviced"] == 30 and s["n_dropped"] == 0
    assert len(perf._memo) > 0


def test_fitted_from_numpy_checks_its_shape():
    w = np.arange(6, dtype=np.float32)
    m = reg.fitted_from_numpy(w, "decode", "cpu")
    assert float(m.predict([2], [3])[0]) == float(
        np.array([1, 2, 3, 6, 4, 9], np.float32) @ w)
    with pytest.raises(ValueError):
        reg.fitted_from_numpy(w, "prefill", "cpu")


def test_regression_prices_on_the_card_by_default_never_the_cpu():
    """The default device is the card: with none, torch's own CUDA error
    is raised, never a quiet fit on the CPU."""
    cfg = PORT.configs.get_config("llama3_70b")
    hw = PORT.hardware
    cluster = hw.ClusterSpec(hw.H100, 2, 2)
    if torch.cuda.is_available():
        perf = ClientPerf(cfg, cluster, use_regression=True)
        assert perf.decode_model.weights.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ClientPerf(cfg, cluster, use_regression=True)
    perf = ClientPerf(cfg, cluster, use_regression=False)
    assert perf.decode_model is None and perf.prefill_model is None
