"""The engines' compiled passes (``repro_torch/engine/graphs.py``).

On the CPU there is no capture; these tests hold what capture needs:

1. every pass function (decode, chunk, draft decode, verify, the dense
   slot decode) is free of ops whose output shape or host value depends on
   data, after its warm-up (the CPU's stand-in for "capturable");
2. the static inputs of every pass, the caches' table and length views and
   the pools keep their addresses through admission, finish, prefix
   sharing, swap and recompute preemption, mixed chunked iterations and
   speculative iterations;
3. the all-trash warm-up writes only the trash page (the dense engine:
   only its trash position) and leaves the host mirrors alone, so it may
   run on a live engine without changing its streams;
4. replay accounting, with stand-in counters and a stand-in graph: the
   capture's counter bumps are taken out, the warm-up's kept, and every
   replay adds the graph's count.

The ``cuda``-marked tests at the end need a card and skip here: graphed ==
eager per pass with ``torch.equal``, replay over new inputs, and a failed
capture raising.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import gemma_2b, guard_2b
from repro_torch.engine import graphs
from repro_torch.engine.core import Engine, EngineConfig, SlotEngine, _push
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import steps as tsteps

# ops whose output shape or host value depends on tensor data: each would
# sync the host on the card and cannot be captured
DATA_DEPENDENT = {
    "_local_scalar_dense", "item", "is_nonzero", "equal", "allclose",
    "nonzero", "nonzero_numpy", "argwhere", "masked_select", "unique",
    "_unique", "_unique2", "unique_consecutive", "unique_dim", "bincount",
    "histc", "repeat_interleave", "masked_scatter",
}
INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}


class DataDependentOps(TorchDispatchMode):
    """Records every aten op and the data-dependent ones: those named in
    DATA_DEPENDENT, one-argument ``where`` and indexing by a boolean
    mask."""

    def __init__(self):
        super().__init__()
        self.seen = 0
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.seen += 1
        if name in DATA_DEPENDENT or (name == "where" and len(args) == 1):
            self.bad.append(str(func))
        if name in INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            self.bad.append(f"{func} with a boolean mask")
        return func(*args, **(kwargs or {}))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lengths]


def _engines():
    """A chunked engine, a speculative one and the dense one, each with a
    pass of every kind between them."""
    cfg = gemma_2b.reduced()
    kw = dict(max_batch=2, max_len=64, device="cpu", seed=3)
    return {
        "chunked": Engine(cfg, block_tokens=16,
                          config=EngineConfig(chunk_size=8), **kw),
        "spec": Engine(cfg, block_tokens=16, config=EngineConfig(
            draft_cfg=guard_2b.reduced(), spec_k=3), **kw),
        "slot": SlotEngine(cfg, **kw),
    }


def _serve(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: list(r.tokens) for r in eng.run()}


def test_passes_are_free_of_data_dependent_ops():
    """Each pass, after its warm-up, over a run's real inputs."""
    ran = set()
    for kind, eng in _engines().items():
        modes = {}
        for name, p in eng.passes().items():
            p.warm_up()
            mode = modes[name] = DataDependentOps()

            def recorded(*a, _body=p._body, _mode=mode, **k):
                with _mode:
                    return _body(*a, **k)
            p._body = recorded
        _serve(eng, _prompts(1, (12, 30, 7)))
        for name, mode in modes.items():
            assert mode.bad == [], (kind, name, mode.bad)
            if mode.seen:
                ran.add(f"{kind}.{name}")
    assert ran == {"chunked.decode", "chunked.chunk", "spec.draft_decode",
                   "spec.verify", "slot.decode"}


def _addresses(eng):
    """data_ptr() of every pass's static inputs, of the caches' table and
    length views and of the pools (target and draft)."""
    out = {}
    for name, p in eng.passes().items():
        for k, t in p.inputs.dev.items():
            out[f"{name}.{k}"] = t.data_ptr()
    for tag in ("caches", "draft_caches"):
        for k, t in getattr(eng, tag, {"attn": {}})["attn"].items():
            out[f"{tag}.{k}"] = t.data_ptr()
    return out


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_static_addresses_never_change(policy):
    """A chunked run and a speculative run under a pool small enough to
    preempt, with a shared prompt prefix: every pass checks the addresses
    as it runs."""
    cfg = gemma_2b.reduced()
    shared = _prompts(5, (32,))[0]
    prompts = [np.concatenate([shared, p]) for p in _prompts(6, (5, 9, 3))]
    prompts += _prompts(7, (40,))
    for config in (EngineConfig(chunk_size=8),
                   EngineConfig(draft_cfg=guard_2b.reduced(), spec_k=3)):
        eng = Engine(cfg, max_batch=2, max_len=64, block_tokens=16,
                     num_blocks=4, preemption=policy, device="cpu", seed=3,
                     config=config)
        want = _addresses(eng)
        assert eng.caches["attn"]["block_tables"].data_ptr() == \
            eng._rows.dev["tables"].data_ptr()
        calls = []
        for p in eng.passes().values():
            def checked(_run=p.run, **arrays):
                calls.append(_addresses(eng) == want)
                return _run(**arrays)
            p.run = checked
        done = _serve(eng, prompts, max_new=12)
        assert len(done) == 4 and calls and all(calls)
        st = eng.kv_stats()
        assert st["prefix_hit_blocks"] > 0
        if eng.spec:       # swap degrades to recompute on shared pages
            assert eng.spec_iters > 0
            assert st["swap_outs"] + st["recompute_drops"] > 0, st
        else:
            key = "swap_outs" if policy == "swap" else "recompute_drops"
            assert st[key] > 0, st


def test_warm_up_touches_only_the_trash_page():
    """Warm-ups of every pass on live engines (mid-run) change no pool page
    but the trash page (the dense engine: no cache position but its last),
    no host mirror, and not the rest of the streams."""
    prompts = _prompts(8, (12, 30, 7))
    want = {k: _serve(e, prompts) for k, e in _engines().items()}
    for kind, eng in _engines().items():
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        eng._admit()
        step = eng._step_decode if kind == "slot" else (
            eng._step_spec if eng.spec else eng._step_mixed)
        for _ in range(3):
            step()
        # what the warm-ups may not touch: pools but for their last (trash)
        # page; dense caches but for their last position, and their lengths
        # (the device holds them); the paged engines' host mirrors (every
        # pass pushes its static tables and lengths from them)
        if kind == "slot":
            g = eng.caches["attn"]
            kept = {"k": g["k"][:, :, :-1], "v": g["v"][:, :, :-1],
                    "length": g["length"]}
        else:
            kept = {f"{tag}.{k}": g["attn"][k][:, :-1]
                    for tag, g in (("target", eng.caches),
                                   ("draft", getattr(eng, "draft_caches",
                                                     None)))
                    if g is not None for k in ("k_pool", "v_pool")}
            kept["tables"] = torch.from_numpy(eng._tables_np)
            kept["lengths"] = torch.from_numpy(eng._lengths_np)
        before = {k: t.clone() for k, t in kept.items()}
        for p in eng.passes().values():
            p.warm_up()
        for k, t in kept.items():
            assert torch.equal(t, before[k]), (kind, k)
        eng.run()
        assert {r.rid: r.tokens for r in eng.finished} == want[kind], kind


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_accounting_with_stand_in_counters(monkeypatch):
    """A pass whose body 'launches' two paged decodes and one flash call:
    the warm-up's three launches stay counted, the capture's are taken
    back out, and each replay adds three without running the body."""
    monkeypatch.setattr(tpa, "launches", 10)
    monkeypatch.setattr(tfa, "launches", 0)
    monkeypatch.setattr(tda, "launches", 5)
    bodies = []

    def body(tokens):
        bodies.append(tokens.clone())
        tpa.launches += 2
        tfa.launches += 1
        return (tokens + 1,)
    monkeypatch.setattr(graphs, "_capture_graph",
                        lambda fn, stream: (_StandInGraph(), fn()))
    p = graphs.CompiledPass("stand-in", body, {"tokens": (2, 1)}, "cpu")
    assert p.graph is None and not bodies             # no capture on the CPU
    p.warm_up()
    assert torch.equal(bodies[-1], torch.zeros(2, 1, dtype=torch.int32))
    assert (tpa.launches, tfa.launches) == (12, 1)    # warm-up launches ran
    p.capture(stream=None)
    assert len(bodies) == 2
    assert (tpa.launches, tfa.launches, tda.launches) == (12, 1, 5)
    assert p.launches == {"paged_decode_attention": 2, "flash_attention": 1}
    for i in range(3):
        out, = p.run(tokens=np.full((2, 1), i, np.int32))
    assert len(bodies) == 2 and p.replays == p.graph.replays == 3
    assert (tpa.launches, tfa.launches, tda.launches) == (18, 4, 5)
    assert torch.equal(p.inputs.dev["tokens"],
                       torch.full((2, 1), 2, dtype=torch.int32))
    counts = ops.launch_counts()
    assert counts["paged_decode_attention"] == 18
    ops.add_launches({"decode_attention": 3}, -1)
    assert tda.launches == 2


def test_eager_pass_runs_the_body_over_its_static_inputs():
    """Where nothing was captured (the CPU, or cuda_graphs=False on the
    card) ``run`` writes the inputs and runs the body over the static
    buffers."""
    p = graphs.CompiledPass("echo", lambda tokens, q_valid: (tokens, q_valid),
                            {"tokens": (2, 3), "q_valid": (2,)}, "cpu",
                            capture=False)
    toks = np.arange(6, dtype=np.int32).reshape(2, 3)
    out_t, out_q = p.run(tokens=toks, q_valid=np.array([3, 1], np.int32))
    assert out_t.data_ptr() == p.inputs.dev["tokens"].data_ptr()
    assert out_t.tolist() == toks.tolist() and out_q.tolist() == [3, 1]
    assert p.replays == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the kernels)")
    return torch.device("cuda")


def _card_engines(cuda, cuda_graphs=True):
    cfg = gemma_2b.reduced()
    kw = dict(max_batch=4, max_len=128, device=cuda, seed=3,
              cuda_graphs=cuda_graphs)
    return [
        Engine(cfg, block_tokens=16, config=EngineConfig(chunk_size=16),
               **kw),
        Engine(cfg, block_tokens=16, config=EngineConfig(
            draft_cfg=guard_2b.reduced(), spec_k=3), **kw),
        SlotEngine(cfg, **kw),
    ]


def _random_inputs(eng, p, rng):
    """Random pools (or dense caches), tables, lengths and tokens for pass
    ``p`` of ``eng``; returns the tensors the pass writes (to restore)."""
    b, s = p.inputs.dev["tokens"].shape
    tokens = rng.integers(0, 512, (b, s)).astype(np.int32)
    arrays = {"tokens": tokens}
    if "q_valid" in p.inputs.dev:
        arrays["q_valid"] = rng.integers(0, s + 1, b).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(99)))
    if isinstance(eng, SlotEngine):
        g = eng.caches["attn"]
        for k in ("k", "v"):
            g[k].copy_(torch.randn(g[k].shape, generator=gen, device="cuda"))
        g["length"].copy_(torch.as_tensor(
            rng.integers(0, eng.max_len - 2, b), device="cuda")[None])
        return arrays, [g["k"], g["v"], g["length"]]
    caches, rows = ((eng.draft_caches, eng._draft_rows)
                    if p.name == "draft_decode" else (eng.caches, eng._rows))
    g = caches["attn"]
    for k in ("k_pool", "v_pool"):
        g[k].copy_(torch.randn(g[k].shape, generator=gen, device="cuda"))
    pages = g["k_pool"].shape[1] - 1
    mb = rows.host["tables"].shape[1]
    cap = min(mb, pages // b) * eng.block_tokens
    perm = rng.permutation(pages)[:b * (cap // eng.block_tokens)]
    tabs = np.full((b, mb), pages, np.int32)
    tabs[:, :cap // eng.block_tokens] = perm.reshape(b, -1)
    lens = rng.integers(0, cap - s, b).astype(np.int32)
    _push(rows, tabs, lens)
    return arrays, [g["k_pool"], g["v_pool"]]


@pytest.mark.cuda
def test_graphed_pass_equals_eager_bitwise(cuda):
    """Every pass: the replay's logits and every written tensor
    ``torch.equal`` the same function run eagerly over the same static
    inputs, at two sets of inputs (the second a replay over rewritten
    inputs)."""
    rng = np.random.default_rng(0)
    seen = set()
    for eng in _card_engines(cuda):
        for name, p in eng.passes().items():
            assert p.graph is not None
            for _ in range(2):
                arrays, state = _random_inputs(eng, p, rng)
                saved = [t.clone() for t in state]
                tok, logits = (t.clone() for t in p.run(**arrays))
                after = [t.clone() for t in state]
                for t, v in zip(state, saved):
                    t.copy_(v)
                tok_e, logits_e = p.fn()
                assert torch.equal(logits, logits_e), name
                assert torch.equal(tok, tok_e), name
                # rows write their padding to the trash page's slots
                # together, in no fixed order: it holds garbage by contract
                trim = slice(None) if isinstance(eng, SlotEngine) else \
                    slice(None, -1)
                for t, a in zip(state, after):
                    assert torch.equal(t[:, trim], a[:, trim]), name
            assert p.replays == 2
            seen.add(name)
    assert seen == {"decode", "chunk", "draft_decode", "verify"}


@pytest.mark.cuda
def test_graphed_engines_equal_eager_engines(cuda):
    """Streams and launch counts (replays added) of the graphed engines
    equal those of the same engines built with cuda_graphs=False."""
    prompts = _prompts(2, (12, 30, 7, 50))
    runs = {}
    for flag in (True, False):
        for i, eng in enumerate(_card_engines(cuda, cuda_graphs=flag)):
            assert all((p.graph is not None) == flag
                       for p in eng.passes().values())
            ops.reset_launches()
            streams = _serve(eng, prompts)
            runs[i, flag] = (streams, ops.launch_counts(),
                             [p.replays for p in eng.passes().values()])
    for i in range(3):
        (streams, counts, replays), (e_streams, e_counts, e_replays) = (
            runs[i, True], runs[i, False])
        assert streams == e_streams and counts == e_counts
        assert all(n > 0 for n in replays) and not any(e_replays)


@pytest.mark.cuda
def test_failed_capture_raises(cuda, monkeypatch):
    """A pass that reads a value back to the host cannot be captured: the
    engine raises instead of running eagerly."""
    serve_step = tsteps.serve_step

    def syncing(params, tokens, caches, cfg):
        if int(tokens.sum()) >= 0:
            return serve_step(params, tokens, caches, cfg)
    monkeypatch.setattr(tsteps, "serve_step", syncing)
    with pytest.raises(RuntimeError):
        Engine(gemma_2b.reduced(), max_batch=2, max_len=64, block_tokens=16,
               device=cuda)
