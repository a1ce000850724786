"""Dry run of every (arch x shape x mesh) cell: the port's own steps run
on rank 0 of a "fake" process group of 256 or 512 ranks over
``meta`` tensors, and their compute, memory and collective terms are
priced on an H100 (twin of ``repro.launch.dryrun``, which lowers and
compiles each cell with XLA and prices it on a TPU v5e). No memory is
allocated and no kernel runs; it needs no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_2b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out dryrun_results.json

*The cell.* Params, AdamW's state and the caches are ``meta`` tensors:
the rank's shards (``weights.shard_params`` over
``transformer.param_specs``, ``steps.state_specs``, ``cache_specs``),
the step ``steps.train_step``, ``prefill_step`` or ``serve_step`` under
``ShardingRules`` over ``launch.mesh.make_production_mesh``, with JAX's
rules: FSDP for a train cell over 30e9 params, ``seq_sharded`` for a
decode at batch 1. The batch is the global batch, as the port's steps
take it. Where JAX's rules leave a cache's positions whole because their
group does not divide ``seq_len + 8``, the port's layout refuses the
length (``transformer.init_cache``): the cell rounds it up to a multiple
of the group (524,296 -> 524,304 positions on 16 data ranks), so its
positions split where JAX's do not. The fake group is global to a
process: ``fake_world`` starts (or restarts) it, and ``forget_meshes``
clears the axis groups and plans ``distributed`` caches by mesh.

*Compute.* ``FlopCounterMode`` counts the matrix products; over
``H100.flops`` (989e12, bf16). Its registry has no formula for
``aten._grouped_mm`` (the MoE experts), so this module registers one:
on ``meta`` the ragged routing is unseen, and a grouped product counts
the routed rows of a balanced router, ``T k n_local / E`` of a rank's
``T`` rows (``moe._moe_local``'s ``expected``), not its capacity buffer.
``layers.mm_fp32`` takes its plain branch on ``meta`` (an fp32 ``mm`` of
the upcast operands), which the counter sees as any product.

*Memory.* A ``TorchDispatchMode`` sums each dispatched op's operand and
output bytes (views, allocations without a write and collectives move
none); over ``H100.mem_bw`` (3.35e12). These are eager bytes, an op at
a time, not XLA's fused count, so they run above JAX's. On ``meta`` the
attention wrappers take the plain attention (``kernels/ops.py`` takes a
kernel only for a CUDA tensor), which writes the scores S to memory;
the hand kernels keep S on chip, so the flash-adjusted term subtracts
``attn_score_bytes``, as JAX's does.

*Collectives.* Every collective of the port is a
``distributed.all_reduce``, which appends each call's payload and group
size to ``distributed.collective_log`` while the dry run holds it. Wire
bytes are a ring all-reduce's, 2 (n - 1) / n x payload, over
``NVLINK.bandwidth`` (450e9 B/s): a lower bound, since 256 ranks span
nodes whose links are slower than NVLink. ``distributed.gather`` is an
all-reduce of a zero-padded buffer and is counted as what it sends, not
as an all-gather. There is no HLO: ``collectives`` holds the payload of
the one kind counted, ``collective_calls`` the calls.

*Memory a device.* ``arg_bytes_per_dev`` sums the rank's leaves (params,
AdamW's state, caches) and its rows of the batch, as JAX's argument
sizes; exact. ``temp_bytes_per_dev`` is the peak of live bytes the step
allocates (the outputs of ops that do not alias an input, each held
until its tensor is freed), ``out_bytes_per_dev`` the bytes the step
returns (its in-place state too); both from one step of the whole cell
at full depth, as JAX reads them from its full-depth compile. A peak is
no affine function of the depth or the sequence (the optimizer's
temporaries and the activations peak at different places), so it is not
extrapolated; the ssm family's full-depth train and prefill cells run
their sLSTM loop over every token for minutes.

*Depth.* ``extrapolated_cost`` runs each layer type at two reduced
depths and extrapolates affinely (JAX's method, which XLA needs because
its cost analysis counts a scanned body once): the port's counts are
exact at any depth, but a full-depth xLSTM step runs its sLSTM loop over
time for minutes on ``meta``. The xLSTM probes set ``slstm_every`` to 0
and 2, as JAX's (``transformer._abstract`` cannot build xlstm_1_3b at 2
or 4 layers with its own 8). The sLSTM layer's terms are a polynomial of
degree 2 in the sequence (one loop step a token; in the backward each
step's slice of the input takes a gradient the size of the whole
input), so in a train or prefill cell they are taken at three short
sequences (``SLSTM_SEQS``) and extrapolated to the cell's by the
quadratic through them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, applicable_shapes,
                                 get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.perfmodel.hardware import H100, NVLINK

# H100 roofline constants (per card)
PEAK_FLOPS = H100.flops       # bf16
HBM_BW = H100.mem_bw          # bytes/s
LINK_BW = NVLINK.bandwidth    # bytes/s

# the three short sequences the sLSTM layer's terms are taken at (each at
# most an mLSTM chunk or a multiple of one, as its chunked scan takes them)
SLSTM_SEQS = (32, 64, 96)
_TERMS = ("flops", "bytes", "wire", "calls")


def mesh_label(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def fake_world(world: int):
    """Make this process rank 0 of a "fake" process group of ``world``
    ranks (PyTorch's test backend: collectives return at once and move
    nothing), restarting it at another size. The mesh caches go with the
    old group (``forget_meshes``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
        forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def forget_meshes():
    """Clear the axis groups and plans that ``distributed`` caches by
    ``id(mesh)``: a mesh of another group may take a freed mesh's id."""
    from repro_torch import distributed as D
    D._AXES.clear()
    D._PLANS.clear()


def production_mesh(multi_pod: bool):
    """The production mesh (16, 16) or (2, 16, 16) over a fake group of
    its size."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


# ---------------------------------------------------------------------------

def attn_score_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic GLOBAL HBM bytes of materialized attention score/prob
    tiles (JAX's): the plain attention streams them through memory, the
    hand kernels keep them on chip, so the memory term of the card
    subtracts them. fwd ~12 B/elem (fp32 write + softmax pass + PV read),
    train ~3x for backward."""
    if cfg.attn_type == "none":
        return 0.0
    n_attn = cfg.num_layers
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // max(1, cfg.shared_attn_every)
    if shape.kind == "decode":
        elems = float(shape.global_batch) * cfg.num_heads * shape.seq_len * n_attn
        return 8.0 * elems
    causal = 0.5 if not cfg.encoder_only else 1.0
    elems = (causal * float(shape.seq_len) ** 2 * cfg.num_heads
             * shape.global_batch * n_attn)
    per_elem = 36.0 if shape.kind == "train" else 12.0
    return per_elem * elems


def wire_bytes(calls) -> float:
    """Bytes on the wire a rank sends for ``calls`` ((op, payload bytes,
    group size) each, ``distributed.collective_log``'s): a ring
    all-reduce sends 2 (n - 1) / n x its payload."""
    return sum(2.0 * (n - 1) / n * b for _, b, n in calls)


# ---------------------------------------------------------------------------
# counting

_ROUTED: list = []      # balanced routed rows of the open _moe_local calls


def _grouped_mm_flops(a_shape, b_shape, offs_shape=None, *args,
                      **kwargs) -> int:
    """``aten._grouped_mm``: a product per group, the rows of a 2-d
    operand split into groups by ``offs``; those rows counted at the
    balanced routed share while ``moe._moe_local`` runs (``_ROUTED``)."""
    def rows(m):
        return min(m, _ROUTED[-1]) if _ROUTED else m
    if len(a_shape) == 2 and len(b_shape) == 3:       # (M, K) x (G, K, N)
        return 2 * rows(a_shape[0]) * a_shape[1] * b_shape[2]
    if len(a_shape) == 2 and len(b_shape) == 2:       # (K, M) x (M, N)
        return 2 * a_shape[0] * rows(a_shape[1]) * b_shape[1]
    # the port's grouped products are these two: the experts' forward and
    # their gradient of the input, and their gradient of the weights
    raise NotImplementedError(f"_grouped_mm {a_shape} x {b_shape}")


_REGISTERED: list = []


def _register_formulas():
    from torch.utils.flop_counter import register_flop_formula
    if not _REGISTERED:
        register_flop_formula(torch.ops.aten._grouped_mm)(_grouped_mm_flops)
        _REGISTERED.append(True)


@contextlib.contextmanager
def _balanced_routing():
    """While open, each ``moe._moe_local`` call pushes its balanced routed
    rows for the grouped products it makes."""
    from repro_torch.models import moe
    saved = moe._moe_local

    def local(x2d, wi, wo, weights, idx, cfg, expert_offset, num_local,
              capacity):
        _ROUTED.append(x2d.shape[0] * idx.shape[1] * num_local
                       / max(1, cfg.moe.num_experts))
        try:
            return saved(x2d, wi, wo, weights, idx, cfg, expert_offset,
                         num_local, capacity)
        finally:
            _ROUTED.pop()
    moe._moe_local = local
    try:
        yield
    finally:
        moe._moe_local = saved


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}
# ops that alias their input without being flagged views, or move nothing
_NO_TRAFFIC = {"_unsafe_view", "set_", "resize_"}


class _Traffic(TorchDispatchMode):
    """Each dispatched op's operand and output bytes (``bytes``, with
    ``count_bytes``), and the peak of live bytes (``peak``) of outputs
    that alias no operand (an in-place op returns its first operand)."""

    def __init__(self, count_bytes: bool = True):
        super().__init__()
        self.count_bytes = count_bytes
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if (func.namespace in ("c10d", "_c10d_functional") or func.is_view
                or name in _NO_TRAFFIC):
            return out
        if self.count_bytes:
            ins = {id(t): t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
        else:
            ins = {id(t): t for t in args if isinstance(t, torch.Tensor)}
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.count_bytes and name not in _ALLOC:
            self.bytes += (sum(_nbytes(t) for t in ins.values())
                           + sum(_nbytes(t) for t in outs))
        for t in outs:
            if id(t) not in ins:
                n = _nbytes(t)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in {id(t): t for t in tree_leaves(tree)
                                    if isinstance(t, torch.Tensor)}.values())


def _cold_caches():
    """Empty the model's host-side caches (rope frequencies, the rounded
    embedding scale), so every counted step makes them once: the counts
    do not hang on which cell ran before."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    layers.rope_frequencies.cache_clear()
    tf._rounded_sqrt.cache_clear()


def _peak(fn, args):
    """(peak live bytes, bytes returned) of one call of ``fn(*args)``."""
    _cold_caches()
    with _Traffic(count_bytes=False) as tr:
        out = fn(*args)
        out_b = _tree_bytes(out)
        del out
    return float(tr.peak), float(out_b)


def _measure(fn, args) -> Dict:
    """One call of ``fn(*args)`` counted: flops, bytes, the all-reduces'
    wire bytes and calls, peak live bytes and the bytes it returns."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import distributed as D
    _register_formulas()
    _cold_caches()
    calls = []
    D.collective_log = calls
    try:
        with _balanced_routing(), FlopCounterMode(display=False) as fc, \
                _Traffic() as tr:
            out = fn(*args)
            out_b = _tree_bytes(out)
            del out
    finally:
        D.collective_log = None
    return {"flops": float(fc.get_total_flops()), "bytes": float(tr.bytes),
            "wire": wire_bytes(calls), "calls": float(len(calls)),
            "temp": float(tr.peak), "out": float(out_b),
            "collectives": {"all-reduce": float(sum(b for _, b, _ in calls))}}


# ---------------------------------------------------------------------------
# the cell

def _nested(flat: Dict) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _rules(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp=None):
    from repro_torch.models.sharding import ShardingRules
    if fsdp is None:
        fsdp = shape.kind == "train" and cfg.param_count() > 30e9
    seq_sharded = shape.kind == "decode" and shape.global_batch == 1
    return ShardingRules(mesh, fsdp=fsdp, seq_sharded=seq_sharded)


def _cache_len(cfg: ModelConfig, shape: ShapeConfig, rules) -> int:
    """``seq_len + 8`` (JAX's), rounded up to a multiple of the group the
    caches' positions split over (``distributed.cache_groups``)."""
    from repro_torch import distributed as D
    n = math.prod(rules.axis_sizes[a]
                  for a in D.cache_groups(cfg, rules)[1])
    return -(-(shape.seq_len + 8) // n) * n


def _batch(cfg: ModelConfig, shape: ShapeConfig):
    """(the global batch on ``meta``, its leaves' logical axes): JAX's
    ``steps.input_specs`` and ``batch_axes``."""
    b, s = shape.global_batch, shape.seq_len

    def t(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "decode":
        return {"tokens": t(b, 1)}, {"tokens": ("batch", None)}
    if cfg.stub_frontend:
        batch = {"embeds": t(b, s, cfg.frontend_dim, dtype=torch.bfloat16)}
        axes = {"embeds": ("batch", "seq", None)}
    else:
        batch, axes = {"tokens": t(b, s)}, {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        batch["labels"], axes["labels"] = t(b, s), ("batch", "seq")
    return batch, axes


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp=None):
    """(fn, args, arg_bytes): the cell's step and its ``meta`` arguments
    (rank 0's shards), and the bytes of the rank's leaves and batch
    rows. A serving step runs without autograd, as the engines run it
    (its row-parallel sums then take their fp32 partials)."""
    import functools
    from repro_torch import distributed as D
    from repro_torch import weights
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import Initializer
    from repro_torch.models.optim import init_opt_state
    rules = _rules(cfg, shape, mesh, fsdp)
    specs = _nested(tf.param_specs(cfg, rules))
    params = weights.shard_params(tf._build(cfg, Initializer(cfg, None,
                                                             "meta")),
                                  specs, mesh, device="meta")
    batch, axes = _batch(cfg, shape)
    arg_bytes = _tree_bytes(params) + sum(
        math.prod(D.local_shape(v.shape, rules.spec(v.shape, axes[k]), mesh))
        * v.element_size() for k, v in batch.items())
    if shape.kind == "train":
        state = {"params": params, "opt": init_opt_state(params)}
        fn = functools.partial(steps.train_step, cfg=cfg, rules=rules,
                               mesh=mesh)
        return fn, (state, batch), arg_bytes + _tree_bytes(state["opt"])
    max_len = _cache_len(cfg, shape, rules)
    if shape.kind == "prefill":
        fn = functools.partial(steps.prefill_step, cfg=cfg, max_len=max_len,
                               rules=rules, mesh=mesh)
        return torch.no_grad()(fn), (params, batch), arg_bytes
    caches = tf.init_cache(cfg, shape.global_batch, max_len, "meta", rules,
                           mesh)
    fn = functools.partial(steps.serve_step, cfg=cfg, rules=rules, mesh=mesh)
    return torch.no_grad()(fn), (params, batch["tokens"], caches), \
        arg_bytes + _tree_bytes(caches)


def _cost_of(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp=None) -> Dict:
    """The counted terms of one step of the cell at ``cfg``'s depth."""
    fn, args, _ = build_cell(cfg, shape, mesh, fsdp)
    return _measure(fn, args)


def _axpy(base, per, n):
    out = {k: base[k] + n * per[k] for k in _TERMS}
    out["collectives"] = {k: base["collectives"].get(k, 0.0)
                          + n * per["collectives"].get(k, 0.0)
                          for k in set(base["collectives"])
                          | set(per["collectives"])}
    return out


def _diff(c2, c1, denom):
    out = {k: (c2[k] - c1[k]) / denom for k in _TERMS}
    out["collectives"] = {k: (c2["collectives"].get(k, 0.0)
                              - c1["collectives"].get(k, 0.0)) / denom
                          for k in set(c2["collectives"])
                          | set(c1["collectives"])}
    return out


def _combo(*terms):
    """The terms' sum of ``coef x cost`` over (coef, cost) pairs."""
    out = _axpy(terms[0][1], terms[0][1], terms[0][0] - 1)
    for coef, cost in terms[1:]:
        out = _axpy(out, cost, coef)
    return out


def _slstm_terms(cfg: ModelConfig, shape: ShapeConfig, mesh, fsdp, pure_m,
                 mixed):
    """(the sLSTM leaves' own fixed terms, one sLSTM layer's terms): at
    the cell's sequence for a decode, else at the three ``SLSTM_SEQS``
    and extrapolated to it by the quadratic through them. With groups of
    one mLSTM and one sLSTM (``slstm_every`` 2) at 2 and 4 layers and
    pure mLSTM models at 2 and 4: one group adds an mLSTM and an sLSTM,
    and the fixed part is what the 2-layer mixed model holds beyond the
    pure one's base and its group, 2 cS2 - cS4 - (2 cM2 - cM4)."""
    def at(sh):
        cM2 = _cost_of(cfg.replace(num_layers=2, xlstm=pure_m), sh, mesh, fsdp)
        cM4 = _cost_of(cfg.replace(num_layers=4, xlstm=pure_m), sh, mesh, fsdp)
        cS2 = _cost_of(cfg.replace(num_layers=2, xlstm=mixed), sh, mesh, fsdp)
        cS4 = _cost_of(cfg.replace(num_layers=4, xlstm=mixed), sh, mesh, fsdp)
        fixed = _combo((2, cS2), (-1, cS4), (-2, cM2), (1, cM4))
        # cS4-cS2 = one (1 mLSTM + 1 sLSTM) group => per_s = diff - per_m
        return fixed, _axpy(_diff(cS4, cS2, 1), _diff(cM4, cM2, 2), -1)
    if shape.kind == "decode":
        return at(shape)
    pts = [at(dataclasses.replace(shape, seq_len=s)) for s in SLSTM_SEQS]
    coef = _lagrange(SLSTM_SEQS, shape.seq_len)
    return tuple(_combo(*[(c, p[i]) for c, p in zip(coef, pts)])
                 for i in (0, 1))


def _lagrange(xs, x):
    """The weights of the values at ``xs`` whose sum is the quadratic
    through them at ``x``."""
    return [math.prod((x - b) / (a - b) for b in xs if b != a) for a in xs]


def extrapolated_cost(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      fsdp=None) -> Dict:
    """Per-layer terms counted at two reduced depths a layer type and
    scaled to the full depth (affine in the per-type layer counts; JAX's
    probes and depths; the hybrid's from its one-application probe, whose
    first application differs from the later ones)."""
    L = cfg.num_layers
    if cfg.family in ("dense", "vlm", "audio"):
        c2 = _cost_of(cfg.replace(num_layers=2), shape, mesh, fsdp)
        c4 = _cost_of(cfg.replace(num_layers=4), shape, mesh, fsdp)
        per = _diff(c4, c2, 2)
        base = _axpy(c2, per, -2)
        return _axpy(base, per, L)
    if cfg.family == "moe":
        kd = cfg.moe.first_k_dense
        cA = _cost_of(cfg.replace(num_layers=kd + 2), shape, mesh, fsdp)
        cB = _cost_of(cfg.replace(num_layers=kd + 4), shape, mesh, fsdp)
        per = _diff(cB, cA, 2)           # per MoE layer
        base = _axpy(cA, per, -2)        # includes the kd dense layers
        return _axpy(base, per, L - kd)
    if cfg.family == "hybrid":
        n_apps = L // cfg.shared_attn_every
        cM2 = _cost_of(cfg.replace(num_layers=2, shared_attn_every=0), shape, mesh, fsdp)
        cM4 = _cost_of(cfg.replace(num_layers=4, shared_attn_every=0), shape, mesh, fsdp)
        per_m = _diff(cM4, cM2, 2)       # per mamba layer
        cS1 = _cost_of(cfg.replace(num_layers=2, shared_attn_every=2), shape, mesh, fsdp)
        cS2 = _cost_of(cfg.replace(num_layers=4, shared_attn_every=2), shape, mesh, fsdp)
        # cS2-cS1 = 2 mamba layers + 1 shared app  =>  shared = diff - 2*per_m
        shared = _axpy(_diff(cS2, cS1, 1), per_m, -2)
        # the first application is cS1's (the shared weights' gradient is
        # written there and added to by every later one, and their AdamW
        # step is once): cS1 + (L - 2) mamba layers + (n_apps - 1) apps
        out = _axpy(cS1, per_m, L - 2)
        return _axpy(out, shared, n_apps - 1)
    if cfg.family == "ssm":
        g = cfg.xlstm.slstm_every
        n_groups = L // g
        pure_m = dataclasses.replace(cfg.xlstm, slstm_every=0)
        mixed = dataclasses.replace(cfg.xlstm, slstm_every=2)
        cM2 = _cost_of(cfg.replace(num_layers=2, xlstm=pure_m), shape, mesh, fsdp)
        cM4 = _cost_of(cfg.replace(num_layers=4, xlstm=pure_m), shape, mesh, fsdp)
        per_m = _diff(cM4, cM2, 2)       # per mLSTM block
        base = _axpy(cM2, per_m, -2)
        fixed, per_s = _slstm_terms(cfg, shape, mesh, fsdp, pure_m, mixed)
        out = _axpy(_axpy(base, fixed, 1), per_m, n_groups * (g - 1))
        return _axpy(out, per_s, n_groups)
    raise ValueError(cfg.family)


def terms(cfg: ModelConfig, shape: ShapeConfig, cost: Dict,
          n_chips: int) -> Dict:
    """A cell's roofline terms on the H100 from its counts a device
    (``cost``: ``extrapolated_cost``'s or ``_measure``'s), JAX's keys."""
    compute_term = cost["flops"] / PEAK_FLOPS
    memory_term = cost["bytes"] / HBM_BW
    # flash-adjusted: the hand kernels keep the score tiles on chip
    adj_bytes = max(cost["bytes"] - attn_score_bytes(cfg, shape) / n_chips,
                    0.05 * cost["bytes"])
    memory_term_flash = adj_bytes / HBM_BW
    collective_term = cost["wire"] / LINK_BW
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.tokens
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * shape.tokens
    else:
        model_flops = 2.0 * n_active * shape.global_batch
    flops_global = cost["flops"] * n_chips
    dominant = max((("compute", compute_term),
                    ("memory", memory_term_flash),
                    ("collective", collective_term)), key=lambda kv: kv[1])[0]
    return {"compute_term_s": compute_term, "memory_term_s": memory_term,
            "memory_term_flash_s": memory_term_flash,
            "collective_term_s": collective_term, "dominant": dominant,
            "model_flops": model_flops,
            "useful_flops_ratio": (model_flops / flops_global
                                   if flops_global else 0.0)}


def run_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
             verbose: bool = True, cfg_override=None, with_cost: bool = True,
             fsdp=None) -> Dict:
    """JAX's ``run_cell`` on the port: the result row with JAX's keys
    (and ``collective_calls``). The memory a device comes from one step
    of the cell at the config's depth; with ``with_cost`` the terms come
    from ``extrapolated_cost``, else from that same step. JAX's
    ``donate`` and ``donate_cache`` have no counterpart: the port's train
    step updates its state in place and its decode writes its caches in
    place."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    # resolve FSDP on the FULL config: the reduced-depth cost probes must
    # use the same weight-sharding mode as the full cell
    if fsdp is None:
        fsdp = shape.kind == "train" and cfg.param_count() > 30e9
    t0 = time.time()
    fn, args, arg_bytes = build_cell(cfg, shape, mesh, fsdp)
    if with_cost:
        temp, out = _peak(fn, args)
        del fn, args
        cost = extrapolated_cost(cfg, shape, mesh, fsdp)
    else:
        cost = _measure(fn, args)
        temp, out = cost["temp"], cost["out"]
    t_run = time.time() - t0
    n_chips = int(mesh.mesh.numel())
    t = terms(cfg, shape, cost, n_chips)
    res = {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_label(multi_pod),
        "n_chips": n_chips,
        "compile_s": round(t_run, 1),
        "flops_per_dev": cost["flops"],
        "bytes_per_dev": cost["bytes"],
        "wire_bytes_per_dev": cost["wire"],
        "collectives": {k: round(v, 1) for k, v in
                        cost["collectives"].items() if v},
        "collective_calls": {"all-reduce": round(cost["calls"])},
        **t,
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
        "arg_bytes_per_dev": int(arg_bytes),
        "temp_bytes_per_dev": int(temp),
        "out_bytes_per_dev": int(out),
    }
    if verbose:
        print(log_line(res), flush=True)
    return res


def log_line(res: Dict) -> str:
    """The printed line of a result row (``parse_dryrun_log`` inverts it)."""
    return (f"[dryrun] {res['arch']:22s} {res['shape']:12s} "
            f"mesh={res['mesh']:8s} compile={res['compile_s']:6.1f}s "
            f"dom={res['dominant']:10s} "
            f"C={res['compute_term_s']*1e3:9.3f}ms "
            f"M={res['memory_term_s']*1e3:9.3f}ms "
            f"Mf={res['memory_term_flash_s']*1e3:9.3f}ms "
            f"N={res['collective_term_s']*1e3:9.3f}ms "
            f"useful={res['useful_flops_ratio']:5.2f} "
            f"args/dev={res['arg_bytes_per_dev']/1e9:6.2f}GB "
            f"temp/dev={res['temp_bytes_per_dev']/1e9:6.2f}GB")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    results = []
    pods = [False, True] if args.both_meshes else [args.multi_pod]
    arch_list = [a for a in ARCH_IDS if a != "llama3_70b"] if args.all \
        else args.arch.split(",")

    def _flush():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    # one mesh at a time: the fake group is global to the process
    for mp in pods:
        mesh = production_mesh(mp)
        for arch in arch_list:
            cfg = get_config(arch)
            shapes = ([SHAPES_BY_NAME[args.shape]] if args.shape
                      else applicable_shapes(cfg))
            for sh in shapes:
                try:
                    results.append(run_cell(arch, sh.name, mesh, mp))
                except Exception as e:  # a failing cell is a bug: surface it
                    print(f"[dryrun] FAIL {arch} {sh.name} {mesh_label(mp)}: "
                          f"{type(e).__name__}: {e}", flush=True)
                    results.append({"arch": arch, "shape": sh.name,
                                    "mesh": mesh_label(mp),
                                    "error": f"{type(e).__name__}: {e}"})
                _flush()  # incremental: survive a killed sweep
    n_fail = sum(1 for r in results if "error" in r)
    print(f"[dryrun] {len(results) - n_fail}/{len(results)} cells OK")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
