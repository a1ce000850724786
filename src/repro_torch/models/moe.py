"""Mixture-of-Experts, DeepSeek-V2 style: shared experts plus routed top-k
experts (twin of ``repro.models.moe`` on one card).

Two interchangeable implementations, as in the JAX package:

* ``moe_ragged`` (``MoEConfig.impl == "ragged_ep"``, the default): the
  ``T·k`` routed rows sorted by expert, and JAX's ``lax.ragged_dot`` as
  ``torch._grouped_mm`` with the group ends on the device, so the work
  tracks the routed rows only;
* ``moe_dispatch_einsum``: the GShard capacity-based dispatch/combine
  einsums, dropping the rows past each expert's capacity as JAX does.

Both run under autograd (training): the router's top-k weights and its
aux through the mean probabilities take gradients, the one-hot density
none, as in JAX; a row dropped past an expert's capacity gets a zero
gradient. Both keep every shape static and read no value back to the host
(no ``bincount``, ``repeat_interleave`` or boolean-mask indexing), so the
SlotEngine's decode pass that runs them captures as a CUDA graph. Each
row's routed outputs are summed over its ``k`` choices in a fixed order (a
scatter of distinct rows, then a sum), not with atomics, so two runs agree
bit for bit. Under a mesh ``moe_ragged`` runs expert parallelism (JAX's
``shard_map`` over the "model" axis) on the rank's shards, and
``moe_dispatch_einsum`` runs the one program JAX's compiler lays out: the
groups, the slots and the capacity of the whole batch, each model rank
computing its experts' slots.
``moe_reference`` is the dense loop-over-experts oracle, for tests.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import distributed as dist_
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Initializer, apply_mlp, gelu, init_mlp


def init_moe(init: Initializer, cfg: ModelConfig) -> Dict:
    d, m = cfg.d_model, cfg.moe
    f = m.expert_d_ff
    glu = cfg.mlp_type in ("swiglu", "geglu")
    p = {
        "router": init.w((d, m.num_experts), ("w_embed", "experts"),
                         scale=d ** -0.5),
        "wi": init.w((m.num_experts, d, 2 * f if glu else f),
                     ("experts", "w_embed", "ff")),
        "wo": init.z((m.num_experts, f, d), ("experts", "ff", "w_embed")),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(init, cfg, d_ff=m.shared_d_ff)
    return p


def _activate(h, cfg: ModelConfig):
    if cfg.mlp_type in ("swiglu", "geglu"):
        gate, up = h.chunk(2, dim=-1)
        act = F.silu(gate) if cfg.mlp_type == "swiglu" else gelu(gate)
        return act * up
    if cfg.mlp_type == "relu2":
        return torch.relu(h).square()
    return gelu(h)


def _one_hot(idx, n: int):
    """fp32 one-hot by comparison (``F.one_hot`` checks its range on the
    host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _router(params, x2d, cfg: ModelConfig):
    """x2d (T, d) -> (weights (T, k) fp32, idx (T, k), aux loss)."""
    return _route(x2d.float() @ params["router"].float(), cfg)


def _route(logits, cfg: ModelConfig, data=None):
    """Router logits (T, E) fp32 -> (weights, idx, aux). With ``data`` (an
    axis group holding the other rows of the batch) the aux's means are
    over every rank's rows, as one program over the whole batch takes
    them."""
    m = cfg.moe
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, m.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balancing aux loss
    if data is None or data.size == 1:
        density = _one_hot(idx, m.num_experts).mean(dim=(0, 1))
        mean_probs = probs.mean(0)
    else:
        T = probs.shape[0] * data.size
        hits = dist_.all_reduce(_one_hot(idx, m.num_experts).sum((0, 1)),
                                data)
        density = hits / (T * m.top_k)
        mean_probs = dist_.reduce_out(probs.sum(0), data) / T
    aux = m.num_experts * torch.sum(density * mean_probs) * m.aux_loss_coef
    return weights, idx, aux


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on its gradient contiguous:
    ``torch._grouped_mm``'s backward raises "Invalid strides/sizes" on a
    stride-0 gradient (an ``expand``, as a ``sum``'s backward gives)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def ragged_dot(x, w, group_sizes):
    """JAX's ``lax.ragged_dot``: rows ``[o_g, o_g + group_sizes[g])`` of x
    (M, K) times ``w[g]`` (K, N), ``o_g`` the sizes before g; the rows past
    the last group are left for the caller to mask. Under autograd the
    gradient is ``torch._grouped_mm``'s backward, given a contiguous
    incoming gradient."""
    ends = torch.cumsum(group_sizes, 0).to(torch.int32)
    y = torch._grouped_mm(x, w, offs=ends)
    if torch.is_grad_enabled() and y.requires_grad:
        y = _ContiguousGrad.apply(y)
    return y


def _capacity(tokens: int, k: int, num_experts: int, num_local: int,
              slack: float) -> int:
    expected = tokens * k * num_local / max(1, num_experts)
    cap = int(math.ceil(expected * slack))
    cap = max(cap, k)
    return min(max(cap, 8), tokens * k)


def _moe_local(x2d, wi, wo, weights, idx, cfg: ModelConfig,
               expert_offset: int, num_local: int, capacity: int):
    """Contribution of experts ``[expert_offset, expert_offset +
    num_local)`` to every token: x2d (T, d), wi (num_local, d, F), wo
    (num_local, f, d), weights/idx (T, k). Returns (T, d).

    The ``T·k`` routed rows are sorted by local expert (stable; rows of
    other shards' experts sort last) and the first ``capacity`` taken;
    group sizes come from a scatter-add of ones, cut where the take ends,
    so a row past the capacity (or of another shard's expert) is dropped
    as in JAX.
    """
    T, d = x2d.shape
    k = idx.shape[1]
    rows = T * k
    eid = idx.reshape(rows)
    tok = torch.arange(T, device=x2d.device)[:, None].expand(T, k).reshape(-1)
    w = weights.reshape(rows)
    local = (eid >= expert_offset) & (eid < expert_offset + num_local)
    local_eid = torch.where(local, eid - expert_offset, num_local)
    order = torch.argsort(local_eid, stable=True)   # local rows by expert
    capacity = min(capacity, rows)
    take = order[:capacity]
    w_sel = w[take]
    counts = torch.zeros(num_local + 1, dtype=torch.int64, device=x2d.device)
    counts.scatter_add_(0, local_eid, torch.ones_like(local_eid))
    counts = counts[:num_local]
    cum = torch.cumsum(counts, 0)
    gs = torch.clamp(counts - torch.clamp(cum - capacity, min=0), min=0)
    valid = (torch.arange(capacity, device=x2d.device) < gs.sum())[:, None]
    # ragged_dot leaves the rows past the last group unwritten: their
    # gradient is dropped here (JAX's ragged_dot gives them zeros)
    x_sel = torch.where(valid, x2d[tok[take]], 0.0)
    h = _activate(ragged_dot(x_sel, wi, gs), cfg)
    y = ragged_dot(h, wo, gs)
    y = torch.where(valid, y, 0.0) * w_sel[:, None].to(y.dtype)
    # each taken row back at its (token, choice) place, then the k choices
    # summed in order: JAX's scatter-add without atomics
    per_row = y.new_zeros(rows, d).index_copy_(0, take, y)
    return per_row.view(T, k, d).sum(1)


def _moe_global_cut(x2d, wi, wo, weights, idx, cfg: ModelConfig,
                    capacity: int, data):
    """Every expert on this rank over its rows of a batch split over the
    data axes (``data``), with JAX's one stable sort over the whole batch:
    a row's place in it is the rows of lower experts on every rank, then
    the rows of its expert on earlier ranks, then its place among this
    rank's; the rows at places past ``capacity`` are dropped. One
    all-reduce of a (ranks x experts) count matrix gives the places."""
    T, d = x2d.shape
    E = wi.shape[0]
    k = idx.shape[1]
    rows = T * k
    eid = idx.reshape(rows)
    tok = torch.arange(T, device=x2d.device)[:, None].expand(T, k).reshape(-1)
    w = weights.reshape(rows)
    counts = torch.zeros(E, dtype=torch.int64, device=x2d.device)
    counts.scatter_add_(0, eid, torch.ones_like(eid))
    grid = torch.zeros(data.size, E, dtype=torch.int64, device=x2d.device)
    grid[data.index] = counts
    dist_.all_reduce(grid, data)
    total = grid.sum(0)
    base = (torch.cumsum(total, 0) - total) + grid[:data.index].sum(0)
    capacity = min(capacity, rows * data.size)
    taken = torch.clamp(capacity - base, min=0)       # per expert, this rank
    order = torch.argsort(eid, stable=True)
    e_sorted = eid[order]
    start = torch.cumsum(counts, 0) - counts
    place = torch.arange(rows, device=x2d.device) - start[e_sorted]
    valid = (place < taken[e_sorted])[:, None]
    h = _activate(ragged_dot(x2d[tok[order]], wi, counts), cfg)
    y = ragged_dot(h, wo, counts)
    y = torch.where(valid, y, 0.0) * w[order][:, None].to(y.dtype)
    per_row = y.new_zeros(rows, d).index_copy_(0, order, y)
    return per_row.view(T, k, d).sum(1)


def moe_ragged(params, x, cfg: ModelConfig, mesh=None, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (same shape, aux loss). Under a mesh (``tp``, the
    module's ``distributed.Layout``; built from ``mesh`` when only it is
    given) ``params`` and ``x`` are this rank's shards and rows.

    Expert parallelism holds, as in JAX, when "model" is in the mesh,
    larger than 1 and divides the experts: each model rank holds ``wi``/
    ``wo`` of its ``num_local`` experts and the router's columns of them
    (stored split on ``experts``; its logits are gathered along them
    before the softmax and top-k, as JAX's shard_map takes the router
    whole), routes its data shard's rows, takes JAX's per-shard capacity
    ``_capacity(T_local, k, E, num_local, slack)`` and sums the experts'
    contributions over "model" (reduce-out: JAX's ``psum``). The aux is
    each data shard's own, as JAX's shard map computes it (its ``pmean``
    over "model" averages equal values; its gradient is shared over the
    model ranks). Without expert parallelism over data shards every rank
    holds every expert and cuts the capacity over the whole batch
    (``_moe_global_cut``), as JAX's one program does."""
    if tp is None and mesh is not None:
        tp = dist_.moe_layout(cfg, mesh)
    m = cfg.moe
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    T = x2d.shape[0]
    if tp is None or (tp.model.size == 1 and tp.batch.size == 1):
        weights, idx, aux = _router(params, x2d, cfg)
        cap = _capacity(T, m.top_k, m.num_experts, m.num_experts,
                        m.capacity_slack)
        out = _moe_local(x2d, params["wi"], params["wo"], weights, idx, cfg,
                         0, m.num_experts, cap)
        return out.reshape(shape).to(x.dtype), aux
    M = tp.model.size
    if M > 1:
        num_local = m.num_experts // M
        xin, logits = _ep_logits(params, x2d, cfg, tp)
        weights, idx, aux = _route(logits, cfg)
        cap = _capacity(T, m.top_k, m.num_experts, num_local,
                        m.capacity_slack)
        out = _moe_local(xin, params["wi"], params["wo"], weights, idx, cfg,
                         tp.model.index * num_local, num_local, cap)
        # every model rank's aux gradient reaches the router's logits
        # through the gather's summed backward: each carries 1/M of it
        aux = dist_.grad_scale(aux, 1.0 / M)
        return tp.reduce_out(out).reshape(shape).to(x.dtype), aux
    weights, idx, aux = _route(x2d.float() @ params["router"].float(), cfg,
                               tp.batch)
    cap = _capacity(T * tp.batch.size, m.top_k, m.num_experts, m.num_experts,
                    m.capacity_slack)
    out = _moe_global_cut(x2d, params["wi"], params["wo"], weights, idx, cfg,
                          cap, tp.batch)
    # the aux is the whole batch's on every data rank; the loss averages
    # it over them, so each rank's share of its gradient is scaled back
    return (out.reshape(shape).to(x.dtype),
            dist_.grad_scale(aux, float(tp.batch.size)))


def _ep_logits(params, x2d, cfg: ModelConfig, tp):
    """(the rows as the experts' products take them, the router's fp32
    logits over every expert) under expert parallelism (``tp.model`` >
    1): the rank's experts' logits gathered along them, as JAX's shard map
    takes the router whole. Refuses a layout whose experts are not split
    over "model"."""
    m = cfg.moe
    if (m.num_experts % tp.model.size or tp.dim("wi") != 0
            or tp.dim("wo") != 0 or tp.dim("router") != 1):
        tp.refuse("wi", "expert parallelism needs the experts split "
                  "over 'model'")
    xin = tp.copy_in(x2d)
    return xin, tp.gather(xin.float() @ params["router"].float(), -1)


def _dispatch_groups(rows: int, ranks: int, index: int, group_size: int):
    """JAX's groups of the whole batch's ``rows * ranks`` rows (of
    ``group_size``, or one group when they do not divide), seen from the
    rank ``index`` of ``ranks`` holding global rows ``[index * rows,
    (index + 1) * rows)``: (group size, the number of groups, the first
    group the rank's rows fall in, how many groups they span, the global
    rows of that first group before the rank's)."""
    total = rows * ranks
    g_sz = min(group_size, total)
    if total % g_sz:
        g_sz = total
    off = index * rows
    first = off // g_sz
    return (g_sz, total // g_sz, first,
            (off + rows - 1) // g_sz - first + 1, off - first * g_sz)


def moe_dispatch_einsum(params, x, cfg: ModelConfig, mesh=None,
                        group_size: int = 4096, tp=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GShard dispatch/combine formulation: each expert takes at most
    ``cap_per_e`` of a group's assignments, in (token, choice) order.
    ``mesh`` alone is taken and not used, as in JAX (whose compiler lays
    the einsums out).

    Under a mesh (``tp``, the module's ``distributed.Layout``) ``params``
    and ``x`` are the rank's shards and rows, and the values are those of
    JAX's one program over the whole batch: the groups come from the
    global row count, ``cap_per_e`` from the global group size, and an
    assignment's slot counts the assignments to its expert before it in
    its group on every rank (this rank's rows in order, after an exclusive
    prefix over the lower ranks of the rows' group: one all-reduce of a
    (ranks, groups, experts) count grid). The rank's rows are laid into
    the groups they fall in (zero rows elsewhere, which take no slot).
    With experts split over "model" a rank computes the dispatch, the
    products and the combine of its experts only, and the contributions
    are summed over "model" (reduce-out). The router's aux is the whole
    batch's (its means over every row, as one program takes them)."""
    if tp is None and mesh is not None:
        tp = dist_.moe_layout(cfg, mesh)
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    T, d = x2d.shape
    M = 1 if tp is None else tp.model.size
    rows = dist_.ONE if tp is None else tp.batch
    if M > 1:
        x2d, logits = _ep_logits(params, x2d, cfg, tp)
        weights, idx, aux = _route(logits, cfg, rows)
    elif rows.size > 1:
        weights, idx, aux = _route(x2d.float() @ params["router"].float(),
                                   cfg, rows)
    else:
        weights, idx, aux = _router(params, x2d, cfg)
    # each rank's share of the aux's gradient: the model ranks each hold
    # the whole aux (the gather's backward sums their gradients), and the
    # loss averages the rows' ranks' equal values
    aux = dist_.grad_scale(aux, rows.size / M)
    g_sz, n_all, first, n_groups, lead = _dispatch_groups(
        T, rows.size, rows.index, group_size)
    pad = n_groups * g_sz - lead - T
    xg = F.pad(x2d, (0, 0, lead, pad)).reshape(n_groups, g_sz, d)
    wg = F.pad(weights, (0, 0, lead, pad)).reshape(n_groups, g_sz, k)
    # -1 marks the rows of other ranks: they meet no expert
    ig = F.pad(idx, (0, 0, lead, pad), value=-1).reshape(n_groups, g_sz, k)

    mean_load = g_sz * k / E
    cap_per_e = min(max(int(math.ceil(mean_load * m.capacity_slack)), 4),
                    g_sz * k)

    a_sz = g_sz * k
    onehot = _one_hot(ig.reshape(n_groups, a_sz), E)            # (g,a,e)
    pos = torch.cumsum(onehot, dim=1) - onehot                  # slot per e
    if rows.size > 1:
        grid = onehot.new_zeros(rows.size, n_all, E)
        grid[rows.index, first:first + n_groups] = onehot.sum(1)
        dist_.all_reduce(grid, rows)
        pos = pos + grid[:rows.index, first:first + n_groups].sum(0)[:, None]
    posidx = torch.sum(pos * onehot, dim=-1)                    # (g,a)
    keep = (posidx < cap_per_e).float()
    slot = _one_hot(posidx, cap_per_e)                          # (g,a,c)
    lo = 0 if tp is None else tp.model.index * (E // M)
    local = onehot[:, :, lo:lo + E // M]
    disp_a = local[:, :, :, None] * slot[:, :, None, :] * keep[:, :, None,
                                                               None]
    disp_a = disp_a.reshape(n_groups, g_sz, k, E // M, cap_per_e)
    dispatch = torch.sum(disp_a, dim=2)                         # (g,s,e,c)
    combine = torch.einsum("gskec,gsk->gsec", disp_a, wg.float())

    xd = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    h = torch.einsum("gecd,edf->gecf", xd, params["wi"])
    h = _activate(h, cfg)
    y = torch.einsum("gecf,efd->gecd", h, params["wo"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(y.dtype), y)
    out = out.reshape(-1, d)[lead:lead + T]
    if M > 1:
        out = tp.reduce_out(out)
    return out.reshape(shape).to(x.dtype), aux


def apply_moe(params, x, cfg: ModelConfig, mesh=None, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if tp is None and mesh is not None:
        tp = dist_.moe_layout(cfg, mesh)
    if cfg.moe.impl == "dispatch_einsum":
        out, aux = moe_dispatch_einsum(params, x, cfg, mesh, tp=tp)
    else:
        out, aux = moe_ragged(params, x, cfg, mesh, tp)
    if cfg.moe.num_shared_experts:
        out = out + apply_mlp(params["shared"], x, cfg,
                              None if tp is None else tp.sub("shared"))
    return out, aux


def moe_reference(params, x, cfg: ModelConfig) -> torch.Tensor:
    """Dense loop-over-experts oracle in fp32 (no capacity drops). Tests
    only."""
    m = cfg.moe
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).float()
    weights, idx, _ = _router(params, x2d, cfg)
    out = torch.zeros_like(x2d)
    for e in range(m.num_experts):
        h = _activate(x2d @ params["wi"][e].float(), cfg)
        y = h @ params["wo"][e].float()
        w_e = torch.where(idx == e, weights, 0.0).sum(-1)
        out = out + y * w_e[:, None]
    if m.num_shared_experts:
        out = out + apply_mlp(params["shared"], x2d.to(x.dtype), cfg).float()
    return out.reshape(shape).to(x.dtype)
