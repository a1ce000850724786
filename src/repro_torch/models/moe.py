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
bit for bit. Expert parallelism (JAX's ``shard_map`` over the "model"
axis) arrives with the distribution slice: a mesh raises here.
``moe_reference`` is the dense loop-over-experts oracle, for tests.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Initializer, apply_mlp, gelu, init_mlp


def init_moe(init: Initializer, cfg: ModelConfig) -> Dict:
    d, m = cfg.d_model, cfg.moe
    f = m.expert_d_ff
    glu = cfg.mlp_type in ("swiglu", "geglu")
    p = {
        "router": init.w((d, m.num_experts), scale=d ** -0.5),
        "wi": init.w((m.num_experts, d, 2 * f if glu else f)),
        "wo": init.z((m.num_experts, f, d)),
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
    m = cfg.moe
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, m.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balancing aux loss
    density = _one_hot(idx, m.num_experts).mean(dim=(0, 1))
    aux = m.num_experts * torch.sum(density * probs.mean(0)) * m.aux_loss_coef
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


def _moe_local(x2d, wi, wo, weights, idx, cfg: ModelConfig, capacity: int):
    """Every expert's contribution to every token on one card: x2d (T, d),
    wi (E, d, F), wo (E, f, d), weights/idx (T, k). Returns (T, d).

    The ``T·k`` routed rows are sorted by expert (stable) and the first
    ``capacity`` taken; group sizes come from a scatter-add of ones, cut
    where the take ends, so a row past the capacity is dropped as in JAX.
    """
    T, d = x2d.shape
    E = wi.shape[0]
    k = idx.shape[1]
    rows = T * k
    eid = idx.reshape(rows)
    tok = torch.arange(T, device=x2d.device)[:, None].expand(T, k).reshape(-1)
    w = weights.reshape(rows)
    order = torch.argsort(eid, stable=True)      # rows grouped by expert
    capacity = min(capacity, rows)
    take = order[:capacity]
    x_sel = x2d[tok[take]]
    w_sel = w[take]
    counts = torch.zeros(E, dtype=torch.int64, device=x2d.device)
    counts.scatter_add_(0, eid, torch.ones_like(eid))
    cum = torch.cumsum(counts, 0)
    gs = torch.clamp(counts - torch.clamp(cum - capacity, min=0), min=0)
    valid = (torch.arange(capacity, device=x2d.device) < gs.sum())[:, None]
    h = _activate(ragged_dot(x_sel, wi, gs), cfg)
    y = ragged_dot(h, wo, gs)
    y = torch.where(valid, y, 0.0) * w_sel[:, None].to(y.dtype)
    # each taken row back at its (token, choice) place, then the k choices
    # summed in order: JAX's scatter-add without atomics
    per_row = y.new_zeros(rows, d).index_copy_(0, take, y)
    return per_row.view(T, k, d).sum(1)


def moe_ragged(params, x, cfg: ModelConfig,
               mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (same shape, aux loss), every expert on one card."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh arrives with the distribution "
            "slice of the PyTorch port")
    m = cfg.moe
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    T = x2d.shape[0]
    weights, idx, aux = _router(params, x2d, cfg)
    cap = _capacity(T, m.top_k, m.num_experts, m.num_experts,
                    m.capacity_slack)
    out = _moe_local(x2d, params["wi"], params["wo"], weights, idx, cfg, cap)
    return out.reshape(shape).to(x.dtype), aux


def moe_dispatch_einsum(params, x, cfg: ModelConfig, mesh=None,
                        group_size: int = 4096
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GShard dispatch/combine formulation: each expert takes at most
    ``cap_per_e`` of a group's assignments, in (token, choice) order."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh arrives with the distribution "
            "slice of the PyTorch port")
    m = cfg.moe
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    T, d = x2d.shape
    weights, idx, aux = _router(params, x2d, cfg)

    g_sz = min(group_size, T)
    n_groups = T // g_sz if T % g_sz == 0 else 1
    if T % g_sz != 0:
        g_sz = T
    xg = x2d.reshape(n_groups, g_sz, d)
    wg = weights.reshape(n_groups, g_sz, m.top_k)
    ig = idx.reshape(n_groups, g_sz, m.top_k)

    mean_load = g_sz * m.top_k / m.num_experts
    cap_per_e = min(max(int(math.ceil(mean_load * m.capacity_slack)), 4),
                    g_sz * m.top_k)

    a_sz = g_sz * m.top_k
    onehot = _one_hot(ig.reshape(n_groups, a_sz), m.num_experts)  # (g,a,e)
    pos = torch.cumsum(onehot, dim=1) - onehot                   # slot per e
    posidx = torch.sum(pos * onehot, dim=-1)                     # (g,a)
    keep = (posidx < cap_per_e).float()
    slot = _one_hot(posidx, cap_per_e)                           # (g,a,c)
    disp_a = onehot[:, :, :, None] * slot[:, :, None, :] * keep[:, :, None,
                                                                None]
    disp_a = disp_a.reshape(n_groups, g_sz, m.top_k, m.num_experts,
                            cap_per_e)
    dispatch = torch.sum(disp_a, dim=2)                          # (g,s,e,c)
    combine = torch.einsum("gskec,gsk->gsec", disp_a, wg.float())

    xd = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    h = torch.einsum("gecd,edf->gecf", xd, params["wi"])
    h = _activate(h, cfg)
    y = torch.einsum("gecf,efd->gecd", h, params["wo"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(y.dtype), y)
    return out.reshape(shape).to(x.dtype), aux


def apply_moe(params, x, cfg: ModelConfig,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.impl == "dispatch_einsum":
        out, aux = moe_dispatch_einsum(params, x, cfg, mesh)
    else:
        out, aux = moe_ragged(params, x, cfg, mesh)
    if cfg.moe.num_shared_experts:
        out = out + apply_mlp(params["shared"], x, cfg)
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
