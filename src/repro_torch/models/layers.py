"""Shared layers: initializer, norms, RoPE, MLP variants (twin of
``repro.models.layers``)."""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


class Initializer:
    """Creates parameters from one ``torch.Generator`` on one device, drawn
    in the order the model builds them. ``w`` is truncated-normal fan-in
    init; ``z`` is zero init (output projections and norm gammas start at
    zero, as in the JAX package); ``ones`` and ``const`` fill a leaf with
    ones or with given values.

    Each method also takes the leaf's logical axes (JAX's ``Initializer``
    records them by path). With ``record=True`` the initializer keeps them
    in ``axes``, keyed by the leaf's ``id`` (the leaves are kept alive, so
    an id stays unique); on the ``meta`` device it allocates nothing and
    draws nothing, so a full-width config's tree costs no memory
    (``transformer.param_axes``)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device, record: bool = False):
        self.cfg = cfg
        self.gen = generator
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.param_dtype)
        self.axes: Optional[Dict[int, Tuple]] = {} if record else None
        self._kept: list = []

    def _note(self, t: torch.Tensor, axes) -> torch.Tensor:
        if self.axes is not None:
            if axes is None or len(axes) != t.ndim:
                raise ValueError(f"logical axes {axes} for shape "
                                 f"{tuple(t.shape)}")
            self.axes[id(t)] = tuple(axes)
            self._kept.append(t)
        return t

    def stacked(self, block, stack):
        """Record the axes of the ``(n, ...)`` leaves of ``stack`` as those
        of ``block``'s matching leaves with JAX's "scan" axis in front."""
        if self.axes is None:
            return
        if isinstance(block, dict):
            for k in block:
                self.stacked(block[k], stack[k])
            return
        self.axes[id(stack)] = ("scan",) + self.axes[id(block)]
        self._kept.append(stack)

    def _meta(self) -> bool:
        return self.device.type == "meta"

    def w(self, shape, axes=None, scale: Optional[float] = None
          ) -> torch.Tensor:
        if self._meta():
            return self._note(torch.empty(shape, dtype=self.dtype,
                                          device="meta"), axes)
        if scale is None:
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / np.sqrt(max(1, fan_in))
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.gen)
        return self._note((t * scale).to(self.dtype), axes)

    def z(self, shape, axes=None) -> torch.Tensor:
        return self._note(torch.zeros(shape, dtype=self.dtype,
                                      device=self.device), axes)

    def ones(self, shape, axes=None) -> torch.Tensor:
        return self._note(torch.ones(shape, dtype=self.dtype,
                                     device=self.device), axes)

    def const(self, value: np.ndarray, axes=None) -> torch.Tensor:
        if self._meta():
            return self._note(torch.empty(np.shape(value), dtype=self.dtype,
                                          device="meta"), axes)
        return self._note(torch.as_tensor(np.asarray(value, np.float32)).to(
            device=self.device, dtype=self.dtype), axes)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(dt)


def rms_norm_split(x, gamma, eps: float, tp=None):
    """``rms_norm`` over a last dim that "model" splits (``tp``: the
    module's ``distributed.Layout``; ``x`` and ``gamma`` the rank's slices
    of it): the rank's fp32 sum of squares summed over "model", divided by
    the whole dim (``Layout.sum_model``, with its gradient under
    autograd). ``rms_norm`` itself without ``tp``."""
    if tp is None:
        return rms_norm(x, gamma, eps)
    dt = x.dtype
    x = x.float()
    ss = tp.sum_model(x.square().sum(dim=-1, keepdim=True))
    out = x * torch.rsqrt(ss / (x.shape[-1] * tp.model.size) + eps)
    return (out * (1.0 + gamma.float())).to(dt)


def layer_norm(x, gamma, beta, eps: float):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float()) + beta.float()).to(dt)


def init_norm(init: Initializer, cfg: ModelConfig, dim: int):
    if cfg.norm_type == "layernorm":
        return {"gamma": init.z((dim,), ("norm",)),
                "beta": init.z((dim,), ("norm",))}
    return {"gamma": init.z((dim,), ("norm",))}


def apply_norm(params, x, cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, params["gamma"], params["beta"], cfg.norm_eps)
    return rms_norm(x, params["gamma"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_frequencies(head_dim: int, theta: float, device=None):
    """Inverse frequencies in fp32 (computed in float64 on the host, as the
    JAX package does). Cached per device: a fresh host-to-device copy on
    every call would block the host on the card twice per layer. Callers
    must not modify the returned tensor."""
    exponent = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    return torch.as_tensor(1.0 / (theta ** exponent), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotate-half
    split, computed in fp32."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., :, None].float() * inv_freq      # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def init_mlp(init: Initializer, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wi": init.w((d, 2, f), ("w_embed", None, "ff")),
                "wo": init.z((f, d), ("ff", "w_embed"))}
    return {"wi": init.w((d, f), ("w_embed", "ff")),          # relu2 | gelu
            "wo": init.z((f, d), ("ff", "w_embed"))}


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def proj_in(x, w):
    """x (..., d) contracted with w (d, *rest) -> (..., *rest) as one
    matmul: the JAX package's einsums "bsd,dnh->bsnh", "bld,dgf->blgf"."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


class _MmFp32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=torch.float32)`` with the backward of
    the upcast product ``x.float() @ w.float()``: the fp32 gradient
    contracted with the other operand, each gradient rounded once to its
    operand's dtype. The gradient coming in is a bf16 one cast up (the
    product's consumer rounds to bf16), so the products take it in bf16
    with fp32 accumulators."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g.to(w.dtype), w.T, out_dtype=torch.float32
                          ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x.T, g.to(x.dtype), out_dtype=torch.float32
                          ).to(w.dtype)
        return dx, dw


def mm_fp32(x, w):
    """``x`` (..., k) @ ``w`` (k, n) with the fp32 accumulator returned
    unrounded: on the card bf16 operands go through one product with an
    fp32 output (``_MmFp32``: ``torch.mm(..., out_dtype=torch.float32)``,
    which has no derivative of its own); on the CPU the operands are
    upcast (exact) and multiplied in fp32."""
    if x.dtype == w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return _MmFp32.apply(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def apply_mlp(params, x, cfg: ModelConfig, tp=None):
    """The MLP; under a mesh (``tp``, its ``distributed.Layout``) with
    ``ff`` sharded over "model", ``wi`` is column-parallel (copy-in in
    front) and ``wo`` row-parallel: a reduce-out after it under autograd,
    else the fp32 partial products' sum rounded once
    (``Layout.row_parallel``)."""
    if tp is not None and tp.dim("wo") is not None:
        if tp.dim("wo") != 0 or tp.dim("wi") != params["wi"].ndim - 1:
            tp.refuse("wi", "the MLP shards its ff dim")
        if not torch.is_grad_enabled():
            return tp.row_parallel(_mlp_hidden(params, x, cfg), params["wo"])
        return tp.reduce_out(_mlp(params, tp.copy_in(x), cfg))
    return _mlp(params, x, cfg)


def _mlp_hidden(params, x, cfg: ModelConfig):
    """The MLP's activation, the input of ``wo``."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        h = proj_in(x, params["wi"])
        gate, up = h[..., 0, :], h[..., 1, :]
        act = F.silu(gate) if cfg.mlp_type == "swiglu" else gelu(gate)
        return act * up
    if cfg.mlp_type == "relu2":
        return torch.relu(x @ params["wi"]).square()
    return gelu(x @ params["wi"])                       # gelu


def _mlp(params, x, cfg: ModelConfig):
    return _mlp_hidden(params, x, cfg) @ params["wo"]


def softcap(logits, cap: float):
    if not cap:
        return logits
    return torch.tanh(logits / cap) * cap
