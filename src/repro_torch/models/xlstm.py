"""xLSTM blocks (twin of ``repro.models.xlstm``): the mLSTM (matrix
memory, chunkwise-parallel prefill, O(1)-state decode) and the sLSTM
(stabilized scalar-memory recurrence), arXiv:2405.04517 with the standard
log-space stabilization.

The mLSTM prefill's inter-chunk ``(C, n, m)`` state is carried by a Python
loop over chunks, and the sLSTM by a Python loop over time, where the JAX
package runs ``lax.scan``. Einsums of three operands are written as
elementwise products and batched matmuls. The order of the operations that
decide a rounding is the JAX package's: ``C * f + i k (x) v``, then ``q C``;
``rms_norm(y) * silu(gate)``.

``mlstm_decode`` writes its state in place (``C``, ``n``, ``m``), where the
JAX package returns a new one: the engine's CUDA graph reads the state at
fixed addresses. Every state leaf is fp32.

Under a mesh (``tp``: the layer's ``distributed.Layout``) a "model" rank
runs its own heads. The mLSTM's ``up`` is column-parallel (the rank's
slice of d_inner, which is its heads'); ``wq``, ``wk``, ``wv`` and
``wif`` are row-parallel as JAX's rules lay them (on their input
d_inner): their fp32 partial products are summed over "model" in one
all-reduce (``Layout.row_parallel``), then the rank takes its heads; the
norm over the whole d_inner sums the rank's squares over "model", and
``down`` is row-parallel too. The sLSTM's ``wx`` gives the rank its
heads' pre-activations, ``r`` and ``b`` are its heads', and its loop over
time runs with no collective; y is gathered whole for the norm over d,
and the FFN tail is column- then row-parallel where "model" splits
``ff`` (whole on every rank where it does not).
Under autograd (training) a copy-in goes in front of each
column-parallel product (``up``, ``wx``, ``ff_wi``), and the sums carry
their gradients (``Layout.sum_model``, ``row_parallel``): the mLSTM's
q | k | v | if sum, of which each rank keeps its heads, takes the sum of
every rank's heads' gradients, written into zeros, as each partial
product's. The sLSTM's gathered y feeds what every rank computes alike,
so its gradient is whole on every rank already: the gather's backward
only keeps the rank's slice.

Under autograd the chunked mLSTM's denominator floor ``exp(-m)`` has the
gradient 0 where it overflows to inf (``_exp_floor``): the output there is
``num / inf = 0`` whatever ``m`` is, and autograd's ``exp`` backward would
give ``0 x inf = NaN``, which the JAX package's gradient is there (a
stabiliser below -88.7, which large gate pre-activations give). The
forward is JAX's bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Initializer, gelu, mm_fp32, proj_in,
                                       rms_norm, rms_norm_split)
from repro_torch.models.mamba2 import NEG_INF, check_chunks


def _mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    nh = cfg.num_heads
    hd = d_in // nh
    return d_in, nh, hd


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(init: Initializer, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    d_in, nh, hd = _mlstm_dims(cfg)
    return {
        "up": init.w((d, 2, d_in), ("w_embed", None, "ssm_inner")),
        "wq": init.w((d_in, d_in), ("ssm_inner", None)),
        "wk": init.w((d_in, d_in), ("ssm_inner", None)),
        "wv": init.w((d_in, d_in), ("ssm_inner", None)),
        "wif": init.w((d_in, 2, nh), ("ssm_inner", None, "ssm_heads"),
                      scale=0.01),
        "b_if": init.const(np.concatenate([np.full((1, nh), -3.0),
                                           np.full((1, nh), 3.0)]),
                           (None, "ssm_heads")),
        "norm": init.z((d_in,), ("ssm_inner",)),
        "down": init.z((d_in, d), ("ssm_inner", "w_embed")),
    }


class _ExpFloor(torch.autograd.Function):
    """``exp(-m)`` whose gradient is 0 where it overflows to inf (there the
    only gradient it receives is 0, through the ``maximum`` it floors)."""

    @staticmethod
    def forward(ctx, m):
        out = torch.exp(-m)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return torch.where(g == 0, 0.0, -g * out)


def _exp_floor(m):
    if torch.is_grad_enabled() and m.requires_grad:
        return _ExpFloor.apply(m)
    return torch.exp(-m)


def _mlstm_chunked(q, k, v, li, lf, chunk: int):
    """Stabilized chunkwise mLSTM.

    q, k, v: (b, l, h, p); li (log input gate) / lf (log forget gate): (b,
    l, h) fp32. Returns y (b, l, h, p) and the final state (C (b, h, p, p),
    n (b, h, p), m (b, h)), all fp32."""
    b, l, h, p = q.shape
    chunk = check_chunks(l, chunk)
    c = l // chunk
    # (b, c, h, q, ...): heads ahead of positions, for batched matmuls
    r = lambda t: t.reshape(b, c, chunk, *t.shape[2:]).transpose(2, 3)
    q = r(q.float() * (p ** -0.5))
    k, v, li, lf = r(k.float()), r(v.float()), r(li), r(lf)

    cum = torch.cumsum(lf, dim=-1)                       # (b,c,h,q) inclusive
    # intra-chunk log weights: w[t,s] = cum_t - cum_s + li_s (s <= t)
    seg = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    seg = torch.where(mask, seg, NEG_INF)                # (b,c,h,t,s)
    # chunk-summary (state) log weights: wS[s] = cum_Q - cum_s + li_s
    wS = cum[..., -1:] - cum + li                        # (b,c,h,q)
    mS_local = wS.amax(dim=-1)                           # (b,c,h)

    C_prev = q.new_zeros((b, h, p, p))
    n_prev = q.new_zeros((b, h, p))
    m_prev = q.new_full((b, h), NEG_INF)
    ys = []
    for i in range(c):
        seg_c, cum_c = seg[:, i], cum[:, i]
        q_c, k_c, v_c = q[:, i], k[:, i], v[:, i]        # (b,h,q,p)
        # position-wise stabilizer: intra max vs decayed state stabilizer
        m_intra = seg_c.amax(dim=-1)                     # (b,h,t)
        m_state = cum_c + m_prev[..., None]              # (b,h,t)
        m_t = torch.maximum(m_intra, m_state)
        w_intra = torch.exp(seg_c - m_t[..., None])      # (b,h,t,s)
        w_state = torch.exp(m_state - m_t)               # (b,h,t)
        sw = (q_c @ k_c.transpose(-1, -2)) * w_intra     # scores * w_intra
        num = sw @ v_c + (q_c @ C_prev) * w_state[..., None]
        den = sw.sum(-1) + (q_c @ n_prev[..., None])[..., 0] * w_state
        ys.append(num / torch.maximum(den.abs(), _exp_floor(m_t))[..., None])
        # state update
        m_new = torch.maximum(cum_c[..., -1] + m_prev, mS_local[:, i])
        wS_st = torch.exp(wS[:, i] - m_new[..., None])   # (b,h,s)
        dec = torch.exp(cum_c[..., -1] + m_prev - m_new)  # (b,h)
        wk = wS_st[..., None] * k_c                      # (b,h,s,p)
        C_prev = (C_prev * dec[..., None, None]
                  + wk.transpose(-1, -2) @ v_c)
        n_prev = n_prev * dec[..., None] + wk.sum(-2)
        m_prev = m_new
    y = torch.stack(ys, 1).transpose(2, 3)               # (b,c,q,h,p)
    return y.reshape(b, l, h, p), (C_prev, n_prev, m_prev)


_MLSTM_LEAVES = ("up", "wq", "wk", "wv", "wif", "b_if", "norm", "down")
_MLSTM_SPLIT = (2, 0, 0, 0, 0, 1, 0, 0)


def mlstm_split(tp) -> bool:
    """Whether the mLSTM runs on the rank's heads under its layout ``tp``
    (None: one process); raises for a layout the schedule does not run."""
    if tp is None:
        return False
    return tp.split(_MLSTM_LEAVES, _MLSTM_SPLIT, "the mLSTM splits its heads "
                    "over 'model'")


def _mlstm_in(params, x, cfg: ModelConfig, tp=None):
    """(q, k, v (b, l, h, p), li, lf (b, l, h) fp32, gate); under ``tp``
    the rank's heads and its slice of the gate."""
    d_in, nh, hd = _mlstm_dims(cfg)
    split = mlstm_split(tp)
    h2 = proj_in(tp.copy_in(x) if split else x, params["up"])
    core_in, gate = h2[..., 0, :], h2[..., 1, :]
    if split:
        # row-parallel: the rank's fp32 partial products q | k | v |
        # if-gates summed over "model" in one all-reduce and rounded once
        # (``Layout.row_parallel``'s arithmetic), then its heads' columns
        # (under autograd the sum's gradient is summed over "model": every
        # rank's heads' written into zeros)
        m, r = tp.model.size, tp.model.index
        wif = params["wif"]
        full = tp.sum_model(torch.cat(
            [mm_fp32(core_in, params[n]) for n in ("wq", "wk", "wv")]
            + [mm_fp32(core_in, wif.reshape(wif.shape[0], -1))],
            dim=-1)).to(x.dtype)
        n_l, dl = nh // m, d_in // m
        q, k, v = (full[..., i * d_in + r * dl:i * d_in + (r + 1) * dl]
                   .reshape(*x.shape[:2], n_l, hd) for i in range(3))
        gates = full[..., 3 * d_in:].unflatten(-1, (2, nh))
        if_gates = (gates[..., r * n_l:(r + 1) * n_l]
                    + params["b_if"][None].to(x.dtype))
    else:
        q = (core_in @ params["wq"]).reshape(*x.shape[:2], nh, hd)
        k = (core_in @ params["wk"]).reshape(*x.shape[:2], nh, hd)
        v = (core_in @ params["wv"]).reshape(*x.shape[:2], nh, hd)
        if_gates = (proj_in(core_in, params["wif"])
                    + params["b_if"][None].to(x.dtype))
    li = if_gates[..., 0, :].float()                     # log input gate
    lf = F.logsigmoid(if_gates[..., 1, :].float())
    return q, k, v, li, lf, gate


def _mlstm_out(params, y, gate, x, cfg: ModelConfig, tp=None):
    y = y.reshape(*x.shape[:2], gate.shape[-1]).to(x.dtype)
    if not mlstm_split(tp):
        y = rms_norm(y, params["norm"], cfg.norm_eps)
        y = y * F.silu(gate)
        return y @ params["down"]
    y = rms_norm_split(y, params["norm"], cfg.norm_eps, tp)
    y = y * F.silu(gate)
    return tp.row_parallel(y, params["down"])


def mlstm_forward(params, x, cfg: ModelConfig, return_state: bool = False,
                  tp=None):
    q, k, v, li, lf, gate = _mlstm_in(params, x, cfg, tp)
    y, state = _mlstm_chunked(q, k, v, li, lf, cfg.xlstm.chunk_size)
    out = _mlstm_out(params, y, gate, x, cfg, tp)
    return out, ({"C": state[0], "n": state[1], "m": state[2]}
                 if return_state else None)


def mlstm_decode(params, x, cfg: ModelConfig, state: Dict, tp=None):
    """One-token step. x: (b, 1, d); state C (b, h, p, p), n (b, h, p), m
    (b, h), written in place. Returns (y (b, 1, d), state). Under ``tp``
    the rank's heads and state."""
    hd = _mlstm_dims(cfg)[2]
    q, k, v, li, lf, gate = _mlstm_in(params, x, cfg, tp)
    q = q[:, 0].float() * (hd ** -0.5)                   # (b,h,p)
    k, v = k[:, 0].float(), v[:, 0].float()
    li, lf = li[:, 0], lf[:, 0]                          # (b,h)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    C.mul_(f_p[..., None, None]).add_(
        (i_p[..., None] * k)[..., :, None] * v[..., None, :])
    n.mul_(f_p[..., None]).add_(i_p[..., None] * k)
    m.copy_(m_new)
    num = (q[..., None, :] @ C)[..., 0, :]               # (b,h,p)
    den = torch.maximum((q * n).sum(-1).abs(), torch.exp(-m_new))
    y = (num / den[..., None])[:, None]                  # (b,1,h,p)
    return _mlstm_out(params, y, gate, x, cfg, tp), state


def mlstm_state_spec(cfg: ModelConfig, batch: int):
    d_in, nh, hd = _mlstm_dims(cfg)
    return {"C": ((batch, nh, hd, hd), torch.float32),
            "n": ((batch, nh, hd), torch.float32),
            "m": ((batch, nh), torch.float32)}


def mlstm_state_axes() -> Dict[str, tuple]:
    """The logical axes of ``mlstm_state_spec``'s leaves (JAX's)."""
    return {"C": ("batch", "ssm_heads", None, None),
            "n": ("batch", "ssm_heads", None),
            "m": ("batch", "ssm_heads")}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(init: Initializer, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    f_up = int(cfg.xlstm.proj_factor_slstm * d)
    return {
        "wx": init.w((d, 4, d), ("w_embed", None, "ssm_inner")),
        "r": init.w((nh, hd, 4, hd), ("ssm_heads", None, None, None),
                    scale=hd ** -0.5),
        "b": init.const(np.concatenate([np.zeros((2, nh, hd)),
                                        np.full((1, nh, hd), 3.0),
                                        np.zeros((1, nh, hd))]),
                        (None, "ssm_heads", None)),
        "norm": init.z((d,), ("norm",)),
        "ff_wi": init.w((d, 2, f_up), ("w_embed", None, "ff")),
        "ff_wo": init.z((f_up, d), ("ff", "w_embed")),
    }


def _slstm_step(r, bias, carry, gx, cfg: ModelConfig):
    """carry: (c, n, h, m) each (b, nh, hd); gx: (b, 4, nh hd)
    pre-activations; r: the recurrent weights in fp32 as (nh, hd, 4 hd),
    bias: ``b`` in fp32 (both converted once a call, where the JAX package
    converts them a step and XLA hoists it). ``nh`` is ``r``'s: a rank's
    heads under a mesh."""
    nh = r.shape[0]
    hd = cfg.d_model // cfg.num_heads
    c, n, h, m = carry
    # rec[b,g,k,x] = sum_h h[b,k,h] r[k,h,g,x]: one matmul per head
    rec = h.transpose(0, 1) @ r                            # (nh, b, 4hd)
    rec = rec.reshape(nh, -1, 4, hd).permute(1, 2, 0, 3)   # (b, 4, nh, hd)
    g = gx.reshape(gx.shape[0], 4, nh, hd).float() + rec + bias[None]
    z = torch.tanh(g[:, 0])
    li = g[:, 1]                                         # log input gate
    lf = F.logsigmoid(g[:, 2])
    o = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


_SLSTM_LEAVES = ("wx", "r", "b")
_SLSTM_SPLIT = (2, 0, 1)


def slstm_split(tp) -> bool:
    """Whether the sLSTM's recurrence runs on the rank's heads under its
    layout ``tp`` (None: one process); raises for a layout the schedule
    does not run."""
    if tp is None:
        return False
    return tp.split(_SLSTM_LEAVES, _SLSTM_SPLIT, "the sLSTM splits its "
                    "heads over 'model'")


def slstm_forward(params, x, cfg: ModelConfig, state=None,
                  return_state: bool = False, tp=None):
    """x: (b, l, d), a loop over time from ``state`` (c, n, h, m: (b, nh,
    hd) each), or from zeros with m = -1e30. Returns (y, the new state when
    ``state`` was given or ``return_state``, else None); ``state`` itself
    is not written. Under ``tp`` the loop runs on the rank's heads (and
    state), y gathered whole after it."""
    b, l, d = x.shape
    split = slstm_split(tp)
    nh = params["r"].shape[0]
    hd = d // cfg.num_heads
    # (b, l, 4, nh hd)
    gx = proj_in(tp.copy_in(x) if split else x, params["wx"])
    if state is None:
        zeros = x.new_zeros((b, nh, hd), dtype=torch.float32)
        carry = (zeros, zeros, zeros, torch.full_like(zeros, NEG_INF))
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
    r = params["r"].float().reshape(nh, hd, 4 * hd)
    bias = params["b"].float()
    hs = []
    for t in range(l):
        carry = _slstm_step(r, bias, carry, gx[:, t], cfg)
        hs.append(carry[2])
    y = torch.stack(hs, 1).reshape(b, l, nh * hd).to(x.dtype)
    if split:
        # what follows is computed alike on every rank: y's gradient is
        # whole on each
        y = tp.gather(y, -1, reduce_grad=False)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    # gated FFN tail (proj_factor_slstm); under ``tp`` column- then
    # row-parallel where "model" splits ff
    ff_split = tp is not None and tp.split(
        ("ff_wi", "ff_wo"), (2, 0), "the sLSTM's FFN shards its ff dim")
    hff = proj_in(tp.copy_in(y) if ff_split else y, params["ff_wi"])
    h = gelu(hff[..., 0, :]) * hff[..., 1, :]
    if ff_split:
        y = tp.row_parallel(h, params["ff_wo"])
    else:
        y = h @ params["ff_wo"]
    new_state = None
    if return_state or state is not None:
        new_state = dict(zip("cnhm", carry))
    return y, new_state


def slstm_state_spec(cfg: ModelConfig, batch: int):
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    sd = ((batch, nh, hd), torch.float32)
    return {"c": sd, "n": sd, "h": sd, "m": sd}


def slstm_state_axes() -> Dict[str, tuple]:
    """The logical axes of ``slstm_state_spec``'s leaves (JAX's)."""
    a = ("batch", "ssm_heads", None)
    return {"c": a, "n": a, "h": a, "m": a}
