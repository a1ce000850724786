"""Mamba2 (SSD) block (twin of ``repro.models.mamba2``): chunked parallel
scan for prefill, O(1)-state recurrent step for decode. Scalar decay per
head, grouped B/C with one group.

Prefill keeps the JAX package's chunking: a quadratic term within each
chunk plus an inter-chunk state ``(b, heads, state, head_dim)``, carried by
a Python loop over chunks where the JAX package runs ``lax.scan``. Its
einsums of three and four operands are written as elementwise products and
batched matmuls that never form a ``(t, s, h, p)`` intermediate (at full
width that would be 1.9 GB a chunk).

Decode writes the state in place (``state["conv"]`` and ``state["ssm"]``),
where the JAX package returns a new one: the engine's CUDA graph reads the
state at fixed addresses. The state's dtypes are those the JAX package
computes it in: the SSM state in fp32, the conv window in the compute
dtype (``mamba2_state_spec``).

Under a mesh (``tp``: the layer's ``distributed.Layout``) a "model" rank
runs its own heads: ``in_proj``, the conv and its window hold the rank's
z, x and dt channels and B and C whole (``distributed.Mamba2Read``), so
B and C are computed whole on every rank; ``A_log``, ``D``, ``dt_bias``,
``norm`` and ``out_proj`` hold the rank's heads. The gated RMSNorm runs
over the whole d_inner (the rank's sum of squares summed over "model")
and ``out_proj`` is row-parallel, its partial products summed in fp32
(``Layout.row_parallel``). No other collective runs in the forward. Under
autograd (training) a copy-in goes in front of ``in_proj`` (each rank's
gradient of the input is its heads' share), the two sums carry their
gradients, and the gradient of B and C's columns and channels, a partial
sum over the rank's heads, is summed over "model" after the backward
(``distributed.Plan.reduce_grad``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Initializer, rms_norm, rms_norm_split

NEG_INF = -1e30


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads, s.state_dim, s.head_dim, s.conv_width


def init_mamba2(init: Initializer, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    d_in, nh, n, hd, cw = _dims(cfg)
    conv_dim = d_in + 2 * n
    return {
        "in_proj": init.w((d, 2 * d_in + 2 * n + nh),
                          ("w_embed", "ssm_inner")),
        "conv_w": init.w((cw, conv_dim), ("conv", "ssm_inner"),
                         scale=1.0 / cw),
        "conv_b": init.z((conv_dim,), ("ssm_inner",)),
        "A_log": init.const(np.zeros((nh,)), ("ssm_heads",)),
        "D": init.ones((nh,), ("ssm_heads",)),
        "dt_bias": init.z((nh,), ("ssm_heads",)),
        "norm": init.z((d_in,), ("ssm_inner",)),
        "out_proj": init.z((d_in, d), ("ssm_inner", "w_embed")),
    }


_LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
           "out_proj")
# the dim "model" shards of each leaf when the layer splits its heads
_SPLIT = (1, 1, 0, 0, 0, 0, 0, 0)


def split_heads(tp) -> bool:
    """Whether the layer runs on the rank's heads under its layout ``tp``
    (None: one process); raises for a layout the schedule does not run."""
    if tp is None:
        return False
    return tp.split(_LEAVES, _SPLIT, "the Mamba2 layer splits its heads "
                    "over 'model'")


def _local_dims(cfg: ModelConfig, tp):
    """``_dims`` on the rank: its share of d_inner and of the heads."""
    d_in, nh, n, hd, cw = _dims(cfg)
    m = tp.model.size if split_heads(tp) else 1
    return d_in // m, nh // m, n, hd, cw


def _split_proj(zxbcdt, cfg: ModelConfig, tp=None):
    d_in, nh, n, hd, _ = _local_dims(cfg, tp)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * n]
    dt = zxbcdt[..., d_in + d_in + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, then SiLU. xbc: (b, l, C); conv_w: (w, C).

    ``conv_state`` (b, w-1, C), when given (decode), is the window of the
    last ``w-1`` inputs, prepended. Returns (out, the last ``w-1`` inputs:
    the new window, a new tensor)."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + xbc.shape[1], :] * conv_w[i][None, None]
              for i in range(w))
    out = F.silu(out + conv_b[None, None])
    return out, xp[:, -(w - 1):, :]


def check_chunks(l: int, chunk: int) -> int:
    """The chunk a prefill of ``l`` tokens is cut into: ``min(chunk, l)``,
    which must divide ``l`` (the JAX package asserts the same); raises
    ``ValueError`` otherwise."""
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(
            f"a prefill of {l} tokens: the chunked scan takes prompts of at "
            f"most {chunk} tokens or a multiple of {chunk}")
    return chunk


def _ssd_chunked(xh, dt, B, C, A, chunk: int):
    """SSD core.

    xh: (b, l, h, p); dt: (b, l, h) fp32 (post-softplus); B, C: (b, l, n);
    A: (h,) negative. Returns (y (b, l, h, p) fp32, final state (b, h, n,
    p) fp32)."""
    b, l, h, p = xh.shape
    n = B.shape[-1]
    chunk = check_chunks(l, chunk)
    c = l // chunk
    r = lambda t: t.reshape(b, c, chunk, *t.shape[2:])
    xh, dt, B, C = r(xh), r(dt), r(B), r(C)
    xf = xh.float()

    la = dt * A                                          # (b,c,q,h) <= 0
    cum = torch.cumsum(la, dim=2)                        # inclusive
    # intra-chunk: M[t,s] = C_t.B_s * exp(cum_t - cum_s) * dt_s  (s <= t);
    # masked before exp, as in the JAX package
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,c,t,s,h)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=xh.device).tril()
    seg = torch.where(mask[None, None, :, :, None], seg, NEG_INF)
    decay = torch.exp(seg)
    cb = (C @ B.transpose(-1, -2)).float()               # (b,c,t,s)
    m = cb[..., None] * decay * dt[:, :, None, :, :]     # (b,c,t,s,h)
    y_intra = (m.permute(0, 1, 4, 2, 3)                  # (b,c,h,t,s)
               @ xf.permute(0, 1, 3, 2, 4))              # (b,c,h,t,p)
    del seg, decay, m

    # chunk summary states: S_c = sum_s exp(cum_Q - cum_s) dt_s B_s (x) x_s
    tail = torch.exp(cum[:, :, -1:, :] - cum)            # (b,c,q,h)
    wx = (tail * dt)[..., None] * xf                     # (b,c,s,h,p)
    S = (B.float().transpose(-1, -2)[:, :, None]         # (b,c,1,n,s)
         @ wx.permute(0, 1, 3, 2, 4))                    # (b,c,h,n,p)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (b,c,h)

    state = xh.new_zeros((b, h, n, p), dtype=torch.float32)
    prev = []
    for i in range(c):
        prev.append(state)                               # state BEFORE chunk
        state = state * chunk_decay[:, i, :, None, None] + S[:, i]
    prev_states = torch.stack(prev, 1)                   # (b,c,h,n,p)

    y_inter = (C.float()[:, :, None] @ prev_states       # (b,c,h,t,p)
               ) * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4)       # (b,c,t,h,p)
    return y.reshape(b, l, h, p), state


def _gates(params, zxbcdt, cfg: ModelConfig, conv_state=None, tp=None):
    """(z, x heads (b, l, h, p), B, C, dt fp32, A fp32, new conv window);
    under ``tp`` the rank's heads."""
    d_in, nh, n, hd, _ = _local_dims(cfg, tp)
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg, tp)
    xbc, window = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                               conv_state)
    xs = xbc[..., :d_in]
    B = xbc[..., d_in:d_in + n]
    C = xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(*xs.shape[:2], nh, hd)
    return z, xh, B, C, dt, A, window


def _out(params, y, z, x, cfg: ModelConfig, tp=None):
    """y (b, l, h, p) fp32 with the D skip added -> the block's output;
    under ``tp`` from the rank's heads, summed over "model"."""
    d_in = _local_dims(cfg, tp)[0]
    y = y.reshape(*x.shape[:2], d_in).to(x.dtype)
    y = y * F.silu(z)
    if not split_heads(tp):
        y = rms_norm(y, params["norm"], cfg.norm_eps)
        return y @ params["out_proj"]
    y = rms_norm_split(y, params["norm"], cfg.norm_eps, tp)
    return tp.row_parallel(y, params["out_proj"])


def mamba2_forward(params, x, cfg: ModelConfig, return_state: bool = False,
                   tp=None):
    """x: (b, l, d) -> (y (b, l, d), state dict or None); under ``tp``
    (the layer's layout) on the rank's heads, the state the rank's."""
    xin = tp.copy_in(x) if split_heads(tp) else x
    z, xh, B, C, dt, A, window = _gates(params, xin @ params["in_proj"],
                                        cfg, tp=tp)
    y, final = _ssd_chunked(xh, dt, B, C, A, cfg.ssm.chunk_size)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    out = _out(params, y, z, x, cfg, tp)
    state = {"conv": window, "ssm": final} if return_state else None
    return out, state


def mamba2_decode(params, x, cfg: ModelConfig, state: Dict, tp=None):
    """One-token step. x: (b, 1, d); state: conv (b, w-1, C), ssm (b, h, n,
    p), both written in place. Returns (y (b, 1, d), state). Under ``tp``
    the rank's heads and state."""
    z, xh, B, C, dt, A, window = _gates(params, x @ params["in_proj"], cfg,
                                        conv_state=state["conv"], tp=tp)
    state["conv"].copy_(window)
    xh = xh[:, 0].float()                                # (b,h,p)
    dt = dt[:, 0]                                        # (b,h)
    decay = torch.exp(dt * A[None])                      # (b,h)
    # contrib[b,h,n,p] = dt[b,h] B[b,n] x[b,h,p]
    contrib = (dt[:, :, None, None] * B[:, 0].float()[:, None, :, None]
               * xh[:, :, None, :])
    ssm = state["ssm"]
    ssm.mul_(decay[..., None, None]).add_(contrib)
    y = (C[:, 0].float()[:, None, None, :] @ ssm)[:, :, 0]   # (b,h,p)
    y = y + params["D"].float()[None, :, None] * xh
    return _out(params, y[:, None], z, x, cfg, tp), state


def mamba2_state_spec(cfg: ModelConfig, batch: int):
    """Shape and dtype of one layer's state: the conv window in the compute
    dtype (what the JAX package's prefill and decode return it in; its
    spec allocates bf16, which its first decode step replaces), the SSM
    state in fp32."""
    d_in, nh, n, hd, cw = _dims(cfg)
    conv_dim = d_in + 2 * n
    return {
        "conv": ((batch, cw - 1, conv_dim), getattr(torch, cfg.compute_dtype)),
        "ssm": ((batch, nh, n, hd), torch.float32),
    }


def mamba2_state_axes() -> Dict[str, tuple]:
    """The logical axes of ``mamba2_state_spec``'s leaves (JAX's)."""
    return {"conv": ("batch", None, "ssm_inner"),
            "ssm": ("batch", "ssm_heads", None, None)}


def mamba2_reference(params, x, cfg: ModelConfig):
    """Naive token-by-token recurrence (oracle for tests)."""
    d_in, nh, n, hd, cw = _dims(cfg)
    b, l, _ = x.shape
    state = {"conv": x.new_zeros((b, cw - 1, d_in + 2 * n),
                                 dtype=torch.float32),
             "ssm": x.new_zeros((b, nh, n, hd), dtype=torch.float32)}
    outs = []
    for t in range(l):
        o, state = mamba2_decode(params, x[:, t:t + 1], cfg, state)
        outs.append(o)
    return torch.cat(outs, dim=1)
