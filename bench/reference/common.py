"""Plain operations the family references share: fp32 throughout, TF32
off, the linear layers optionally in fp8 (e4m3 weights per output column
and activations per row, each rounded and scaled back: the control of
``correct``) or with operands and products rounded to bf16 (a witness of
what bf16 alone does)."""
from __future__ import annotations

import numpy as np
import torch

FP8_MAX = 448.0


def runs(hf: dict) -> dict:
    """The configuration as the program runs it: the published values of
    ``hf`` with the port's departures (``hf["assumed"]["port_runs"]``, for
    values the port has no option for) in their place."""
    assumed = hf.get("assumed")
    if not isinstance(assumed, dict) or not assumed.get("port_runs"):
        return hf
    return {**hf, **assumed["port_runs"]}


def strict_fp32():
    """Full fp32 products: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x (..., k) @ w (k, ...)`` in fp32; with both operands rounded to
    fp8 first (``precision == "fp8"``); or with the operands and the
    product rounded to bf16 (``"bf16"``; the weights are bf16 already)."""
    w2 = w.float().reshape(w.shape[0], -1)
    x2 = x.reshape(-1, x.shape[-1])
    if precision == "fp8":
        x2, w2 = _fp8(x2, 1), _fp8(w2, 0)
    elif precision == "bf16":
        x2 = x2.to(torch.bfloat16).float()
        return (x2 @ w2).to(torch.bfloat16).float().reshape(
            *x.shape[:-1], *w.shape[1:])
    elif precision != "fp32":
        raise ValueError(precision)
    return (x2 @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def rms(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with the gain applied as ``1 + gamma``."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + gamma.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of ``x (s, heads, d)`` at ``pos (s,)``;
    frequencies ``theta ** (-2i / d)`` worked out in float64."""
    d = x.shape[-1]
    inv = torch.as_tensor(
        1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d),
        dtype=torch.float32, device=x.device)
    ang = pos.float()[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, block: int = 1024):
    """Softmax attention of ``q (s, h, dq)`` over ``k (s, h, dq)``, ``v
    (s, h, dv)``, causal, in blocks of ``block`` queries."""
    s = q.shape[0]
    out = []
    kt = k.permute(1, 2, 0)                                  # (h, dq, s)
    vh = v.transpose(0, 1)                                   # (h, s, dv)
    for i in range(0, s, block):
        qi = q[i:i + block].transpose(0, 1)                  # (h, b, dq)
        sc = (qi @ kt) * scale                               # (h, b, s)
        rows = torch.arange(i, i + qi.shape[1], device=q.device)
        mask = torch.arange(s, device=q.device)[None, :] > rows[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out.append((torch.softmax(sc, -1) @ vh).transpose(0, 1))
    return torch.cat(out, 0)


def embed_scale(d: int) -> float:
    """The port scales the embedding by ``sqrt(d_model)`` rounded to bf16
    (a parametrisation of the embedding table)."""
    return float(torch.tensor(d ** 0.5, dtype=torch.bfloat16))


def swiglu(x, wi, wo, precision: str):
    """``wi (d, 2, f)``: gate then up; ``wo (f, d)``."""
    h = linear(x, wi, precision)
    return linear(torch.nn.functional.silu(h[..., 0, :]) * h[..., 1, :], wo,
                  precision)


def swiglu_cat(x, wi, wo, precision: str):
    """``wi (d, 2f)``: gate columns then up columns; ``wo (f, d)``."""
    h = linear(x, wi, precision)
    gate, up = h.chunk(2, dim=-1)
    return linear(torch.nn.functional.silu(gate) * up, wo, precision)


def layer(params: dict, key: str, i: int, device) -> dict:
    """Layer ``i`` of the stacked group ``key``, in fp32 on ``device``."""
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[i].to(device=device, dtype=torch.float32)
    return take(params[key])


def head_logits(params: dict, xs, want, eps: float, precision: str):
    """Final norm and head at the positions ``want[j]`` of each sequence's
    hidden states ``xs[j]``."""
    g = params["final_norm"]["gamma"]
    out = []
    for x, w in zip(xs, want):
        h = rms(x[torch.as_tensor(w, device=x.device)], g, eps)
        out.append(linear(h, params["head"], precision))
    return out
