"""ML-assisted runtime prediction (paper §III-E1) in torch, and the
alpha-beta fit of timed transfers; copied from ``repro.perfmodel.regression``
so that the port imports nothing of ``repro``.

The ridge fits are the JAX module's: polynomial features of a decode pass
(batch, past tokens) and of a prefill pass (past tokens, new tokens,
batch), closed-form ridge regression by the fp32 normal equations
(``torch.linalg.solve`` where JAX calls ``jnp.linalg.solve``) and batched
prediction. The tensors live on an explicit ``device`` (default the card).
The features reach p^2 ~ 6.7e7, so XᵀX is badly conditioned in fp32 and
the weights of two fp32 solvers differ widely (JAX's own are far from
float64's); what the fits are for, and what the tests hold against JAX's,
are the predictions.

``fit_link_spec`` (numpy, float64) fits the disaggregated engine's timed
handoffs into a ``LinkSpec``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.perfmodel import analytical as ana
from repro_torch.perfmodel.hardware import ClusterSpec, LinkSpec


def _poly_features_decode(batch, past):
    b = batch.to(torch.float32)
    p = past.to(torch.float32)
    return torch.stack([torch.ones_like(b), b, p, b * p, b * b, p * p],
                       dim=-1)


def _poly_features_prefill(past, new, batch):
    p = past.to(torch.float32)
    n = new.to(torch.float32)
    b = batch.to(torch.float32)
    return torch.stack([torch.ones_like(p), p, n, b, n * n, p * n, b * n],
                       dim=-1)


@dataclass
class FittedModel:
    weights: torch.Tensor
    feature_fn: Callable
    mse: float

    def predict(self, *args) -> torch.Tensor:
        x = self.feature_fn(*[torch.as_tensor(a, device=self.weights.device)
                              for a in args])
        return x @ self.weights


def ridge_fit(X: torch.Tensor, y: torch.Tensor,
              lam: float = 1e-6) -> torch.Tensor:
    XtX = X.T @ X + lam * torch.eye(X.shape[1], dtype=X.dtype,
                                    device=X.device)
    Xty = X.T @ y
    return torch.linalg.solve(XtX, Xty)


def _fit(X, y, fn) -> FittedModel:
    w = ridge_fit(X, y)
    return FittedModel(w, fn, float(torch.mean((X @ w - y) ** 2)))


def fit_decode_model(cfg: ModelConfig, cluster: ClusterSpec,
                     batches: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
                     contexts: Sequence[int] = (128, 512, 1024, 2048, 4096,
                                                8192),
                     device="cuda") -> FittedModel:
    bs, ps, ys = [], [], []
    for b in batches:
        for c in contexts:
            bs.append(b)
            ps.append(c)
            ys.append(ana.decode_step_time(cfg, cluster, b, c).time)
    X = _poly_features_decode(torch.as_tensor(bs, device=device),
                              torch.as_tensor(ps, device=device))
    y = torch.as_tensor(ys, dtype=torch.float32, device=device)
    return _fit(X, y, _poly_features_decode)


def fit_prefill_model(cfg: ModelConfig, cluster: ClusterSpec,
                      pasts: Sequence[int] = (0, 512, 2048, 8192),
                      news: Sequence[int] = (64, 128, 256, 512, 1024, 2048,
                                             4096),
                      batches: Sequence[int] = (1, 2, 4, 8),
                      device="cuda") -> FittedModel:
    ps, ns, bs, ys = [], [], [], []
    for p_ in pasts:
        for n_ in news:
            for b_ in batches:
                ps.append(p_)
                ns.append(n_)
                bs.append(b_)
                ys.append(ana.prefill_time(cfg, cluster, n_, b_,
                                           past_tokens=p_).time)
    X = _poly_features_prefill(torch.as_tensor(ps, device=device),
                               torch.as_tensor(ns, device=device),
                               torch.as_tensor(bs, device=device))
    y = torch.as_tensor(ys, dtype=torch.float32, device=device)
    return _fit(X, y, _poly_features_prefill)


def fit_from_trace(rows, kind: str = "decode", device="cuda") -> FittedModel:
    """rows: (N, 3) [batch, past, time] for decode or (N, 4)
    [past, new, batch, time] for prefill — real-hardware trace ingest."""
    rows = torch.as_tensor(np.asarray(rows, np.float32), device=device)
    if kind == "decode":
        X = _poly_features_decode(rows[:, 0], rows[:, 1])
        return _fit(X, rows[:, 2], _poly_features_decode)
    X = _poly_features_prefill(rows[:, 0], rows[:, 1], rows[:, 2])
    return _fit(X, rows[:, 3], _poly_features_prefill)


def fitted_from_numpy(weights, kind: str, device="cuda") -> FittedModel:
    """A ``FittedModel`` over given ridge weights (another fit's, as a
    numpy array of 6 for ``kind`` "decode" or 7 for "prefill"), so that two
    predictors price from the same weights. Its ``mse`` is unknown: NaN."""
    fn = {"decode": _poly_features_decode,
          "prefill": _poly_features_prefill}[kind]
    w = torch.as_tensor(np.array(weights, np.float32), device=device)
    if w.shape != (6 if kind == "decode" else 7,):
        raise ValueError(f"{kind} weights of shape {tuple(w.shape)}")
    return FittedModel(w, fn, float("nan"))


def batched_decode_predict(model: FittedModel, batch_arr, past_arr):
    """Predictions of a decode model over arrays of (batch, past): one
    product of the features with the weights, on the weights' device."""
    dev = model.weights.device
    X = _poly_features_decode(torch.as_tensor(batch_arr, device=dev),
                              torch.as_tensor(past_arr, device=dev))
    return X @ model.weights


def fit_link_spec(samples: Sequence[Tuple[float, float]],
                  name: str = "measured") -> LinkSpec:
    """Least-squares ``time = alpha + nbytes / beta`` over ``(nbytes,
    seconds)`` samples, as ``LinkSpec(latency=alpha, bandwidth=beta)``.

    Alpha is clamped to >= 0 (a negative intercept means the latency is
    below the noise); the slope to a tiny positive value so beta stays
    finite. With fewer than 2 samples of distinct sizes the fit is the
    bandwidth through the origin, latency 0."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.ndim != 2 or arr.shape[0] == 0:
        raise ValueError("fit_link_spec needs (nbytes, seconds) samples")
    nbytes, secs = arr[:, 0], arr[:, 1]
    if arr.shape[0] < 2 or float(np.ptp(nbytes)) == 0.0:
        bw = float(np.sum(nbytes) / max(np.sum(secs), 1e-12))
        return LinkSpec(name, max(bw, 1e-9), 0.0)
    slope, alpha = np.polyfit(nbytes, secs, 1)
    slope = max(float(slope), 1e-18)          # beta = 1/slope stays finite
    return LinkSpec(name, 1.0 / slope, max(float(alpha), 0.0))
