"""Alpha-beta fit of timed transfers, copied from
``repro.perfmodel.regression.fit_link_spec`` (numpy only: the JAX module
imports jax at its top, so the port keeps its own copy); a test holds the
two equal on the same samples. The ridge fits of pass runtimes stay in the
JAX package until the port's measurement loops need them.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.perfmodel.hardware import LinkSpec


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
