"""The one traffic generator: a mix is a JSON file of parameters
(``bench/traffic/<mix>.json``), read by ``generate``.

A mix gives the arrivals (``"poisson"`` at a fixed ``rate`` in requests a
second, in blocks of ``block_s`` seconds, optionally in bursts of
``burst`` requests due together, a compound Poisson process; or a
``"backlog"`` of ``count`` requests all due at 0), the prompt
and output lengths (lognormal: ``median``, ``sigma``, clipped to ``min`` ..
``max``) and, optionally, ``sessions``: each session one document of
``doc_tokens`` asked ``turns`` times, a question of ``question_min`` ..
``question_max`` tokens after it, the follow-ups at exponential gaps of
``gap_mean_s``, open loop (a follow-up does not wait for the answer).

Every seed gets the same multiset of lengths and gaps in every block: the
i-th of n values is the distribution's quantile at (i + 0.5) / n, and the
seed only shuffles them and draws the token ids (uniform over the
vocabulary). So two seeds differ in the order of the work and not in its
amount.

The shapes are those of the simulator's ``repro_torch/core/workload.py``
(at 1253b8593d7c): ``AZURE_CONV``'s lognormal prompts and outputs
(medians 1020 and 210, sigmas 0.85 and 0.7) and ``AZURE_CODE``'s short
answers, held as numbers in the mixes, and ``arrival_times``'s Poisson
process; its i.i.d. draws are replaced by the stratified ones above, so
nothing of it is copied and later changes to the simulator cannot move
the benchmark.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np


TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclass
class Request:
    """One request as the benchmark hands it to the program: due time (s
    after the first due request), prompt token ids, tokens to generate."""
    due: float
    prompt: np.ndarray
    max_new: int


def load(name: str, root: Path = TRAFFIC_DIR) -> dict:
    return json.loads((root / f"{name}.json").read_text())


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(spec: dict, n: int, rng) -> np.ndarray:
    """``n`` lengths: the stratified lognormal quantiles, clipped, shuffled
    by ``rng``."""
    z = np.array([NormalDist().inv_cdf(q) for q in _quantiles(n)])
    x = np.clip(spec["median"] * np.exp(spec["sigma"] * z),
                spec["min"], spec["max"]).astype(np.int64)
    return rng.permutation(x)


def exponential_gaps(mean: float, n: int, rng) -> np.ndarray:
    """``n`` exponential gaps of ``mean``, stratified, shuffled."""
    return rng.permutation(-mean * np.log1p(-_quantiles(n)))


def uniform_ints(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """``n`` whole numbers spread evenly over ``lo`` .. ``hi``, shuffled."""
    return rng.permutation(np.floor(lo + _quantiles(n) * (hi - lo + 1))
                           .astype(np.int64))


def _block(n: int, span: float, rng) -> np.ndarray:
    """``n`` due times in ``[0, span)``: the stratified exponential gaps,
    shuffled, scaled to fill ``span`` (the first due at 0)."""
    gaps = exponential_gaps(1.0, n, rng)
    gaps *= span / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def generate(mix: dict, seed: int, horizon_s: float,
             vocab: int) -> List[Request]:
    """The requests of ``mix`` due before ``horizon_s``, sorted by due
    time, drawn from ``seed``.

    Poisson arrivals come in blocks of ``block_s`` seconds, each with the
    same number of requests (``rate * block_s`` rounded; of sessions, that
    over ``turns``; of bursts, that over ``burst``), the same multiset of
    gaps and of lengths, in its own order: a window that is a whole number
    of blocks, starting at a block's start, holds the same work on every
    seed. Sessions start so; their follow-ups come after their own
    stratified gaps."""
    rng = np.random.default_rng(seed)
    arr = mix["arrivals"]
    sess = mix.get("sessions")
    turns = sess["turns"] if sess else 1
    if arr["process"] == "backlog":
        blocks = [np.zeros(int(arr["count"]))]
    elif arr["process"] == "poisson":
        span, burst = float(arr["block_s"]), int(arr.get("burst", 1))
        n = int(round(float(arr["rate"]) * span / (turns * burst)))
        blocks = [b * span + np.repeat(_block(n, span, rng), burst)
                  for b in range(int(np.ceil(horizon_s / span)))]
    else:
        raise ValueError(f"arrivals.process={arr['process']!r}")
    reqs = []
    for starts in blocks:
        n = starts.size * turns
        dues = starts
        if sess:
            gaps = exponential_gaps(sess["gap_mean_s"],
                                    starts.size * (turns - 1), rng)
            gaps = gaps.reshape(starts.size, turns - 1)
            dues = (starts[:, None] + np.concatenate(
                [np.zeros((starts.size, 1)), np.cumsum(gaps, 1)], 1)
                    ).reshape(-1)
        outs = lognormal_lengths(mix["output"], n, rng)
        if sess:
            docs = rng.integers(0, vocab, (starts.size, sess["doc_tokens"]))
            qlen = uniform_ints(sess["question_min"], sess["question_max"],
                                n, rng)
            prompts = [np.concatenate([docs[i // turns],
                                       rng.integers(0, vocab, qlen[i])])
                       for i in range(n)]
        else:
            plen = lognormal_lengths(mix["prompt"], n, rng)
            prompts = [rng.integers(0, vocab, k) for k in plen]
        reqs += [Request(float(d), p.astype(np.int32), int(o))
                 for d, p, o in zip(dues, prompts, outs) if d < horizon_s]
    reqs.sort(key=lambda r: r.due)
    return reqs
