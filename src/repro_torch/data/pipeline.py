"""Deterministic synthetic LM data pipeline for the training launcher (a copy
of ``repro.data.pipeline``, numpy only).

Generates a mixture of structured sequences (copy / arithmetic-progression /
Markov n-gram text) so a ~100M model has real signal to learn in a few hundred
steps; shard-aware batching keeps per-host slices disjoint and restart-stable
(the stream is a pure function of (seed, step), so resuming from a checkpoint
replays the exact same batches).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 256
    global_batch: int = 32
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


def _markov_rows(rng: np.random.Generator, n: int, s: int, vocab: int):
    """Order-1 Markov chains with a per-row random phase — learnable."""
    trans_seed = rng.integers(0, 2 ** 31)
    trng = np.random.default_rng(trans_seed)
    next_tok = trng.integers(0, vocab, size=vocab)           # deterministic map
    rows = np.empty((n, s), np.int32)
    rows[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(1, s):
        noisy = rng.random(n) < 0.1
        rows[:, t] = np.where(noisy, rng.integers(0, vocab, size=n),
                              next_tok[rows[:, t - 1]])
    return rows


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The global batch for ``step`` (pure function; host-sliced)."""
    rng = np.random.default_rng((cfg.seed, step))
    b, s = cfg.global_batch, cfg.seq_len + 1
    kind = rng.random(b)
    rows = _markov_rows(rng, b, s, cfg.vocab_size)
    # 30% copy task: second half repeats the first
    copy_mask = kind < 0.3
    half = s // 2
    rows[copy_mask, half:half * 2] = rows[copy_mask, :half]
    per_host = b // cfg.n_hosts
    lo = cfg.host_id * per_host
    sl = rows[lo: lo + per_host]
    return {"tokens": sl[:, :-1].astype(np.int32),
            "labels": sl[:, 1:].astype(np.int32)}


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
