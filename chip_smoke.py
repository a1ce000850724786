#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an H100.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the checkout around this
file; imports only ``repro_torch``, torch and numpy. Phases, each of which
raises on failure:

1. device: card name, power limit, device count;
2. build: compile the kernels from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, started together) and print each one's registers,
   shared memory and spills;
3. kernels: run each of the four kernels (flash, paged decode, dense
   decode, paged verify) at its path's shapes and at head dim 16, hold it
   against its plain PyTorch version, check with ``torch.equal`` that dense
   decode == paged decode on one logical cache and that verify position j
   == paged decode at lengths + j + 1, and time kernel, plain version and
   one PyTorch library call beside the card's bound;
4. serve: the paged ``Engine`` at the full width of ``gemma_2b.CONFIG``
   (18 layers, random seeded weights, every weight perturbed) over 16
   requests, with the launch counters reset just before and read just
   after; its logits are held against the same model run through the plain
   attention versions;
5. preemption: 4 of those requests under a pool small enough to force swaps
   (token streams must equal the unpressured run's) and under recompute;
6. slot: the dense ``SlotEngine`` over the same 16 requests, through
   ``decode_attention``; its streams must equal the paged ``Engine``'s;
7. spec: the paged ``Engine`` with a draft model (the target's weights plus
   seeded noise, ``spec_k = 4``) over 8 of the requests, through
   ``paged_verify_attention``; one verify pass is held against sequential
   decode steps, and the streams are compared with plain decode's;
8. the ``kernels`` JSON line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and dense bf16
# tensor-core rate; the card's power limit is printed beside every time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# bf16 outputs: kernel and plain version round P and the output at
# different points; |err| <= ATOL + RTOL * |plain| elementwise, and per
# output row (one query position and head) ||kernel - plain|| / ||plain||
# <= ROW_RTOL, a few bf16 ulps. The row check is the sharp one: a long row
# averages many values, so its entries are far below ATOL.
ATOL, RTOL = 2e-2, 2e-2
ROW_RTOL = 1e-2
# full model, kernels vs plain attention: max |logit difference| as a share
# of max |logit|. The two differ only in where attention rounds to bf16;
# measured 0.0155 on an H100 80GB HBM3 at 700 W (18 layers, 300 tokens)
LOGIT_TOL = 0.05

# speculative phase: the draft is the target plus seeded noise of this
# share of each weight's init scale (the JAX spec benchmark's "noisy" arm).
# The random full-width model's greedy choices are robust: shares 0.1 to
# 0.5 accepted every draft token on an H100 80GB HBM3 at 700 W (8 requests
# x 16 tokens), 1.0 accepted 0.87 of first draft tokens
SPEC_NOISE = 1.0
SPEC_K = 4

KERNELS = ("flash_attention", "paged_decode_attention", "decode_attention",
           "paged_verify_attention")
SOURCE = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "paged_verify_attention":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:95",
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:135",
    "decode_attention": "src/repro/kernels/decode_attention.py:105",
    "paged_verify_attention": "src/repro/kernels/paged_attention.py:243",
}


def log(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got, want):
    """(max abs error, max per-row relative error) of a kernel's output
    against its plain version; raises past ATOL/RTOL or ROW_RTOL."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {float(err.max()):.4g}")
    d = got.shape[-1]
    row = float(((got - want).reshape(-1, d).norm(dim=1)
                 / want.reshape(-1, d).norm(dim=1)).max())
    if row > ROW_RTOL:
        raise AssertionError(f"{name}: a row is off by {row:.4g} of its norm")
    return float(err.max()), row


# ---------------------------------------------------------------------------
# phases 1-3
# ---------------------------------------------------------------------------

def phase_device():
    line = card_line()
    log(f"[device] {line} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count={torch.cuda.device_count()}")
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.monotonic() - t0:.1f}s ({' '.join(_build.FLAGS)})")
    for name, report in _build.ptxas_reports.items():
        for ln in report.splitlines():
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "smem", "error")):
                log(f"[build] {name}: {ln.strip()}")
    for name, entry in (("flash_attention", "flash_attention_smem_bytes"),
                        ("paged_attention",
                         "paged_decode_attention_smem_bytes"),
                        ("decode_attention", "decode_attention_smem_bytes")):
        fn = getattr(_build.load(name), entry)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        log(f"[build] {name}: {fn(256)} bytes of dynamic shared memory per "
            f"block at head dim 256, {fn(16)} at head dim 16")


def _flash_case(gen, b, s, nh, kvh, d):
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(torch.bfloat16)
    return mk(b, s, nh, d), mk(b, s, kvh, d), mk(b, s, kvh, d)


def _paged_case(gen, rng, b, nh, kvh, d, bt, mb, lengths, s=1):
    """Random pool with a shuffled block table; entries past each row's
    live pages point at the trash page (the last page), which holds large
    finite garbage the kernel must never weigh. q holds ``s`` positions;
    for verify (s > 1) the live pages cover the lengths + s positions it
    reads."""
    nb = b * mb + 1
    trash = nb - 1
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(torch.bfloat16)
    q = mk(b, s, nh, d)
    kp, vp = mk(nb, bt, kvh, d), mk(nb, bt, kvh, d)
    kp[trash], vp[trash] = 1e4, -1e4
    perm = rng.permutation(nb - 1)
    tab = np.full((b, mb), trash, np.int32)
    for i, n in enumerate(lengths):
        live = -(-(int(n) + (s if s > 1 else 0)) // bt)
        tab[i, :live] = perm[i * mb:i * mb + live]
    return (q, kp, vp, torch.as_tensor(tab, device="cuda"),
            torch.as_tensor(np.asarray(lengths, np.int32), device="cuda"))


def _sdpa_dense(q, k, v, lens):
    """One library call (the yardstick) on a dense cache k/v (b, S, kvh,
    d), K/V repeated to the query heads: q (b, s, nh, d), query position j
    of row i sees cache positions < lens[i] + j (s = 1: decode)."""
    b, s, nh, d = q.shape
    S, kvh = k.shape[1], k.shape[2]
    kt = k.permute(0, 2, 1, 3).repeat_interleave(nh // kvh, dim=1)
    vt = v.permute(0, 2, 1, 3).repeat_interleave(nh // kvh, dim=1)
    see = (lens[:, None].long()
           + torch.arange(s, device="cuda")[None, :])         # (b, s)
    mask = (torch.arange(S, device="cuda")[None, None, :]
            < see[:, :, None])[:, None]                       # (b,1,s,S)
    qt = q.permute(0, 2, 1, 3)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)


def _sdpa_paged(q, kp, vp, tab, lens):
    """The yardstick on the gathered dense cache; for verify (s > 1)
    position j sees positions <= lens + j."""
    from repro_torch.kernels import ref
    see = lens if q.shape[1] == 1 else lens + 1
    return _sdpa_dense(q, ref.gather_paged_kv(kp, tab),
                       ref.gather_paged_kv(vp, tab), see)


def _dense_case(gen, b, S, nh, kvh, d, lengths):
    """Padded per-row caches whose content at or past each row's length is
    large finite garbage the kernel must never weigh."""
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(torch.bfloat16)
    q, k, v = mk(b, 1, nh, d), mk(b, S, kvh, d), mk(b, S, kvh, d)
    for i, n in enumerate(lengths):
        k[i, n:], v[i, n:] = 1e4, -1e4
    return q, k, v, torch.as_tensor(np.asarray(lengths, np.int32),
                                    device="cuda")


def phase_kernels():
    """Hold each kernel against its plain version and time the three."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    rows = {}

    # flash: the main path's prefill shape (1, 1024, 8 heads, 1 kv head, 256)
    b, s, nh, kvh, d = 1, 1024, 8, 1, 256
    q, k, v = _flash_case(gen, b, s, nh, kvh, d)
    err, rel = compare("flash_attention d=256",
                       fa.flash_attention(q, k, v, causal=True),
                       ref.flash_attention(q, k, v, causal=True))
    for shape, causal in (((2, 100, 4, 1, 16), True),
                          ((2, 100, 4, 1, 16), False),
                          ((1, 77, 8, 2, 64), True)):
        qs, ks, vs = _flash_case(gen, *shape)
        e, r = compare(f"flash_attention {shape} causal={causal}",
                       fa.flash_attention(qs, ks, vs, causal=causal),
                       ref.flash_attention(qs, ks, vs, causal=causal))
        log(f"[kernels] flash_attention {shape} causal={causal}: "
            f"max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    qt = q.permute(0, 2, 1, 3)
    kt = k.permute(0, 2, 1, 3).expand(b, nh, s, d)
    vt = v.permute(0, 2, 1, 3).expand(b, nh, s, d)
    pairs = s * (s + 1) // 2                      # causal (query, key) pairs
    flops = 4 * d * nh * b * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    rows["flash_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel,
        ms=cuda_time_ms(lambda: fa.flash_attention(q, k, v)),
        plain_ms=cuda_time_ms(lambda: ref.flash_attention(q, k, v)),
        library_ms=cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
        bound=(nbytes, flops))
    log(f"[kernels] flash_attention (1,1024,8,256) kvh=1 causal: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL})")

    # paged decode: b = 8, ragged lengths up to 2048, bt = 16, shuffled table
    b, nh, kvh, d, bt, mb = 8, 8, 1, 256, 16, 128
    lengths = [2048, 1, 17, 300, 1024, 1537, 640, 2000]
    case = _paged_case(gen, rng, b, nh, kvh, d, bt, mb, lengths)
    err, rel = compare("paged_decode_attention d=256",
                       pa.paged_decode_attention(*case),
                       ref.paged_decode_attention(*case))
    small = _paged_case(gen, rng, 3, 4, 1, 16, 8, 6, [0, 5, 37])
    out = pa.paged_decode_attention(*small)
    torch.cuda.synchronize()
    if not torch.isfinite(out[0].float()).all():
        raise AssertionError("paged_decode_attention: length-0 row not finite")
    e, r = compare("paged_decode_attention d=16", out[1:],
                   ref.paged_decode_attention(*small)[1:])
    log(f"[kernels] paged_decode_attention d=16 g=4 bt=8 lens [0,5,37]: "
        f"max_abs_err={e:.3g} max_row_rel_err={r:.3g} (length-0 row "
        f"finite)")
    live = sum(lengths)
    nbytes = 2 * (2 * live * kvh * d + 2 * b * nh * d) + 4 * (b * mb + b)
    flops = 4 * nh * d * live
    rows["paged_decode_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel,
        ms=cuda_time_ms(lambda: pa.paged_decode_attention(*case), iters=50),
        plain_ms=cuda_time_ms(lambda: ref.paged_decode_attention(*case)),
        library_ms=cuda_time_ms(_sdpa_paged(*case), iters=50),
        bound=(nbytes, flops))
    log(f"[kernels] paged_decode_attention b=8 lens<=2048 bt=16 d=256: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL})")

    # dense decode: the slot path's shape, b = 8, S = max_len = 2048
    S = 2048
    case = _dense_case(gen, b, S, nh, kvh, d, lengths)
    err, rel = compare("decode_attention d=256",
                       da.decode_attention(*case),
                       ref.decode_attention(*case))
    small = _dense_case(gen, 4, 48, 4, 1, 16, [0, 5, 37, 100])
    out = da.decode_attention(*small)
    torch.cuda.synchronize()
    if not torch.isfinite(out[0].float()).all():
        raise AssertionError("decode_attention: length-0 row not finite")
    e, r = compare("decode_attention d=16", out[1:],
                   ref.decode_attention(*small)[1:])
    log(f"[kernels] decode_attention d=16 g=4 S=48 lens [0,5,37,100]: "
        f"max_abs_err={e:.3g} max_row_rel_err={r:.3g} (length-0 row "
        f"finite, length past S read as S)")
    live = sum(min(n, S) for n in lengths)
    nbytes = 2 * (2 * live * kvh * d + 2 * b * nh * d) + 4 * b
    rows["decode_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel,
        ms=cuda_time_ms(lambda: da.decode_attention(*case), iters=50),
        plain_ms=cuda_time_ms(lambda: ref.decode_attention(*case)),
        library_ms=cuda_time_ms(_sdpa_dense(*case), iters=50),
        bound=(nbytes, 4 * nh * d * live))
    log(f"[kernels] decode_attention b=8 S=2048 lens<=2048 d=256: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL})")
    paged = _paged_case(gen, rng, b, nh, kvh, d, 16, 128, lengths)
    qp, kp, vp, tab, lp = paged
    same = torch.equal(
        da.decode_attention(qp, ref.gather_paged_kv(kp, tab),
                            ref.gather_paged_kv(vp, tab), lp),
        pa.paged_decode_attention(*paged))
    log(f"[kernels] decode_attention == paged_decode_attention on one "
        f"logical cache (torch.equal): {same}")
    if not same:
        raise AssertionError("dense decode differs from paged decode")

    # paged verify: b = 8, s = spec_k + 1 = 5 feed positions, lengths up
    # to 2043 so every row's lengths + s fits the 2048-token table
    s_ver = SPEC_K + 1
    vlens = [2043, 1, 17, 300, 1024, 1537, 640, 2000]
    case = _paged_case(gen, rng, b, nh, kvh, d, 16, 128, vlens, s=s_ver)
    err, rel = compare("paged_verify_attention d=256",
                       pa.paged_verify_attention(*case),
                       ref.paged_verify_attention(*case))
    small = _paged_case(gen, rng, 3, 4, 1, 16, 8, 6, [0, 5, 37], s=s_ver)
    e, r = compare("paged_verify_attention d=16",
                   pa.paged_verify_attention(*small),
                   ref.paged_verify_attention(*small))
    log(f"[kernels] paged_verify_attention d=16 g=4 s=5 (20 query rows) "
        f"bt=8 lens [0,5,37]: max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    q, kp, vp, tab, vl = case
    out = pa.paged_verify_attention(*case)
    same = all(torch.equal(out[:, j:j + 1], pa.paged_decode_attention(
        q[:, j:j + 1].contiguous(), kp, vp, tab, vl + j + 1))
        for j in range(s_ver))
    log(f"[kernels] paged_verify_attention position j == "
        f"paged_decode_attention at lengths + j + 1 for every j "
        f"(torch.equal): {same}")
    if not same:
        raise AssertionError("verify differs from sequential paged decode")
    read = sum(min(n + s_ver, 128 * 16) for n in vlens)
    pairs = sum(min(n + j + 1, 128 * 16) for n in vlens
                for j in range(s_ver))
    nbytes = (2 * (2 * read * kvh * d + 2 * b * s_ver * nh * d)
              + 4 * (b * 128 + b))
    rows["paged_verify_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel,
        ms=cuda_time_ms(lambda: pa.paged_verify_attention(*case), iters=50),
        plain_ms=cuda_time_ms(lambda: ref.paged_verify_attention(*case)),
        library_ms=cuda_time_ms(_sdpa_paged(*case), iters=50),
        bound=(nbytes, 4 * nh * d * pairs))
    log(f"[kernels] paged_verify_attention b=8 s=5 lens<=2043 bt=16 d=256: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL})")

    for name, r in rows.items():
        nbytes, flops = r.pop("bound")
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the paged Engine at full Gemma-2B width
# ---------------------------------------------------------------------------

def _perturb(params, cfg, gen, share: float = 1.0):
    """Add seeded noise to every leaf in place: ``share`` of each weight's
    fan-in scale (0.1 for norm gammas), so activations stay O(1) at full
    width."""
    d = cfg.d_model

    def std(path, shape):
        if path == "embed":
            return d ** -0.5
        if path.endswith("gamma"):
            return 0.1
        per_layer = shape[1:]
        fan_in = (int(np.prod(per_layer[:-1])) if path.endswith("wo")
                  else per_layer[0])
        return fan_in ** -0.5

    def walk(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            noise = torch.randn(v.shape, generator=gen, device="cuda")
            v.add_((noise * (share * std(path, v.shape))).to(v.dtype))
    walk(params, "")
    return params


def full_width_params(cfg, seed: int = 0):
    """Seeded random weights on the card with every leaf perturbed: the
    JAX-style init zeroes both output projections and every norm gamma,
    which would make the output ignore attention."""
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return _perturb(tf.init_model(cfg, gen, "cuda"), cfg, gen)


def noisy_draft_params(params, cfg, share: float, seed: int = 23):
    """The speculative draft: a copy of the target's weights plus seeded
    noise of ``share`` of each weight's scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    copy = lambda t: ({k: copy(v) for k, v in t.items()}
                      if isinstance(t, dict) else t.clone())
    return _perturb(copy(params), cfg, gen, share)


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain PyTorch versions (on
    the card) instead of the kernels, for the end-to-end comparison."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.paged_decode_attention
    ops.flash_attention = ref.flash_attention
    ops.paged_decode_attention = ref.paged_decode_attention
    try:
        yield
    finally:
        ops.flash_attention, ops.paged_decode_attention = saved


def _prefill_paged(params, cfg, prompt, bt=16, max_len=2048, batch=8):
    """Prefill one prompt and page it into row 0 of a ``batch``-row paged
    cache whose table covers all of ``max_len`` (other rows dead on the
    trash page). Returns (prefill logits, caches, tables, lengths)."""
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    mb = max_len // bt
    nb = batch * mb
    logits, dense = steps.prefill_step(
        params, {"tokens": torch.as_tensor(prompt[None], device="cuda")},
        cfg, max_len)
    caches = tf.init_paged_cache(cfg, batch, nb, bt, mb, "cuda")
    n = -(-len(prompt) // bt)
    steps.write_prefill_pages(caches, dense,
                              torch.arange(n, device="cuda"), block_tokens=bt)
    tabs = torch.full((batch, mb), nb, dtype=torch.int32, device="cuda")
    tabs[0] = torch.arange(mb, dtype=torch.int32, device="cuda")
    lens = torch.zeros(batch, dtype=torch.int32, device="cuda")
    lens[0] = len(prompt)
    return logits, caches, tabs, lens


def _set_rows(cfg, caches, tabs, lens):
    g = caches["attn"]
    g["block_tables"] = tabs[None].expand(cfg.num_layers, *tabs.shape)
    g["length"] = lens[None].expand(cfg.num_layers, *lens.shape)


def _prefill_and_decode(params, cfg, prompt, feed, batch=8):
    """Prefill one prompt into row 0 of a ``batch``-row paged cache and
    decode ``len(feed)`` tokens; returns the logits of every step."""
    from repro_torch.models import steps
    logits, caches, tabs, lens = _prefill_paged(params, cfg, prompt,
                                                batch=batch)
    out = [logits[0].float()]
    for tok in feed:
        _set_rows(cfg, caches, tabs, lens)
        toks = torch.zeros(batch, 1, dtype=torch.int32, device="cuda")
        toks[0, 0] = tok
        _, lg, caches = steps.serve_step(params, toks, caches, cfg)
        out.append(lg[0].float())
        lens = lens.clone()
        lens[0] += 1
    return out


def phase_logits(cfg, params):
    """The full model through the kernels against the same model through
    the plain attention versions: prefill of 300 tokens and 4 decode steps
    fed the kernel path's greedy tokens."""
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 300
                                               ).astype(np.int32)
    first = _prefill_and_decode(params, cfg, prompt, [])[0]
    feed = [int(first.argmax())]
    got = _prefill_and_decode(params, cfg, prompt, feed * 4)
    with plain_attention():
        want = _prefill_and_decode(params, cfg, prompt, feed * 4)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != (cfg.vocab_size,) or not torch.isfinite(g).all():
            raise AssertionError(f"logits step {i}: bad shape or non-finite")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        log(f"[logits] step {i}: max|kernel - plain| = {err:.4g} "
            f"(max|logit| {scale:.4g}, argmax equal: "
            f"{int(g.argmax()) == int(w.argmax())})")
        if err > LOGIT_TOL * scale:
            raise AssertionError(f"logits step {i} off by {err}")
        worst = max(worst, err)
    return worst


def _requests(cfg, n=16):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, int(p)).astype(np.int32)
            for p in rng.integers(128, 1025, n)]


def _engine(cfg, params, **kw):
    from repro_torch.engine.core import Engine
    return Engine(cfg, params=params, max_batch=8, max_len=2048,
                  block_tokens=16, device="cuda", **kw)


def _serve(eng, prompts, max_new=64):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run()
    torch.cuda.synchronize()
    return done


def _streams(done):
    return {r.rid: list(r.tokens) for r in done}


def _serve_line(tag, done, prompts, wall, steps):
    toks = sum(len(r.tokens) for r in done)
    log(f"[{tag}] {len(done)} requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens, {toks} tokens generated; wall "
        f"{wall:.3f}s, {toks / wall:.2f} tok/s, TTFT mean "
        f"{np.mean([r.ttft for r in done]) * 1e3:.2f} ms, TPOT mean "
        f"{np.mean([r.tpot for r in done]) * 1e3:.2f} ms, engine steps "
        f"{steps}, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_serve(cfg, params):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    prompts = _requests(cfg)
    _serve(_engine(cfg, params), prompts[:1], max_new=2)        # warm-up
    eng = _engine(cfg, params)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = pa.launches = 0
    t0 = time.monotonic()
    done = _serve(eng, prompts)
    wall = time.monotonic() - t0
    launches = {"flash_attention": fa.launches,
                "paged_decode_attention": pa.launches}
    if len(done) != len(prompts) or any(len(r.tokens) != 64 for r in done):
        raise AssertionError("not every request finished with 64 tokens")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if not (eng.caches["attn"]["k_pool"].is_cuda
            and eng.params["embed"].is_cuda):
        raise AssertionError("pool or params not on the card")
    log("[serve] gemma_2b full width (18 layers, d_model 2048, head dim "
        "256), bf16, max_batch=8, max_len=2048, block_tokens=16")
    _serve_line("serve", done, prompts, wall, eng.steps)
    log(f"[serve] launches on the main path: {launches}")
    return launches, prompts, _streams(done)


def phase_preemption(cfg, params, prompts):
    four = prompts[:4]
    base = {r.rid: r.tokens for r in _serve(_engine(cfg, params), four)}
    pages = sum(-(-len(p) // 16) for p in four) + 4
    swap = _engine(cfg, params, num_blocks=pages, preemption="swap")
    got = {r.rid: r.tokens for r in _serve(swap, four)}
    st = swap.kv_stats()
    log(f"[preempt] swap, {pages} pages: swap_outs={st['swap_outs']} "
        f"swap_ins={st['swap_ins']} page_faults={st['page_faults']}, "
        f"streams identical to the unpressured run: {got == base}")
    if st["swap_outs"] < 1 or got != base:
        raise AssertionError("swap pressure: no swap or streams differ")
    rec = _engine(cfg, params, num_blocks=pages, preemption="recompute")
    done = _serve(rec, four)
    st = rec.kv_stats()
    log(f"[preempt] recompute, {pages} pages: "
        f"recompute_drops={st['recompute_drops']}, finished {len(done)}/4")
    if st["recompute_drops"] < 1 or len(done) != 4 \
            or any(len(r.tokens) != 64 for r in done):
        raise AssertionError("recompute pressure: no drop or unfinished")


def phase_slot(cfg, params, prompts, paged_streams):
    """The dense SlotEngine over the same 16 requests, decoding through
    decode_attention; both engines decode at (8, 1), so the streams must be
    equal."""
    from repro_torch.engine.core import SlotEngine
    from repro_torch.kernels import decode_attention as da

    def slot():
        return SlotEngine(cfg, params=params, max_batch=8, max_len=2048,
                          device="cuda")
    _serve(slot(), prompts[:1], max_new=2)                    # warm-up
    eng = slot()
    torch.cuda.reset_peak_memory_stats()
    da.launches = 0
    t0 = time.monotonic()
    done = _serve(eng, prompts)
    wall = time.monotonic() - t0
    launches = da.launches
    if len(done) != len(prompts) or any(len(r.tokens) != 64 for r in done):
        raise AssertionError("slot: not every request finished with 64 "
                             "tokens")
    if launches <= 0:
        raise AssertionError("slot: decode_attention never launched")
    _serve_line("slot", done, prompts, wall, eng.steps)
    same = _streams(done) == paged_streams
    log(f"[slot] decode_attention launches {launches}; 16 streams equal to "
        f"the paged Engine's: {same}")
    if not same:
        raise AssertionError("SlotEngine streams differ from the paged "
                             "Engine's")
    return launches


def phase_spec_logits(cfg, params):
    """One verify pass of 5 fed tokens against 5 sequential decode steps on
    the same prefilled paged cache, through the kernels."""
    from repro_torch.models import steps
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 300
                                               ).astype(np.int32)
    logits, caches, tabs, lens = _prefill_paged(params, cfg, prompt)
    feed, seq = [int(logits[0].argmax())], []
    for _ in range(SPEC_K + 1):
        _set_rows(cfg, caches, tabs, lens)
        toks = torch.zeros(8, 1, dtype=torch.int32, device="cuda")
        toks[0, 0] = feed[-1]
        _, lg, caches = steps.serve_step(params, toks, caches, cfg)
        seq.append(lg[0].float())
        feed.append(int(lg[0].argmax()))
        lens = lens.clone()
        lens[0] += 1
    _, caches, tabs, lens = _prefill_paged(params, cfg, prompt)
    _set_rows(cfg, caches, tabs, lens)
    toks = torch.zeros(8, SPEC_K + 1, dtype=torch.int32, device="cuda")
    toks[0] = torch.as_tensor(feed[:SPEC_K + 1], device="cuda")
    q_valid = torch.zeros(8, dtype=torch.int32, device="cuda")
    q_valid[0] = SPEC_K + 1
    _, ver, _ = steps.verify_step(params, toks, q_valid, caches, cfg)
    torch.cuda.synchronize()
    for j, want in enumerate(seq):
        got = ver[0, j].float()
        if got.shape != (cfg.vocab_size,) or not torch.isfinite(got).all():
            raise AssertionError(f"verify logits {j}: bad shape or "
                                 "non-finite")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        argmax = int(got.argmax()) == int(want.argmax())
        log(f"[spec] verify position {j} vs decode step {j}: max|diff| = "
            f"{err:.4g} (max|logit| {scale:.4g}), argmax equal: {argmax}, "
            f"bitwise equal: {torch.equal(got, want)}")
        if err > LOGIT_TOL * scale or not argmax:
            raise AssertionError(f"verify position {j} off by {err}")


def phase_spec(cfg, params, prompts, paged_streams):
    """The paged Engine with a noisy copy of the target as draft, over 8 of
    the requests x 64 tokens, verifying through paged_verify_attention."""
    from repro_torch.engine.core import EngineConfig
    from repro_torch.kernels import paged_attention as pa
    eight = prompts[:8]
    draft = noisy_draft_params(params, cfg, SPEC_NOISE)
    eng = _engine(cfg, params, draft_params=draft, config=EngineConfig(
        draft_cfg=cfg, spec_k=SPEC_K))
    torch.cuda.reset_peak_memory_stats()
    pa.verify_launches = 0
    t0 = time.monotonic()
    done = _serve(eng, eight)
    wall = time.monotonic() - t0
    launches = pa.verify_launches
    if len(done) != 8 or any(len(r.tokens) != 64 for r in done):
        raise AssertionError("spec: not every request finished with 64 "
                             "tokens")
    if launches <= 0:
        raise AssertionError("spec: paged_verify_attention never launched")
    st = eng.spec_stats()
    log(f"[spec] draft = target + noise of {SPEC_NOISE} of each weight's "
        f"scale, spec_k={SPEC_K}")
    _serve_line("spec", done, eight, wall, eng.steps)
    rounded = lambda key: [round(float(a), 4) for a in st[key]]
    log(f"[spec] paged_verify_attention launches {launches}; tokens_per_step "
        f"{st['tokens_per_step']:.4f}, acceptance per position "
        f"{rounded('acceptance_per_position')}, conditional "
        f"{rounded('conditional_acceptance_per_position')}")
    if not st["tokens_per_step"] > 1:
        raise AssertionError("spec: no draft token was ever accepted")
    if not 0 < st["acceptance_per_position"][0] < 1:
        raise AssertionError("spec: acceptance is not partial at this noise")
    got = _streams(done)
    diff = {rid: next(i for i, (a, b) in enumerate(zip(t, paged_streams[rid]))
                      if a != b)
            for rid, t in got.items() if t != paged_streams[rid]}
    log(f"[spec] {8 - len(diff)} of 8 streams identical to the plain "
        f"Engine's; first differing step by request: {diff}")
    phase_spec_logits(cfg, params)
    return launches


def kernels_line(rows, launches):
    out = []
    for name in KERNELS:
        r = rows[name]
        out.append({"name": name, "route": "cuda",
                    "source": SOURCE[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"],
                    "max_row_rel_err": r["max_row_rel_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import gemma_2b
    t0 = time.monotonic()
    line = phase_device()
    phase_build()
    rows = phase_kernels()
    cfg = gemma_2b.CONFIG
    params = full_width_params(cfg)
    log(f"[params] {sum(v.numel() for v in _leaves(params)) / 1e9:.3f}B "
        f"parameters on the card")
    phase_logits(cfg, params)
    launches, prompts, streams = phase_serve(cfg, params)
    phase_preemption(cfg, params, prompts)
    launches["decode_attention"] = phase_slot(cfg, params, prompts, streams)
    launches["paged_verify_attention"] = phase_spec(cfg, params, prompts,
                                                    streams)
    log(f"[done] all phases in {time.monotonic() - t0:.1f}s")
    log(json.dumps(kernels_line(rows, launches)))
    log(line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    sys.exit(main())
