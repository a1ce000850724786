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
3. kernels: run each of the four attention kernels (flash, paged decode,
   dense decode, paged verify) at its path's shapes and at head dim 16,
   hold it against its plain PyTorch version, and time kernel, plain
   version and one PyTorch library call on the device with the host queue
   held, beside the card's bound and the kernel paced by the host's
   launches. Flash is also held over an edge product (lengths 1-1000, 1-8
   kv heads, head dims 16-256, causal and not) and timed over the path's
   prefill lengths 128-2048 beside ``scaled_dot_product_attention``
   (``phase_flash``). The three decode kernels share one body split over
   the sequence every ``DECODE_SPLIT`` tokens (``phase_decode``): each is
   also held at lengths that straddle the split boundaries (and a dead
   length-0 row), ``torch.equal`` checks that dense decode == paged decode
   on one logical cache, that verify position j == paged decode at lengths
   + j + 1 and that two calls agree, at the path's and the straddling
   lengths, and paged decode is timed at batch 1, 8 and 32. The chunk
   kernel ``paged_chunk_attention`` (``phase_chunk_kernel``, the flash body
   with a paged K/V loader) is held against its plain version at the
   chunked path's contexts with chunks of 256 and 100, two calls equal,
   each chunk's rows ``torch.equal`` to the flash kernel's rows of one
   1024-token prompt prefilled in chunks of 64, 100 and 256, and timed.
   At the reduced dense GQA configs' shape (8 query heads over 2 kv heads,
   head dim 8: ``phase_head_dim_8``) every attention kernel is held
   against its plain version and the three bitwise contracts are checked
   again; flash and paged decode are also held and timed beside the bound
   and one ``scaled_dot_product_attention`` call at the attention shapes of
   llama3_70b (64/8 heads, d 128), internlm2_20b (48/8, d 128),
   pixtral_12b (32/8, d 128) and nemotron_4_340b (96/8, d 192), and dense
   decode on the same caches gathered dense is held against its plain
   version and ``torch.equal`` to paged decode there
   (``phase_path_shapes``);
4. rag: the kernel's registers and spills; the
   IVF-PQ scan kernel ``pq_scan`` against its plain version at the JAX
   test's shapes with int32 and uint8 codes, on out-of-range codes (each
   adds 0) and at the shared-memory limit of its LUT (one column more
   raises), and equal bit for bit (``torch.equal``) to the in-order plain
   version ``ref.pq_scan_in_order`` throughout, each with its launch plan
   (grid, row loads, LUT fill); then the path, ``launch.rag.main`` at
   its defaults with int32 and with uint8 codes, the launch counter reset
   just before and read just after, whose top-5 ids must equal the plain
   version's and whose scan, rerun on the same inputs, is held against it
   row by row and bit for bit; ``examples/rag_pipeline_torch.py`` whole,
   its scan's distances at the ids it prints held against the plain
   version's and its top-5 equal to the plain top-5 but at ties within
   that rounding (``_rag_example``); then one query's scan at ``IVFPQConfig``'s
   sizes (250,000 rows x 16 uint8 codes, K = 256) timed cold beside the
   plain version and one ``embedding_bag`` call, and warm, and cold with
   int32 codes; then a shard-scale scan of 2^28 rows (4 GiB of codes) with
   its achieved bandwidth, held against the plain version in chunks and
   bit for bit on its last chunk;
5. logits and graphs: ``gemma_2b.CONFIG``'s logits through the kernels
   (prefill of 300 tokens, 4 decode steps) within LOGIT_TOL of plain
   attention's, every layer's attention call held against its plain
   version on that call's own inputs (``layer_checks``); every compiled
   pass of the engines (decode and chunk of the
   chunked ``Engine``, draft decode and verify of the speculative one, the
   ``SlotEngine``'s decode) at full width and the engines' shapes, its
   CUDA graph replayed against the same function run eagerly over the same
   static inputs: logits, tokens and written K/V ``torch.equal``, at
   seeded inputs and after rewriting the inputs; warm-up and capture time;
   then the dry run (``phase_dryrun``): ``launch.dryrun.run_cell`` at full
   size for deepseek_v2_236b ``train_4k`` and nemotron_4_340b
   ``decode_32k`` on the (16, 16) mesh of a fake process group (each in a
   subprocess started after the build, ``start_dryrun``: the group is
   global to a process), every term finite and positive; gemma_2b's
   decode at the SlotEngine's shape (8 rows, 2048 positions) on a (1, 1)
   mesh, its ``arg_bytes_per_dev`` equal to the
   bytes of the params, caches and tokens on the card and within the
   caching allocator's rounding of what ``torch.cuda.memory_allocated``
   grows by when they are made, its terms printed beside the graphed slot
   decode pass's replay; the ridge fits of ``perfmodel.regression`` fitted
   on the card and held against the CPU's fit (predictions against the
   float64 fit within ``RIDGE_FACTOR`` x the CPU's own error); then the
   fleet simulator ``repro_torch.core`` (``phase_sim``): llama3_70b on 4
   clients, ``SIM_RUNS`` (the regular, rag, kv and reasoning pipelines)
   priced by the ridge fits on the card, each run's summary ``==`` the
   same run with fast-forward off and with the fleet index off; every
   point priced on the card against the CPU fit's prediction of it
   (``RIDGE_FACTOR``); wall seconds, memo misses and µs a miss on the card
   and on the CPU; and ``examples/serve_e2e_torch.py`` whole, its measured
   TTFT and TPOT p50 beside the simulator's;
6. serve: the paged ``Engine`` at the full width of ``gemma_2b.CONFIG``
   (18 layers, random seeded weights, every weight perturbed) over 16
   requests, with the launch counters reset just before and read just
   after. Every engine run from here on runs twice, its passes replayed as
   CUDA graphs and then eagerly (``cuda_graphs=False``), on the same
   requests: the streams and the launch counts (the graphs' replays
   added) must be equal and every pass replayed; tok/s, TTFT, TPOT and peak
   memory are printed side by side. The kernels line reads the graphed
   runs;
7. preemption: 4 of those requests under a pool small enough to force swaps
   (token streams must equal the unpressured run's) and under recompute;
8. slot: the dense ``SlotEngine`` over the same 16 requests, through
   ``decode_attention``; its streams must equal the paged ``Engine``'s;
9. spec: the paged ``Engine`` with a draft model (the target's weights plus
   seeded noise, ``spec_k = 4``) over 8 of the requests, through
   ``paged_verify_attention``; one verify pass is held against sequential
   decode steps (each layer's verify call against its plain version on
   its own inputs, ``layer_checks``), and the streams are compared with
   plain decode's;
10. chunked: a 1024-token prompt prefilled in chunks of 256 against whole
   prefill (logits, written K/V; each layer's chunk call held,
   ``layer_checks``); the chunked ``Engine`` (``chunk_size =
   256``) over the 16 requests through ``paged_chunk_attention``, its
   streams equal to the whole-prefill ``Engine``'s, its TTFT and TPOT
   beside them; a swap-pressured chunked run; a 3000-token prompt under
   ``max_context = 4096`` against the ``SlotEngine``;
11. disagg: the disaggregated engine (``DisaggEngine``, one prefill and
   one decode worker on the card, each request's KV pages handed over
   through host memory as a timed transfer) over the 16 requests, graphed
   and eagerly, its streams equal to the paged ``Engine``'s and its bytes
   pages x one page's; one prefill and two decode workers with layerwise
   handoffs; a chunked prefill worker; decode-side swap and recompute;
   handoff bytes and seconds, the host link fitted to them, the largest
   handoff staged through the host four ways, TTFT, TPOT and tok/s beside
   the single engine's; with two cards or more, the roles on cards of
   their own;
12. families (after the Gemma weights are freed): the reduced configs of
   llama3_70b, internlm2_20b, nemotron_4_340b and pixtral_12b served on the
   card by the paged Engine and the SlotEngine (equal streams); then each
   at full width (bf16, seeded perturbed weights; llama3_70b cut to 16 of
   80 layers and nemotron_4_340b to 2 of 96, since neither fits one card):
   every layer's attention held against its plain version on its own
   inputs at the served depth and the logits' drift from plain
   attention's printed (see FAMILIES), the 16 requests graphed and eager
   (equal streams and launch counts), for internlm2_20b (all 48 layers)
   also the graphed SlotEngine, whose streams must equal the paged
   Engine's; tok/s, TTFT, TPOT and peak memory beside the card's name and
   power limit;
13. latent (after the families' weights are freed): flash at MLA
   prefill's shapes, query/key head dim != value head dim (24/16 reduced,
   96/64 at MiniCPM3-4B's 40 heads, 192/128 at DeepSeek-V2-Lite's 16 and
   DeepSeek-V2-236B's 128), held against its plain version at lengths
   1-1000 and timed beside the bound and one scaled_dot_product_attention
   call; then minicpm3_4b (62 layers), deepseek_v2_lite_16b (27 layers,
   MoE) and deepseek_v2_236b (1 dense + 4 MoE layers of 60) at full width
   through ``make_engine``, which gives the SlotEngine: every layer's
   flash call and every MoE layer's ``apply_moe`` (against
   ``moe_reference``) held (``layer_checks``), the 16 requests graphed and
   eager
   (equal streams and launch counts), tok/s, TTFT, TPOT, peak memory and
   the weights a decode pass reads (MoE: the experts it routes to)
   against their byte bound; minicpm3_4b also with the absorbed decode;
14. recurrent (after the MLA weights are freed): flash and dense decode
   at zamba2_7b's shared-block shape (MHA, 32/32 heads, head dim 112:
   two 64-column atoms, a query group of 1) held against their plain
   versions and timed beside the bound and one
   scaled_dot_product_attention call; one full-width layer each of
   Mamba2 (1, 512, 3584), mLSTM and sLSTM (1, 512, 2048) at fp32, the
   chunked prefill against the token-by-token recurrence (sLSTM: one call
   against a call a token); then zamba2_7b (81 Mamba2 layers, 6 shared
   block applications) and xlstm_1_3b (48 layers) at full width, nothing
   cut, through ``make_engine``, which gives the SlotEngine: zamba2's
   every shared-block flash and decode call and Mamba2 decode step, and
   xlstm's every mLSTM decode step (against the fp32 step), held
   (``layer_checks``), a
   1024-token prefill's peak memory, the 16 requests (prompts of 64-1024
   tokens, lengths the chunked prefill takes) graphed and eager (equal
   streams and launch counts), tok/s, TTFT, TPOT, peak memory and the
   bytes a decode pass reads and writes (weights, the shared block per
   application, recurrent state, K/V) against their byte bound;
15. train (after the recurrent weights are freed; first what the earlier
   phases leave allocated, by block, pool and allocation stack): the
   backward kernel ``flash_attention_bwd`` against its plain version at
   Gemma's (1, 1024, 8/1 heads, 256) causal and its training batch of 4,
   HuBERT's (4, 1024, 16/16, 80) non-causal, a dv < dq shape (1, 512,
   16/16, 192/128) and the training shapes of minicpm3_4b, v2-lite and
   zamba2's shared block, each with its launch plan (head splits, blocks,
   ring stages, partial bytes), the forward's lse output ``torch.equal``
   in its output to the launch without it and held against the plain lse,
   kernel, plain version and autograd's backward of
   scaled_dot_product_attention timed beside the bound (2.5 x the
   forward's operations, or the bytes); then ``launch.train.main`` at
   full width, bf16, seeded perturbed weights (xlstm's at 0.3 of their
   scale: TRAIN_SHARE), 6 steps of 4 x 1024 tokens, for each of
   TRAIN_RUNS: gemma_2b (18 layers) and hubert_xlarge
   (48) under remat "none" as the launcher trains, minicpm3_4b (62
   layers), zamba2_7b (26 of 81) and xlstm_1_3b (16 of 48) under "full",
   deepseek_v2_lite_16b (5 of 27) under "none"; the launch counters reset
   just before and read just after (forward and backward launches =
   attention layers x steps, the forward doubled under "full"), every
   backward call of the first step held against its plain version on its
   own inputs, finite losses and gradient norms, MoE's aux > 0, every
   layer of every leaf changed; xlstm's device idle share of one step;
   gemma's gradients of one batch ``torch.equal`` under remat "full" and
   "none" and their drift from plain attention printed; minicpm3_4b's at
   4 layers under "none", "full" and "dots"; one HuBERT step from seeded
   embeds through ``frontend_proj`` and its serving entry
   ``prefill_step`` (every flash call held); the restart (hubert_xlarge at
   4 of 48 layers, the launcher's config cut while it runs, stopped after
   step 4 with its newest checkpoint at step 3 and resumed: losses equal
   to the uninterrupted run's); step time, tokens/s, peak memory,
   achieved TFLOP/s of the model's products and their share of the peak;
16. dist (after the training runs are freed): the sharded train step,
   4 ranks on the one card over gloo (NCCL refuses two ranks on one
   device), mesh ("data", "model") = DIST_MESH, each rank's exit code
   checked: gemma_2b (6 of 18 layers: its one kv head's head dim split
   over "model", the tied vocabulary split, flash forward and backward on
   4 of 8 heads a rank) and deepseek_v2_lite_16b (3 of 27: MLA on 8 of 16
   heads a rank, its MoE layers on 32 of 64 experts a rank; again with
   the MoE dispatch einsum, its slots the whole batch's) at full
   width, 2 steps of 4 x 1024 tokens through ``steps.train_step(...,
   rules=, mesh=)`` from seeded perturbed weights; flash launches counted
   on every rank, every flash call of step 1 held (``layer_checks``,
   ``backward_checks``), the replicated loss, aux and grad norm equal on
   every rank, the loss against the same steps in one process on the card
   within DIST_LOSS_RTOL, every gathered gradient leaf's cosine to the
   one-process gradient >= DIST_COS (MoE: with the ranks' routing, the
   free routing's cosine and flipped rows printed); each rank's step time
   and peak memory, gloo-staged (not the card's collectives);
17. dist_serve: dense decode with its lse output at one rank's slice of
   gemma_2b's decode_32k cell under ``shard_v2`` (64, 16,384, 8/1 heads,
   d 256) against its plain version, timed beside the bound and sdpa
   (``phase_v2_kernel``); then serving under a mesh, 4 ranks on the one
   card over gloo as phase dist runs them, DIST_SERVE_RUNS at full width
   (gemma_2b 6 of 18 layers on (2, 2): its one kv head whole on every
   model rank; llama3_70b 4 of 80 on (1, 4): 16 of 64 query heads and 2
   of 8 kv heads a rank; deepseek_v2_lite_16b 3 of 27 on (2, 2), naive and
   absorbed: the whole latent, 32 of 64 experts a rank; and gemma_2b
   under ``shard_v2`` (the cache's positions over the model ranks, the
   query heads gathered for the decode), v2-lite under ``seq_sharded``
   (its latent cache's positions over the data ranks), v2-lite with the
   dispatch einsum and gemma_2b under ``fsdp=True`` (each layer's weights
   gathered in every pass), 8 steps each), each rank making only its
   shards of the seeded weights (``seeded_params``); ``prefill_step`` of 8
   x 512 tokens and 32 ``serve_step``s under ``rules``/``mesh``, the
   prefill's and first step's flash and ``decode_attention`` calls held
   (``layer_checks``), launches counted on every rank; against one
   process on the same weights fed the ranks' tokens (MoE routed as the
   ranks routed): each pass's logits within LOGIT_TOL, the first tokens
   where the margin is sure, each layer's gathered cache against one
   process's projection of that layer's own inputs;
18. dist_recurrent: dense decode with its lse output at one data rank's
   slice of JAX's long_500k cell (1, 262,148, 16/16 heads, d 112) against
   its plain version (rows and lse), ``out`` ``torch.equal`` to the call
   without the lse, timed beside the bound and one
   scaled_dot_product_attention call; then the recurrent families served
   under a mesh by the same 4 gloo ranks, DIST_RECURRENT_RUNS at full
   width (zamba2_7b 14 of 81 layers on (2, 2), and again under
   ``seq_sharded``, batch 1, a 4096-token prompt in 8200 positions split
   over the data ranks, 16 steps across the boundary; xlstm_1_3b 8 of 48
   on (1, 4)), each rank making only its shards of the seeded weights;
   the prefill's and first step's flash, dense decode (and its lse),
   merged decode (against the plain decode over the cache gathered from
   the data ranks) and Mamba2 / mLSTM decode calls held
   (``layer_checks``), launches counted; against one process fed the
   ranks' tokens: each pass's logits within LOGIT_TOL, the sure first
   tokens equal;
19. dist_train_all: training the recurrent families and under FSDP on a
   mesh, the same 4 gloo ranks, DIST_TRAIN_RUNS at full width, bf16,
   remat "full" (the configs'): zamba2_7b 14 of 81 layers on (2, 2) (56
   of 112 Mamba2 heads and 16 of 32 shared-block heads a rank), xlstm_1_3b
   8 of 48 (7 mLSTM + 1 sLSTM) on (1, 4) at 4 x 512 tokens (its sLSTM
   loop is host-paced; weights at TRAIN_SHARE), gemma_2b 6 layers and
   zamba2_7b 14 layers on (2, 2) under ``fsdp=True`` (each leaf's d_model
   over the data ranks, gathered in each layer's remat body); each rank
   making only its shards of the seeded weights; 2 steps of 4 x 1024
   tokens through ``steps.train_step(..., rules=, mesh=)``; dist's gates
   (flash launches on every rank, every flash call of step 1 held, the
   replicated metrics equal on every rank, the loss within DIST_LOSS_RTOL
   against one process, and each gradient leaf's cosine to the one
   process's >= DIST_COS; for the hybrid, whose bf16 gradient is
   ill-conditioned, instead the whole gradient's and its Mamba2 B/C
   pieces' 1 - cosine to the fp32 gradient within DIST_COND_FACTOR x that
   of the one process's gradient summed from its data shards', with the
   B and C pieces before their sum over "model" as a control that must
   fail; single leaves printed),
   every (leaf, layer) moved on every rank (but TRAIN_STUCK's) and each
   rank's m and v of its shards' shape;
20. the ``kernels`` JSON line (flash's row also holds its MLA shapes and
   launches, flash's and dense decode's their zamba2 shape and launches,
   flash's its training launches; dense decode's its long_500k and
   shard_v2 slices; the
   backward's row its other shapes and ptxas report; rows 1 and 7 add
   phase dist's and dist_train_all's launches, rows 1 and dense decode's
   phases dist_serve's and dist_recurrent's), the card line, and the last
   line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
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
# fp32 outside the tensor cores: the scan's adds (bytes bound the scan
# by ~1000x, but the bound is the larger of the two by definition)
PEAK_FP32_FLOPS = 67e12

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

# the IVF-PQ scan: fp32 sums of M table entries on both sides, only the
# summation order differs (the JAX test's tolerance, tests/test_kernels.py)
PQ_ATOL, PQ_RTOL = 1e-4, 1e-5
# distinct code arrays cycled between timed launches of one query's scan:
# 16 x 4 MB > the 50 MB L2, so each launch finds its codes in HBM as a real
# query finds its probed lists
COLD_ARRAYS = 16
# a shard of a billion-vector PQ16 index (a quarter of SIFT1B / Deep1B)
SHARD_ROWS = 2 ** 28
SHARD_CHUNK = 2 ** 24            # rows per plain-version comparison
# host-queue hold before a timed window (cycles of torch.cuda._sleep,
# ~50 ms): the card waits while the host queues every launch, so the
# events time the device alone and not the host's launch rate
HOLD_CYCLES = 100_000_000

# flash_attention's edge cases (b = 2, 8 query heads, every combination,
# causal and not; head dims 8, 24 and 40 end on a half k16 step or a part
# of a 64-column swizzle atom) and the timed sweep over the path's prefill
# lengths (prompts of 128-1024 tokens, and 2048) at (1, s, 8 heads, 1 kv
# head, 256)
FLASH_S = (1, 64, 65, 1000)
FLASH_KVH = (1, 2, 8)
FLASH_D = (8, 16, 24, 40, 64, 128, 256)
FLASH_SWEEP = (128, 256, 512, 1024, 2048)

KERNELS = ("flash_attention", "paged_decode_attention", "decode_attention",
           "paged_verify_attention", "pq_scan", "paged_chunk_attention",
           "flash_attention_bwd")
SOURCE = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_chunk_attention":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "paged_verify_attention":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "pq_scan": "src/repro_torch/kernels/csrc/pq_scan.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:95",
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:135",
    "decode_attention": "src/repro/kernels/decode_attention.py:105",
    "paged_verify_attention": "src/repro/kernels/paged_attention.py:243",
    "pq_scan": "src/repro/kernels/pq_scan.py:41",
    # no Pallas kernel: the JAX chunk pass runs its jnp version everywhere
    "paged_chunk_attention": "src/repro/kernels/ops.py:83",
    # no Pallas kernel: the JAX train step differentiates its jnp reference
    "flash_attention_bwd": "src/repro/kernels/ref.py:10",
}


def log(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3,
                 hold: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` launches between two CUDA
    events; ``hold`` first parks the card for HOLD_CYCLES so that the host
    has queued every launch before the first one runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
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


def bound(nbytes: float, ops: float, peak_ops: float):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over their peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(name: str, got, want, of_max: bool = False):
    """(max abs error, max per-row relative error) of a kernel's output
    against its plain version; raises past ATOL/RTOL or ROW_RTOL. With
    ``of_max`` the elementwise bound is ATOL x max |plain| + RTOL x |plain|
    (the gradient kernel's form, for layer outputs that are sums which
    cancel: MoE, the recurrent decode steps)."""
    torch.cuda.synchronize()
    got, want = got.detach().float(), want.detach().float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    atol = ATOL * float(want.abs().max()) if of_max else ATOL
    bad = err > atol + RTOL * want.abs()
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
    for name, entry in (("paged_attention",
                         "paged_decode_attention_smem_bytes"),
                        ("decode_attention", "decode_attention_smem_bytes")):
        fn = getattr(_build.load(name), entry)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        log(f"[build] {name}: {fn(256)} bytes of dynamic shared memory per "
            f"block at head dim 256, {fn(16)} at head dim 16")
    fn = _build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    log(f"[build] flash_attention: {fn(256, 256)} bytes of dynamic shared "
        f"memory per block at head dim 256, {fn(16, 16)} at 16; at dq/dv "
        f"192/128 (MLA) {fn(192, 128)}")
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    log(f"[build] flash_attention_bwd: {fn(256, 256)} bytes of dynamic "
        f"shared memory per block at head dim 256, {fn(80, 80)} at 80, "
        f"{fn(192, 128)} at 192/128")


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
    """The yardstick on the gathered dense cache; for verify and chunk
    attention (s > 1) position j sees positions <= lens + j."""
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


def _flash_work(b, s, nh, kvh, d, dv=None):
    """(bytes, operations) of causal flash attention at query/key head dim
    d and value head dim dv (default d): q, k, v read and o written once;
    2·(d + dv) operations per (query, key) pair the mask keeps and head."""
    dv = d if dv is None else dv
    nbytes = 2 * b * s * (nh * (d + dv) + kvh * (d + dv))
    return nbytes, 2 * (d + dv) * nh * b * (s * (s + 1) // 2)


def _sdpa_flash(q, k, v):
    """The yardstick: one causal scaled_dot_product_attention call, each kv
    head broadcast to its query heads (a view for one kv head, a copy made
    before the timing for more)."""
    b, s, nh = q.shape[:3]
    kvh = k.shape[2]
    qt = q.permute(0, 2, 1, 3)
    rep = lambda x: x.permute(0, 2, 1, 3)[:, :, None].expand(  # noqa: E731
        b, kvh, nh // kvh, s, x.shape[-1]).reshape(b, nh, s, x.shape[-1])
    kt, vt = rep(k), rep(v)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)


def phase_flash(gen):
    """flash_attention against its plain version at the path's prefill
    shape, at earlier slices' shapes and over the edge product FLASH_S x
    FLASH_KVH x FLASH_D x causal; kernel, plain version and the library call
    timed on the device (host queue held) at the path shape, kernel and
    library call over FLASH_SWEEP. Returns the kernels-line row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
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
    egen = torch.Generator(device="cuda").manual_seed(15)
    worst = {}
    for d_e, s_e, kvh_e, causal in itertools.product(
            FLASH_D, FLASH_S, FLASH_KVH, (True, False)):
        shape = (2, s_e, 8, kvh_e, d_e)
        qs, ks, vs = _flash_case(egen, *shape)
        e, r = compare(f"flash_attention {shape} causal={causal}",
                       fa.flash_attention(qs, ks, vs, causal=causal),
                       ref.flash_attention(qs, ks, vs, causal=causal))
        w = worst.setdefault(d_e, [0.0, 0.0])
        w[0], w[1] = max(w[0], e), max(w[1], r)
    for d_e, (e, r) in worst.items():
        log(f"[kernels] flash_attention b=2 nh=8 d={d_e}, s in {FLASH_S}, "
            f"kvh in {FLASH_KVH}, causal and not "
            f"({2 * len(FLASH_S) * len(FLASH_KVH)} cases): "
            f"max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    # device time (host queue held): at short lengths the wrapper's host
    # work per call outlasts the kernel
    row = dict(
        max_abs_err=err, max_row_rel_err=rel,
        ms=cuda_time_ms(lambda: fa.flash_attention(q, k, v), hold=True),
        plain_ms=cuda_time_ms(lambda: ref.flash_attention(q, k, v),
                              hold=True),
        library_ms=cuda_time_ms(_sdpa_flash(q, k, v), hold=True),
        bound=_flash_work(b, s, nh, kvh, d))
    log(f"[kernels] flash_attention (1,1024,8,256) kvh=1 causal: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL})")
    for s_w in FLASH_SWEEP:
        qw, kw, vw = _flash_case(egen, 1, s_w, nh, kvh, d)
        run = lambda: fa.flash_attention(qw, kw, vw)  # noqa: E731
        compare(f"flash_attention sweep s={s_w}", run(),
                ref.flash_attention(qw, kw, vw))
        ms = cuda_time_ms(run, hold=True)
        paced = cuda_time_ms(run)
        lib = cuda_time_ms(_sdpa_flash(qw, kw, vw), hold=True)
        bound_ms, bound_by = bound(*_flash_work(1, s_w, nh, kvh, d),
                                   PEAK_BF16_FLOPS)
        log(f"[kernels] flash sweep (1, {s_w}, 8, 1, 256) causal, host "
            f"queue held: kernel {ms:.4f} ms, sdpa {lib:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); kernel / sdpa {ms / lib:.2f}, "
            f"bound / kernel {bound_ms / ms:.3f}; kernel paced by the "
            f"host's launches {paced:.4f} ms")
    return row


# the decode kernels: b = 8 rows, 8 heads, 1 kv head, head dim 256, lengths
# up to 2048 (verify: 2043, so that lengths + s fits the 2048-token table)
DEC_LENGTHS = [2048, 1, 17, 300, 1024, 1537, 640, 2000]
VER_LENGTHS = [2043, 1, 17, 300, 1024, 1537, 640, 2000]
DEC_BATCHES = (1, 8, 32)      # paged decode's batch sweep


def straddle_lengths(split: int):
    """Row lengths across the decode body's split boundaries: split - 1,
    split, split + 1, 2·split + 3, split - 3 (verify's lengths + j + 1
    cross the boundary for some j of 5) and a dead length-0 row."""
    return [split - 1, split, split + 1, 2 * split + 3, split - 3, 0]


def _decode_times(name, run, plain, library, work):
    """The kernel, its plain version and the library call on the device
    with the host queue held, the kernel also paced by the host's
    launches; logged beside the bound. Returns the kernels-line times."""
    ms = cuda_time_ms(run, iters=50, hold=True)
    paced = cuda_time_ms(run, iters=50)
    plain_ms = cuda_time_ms(plain, hold=True)
    lib = cuda_time_ms(library, iters=50, hold=True)
    bound_ms, bound_by = bound(*work, PEAK_BF16_FLOPS)
    log(f"[kernels] {name}, host queue held: kernel {ms:.4f} ms, library "
        f"{lib:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); kernel / library {ms / lib:.2f}, bound / kernel "
        f"{bound_ms / ms:.3f}; kernel paced by the host's launches "
        f"{paced:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound=work)


def _decode_work(lengths, nh, kvh, d, cap, table_ints=0, s=1):
    """(bytes, operations) of decode-shaped and chunk attention: K/V of
    each row's read tokens (verify, chunk: lengths + s) once, q and out
    once, table and lengths; 4·d operations per (query, key) pair the mask
    keeps (position j of a row of length n sees n + j + 1 keys when s > 1)
    and head."""
    b = len(lengths)
    read = sum(min(n + (s if s > 1 else 0), cap) for n in lengths)
    pairs = sum(min(n + (j + 1 if s > 1 else 0), cap) for n in lengths
                for j in range(s))
    nbytes = (2 * (2 * read * kvh * d + 2 * b * s * nh * d)
              + 4 * (table_ints + b))
    return nbytes, 4 * nh * d * pairs


# dense decode's lse output against the plain lse: fp32 on both sides
# (bf16 x bf16 scores are exact in fp32), only the order of the sums and
# exp/log differ: within LSE_RTOL of max(1, |lse|)
LSE_RTOL = 1e-5


def _check_lse(name, got, want, lengths):
    """The largest lse difference of the live rows (each within LSE_RTOL
    of max(1, |plain lse|)); a length-0 row's must be -inf on both
    sides."""
    torch.cuda.synchronize()
    dead = torch.tensor([n <= 0 for n in lengths], device=got.device)
    if not (torch.isneginf(got[dead]).all()
            and torch.isneginf(want[dead]).all()):
        raise AssertionError(f"{name}: a length-0 row's lse is not -inf")
    g, w = got[~dead], want[~dead]
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite lse of a live row")
    err = (g - w).abs()
    if (err > LSE_RTOL * w.abs().clamp(min=1.0)).any():
        raise AssertionError(f"{name}: lse off by {float(err.max()):.4g}")
    return float(err.max()) if err.numel() else 0.0


def _check_rows(name, got, want, lengths, s=1):
    """compare() over the rows whose attended length is > 0 (a length-0
    decode row must only be finite). Returns (max abs, max row rel)."""
    live = [i for i, n in enumerate(lengths) if n > 0 or s > 1]
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not live:                # a sequence slice no row reaches yet
        return 0.0, 0.0
    return compare(name, got[live], want[live])


def phase_decode(gen, rng):
    """The three decode-shaped kernels (one shared body, split over the
    sequence every DECODE_SPLIT tokens): each against its plain version at
    the path shape, at head dim 16 and at lengths straddling the split
    boundaries; the two bitwise contracts (dense == paged decode, verify
    position j == paged decode at lengths + j + 1) and two calls' equality
    at the path's and the straddling lengths; kernel, plain version and
    library call timed with the host queue held; paged decode's batch
    sweep. Returns the three kernels-line rows."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    split = _build.DECODE_SPLIT
    b, nh, kvh, d, bt, mb = 8, 8, 1, 256, 16, 128
    cap = mb * bt
    strad = straddle_lengths(split) + [2048, 1537]
    vstrad = straddle_lengths(split) + [2043, 1000]
    rows = {}

    def small(fn, want_fn, case, label, lengths, s=1):
        out = fn(*case)
        e, r = _check_rows(f"{label} d=16", out, want_fn(*case), lengths, s)
        log(f"[kernels] {label} d=16 g=4 lens {lengths}: max_abs_err={e:.3g} "
            f"max_row_rel_err={r:.3g} (length-0 row finite)")

    # paged decode
    case = _paged_case(gen, rng, b, nh, kvh, d, bt, mb, DEC_LENGTHS)
    err, rel = compare("paged_decode_attention d=256",
                       pa.paged_decode_attention(*case),
                       ref.paged_decode_attention(*case))
    small(pa.paged_decode_attention, ref.paged_decode_attention,
          _paged_case(gen, rng, 3, 4, 1, 16, 8, 6, [0, 5, 37]),
          "paged_decode_attention", [0, 5, 37])
    sc = _paged_case(gen, rng, b, nh, kvh, d, bt, mb, strad)
    e, r = _check_rows("paged_decode_attention straddling",
                       pa.paged_decode_attention(*sc),
                       ref.paged_decode_attention(*sc), strad)
    log(f"[kernels] paged_decode_attention b=8 lens<=2048 bt=16 d=256: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL}); straddling lens "
        f"{strad}: max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    scratch = 4 * b * nh * -(-cap // split) * (d + 2)
    log(f"[kernels] decode body split {split} tokens: {-(-cap // split)} "
        f"splits of a {cap}-token row, scratch {scratch} B for paged and "
        f"dense decode at b=8, {5 * scratch} B for verify (s=5)")
    rows["paged_decode_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel, **_decode_times(
            "paged_decode_attention b=8 lens<=2048 bt=16 d=256",
            lambda: pa.paged_decode_attention(*case),
            lambda: ref.paged_decode_attention(*case), _sdpa_paged(*case),
            _decode_work(DEC_LENGTHS, nh, kvh, d, cap, b * mb)))
    for bs in DEC_BATCHES:
        lens = (DEC_LENGTHS * 4)[:bs]
        bc = _paged_case(gen, rng, bs, nh, kvh, d, bt, mb, lens)
        compare(f"paged_decode_attention b={bs}",
                pa.paged_decode_attention(*bc),
                ref.paged_decode_attention(*bc))
        _decode_times(f"paged decode batch sweep b={bs} lens {lens[:8]}"
                      f"{'...' if bs > 8 else ''}",
                      lambda: pa.paged_decode_attention(*bc),
                      lambda: ref.paged_decode_attention(*bc),
                      _sdpa_paged(*bc),
                      _decode_work(lens, nh, kvh, d, cap, bs * mb))
        del bc

    # dense decode: the slot path's shape, S = max_len = 2048
    S = cap
    case = _dense_case(gen, b, S, nh, kvh, d, DEC_LENGTHS)
    err, rel = compare("decode_attention d=256", da.decode_attention(*case),
                       ref.decode_attention(*case))
    small(da.decode_attention, ref.decode_attention,
          _dense_case(gen, 4, 48, 4, 1, 16, [0, 5, 37, 100]),
          "decode_attention (S=48, a length past S read as S)",
          [0, 5, 37, 100])
    sc = _dense_case(gen, b, S, nh, kvh, d, strad)
    e, r = _check_rows("decode_attention straddling",
                       da.decode_attention(*sc), ref.decode_attention(*sc),
                       strad)
    log(f"[kernels] decode_attention b=8 S=2048 lens<=2048 d=256: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL}); straddling lens "
        f"{strad}: max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    rows["decode_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel, **_decode_times(
            "decode_attention b=8 S=2048 lens<=2048 d=256",
            lambda: da.decode_attention(*case),
            lambda: ref.decode_attention(*case), _sdpa_dense(*case),
            _decode_work(DEC_LENGTHS, nh, kvh, d, S)))

    # paged verify: s = spec_k + 1 = 5 feed positions
    s_ver = SPEC_K + 1
    case = _paged_case(gen, rng, b, nh, kvh, d, bt, mb, VER_LENGTHS, s=s_ver)
    err, rel = compare("paged_verify_attention d=256",
                       pa.paged_verify_attention(*case),
                       ref.paged_verify_attention(*case))
    small(pa.paged_verify_attention, ref.paged_verify_attention,
          _paged_case(gen, rng, 3, 4, 1, 16, 8, 6, [0, 5, 37], s=s_ver),
          "paged_verify_attention (s=5, 20 query rows)", [0, 5, 37], s_ver)
    sc = _paged_case(gen, rng, b, nh, kvh, d, bt, mb, vstrad, s=s_ver)
    e, r = _check_rows("paged_verify_attention straddling",
                       pa.paged_verify_attention(*sc),
                       ref.paged_verify_attention(*sc), vstrad, s_ver)
    log(f"[kernels] paged_verify_attention b=8 s=5 lens<=2043 bt=16 d=256: "
        f"max_abs_err={err:.3g} (atol {ATOL}, rtol {RTOL}) "
        f"max_row_rel_err={rel:.3g} (limit {ROW_RTOL}); straddling lens "
        f"{vstrad}: max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    rows["paged_verify_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel, **_decode_times(
            "paged_verify_attention b=8 s=5 lens<=2043 bt=16 d=256",
            lambda: pa.paged_verify_attention(*case),
            lambda: ref.paged_verify_attention(*case), _sdpa_paged(*case),
            _decode_work(VER_LENGTHS, nh, kvh, d, cap, b * mb, s_ver)))

    # the bitwise contracts and determinism, at the path's and the
    # straddling lengths
    _bitwise_contracts(gen, rng, nh, kvh, d, (
        ("path", DEC_LENGTHS, VER_LENGTHS), ("straddling", strad, vstrad)))
    return rows


def _bitwise_contracts(gen, rng, nh, kvh, d, cases, bt=16, mb=128):
    """torch.equal: dense decode == paged decode on one logical cache,
    verify position j == paged decode at lengths + j + 1, and two calls of
    each kernel, at b = 8 for each (tag, decode lengths, verify lengths) of
    ``cases``."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    b, s_ver = 8, SPEC_K + 1
    for tag, dl, vl in cases:
        qp, kp, vp, tab, lp = _paged_case(gen, rng, b, nh, kvh, d, bt, mb,
                                          dl)
        paged = pa.paged_decode_attention(qp, kp, vp, tab, lp)
        kd, vd = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
        dense = da.decode_attention(qp, kd, vd, lp)
        same = torch.equal(dense, paged)
        again = (torch.equal(paged, pa.paged_decode_attention(
            qp, kp, vp, tab, lp))
            and torch.equal(dense, da.decode_attention(qp, kd, vd, lp)))
        q, kp, vp, tab, vlen = _paged_case(gen, rng, b, nh, kvh, d, bt, mb,
                                           vl, s=s_ver)
        out = pa.paged_verify_attention(q, kp, vp, tab, vlen)
        ver = all(torch.equal(out[:, j:j + 1], pa.paged_decode_attention(
            q[:, j:j + 1].contiguous(), kp, vp, tab, vlen + j + 1))
            for j in range(s_ver))
        again = again and torch.equal(
            out, pa.paged_verify_attention(q, kp, vp, tab, vlen))
        log(f"[kernels] d={d} nh={nh} kvh={kvh} {tag} lengths {dl} / verify "
            f"{vl} (torch.equal): "
            f"decode_attention == paged_decode_attention on one logical "
            f"cache: {same}; paged_verify_attention position j == "
            f"paged_decode_attention at lengths + j + 1 for every j: {ver}; "
            f"two calls equal for each kernel: {again}")
        if not (same and ver and again):
            raise AssertionError(f"{tag} lengths: a bitwise contract fails")
        del kd, vd


# the chunk kernel: b = 8 rows at the decode kernels' contexts, capped so
# that context + chunk fits the 2048-token table, chunks of 256 (timed) and
# an unaligned 100; the flash comparison's chunks over one 1024-token prompt
CHUNK_S = (256, 100)
CHUNK_FLASH = (64, 100, 256)


def _chunk_case(gen, rng, s, b=8, nh=8, kvh=1, d=256, bt=16, mb=128):
    """q (b, s, nh, d) and pools with a shuffled table covering each row's
    context + s positions; unused and trash pages hold large finite
    garbage the kernel must never weigh."""
    lengths = [min(n, mb * bt - s) for n in DEC_LENGTHS[:b]]
    nb = b * mb + 1
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(torch.bfloat16)
    q = mk(b, s, nh, d)
    kp, vp = mk(nb, bt, kvh, d), mk(nb, bt, kvh, d)
    perm = rng.permutation(nb - 1)
    tab = np.full((b, mb), nb - 1, np.int32)
    for i, n in enumerate(lengths):
        live = -(-(n + s) // bt)
        tab[i, :live] = perm[i * mb:i * mb + live]
        unused = torch.as_tensor(perm[i * mb + live:(i + 1) * mb],
                                 device="cuda")
        kp[unused], vp[unused] = 1e4, -1e4
    kp[nb - 1], vp[nb - 1] = 1e4, -1e4
    return (q, kp, vp, torch.as_tensor(tab, device="cuda"),
            torch.as_tensor(np.asarray(lengths, np.int32), device="cuda"))


def _ptxas_lines(lib: str, mangled: str):
    """The ptxas report lines (registers, spills) of one kernel of
    ``lib`` whose mangled name contains ``mangled``."""
    from repro_torch.kernels import _build
    out, on = [], False
    for ln in _build.ptxas_reports.get(lib, "").splitlines():
        if "entry function" in ln:
            on = mangled in ln
        elif on and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def phase_chunk_kernel(gen, rng):
    """paged_chunk_attention against its plain version at the chunked
    path's contexts (s = 256 and 100), two calls equal, each chunk's rows
    bit for bit the flash kernel's rows at the same positions of one
    1024-token prompt, and kernel, plain version and the library call timed
    with the host queue held at s = 256. Returns the kernels-line row."""
    from repro_torch.kernels import paged_chunk_attention as pca
    from repro_torch.kernels import ref
    nh, kvh, d, bt, mb = 8, 1, 256, 16, 128
    for ln in _ptxas_lines("flash_attention", "ILi4ELi4ELb1E"):
        log(f"[kernels] paged_chunk_attention ptxas (head dim 256): {ln}")
    row = None
    for s in CHUNK_S:
        case = _chunk_case(gen, rng, s)
        got = pca.paged_chunk_attention(*case)
        err, rel = compare(f"paged_chunk_attention s={s}", got,
                           ref.paged_chunk_attention(*case))
        again = torch.equal(got, pca.paged_chunk_attention(*case))
        log(f"[kernels] paged_chunk_attention b=8 s={s} contexts "
            f"{case[4].tolist()} bt=16 d=256: max_abs_err={err:.3g} (atol "
            f"{ATOL}, rtol {RTOL}) max_row_rel_err={rel:.3g} (limit "
            f"{ROW_RTOL}); two calls equal (torch.equal): {again}")
        if not again:
            raise AssertionError("paged_chunk_attention: two calls differ")
        if s == CHUNK_S[0]:
            lens = case[4].tolist()
            row = dict(max_abs_err=err, max_row_rel_err=rel,
                       **_decode_times(
                           f"paged_chunk_attention b=8 s={s} bt=16 d=256",
                           lambda: pca.paged_chunk_attention(*case),
                           lambda: ref.paged_chunk_attention(*case),
                           _sdpa_paged(*case),
                           _decode_work(lens, nh, kvh, d, mb * bt, 8 * mb,
                                        s)))
        del case, got
    _chunk_rows_equal_flash(gen, rng, nh, kvh, d)
    return row


def _chunk_rows_equal_flash(gen, rng, nh, kvh, d, bt=16, mb=128):
    """One 1024-token prompt's q, k, v, the K/V paged through a shuffled
    table and prefilled chunk by chunk (CHUNK_FLASH): raise unless every
    chunk's rows equal the flash kernel's rows bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_chunk_attention as pca
    P = 1024
    q, k, v = _flash_case(gen, 1, P, nh, kvh, d)
    whole = fa.flash_attention(q, k, v)
    ids = torch.as_tensor(rng.permutation(mb), device="cuda")
    kp = torch.zeros(mb + 1, bt, kvh, d, device="cuda", dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    n = P // bt
    kp[ids[:n]] = k[0].reshape(n, bt, kvh, d)
    vp[ids[:n]] = v[0].reshape(n, bt, kvh, d)
    tab = ids.to(torch.int32)[None]
    same = {}
    for chunk in CHUNK_FLASH:
        ok = True
        for L in range(0, P, chunk):
            take = min(chunk, P - L)
            qc = torch.zeros(1, chunk, nh, d, device="cuda",
                             dtype=torch.bfloat16)
            qc[0, :take] = q[0, L:L + take]
            out = pca.paged_chunk_attention(
                qc, kp, vp, tab,
                torch.tensor([L], dtype=torch.int32, device="cuda"))
            ok = ok and torch.equal(out[0, :take], whole[0, L:L + take])
        same[chunk] = ok
    log(f"[kernels] paged_chunk_attention rows == flash_attention rows of "
        f"one {P}-token prompt, d={d} nh={nh} kvh={kvh} (torch.equal), by "
        f"chunk size: {same}")
    if not all(same.values()):
        raise AssertionError("paged_chunk_attention rows differ from the "
                             "flash kernel's")


def phase_head_dim_8(gen, rng):
    """The reduced dense GQA configs' attention shape (8 query heads over 2
    kv heads, head dim 8: Q K^T is one k16 step over 8 zero columns)
    through each attention kernel against its plain version, at the path's
    and the straddling lengths, and the three bitwise contracts there:
    dense == paged decode, verify position j == paged decode at lengths +
    j + 1, chunk rows == flash rows."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_chunk_attention as pca
    from repro_torch.kernels import ref
    b, nh, kvh, d, bt, mb = 8, 8, 2, 8, 16, 128
    s_ver = SPEC_K + 1
    strad = straddle_lengths(_build.DECODE_SPLIT) + [2048, 1537]
    vstrad = straddle_lengths(_build.DECODE_SPLIT) + [2043, 1000]
    q, k, v = _flash_case(gen, 2, 1000, nh, kvh, d)
    e, r = compare("flash_attention d=8", fa.flash_attention(q, k, v),
                   ref.flash_attention(q, k, v))
    log(f"[kernels d=8] flash_attention (2, 1000, 8, 2, 8) causal: "
        f"max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    for label, lengths, s in (("path", DEC_LENGTHS, 1),
                              ("straddling", strad, 1),
                              ("path", VER_LENGTHS, s_ver),
                              ("straddling", vstrad, s_ver)):
        case = _paged_case(gen, rng, b, nh, kvh, d, bt, mb, lengths, s=s)
        if s == 1:
            kd = ref.gather_paged_kv(case[1], case[3])
            vd = ref.gather_paged_kv(case[2], case[3])
            dense = (case[0], kd, vd, case[4])
            runs = (("paged_decode_attention", pa.paged_decode_attention,
                     ref.paged_decode_attention, case),
                    ("decode_attention", da.decode_attention,
                     ref.decode_attention, dense))
        else:
            runs = (("paged_verify_attention", pa.paged_verify_attention,
                     ref.paged_verify_attention, case),)
        for name, kern, plain, args in runs:
            e, r = _check_rows(f"{name} d=8 {label}", kern(*args),
                               plain(*args), lengths, s)
            log(f"[kernels d=8] {name} b=8 nh=8 kvh=2 bt=16 {label} lens "
                f"{lengths}: max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    for s in CHUNK_S:
        case = _chunk_case(gen, rng, s, nh=nh, kvh=kvh, d=d)
        e, r = compare(f"paged_chunk_attention d=8 s={s}",
                       pca.paged_chunk_attention(*case),
                       ref.paged_chunk_attention(*case))
        log(f"[kernels d=8] paged_chunk_attention b=8 s={s} nh=8 kvh=2 "
            f"bt=16: max_abs_err={e:.3g} max_row_rel_err={r:.3g}")
    _bitwise_contracts(gen, rng, nh, kvh, d, (
        ("path", DEC_LENGTHS, VER_LENGTHS), ("straddling", strad, vstrad)))
    _chunk_rows_equal_flash(gen, rng, nh, kvh, d)


# the attention shapes of the dense GQA configs that phase families serves
# at full width: (name, query heads, kv heads, head dim)
PATH_SHAPES = (("llama3_70b", 64, 8, 128), ("internlm2_20b", 48, 8, 128),
               ("pixtral_12b", 32, 8, 128), ("nemotron_4_340b", 96, 8, 192))


def phase_path_shapes(gen, rng):
    """Flash at the path's 1024-token prefill and paged decode at the
    decode rows' shape (b = 8, lengths up to 2048, bt = 16) for each of
    PATH_SHAPES: against the plain version, and kernel, plain version and
    one scaled_dot_product_attention call timed with the host queue held,
    beside the bound; dense decode (the SlotEngine's kernel) on the same
    caches gathered dense (S = 2048) against its plain version and
    ``torch.equal`` to paged decode."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    b, bt, mb = 8, 16, 128
    for arch, nh, kvh, d in PATH_SHAPES:
        q, k, v = _flash_case(gen, 1, 1024, nh, kvh, d)
        e, r = compare(f"flash_attention {arch}", fa.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v))
        run = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        ms = cuda_time_ms(run, hold=True)
        plain = cuda_time_ms(lambda: ref.flash_attention(q, k, v), hold=True)
        lib = cuda_time_ms(_sdpa_flash(q, k, v), hold=True)
        bound_ms, by = bound(*_flash_work(1, 1024, nh, kvh, d),
                             PEAK_BF16_FLOPS)
        log(f"[kernels {arch}] flash_attention (1, 1024, {nh}, {kvh}, {d}) "
            f"causal: max_abs_err={e:.3g} max_row_rel_err={r:.3g}; host "
            f"queue held: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
            f"{lib:.4f} ms, bound {bound_ms:.4f} ms ({by}); kernel / sdpa "
            f"{ms / lib:.2f}, bound / kernel {bound_ms / ms:.3f}")
        del q, k, v
        case = _paged_case(gen, rng, b, nh, kvh, d, bt, mb, DEC_LENGTHS)
        paged = pa.paged_decode_attention(*case)
        e, r = compare(f"paged_decode_attention {arch}", paged,
                       ref.paged_decode_attention(*case))
        dense = (case[0], ref.gather_paged_kv(case[1], case[3]),
                 ref.gather_paged_kv(case[2], case[3]), case[4])
        got = da.decode_attention(*dense)
        de, dr = compare(f"decode_attention {arch}", got,
                         ref.decode_attention(*dense))
        same = torch.equal(got, paged)
        log(f"[kernels {arch}] paged_decode_attention b=8 lens<=2048 bt=16 "
            f"nh={nh} kvh={kvh} d={d}: max_abs_err={e:.3g} "
            f"max_row_rel_err={r:.3g}; decode_attention on the gathered "
            f"(8, 2048, {kvh}, {d}) caches: max_abs_err={de:.3g} "
            f"max_row_rel_err={dr:.3g}, torch.equal to paged decode: {same}")
        if not same:
            raise AssertionError(f"{arch}: dense decode differs from paged "
                                 f"decode on one logical cache")
        del dense, got, paged
        _decode_times(f"paged_decode_attention {arch} b=8 lens<=2048 bt=16",
                      lambda: pa.paged_decode_attention(*case),
                      lambda: ref.paged_decode_attention(*case),
                      _sdpa_paged(*case),
                      _decode_work(DEC_LENGTHS, nh, kvh, d, mb * bt, b * mb))
        del case


def phase_kernels():
    """Hold each attention kernel against its plain version and time it."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    rows = {"flash_attention": phase_flash(gen)}
    rows.update(phase_decode(gen, rng))
    rows["paged_chunk_attention"] = phase_chunk_kernel(gen, rng)
    phase_head_dim_8(gen, rng)
    phase_path_shapes(gen, rng)
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(*r.pop("bound"),
                                             PEAK_BF16_FLOPS)
        log(f"[kernels] {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the RAG retrieval scan
# ---------------------------------------------------------------------------

def compare_fp32(name: str, got, want):
    """Max abs error of a pq_scan output against its plain version; raises
    past PQ_ATOL + PQ_RTOL * |plain| or on a non-finite or misshapen
    output."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{name}: output {tuple(got.shape)} "
                             f"{got.dtype}, want {tuple(want.shape)} fp32")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > PQ_ATOL + PQ_RTOL * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} rows off, max abs "
                             f"err {float(err.max()):.4g}")
    return float(err.max())


def _pq_inputs(gen, n, m, k, dtype, high=None):
    codes = torch.randint(0, high or k, (n, m), generator=gen,
                          device="cuda").to(dtype)
    return codes, torch.randn(m, k, generator=gen, device="cuda")


def equal_in_order(name: str, got, codes, lut):
    """Raise unless a pq_scan output equals the in-order plain version bit
    for bit (the kernel's contract: each row summed m = 0 … M-1 in fp32)."""
    from repro_torch.kernels import ref
    if not torch.equal(got, ref.pq_scan_in_order(codes, lut)):
        raise AssertionError(f"{name}: differs from the in-order plain "
                             f"version")


def _pq_kernel_cases(gen):
    """(a) the kernel against its plain version at the JAX test's shapes
    with both code types, on out-of-range codes and at the LUT's limit;
    equal to the in-order plain version bit for bit throughout."""
    from repro_torch.kernels import pq_scan as pq
    from repro_torch.kernels import ref
    for n, m, k in ((1000, 16, 256), (4096, 8, 256), (513, 32, 64)):
        for dtype in (torch.int32, torch.uint8):
            codes, lut = _pq_inputs(gen, n, m, k, dtype)
            got = pq.pq_scan(codes, lut)
            e = compare_fp32(f"pq_scan {(n, m, k)} {dtype}", got,
                             ref.pq_scan(codes, lut))
            equal_in_order(f"pq_scan {(n, m, k)} {dtype}", got, codes, lut)
            log(f"[rag] pq_scan (N, M, K) = {(n, m, k)} {dtype}: "
                f"max_abs_err={e:.3g} (atol {PQ_ATOL}, rtol {PQ_RTOL}), "
                f"equal to the in-order plain version; plan "
                f"{_plan_line(codes, lut)}")
    # int32 codes -1, K and 2^30 and uint8 codes >= K = 64 each add 0
    for dtype, k, bad in ((torch.int32, 256, (-1, 256, 2 ** 30)),
                          (torch.uint8, 64, (64, 200, 255))):
        codes, lut = _pq_inputs(gen, 1000, 16, k, dtype)
        pick = torch.tensor(bad, device="cuda")[torch.randint(
            0, len(bad), codes.shape, generator=gen, device="cuda")]
        hit = torch.rand(codes.shape, generator=gen, device="cuda") < 0.3
        codes = torch.where(hit, pick.to(dtype), codes)
        codes[0] = bad[0]                          # a row with no code in range
        got = pq.pq_scan(codes, lut)
        e = compare_fp32(f"pq_scan out of range {dtype}", got,
                         ref.pq_scan(codes, lut))
        equal_in_order(f"pq_scan out of range {dtype}", got, codes, lut)
        if float(got[0]) != 0.0:
            raise AssertionError("pq_scan: an all-out-of-range row is not 0")
        log(f"[rag] pq_scan {dtype} K={k} with codes {list(bad)} (30% of "
            f"codes, one row all): max_abs_err={e:.3g}, that row = 0")
    codes, lut = _pq_inputs(gen, 2000, 227, 256, torch.uint8)
    got = pq.pq_scan(codes, lut)
    e = compare_fp32("pq_scan at the LUT limit", got, ref.pq_scan(codes, lut))
    equal_in_order("pq_scan at the LUT limit", got, codes, lut)
    log(f"[rag] pq_scan M=227 K=256 (LUT {227 * 256 * 4} B = the "
        f"{pq.SMEM_LIMIT} B limit): max_abs_err={e:.3g}, equal to the "
        f"in-order plain version; plan {_plan_line(codes, lut)}")
    codes, lut = _pq_inputs(gen, 10, 227, 257, torch.int32)
    try:
        pq.pq_scan(codes, lut)
    except ValueError as err:
        log(f"[rag] pq_scan M=227 K=257 raises: {err}")
    else:
        raise AssertionError("pq_scan took a LUT past shared memory")


def _plan_line(codes, lut) -> str:
    """The kernel's launch plan for these inputs, as its C entry makes it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import pq_scan as pq
    p = pq.plan(codes, _build.aligned(lut))
    rows = (f"rows of {p['vectors']} x 16 bytes" if p["vectors"]
            else "row by row")
    return (f"grid {p['grid']} x {p['threads']} threads, {rows} in batches "
            f"of {p['batch']}, LUT by "
            f"{'bulk copy' if p['lut_bulk'] else 'plain fill'}, {p['smem']} B "
            f"of shared memory")


def _pq_timed(gen):
    """(c) one query's scan at IVFPQConfig's sizes, cold: the kernel, the
    plain version and one embedding_bag call over COLD_ARRAYS code arrays
    in turn; the kernel also warm and with int32 codes. Returns the kernel
    row of the kernels line (uint8, cold)."""
    from repro_torch.kernels import pq_scan as pq
    from repro_torch.kernels import ref
    from repro_torch.perfmodel.rag_model import IVFPQConfig
    cfg = IVFPQConfig()
    n, m, k = cfg.n_probe * cfg.points_per_probe, cfg.pq_m, cfg.pq_k
    arrays = [torch.randint(0, k, (n, m), generator=gen, device="cuda",
                            dtype=torch.uint8) for _ in range(COLD_ARRAYS)]
    lut = torch.rand(m, k, generator=gen, device="cuda")
    got, want = pq.pq_scan(arrays[0], lut), ref.pq_scan(arrays[0], lut)
    err = compare_fp32("pq_scan one query", got, want)
    equal_in_order("pq_scan one query", got, arrays[0], lut)
    rel = float(((got - want).abs() / want.abs()).max())
    # the library yardstick: bag n of the flat LUT at code + m * K
    table = lut.reshape(-1, 1)
    offs = torch.arange(m, device="cuda") * k
    idx = [a.long() + offs for a in arrays]
    lib = torch.nn.functional.embedding_bag(idx[0], table, mode="sum")[:, 0]
    compare_fp32("embedding_bag yardstick", lib, want)
    iters = 3 * COLD_ARRAYS
    turn = itertools.cycle(range(COLD_ARRAYS))
    ms = cuda_time_ms(lambda: pq.pq_scan(arrays[next(turn)], lut),
                      iters=iters, hold=True)
    paced = cuda_time_ms(lambda: pq.pq_scan(arrays[next(turn)], lut),
                         iters=iters)
    warm = cuda_time_ms(lambda: pq.pq_scan(arrays[0], lut), iters=iters,
                        hold=True)
    plain = cuda_time_ms(lambda: ref.pq_scan(arrays[next(turn)], lut),
                         iters=iters, hold=True)
    library = cuda_time_ms(lambda: torch.nn.functional.embedding_bag(
        idx[next(turn)], table, mode="sum"), iters=iters, hold=True)
    nbytes = n * m + 4 * n + 4 * m * k
    bound_ms, bound_by = bound(nbytes, n * m, PEAK_FP32_FLOPS)
    log(f"[rag] one query's scan, IVFPQConfig n_probe {cfg.n_probe} x "
        f"points_per_probe {cfg.points_per_probe} = {n} rows x {m} uint8 "
        f"codes, K={k}: max_abs_err={err:.3g} max_rel_err={rel:.3g}, equal "
        f"to the in-order plain version; plan {_plan_line(arrays[0], lut)}")
    log(f"[rag] cold ({COLD_ARRAYS} code arrays in turn, host queue held): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, embedding_bag "
        f"{library:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{nbytes} B); kernel paced by the host's launches {paced:.4f} ms, "
        f"warm (one array, L2-resident) {warm:.4f} ms")
    del arrays, idx
    arrays = [torch.randint(0, k, (n, m), generator=gen, device="cuda",
                            dtype=torch.int32) for _ in range(COLD_ARRAYS)]
    equal_in_order("pq_scan one query int32", pq.pq_scan(arrays[0], lut),
                   arrays[0], lut)
    ms32 = cuda_time_ms(lambda: pq.pq_scan(arrays[next(turn)], lut),
                        iters=iters, hold=True)
    nbytes32 = 4 * n * m + 4 * n + 4 * m * k
    log(f"[rag] the same query with int32 codes, cold: kernel {ms32:.4f} ms, "
        f"bound {bound(nbytes32, n * m, PEAK_FP32_FLOPS)[0]:.4f} ms "
        f"({nbytes32} B), equal to the in-order plain version; plan "
        f"{_plan_line(arrays[0], lut)}")
    del arrays
    return dict(max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain,
                library_ms=library, bound_ms=bound_ms, bound_by=bound_by)


def _pq_shard(gen):
    """(d) a shard-scale scan: SHARD_ROWS x 16 uint8 codes, timed, its
    achieved bandwidth printed, held against the plain version in
    SHARD_CHUNK-row chunks."""
    from repro_torch.kernels import pq_scan as pq
    from repro_torch.kernels import ref
    m, k = 16, 256
    codes = torch.empty(SHARD_ROWS, m, device="cuda", dtype=torch.uint8)
    for i in range(0, SHARD_ROWS, SHARD_CHUNK):
        codes[i:i + SHARD_CHUNK].random_(0, k, generator=gen)
    lut = torch.rand(m, k, generator=gen, device="cuda")
    out = pq.pq_scan(codes, lut)
    err = max(compare_fp32(f"pq_scan shard rows {i}+",
                           out[i:i + SHARD_CHUNK],
                           ref.pq_scan(codes[i:i + SHARD_CHUNK], lut))
              for i in range(0, SHARD_ROWS, SHARD_CHUNK))
    last = slice(SHARD_ROWS - SHARD_CHUNK, SHARD_ROWS)
    equal_in_order("pq_scan shard's last chunk", out[last], codes[last], lut)
    del out
    ms = cuda_time_ms(lambda: pq.pq_scan(codes, lut), iters=5, warmup=1)
    nbytes = SHARD_ROWS * m + 4 * SHARD_ROWS + 4 * m * k
    bound_ms, bound_by = bound(nbytes, SHARD_ROWS * m, PEAK_FP32_FLOPS)
    log(f"[rag] shard scan {SHARD_ROWS} rows x {m} uint8 codes "
        f"({SHARD_ROWS * m / 2**30:.0f} GiB codes, "
        f"{4 * SHARD_ROWS / 2**30:.0f} GiB out): kernel {ms:.4f} ms, "
        f"{nbytes / ms / 1e6:.1f} GB/s = {bound_ms / ms:.4f} of "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s (bound {bound_ms:.4f} ms, "
        f"{bound_by}); max_abs_err={err:.3g} over {SHARD_ROWS // SHARD_CHUNK} "
        f"plain chunks of {SHARD_CHUNK} rows, the last equal to the in-order "
        f"plain version; plan {_plan_line(codes, lut)}")
    del codes, lut
    torch.cuda.empty_cache()


def phase_rag():
    """The IVF-PQ scan kernel checked, the RAG path driven through it, one
    query's scan and a shard-scale scan timed. Returns (the pq_scan row of
    the kernels line, its launches on the path)."""
    from repro_torch.kernels import pq_scan as pq
    from repro_torch.kernels import ref
    from repro_torch.launch import rag
    from repro_torch.kernels import _build
    gen = torch.Generator(device="cuda").manual_seed(13)
    for key, report in _build.ptxas_reports.items():
        if key.startswith("pq_scan"):
            fn = ""
            for ln in report.splitlines():
                if "entry function" in ln:
                    fn = ln.split("'")[1] if "'" in ln else ln
                elif "registers" in ln or "spill" in ln:
                    log(f"[rag] ptxas {fn}: {ln.strip()}")
    _pq_kernel_cases(gen)

    # (b) the path at its defaults (200,000 rows x 16 int32 codes, K = 256,
    # seed 0) and with the same codes stored as uint8; the plain version on
    # the same inputs on the card
    pq.launches = 0
    ids = {c: rag.main(["--codes", c]) for c in ("int32", "uint8")}
    torch.cuda.synchronize()
    launches = pq.launches
    if launches <= 0:
        raise AssertionError("rag: pq_scan never launched")
    for c, got in ids.items():
        codes, lut = rag.make_inputs(200_000, 16, 256, seed=0, codes=c)
        want = ref.pq_scan(codes, lut)
        scan = pq.pq_scan(codes, lut)
        e = compare_fp32(f"pq_scan main path {c}", scan, want)
        equal_in_order(f"pq_scan main path {c}", scan, codes, lut)
        log(f"[rag] launch.rag.main --codes {c} on the card: top-5 ids "
            f"{got}, plain version {rag.nearest(want)}; kernel vs plain on "
            f"the path's inputs max_abs_err={e:.3g}, equal to the in-order "
            f"plain version; plan {_plan_line(codes, lut)}")
        if got != rag.nearest(want):
            raise AssertionError(f"rag: {c} top-5 ids differ from the plain "
                                 f"version's")
        del codes, lut, want
    launches += _rag_example()
    log(f"[rag] pq_scan launches on the path: {launches}")

    row = _pq_timed(gen)
    _pq_shard(gen)
    return row, launches


def _rag_example() -> int:
    """``examples/rag_pipeline_torch.py`` whole on the card: its live scan
    through the pq_scan kernel, the distances at the ids it prints held
    against the plain version's (``compare_fp32``), its top-5 equal to the
    plain top-5 but where two distances tie within that rounding. Returns
    the kernel's launches in it."""
    import importlib.util
    from repro_torch.kernels import pq_scan as pq
    from repro_torch.kernels import ref
    from repro_torch.launch import rag
    spec = importlib.util.spec_from_file_location(
        "rag_pipeline_torch", ROOT / "examples" / "rag_pipeline_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    before = pq.launches
    ids, dist = ex.main([])
    torch.cuda.synchronize()
    launches = pq.launches - before
    codes, lut = rag.make_inputs(ex.N, ex.M, ex.K, seed=0)
    want = ref.pq_scan(codes, lut)
    at = torch.tensor(ids, device=want.device)
    e = compare_fp32("rag_pipeline_torch distances at its top-5",
                     dist[at], want[at])
    plain = rag.nearest(want)
    ties = [(a, b) for a, b in zip(ids, plain) if a != b]
    if launches <= 0 or any(
            abs(float(want[a] - want[b])) > PQ_ATOL + PQ_RTOL * abs(
                float(want[b])) for a, b in ties):
        raise AssertionError(f"rag_pipeline_torch: {launches} launches, "
                             f"top-5 {ids} against the plain {plain}")
    log(f"[rag] examples/rag_pipeline_torch.py on the card: top-5 ids {ids}, "
        f"plain version {plain} ({len(ties)} places differ within a tie); "
        f"distances there max_abs_err={e:.3g} (atol {PQ_ATOL}, rtol "
        f"{PQ_RTOL}); {launches} pq_scan launches")
    return launches


# ---------------------------------------------------------------------------
# phases 5-6: the paged Engine at full Gemma-2B width
# ---------------------------------------------------------------------------

# fp32 noise drawn at a time by _perturb outside the stacked layers (the
# embedding and head of a 256k vocabulary are billions of values)
NOISE_ELEMS = 2 ** 28


def _weight_std(cfg, path, shape) -> float:
    """A leaf's scale: its fan-in's (``shape`` the stacked leaf's), 0.1 for
    norm gammas, d ** -0.5 for the embedding, so activations stay O(1) at
    full width."""
    if path == "embed":
        return cfg.d_model ** -0.5
    if path.endswith(("gamma", "beta")):    # norms (beta: layernorm)
        return 0.1
    # the hybrid's one shared block is not stacked
    per_layer = shape if path.startswith("shared.") else shape[1:]
    if ".moe.w" in path:              # (experts, fan-in, fan-out)
        return per_layer[1] ** -0.5
    if path == "slstm.r":             # (heads, fan-in, 4, head dim)
        return per_layer[1] ** -0.5
    fan_in = (int(np.prod(per_layer[:-1])) if path.endswith("wo")
              else per_layer[0])
    return fan_in ** -0.5


def _perturb(params, cfg, gen, share: float = 1.0):
    """Add seeded noise to every leaf in place: ``share`` of each weight's
    scale (``_weight_std``). The noise is drawn one layer slice of a
    stacked leaf at a time, and in blocks of rows of at most NOISE_ELEMS
    values elsewhere, so that it never needs the fp32 size of a whole
    leaf."""
    def walk(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
                continue
            sd = share * _weight_std(cfg, path, v.shape)
            rows = (1 if path.startswith("layers.")
                    else max(1, NOISE_ELEMS // max(1, v[0].numel())))
            # an MoE layer's experts (DeepSeek-V2-236B: 2.5e9 values) one
            # at a time
            parts = (v.flatten(0, 1).split(1) if ".moe.w" in path
                     else v.split(rows))
            for part in parts:
                noise = torch.randn(part.shape, generator=gen, device="cuda")
                part.add_((noise * sd).to(v.dtype))
                del noise
    walk(params, "")
    return params


def full_width_params(cfg, seed: int = 0, share: float = 1.0):
    """Seeded random weights on the card with every leaf perturbed by
    ``share`` of its scale (``_perturb``): the JAX-style init zeroes both
    output projections and every norm gamma, which would make the output
    ignore attention."""
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return _perturb(tf.init_model(cfg, gen, "cuda"), cfg, gen, share)


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
    names = ("flash_attention", "paged_decode_attention", "decode_attention")
    saved = [getattr(ops, n) for n in names]
    for n in names:
        setattr(ops, n, getattr(ref, n))
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ops, n, fn)


def flash_p_bf16(q, k, v, *, causal=True, scale=None):
    """ref.flash_attention with P rounded to bf16 before P·V and the row
    sums taken over the fp32 P, the rounding the flash kernel makes: a
    second plain version, to measure how far rounding alone moves the
    model."""
    from repro_torch.kernels import ref
    b, s, nh, d = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qr = q.reshape(b, s, kvh, nh // kvh, d)
    sc = torch.einsum("bskgh,btkh->bkgst", qr.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        sc = torch.where(mask, sc, torch.tensor(ref.NEG_INF, device=q.device))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgst,btkh->bskgh", p.to(torch.bfloat16).float(),
                       v.float())
    out = out / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, nh, dv).to(q.dtype)


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


def _prefill_and_decode(params, cfg, prompt, feed=None, steps=4, batch=8):
    """Prefill one prompt into row 0 of a ``batch``-row paged cache and
    decode ``steps`` tokens, each ``feed`` (default: the prefill's greedy
    token). Returns (the logits of every step, feed)."""
    from repro_torch.models import steps as st
    logits, caches, tabs, lens = _prefill_paged(params, cfg, prompt,
                                                batch=batch)
    out = [logits[0].float()]
    feed = int(out[0].argmax()) if feed is None else feed
    for _ in range(steps):
        _set_rows(cfg, caches, tabs, lens)
        toks = torch.zeros(batch, 1, dtype=torch.int32, device="cuda")
        toks[0, 0] = feed
        _, lg, caches = st.serve_step(params, toks, caches, cfg)
        out.append(lg[0].float())
        lens = lens.clone()
        lens[0] += 1
    return out, feed


def _prefill_and_decode_dense(params, cfg, prompt, feed=None, steps=4):
    """``_prefill_and_decode`` over one row's dense caches (MLA's latent
    cache is not paged): prefill, then ``steps`` decode steps each fed
    ``feed`` (default: the prefill's greedy token)."""
    from repro_torch.models import steps as st
    logits, caches = st.prefill_step(
        params, {"tokens": torch.as_tensor(prompt[None], device="cuda")},
        cfg, 2048)
    out = [logits[0].float()]
    feed = int(out[0].argmax()) if feed is None else feed
    for _ in range(steps):
        _, lg, caches = st.serve_step(
            params, torch.tensor([[feed]], dtype=torch.int32, device="cuda"),
            caches, cfg)
        out.append(lg[0].float())
    return out, feed


# the attention kernels layer_checks holds (ops entry = ref entry)
ATTN_KERNELS = ("flash_attention", "paged_decode_attention",
                "decode_attention", "paged_verify_attention",
                "paged_chunk_attention")


def _fp32_tree(tree):
    """An fp32 copy of every leaf (a copy also of fp32 leaves: a state
    given to a step that writes it in place)."""
    return {k: _fp32_tree(v) if isinstance(v, dict)
            else v.to(torch.float32, copy=True) for k, v in tree.items()}


# a recurrent decode step (bf16, its state written by the bf16 steps)
# against the same step in fp32: per output row ||bf16 - fp32|| / ||fp32||
# <= STEP_ROW_RTOL, and the control, the fp32 step given the state as it
# was before the last write (of the step before, or of the prefill), must
# fail it. Set from the readings of tools/recurrent_step_tol.py over seeds
# (PERF.md section 6)
STEP_ROW_RTOL = {"mamba2_decode": 0.03, "mlstm_decode": 0.03}


class _Held(dict):
    """``layer_checks``' readings: name -> (calls, max abs error, max row
    error); for a recurrent step, ``controls``: -> its controls' least row
    error, ``bounds``: -> its largest elementwise error as a share of the
    bound."""

    def __init__(self):
        super().__init__()
        self.controls, self.bounds = {}, {}
        self.lse = 0.0          # dense decode's largest lse difference


def _step_errors(got, want, ctrl):
    """(max abs error, the largest elementwise error as a share of ATOL x
    max |want| + RTOL x |want|, the largest row error, the control's least
    row error) of a recurrent step's output against its fp32 step and
    against the control."""
    torch.cuda.synchronize()
    got, want, ctrl = got.float(), want.float(), ctrl.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite recurrent step output")
    err = (got - want).abs()
    ratio = float((err / (ATOL * want.abs().max() + RTOL * want.abs())
                   ).max())
    d = got.shape[-1]
    rows = lambda a, b: ((a - b).reshape(-1, d).norm(dim=1)  # noqa: E731
                         / b.reshape(-1, d).norm(dim=1))
    return (float(err.max()), ratio, float(rows(got, want).max()),
            float(rows(got, ctrl).min()))


@contextlib.contextmanager
def layer_checks(gate_steps: bool = True):
    """Hold every layer call the model makes against its plain version on
    that call's own inputs (``compare``: ATOL/RTOL and ROW_RTOL; a dense
    decode row of length 0 must only be finite), the kernel path's output
    going on into the model: the five attention kernels (ATTN_KERNELS)
    against ``ref``; each MoE layer's ``apply_moe`` against
    ``moe_reference`` (fp32, the same routing), with the elementwise bound
    taken of the output's largest entry (``compare(of_max=True)``); each
    Mamba2 and mLSTM decode step against the same step in fp32
    (parameters, input and state), its state written by the bf16 step
    only: that elementwise bound, STEP_ROW_RTOL per row, and a control
    that must fail the row check, the fp32 step given the state as it was
    before the last write (``_step_errors``; ``gate_steps=False`` only
    records the readings); dense decode's lse, where a caller asks for it,
    against the plain lse (``_check_lse``), and under ``seq_sharded`` each
    merged decode (``attention.seq_decode_attention``) against the plain
    decode over the whole sequence gathered from the data ranks. Each
    layer is so held
    at the activations the model gives it, whatever the depth: rounding
    that compounds through the layers does not enter. Yields a ``_Held``
    of each checked call's (calls, max abs error, max row error), by
    name."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm as xl
    saved = {n: getattr(ops, n) for n in ATTN_KERNELS}
    merge_fn = attn.seq_decode_attention
    moe_fn = tf.apply_moe
    decodes = {"mamba2_decode": m2, "mlstm_decode": xl}
    saved_dec = {n: getattr(mod, n) for n, mod in decodes.items()}
    worst = _Held()

    def note(name, e, r):
        n, e0, r0 = worst.get(name, (0, 0.0, 0.0))
        worst[name] = (n + 1, max(e0, e), max(r0, r))
        return n

    def held(name, kernel, plain):
        def run(*args, **kw):
            out = kernel(*args, **kw)
            n = worst.get(name, (0,))[0]
            want = plain(*args, **kw)
            if name == "decode_attention":
                lengths = args[3].tolist()
                if kw.get("return_lse"):
                    worst.lse = max(worst.lse, _check_lse(
                        f"{name} call {n} lse", out[1], want[1], lengths))
                    e, r = _check_rows(f"{name} call {n}", out[0], want[0],
                                       lengths)
                else:
                    e, r = _check_rows(f"{name} call {n}", out, want,
                                       lengths)
            else:
                e, r = compare(f"{name} call {n}", out, want)
            note(name, e, r)
            return out
        return run

    def held_merge(q, k_cache, v_cache, lengths, scale, ax):
        # the slices' merged output against the plain decode over the
        # whole sequence gathered from the ranks (positions over ``ax``),
        # at each row's whole length (the sum of the local ones)
        out = merge_fn(q, k_cache, v_cache, lengths, scale, ax)
        from repro_torch import distributed as D
        k_all = D.gather(k_cache, 1, ax)
        v_all = D.gather(v_cache, 1, ax)
        total = D.all_reduce(lengths.clone(), ax)
        n = worst.get("seq_decode_attention", (0,))[0]
        note("seq_decode_attention", *_check_rows(
            f"seq_decode_attention call {n}", out,
            ref.decode_attention(q, k_all, v_all, total, scale=scale),
            total.tolist()))
        return out

    def held_moe(p, x, cfg, mesh=None, tp=None):
        out, aux = moe_fn(p, x, cfg, mesh, tp)
        if tp is None:    # a rank's shards have no one-card reference
            n = worst.get("apply_moe", (0,))[0]
            note("apply_moe", *compare(f"apply_moe call {n}", out,
                                       moe.moe_reference(p, x, cfg), True))
        return out, aux

    def held_decode(name):
        step = saved_dec[name]
        # each state's copy before the last step wrote it, by address
        before = {}

        def run(p, x, cfg, state, tp=None):
            # the fp32 steps first, on copies: the bf16 step writes state
            # (under a mesh, ``tp``, every rank runs the same three steps,
            # so their collectives pair up)
            p32, x32 = _fp32_tree(p), x.float()
            cfg32 = cfg.replace(param_dtype="float32",
                                compute_dtype="float32")
            s_in = _fp32_tree(state)
            want, _ = step(p32, x32, cfg32, _fp32_tree(state), tp=tp)
            # the control: the state as it was before the last write (of
            # the step before, or zeros where the prefill wrote it)
            key = next(_leaves(state)).data_ptr()
            ctrl, _ = step(p32, x32, cfg32, before.get(key) or {
                k: torch.zeros_like(v) for k, v in s_in.items()}, tp=tp)
            before[key] = s_in
            out = step(p, x, cfg, state, tp=tp)
            n = worst.get(name, (0,))[0]
            e, ratio, r, rc = _step_errors(out[0], want, ctrl)
            note(name, e, r)
            worst.controls[name] = min(worst.controls.get(name, rc), rc)
            worst.bounds[name] = max(worst.bounds.get(name, 0.0), ratio)
            tol = STEP_ROW_RTOL[name]
            if gate_steps and not (ratio <= 1 and r <= tol < rc):
                raise AssertionError(
                    f"{name} call {n}: elementwise {ratio:.3g} of its "
                    f"bound, row error {r:.4g}, control's {rc:.4g} "
                    f"(limit {tol})")
            return out
        return run
    for n in ATTN_KERNELS:
        setattr(ops, n, held(n, saved[n], getattr(ref, n)))
    tf.apply_moe = held_moe
    attn.seq_decode_attention = held_merge
    for n, mod in decodes.items():
        setattr(mod, n, held_decode(n))
    try:
        yield worst
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
        tf.apply_moe = moe_fn
        attn.seq_decode_attention = merge_fn
        for n, mod in decodes.items():
            setattr(mod, n, saved_dec[n])


def _steps_text(worst) -> str:
    """The recurrent steps' readings of ``layer_checks``, for a log line."""
    return "".join(
        f"; {k}: elementwise <= {worst.bounds[k]:.3g} of its bound, row "
        f"error <= {worst[k][2]:.4g} (limit {STEP_ROW_RTOL[k]}), control's "
        f">= {c:.4g}" for k, c in worst.controls.items())


def _held_line(tag, worst, want):
    """Log what ``layer_checks`` held and raise unless it held ``want``
    (name -> calls) and nothing else."""
    log(f"[{tag}] every layer call against its plain version on its own "
        f"inputs: " + "; ".join(f"{k} {n} calls, max_abs_err={e:.3g} "
                                f"max_row_rel_err={r:.3g}"
                                for k, (n, e, r) in worst.items())
        + f" (atol {ATOL}, rtol {RTOL}, row {ROW_RTOL})" + _steps_text(worst))
    if {k: n for k, (n, _, _) in worst.items()} != want:
        raise AssertionError(f"{tag}: held {worst}, want {want}")


def phase_logits(cfg, params, tag="logits", gate=True, prompt_len=300):
    """The full model through the kernels, every layer's attention held
    against its plain version on its own inputs (``layer_checks``),
    against the same model through the plain attention versions: prefill
    of ``prompt_len`` tokens and 4 decode steps fed the kernel path's
    greedy token. ``gate``: the logits must also lie within LOGIT_TOL of
    plain attention's; else their drift is printed beside it."""
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, prompt_len
                                               ).astype(np.int32)
    # MLA: dense caches, and decode is einsums (flash in prefill only); the
    # hybrid: dense caches, its shared block applied n_apps times
    mla = cfg.attn_type == "mla"
    hybrid = cfg.family == "hybrid"
    run = (_prefill_and_decode_dense if mla or hybrid
           else _prefill_and_decode)
    with layer_checks() as worst:
        got, feed = run(params, cfg, prompt)
    with plain_attention():
        want, _ = run(params, cfg, prompt, feed)
    torch.cuda.synchronize()
    layers = (cfg.num_layers // cfg.shared_attn_every if hybrid
              else cfg.num_layers)
    calls = layers * (1 if mla else len(got))
    log(f"[{tag}] every layer's attention (and MoE, and Mamba2 decode "
        f"step) against its plain version on its own inputs, {layers} "
        f"attention layers x (prefill + 4 decode steps): "
        + "; ".join(f"{k} {n} calls, max_abs_err={e:.3g} "
                    f"max_row_rel_err={r:.3g}"
                    for k, (n, e, r) in worst.items())
        + f" (atol {ATOL}, rtol {RTOL}, row {ROW_RTOL})" + _steps_text(worst))
    held = {k: n for k, (n, _, _) in worst.items()}
    expect = {}
    if cfg.family == "moe":
        expect["apply_moe"] = (cfg.num_layers - cfg.moe.first_k_dense
                               ) * len(got)
    if hybrid:
        expect["mamba2_decode"] = cfg.num_layers * (len(got) - 1)
    if (sum(held.get(k, 0) for k in ATTN_KERNELS) != calls
            or any(held.get(k) != n for k, n in expect.items())):
        raise AssertionError(f"{tag}: {worst} held, {calls} attention "
                             f"calls and {expect} expected")
    drift = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != (cfg.vocab_size,) or not torch.isfinite(g).all():
            raise AssertionError(f"logits step {i}: bad shape or non-finite")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        log(f"[{tag}] step {i}: max|kernel - plain| = {err:.4g} "
            f"(max|logit| {scale:.4g}, share {err / scale:.4f}, "
            f"{'limit' if gate else 'not gated, LOGIT_TOL'} {LOGIT_TOL}; "
            f"argmax equal: {int(g.argmax()) == int(w.argmax())})")
        if gate and err > LOGIT_TOL * scale:
            raise AssertionError(f"logits step {i} off by {err}")
        drift = max(drift, err / scale)
    return drift


def _pass_inputs(eng, p, rng, gen):
    """Random inputs for compiled pass ``p`` of ``eng`` at its shape:
    seeded pools (the dense engine: caches), per-row tables over a random
    permutation of the pages, lengths that leave room for the pass's ``s``
    positions, tokens and q_valid. Returns (the pass's arrays, the tensors
    it writes)."""
    from repro_torch.engine.core import SlotEngine, _push
    b, s = p.inputs.dev["tokens"].shape
    arrays = {"tokens": rng.integers(0, eng.cfg.vocab_size, (b, s)
                                     ).astype(np.int32)}
    if "q_valid" in p.inputs.dev:
        arrays["q_valid"] = rng.integers(0, s + 1, b).astype(np.int32)
    rand = lambda t: t.copy_(torch.randn(  # noqa: E731
        t.shape, generator=gen, device="cuda"))
    if isinstance(eng, SlotEngine):
        g = eng.caches["attn"]
        rand(g["k"]), rand(g["v"])
        g["length"].copy_(torch.as_tensor(
            rng.integers(0, eng.max_len - 2, b), device="cuda")[None])
        return arrays, [g["k"], g["v"], g["length"]]
    caches, rows = ((eng.draft_caches, eng._draft_rows)
                    if p.name == "draft_decode" else (eng.caches, eng._rows))
    g = caches["attn"]
    rand(g["k_pool"]), rand(g["v_pool"])
    pages = g["k_pool"].shape[1] - 1                # the last is trash
    mb = rows.host["tables"].shape[1]
    per_row = min(mb, pages // b)
    tabs = np.full((b, mb), pages, np.int32)
    tabs[:, :per_row] = rng.permutation(pages)[:b * per_row].reshape(b, -1)
    lens = rng.integers(0, per_row * eng.block_tokens - s, b)
    _push(rows, tabs, lens.astype(np.int32))
    return arrays, [g["k_pool"], g["v_pool"]]


def _pass_work(eng, p, b, s):
    """(bytes, operations) of a pass's matrix products: every weight it
    multiplies by read once (the tied embedding as the head), two
    operations per weight and token row; the head's rows are the logits'
    (every position for verify, one a row otherwise)."""
    params = eng.draft_params if p.name == "draft_decode" else eng.params
    layers = sum(t.numel() for t in _leaves(params["layers"]))
    head = params["embed"].numel()
    rows = b * s if p.name == "verify" else b
    return 2 * (layers + head), 2 * (layers * b * s + head * rows)


def phase_graphs(cfg, params):
    """Every compiled pass at the engines' shapes (chunked Engine: decode
    (8, 1) and chunk (8, CHUNK); spec Engine: draft decode (8, 1) and
    verify (8, SPEC_K + 1); SlotEngine: decode (8, 1)), replayed against
    the same function run eagerly over the same static inputs: logits and
    tokens ``torch.equal`` and the written K/V ``torch.equal`` (every pool
    page but the trash page, where rows write their padding in no fixed
    order), at seeded inputs and again after rewriting the static inputs to
    new tables, lengths and tokens."""
    from repro_torch.engine.core import EngineConfig, SlotEngine
    draft = noisy_draft_params(params, cfg, SPEC_NOISE)
    makers = (
        ("chunked", lambda: _engine(cfg, params,
                                    config=EngineConfig(chunk_size=CHUNK))),
        ("spec", lambda: _engine(cfg, params, draft_params=draft,
                                 config=EngineConfig(draft_cfg=cfg,
                                                     spec_k=SPEC_K))),
        ("slot", lambda: SlotEngine(cfg, params=params, max_batch=8,
                                    max_len=2048, device="cuda")))
    rng = np.random.default_rng(19)
    gen = torch.Generator(device="cuda").manual_seed(19)
    seen, times = [], {}
    for tag, make in makers:
        eng = make()
        trim = slice(None) if tag == "slot" else slice(None, -1)
        for name, p in eng.passes().items():
            if p.graph is None:
                raise AssertionError(f"{tag}.{name}: not captured")
            for _ in range(2):
                arrays, state = _pass_inputs(eng, p, rng, gen)
                saved = [t.clone() for t in state]
                tok, logits = (t.clone() for t in p.run(**arrays))
                after = [t.clone() for t in state]
                for t, v in zip(state, saved):
                    t.copy_(v)
                tok_e, logits_e = p.fn()
                torch.cuda.synchronize()
                if logits.shape[0] != 8 or not torch.isfinite(logits).all():
                    raise AssertionError(f"{tag}.{name}: bad logits")
                equal = (torch.equal(logits, logits_e)
                         and torch.equal(tok, tok_e)
                         and all(torch.equal(t[:, trim], a[:, trim])
                                 for t, a in zip(state, after)))
                if not equal:
                    diff = float((logits - logits_e).abs().max())
                    raise AssertionError(
                        f"{tag}.{name}: graphed != eager (max logit "
                        f"difference {diff:.4g})")
            b, s = p.inputs.dev["tokens"].shape
            ms = cuda_time_ms(p.graph.replay, iters=10, warmup=2, hold=True)
            bound_ms, by = bound(*_pass_work(eng, p, b, s), PEAK_BF16_FLOPS)
            log(f"[graphs] {tag}.{name} ({b}, {s}): warm-up "
                f"{p.warm_up_s:.3f} s, capture {p.capture_s:.3f} s, one "
                f"replay launches {p.launches}; logits, tokens and written "
                f"K/V torch.equal eager at two input sets; one replay "
                f"{ms:.3f} ms of device time (host queue held), bound of its "
                f"matrix products {bound_ms:.3f} ms ({by})")
            seen.append(f"{tag}.{name}")
            times[f"{tag}.{name}"] = ms
        del eng
        torch.cuda.empty_cache()
    del draft
    log(f"[graphs] {len(seen)} passes graphed == eager: {seen}")
    return times


# the dry run's full-size cells on the (16, 16) mesh, and the SlotEngine's
# decode (its rows and cache length, phase graphs' "slot.decode") on (1, 1)
DRYRUN_CELLS = (("deepseek_v2_236b", "train_4k"),
                ("nemotron_4_340b", "decode_32k"))
DRYRUN_SLOT = (8, 2048)
# a fit's largest prediction error (of the largest float64 prediction)
# over the CPU fit's: the CPU tests hold torch's fp32 fit to 4x JAX's on
# the analytical grid and 16x on traces (tests/test_torch_perfmodel.py);
# the card sums XᵀX in yet another order
RIDGE_FACTOR = 16.0
RIDGE_ARCHS = ("gemma_2b", "llama3_70b", "deepseek_v2_236b", "zamba2_7b")

_DRYRUN = """
import json, sys
from repro_torch.launch import dryrun as dr
kind, what, out = json.loads(sys.argv[1])
if kind == "cell":
    row = dr.run_cell(*what, dr.production_mesh(False), False)
else:
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    b, max_len = what
    dr.fake_world(1)
    mesh = compat_make_mesh((1, 1), ("data", "model"), device="cpu")
    cfg = get_config("gemma_2b")
    shape = ShapeConfig("slot", max_len - 8, b, "decode")
    fn, args, arg_bytes = dr.build_cell(cfg, shape, mesh)
    cost = dr._measure(fn, args)
    row = {"arch": "gemma_2b", "shape": "slot", "arg_bytes_per_dev":
           arg_bytes, "bytes": cost["bytes"], **dr.terms(cfg, shape, cost, 1)}
with open(out, "w") as f:
    json.dump(row, f)
"""


def _ridge64(kind, cfg, cluster):
    """The float64 ridge fit of ``perfmodel.regression``'s ``kind``
    ("decode" or "prefill") on its own grid: its weights, its features in
    numpy and the grid's arguments."""
    from repro_torch.perfmodel import analytical as ana
    if kind == "decode":
        b = np.tile([1, 2, 4, 8, 16, 32, 64, 128], 6)
        p = np.repeat([128, 512, 1024, 2048, 4096, 8192], 8)
        y = [ana.decode_step_time(cfg, cluster, int(x), int(c)).time
             for x, c in zip(b, p)]
        args = (b, p)

        def feats(b, p):
            b, p = np.asarray(b, np.float64), np.asarray(p, np.float64)
            return np.stack([np.ones_like(b), b, p, b * p, b * b, p * p], -1)
    else:
        grid = np.array([(p_, n_, b_) for p_ in (0, 512, 2048, 8192)
                         for n_ in (64, 128, 256, 512, 1024, 2048, 4096)
                         for b_ in (1, 2, 4, 8)])
        args = tuple(grid.T)
        y = [ana.prefill_time(cfg, cluster, int(n_), int(b_),
                              past_tokens=int(p_)).time for p_, n_, b_ in grid]

        def feats(p, n, b):
            p, n, b = (np.asarray(v, np.float64) for v in (p, n, b))
            return np.stack([np.ones_like(p), p, n, b, n * n, p * n, b * n],
                            -1)
    X, y = feats(*args), np.asarray(y)
    w = np.linalg.solve(X.T @ X + 1e-6 * np.eye(X.shape[1]), X.T @ y)
    return w, feats, args


def _fit_errors(fit, cfg, cluster, device):
    """A ridge fit (``fit_decode_model`` or ``fit_prefill_model``) on
    ``device``: its largest prediction error over the float64 fit's at
    its own points, of the largest float64 prediction."""
    from repro_torch.perfmodel import regression as reg
    m = fit(cfg, cluster, device=device)
    kind = "decode" if fit is reg.fit_decode_model else "prefill"
    w, feats, args = _ridge64(kind, cfg, cluster)
    want = feats(*args) @ w
    got = m.predict(*args).double().cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def start_dryrun():
    """Start the dry run's cells (``_DRYRUN``: the full-size cells of
    ``DRYRUN_CELLS`` and gemma_2b's decode at ``DRYRUN_SLOT`` on (1, 1)),
    each in a subprocess of its own (the fake process group is global to
    a process), all at once: they need no card and run on the host's CPU
    beside the kernel phases until ``phase_dryrun`` collects them. Any
    still running when this process exits are stopped."""
    import atexit
    (ROOT / "build").mkdir(exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    jobs = [("cell", c) for c in DRYRUN_CELLS] + [("slot", DRYRUN_SLOT)]
    outs = [ROOT / "build" / f"dryrun{i}.json" for i in range(len(jobs))]
    procs = [subprocess.Popen([sys.executable, "-c", _DRYRUN,
                               json.dumps([kind, what, str(out)])], env=env)
             for (kind, what), out in zip(jobs, outs)]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs, outs


def phase_dryrun(cfg, params, graphed, started):
    """The dry run under the torch that runs this script: the rows of
    the cells ``start_dryrun`` started (``started``), every term finite
    and positive; the slot decode's ``arg_bytes_per_dev`` against the params
    (``params``), caches and tokens made on the card, its terms beside the
    graphed slot decode's replay (``graphed``, phase graphs'); the ridge
    fits on the card against the CPU's (``RIDGE_FACTOR``)."""
    from repro_torch.models import transformer as tf
    from repro_torch.perfmodel import hardware as hw
    from repro_torch.perfmodel import regression as reg
    from repro_torch.configs import get_config
    t0 = time.monotonic()
    procs, outs = started
    worst = []
    try:
        for arch in RIDGE_ARCHS:
            c = get_config(arch)
            cluster = hw.ClusterSpec(hw.H100, 8, 8)
            for fit in (reg.fit_decode_model, reg.fit_prefill_model):
                card = _fit_errors(fit, c, cluster, "cuda")
                cpu = _fit_errors(fit, c, cluster, "cpu")
                worst.append(card / max(cpu, 1e-6))
                if card > RIDGE_FACTOR * max(cpu, 1e-6):
                    raise AssertionError(
                        f"dryrun {arch} {fit.__name__} on the card: error "
                        f"{card:.3g} against the CPU fit's {cpu:.3g}")
        for p in procs:
            if p.wait(timeout=300):
                raise AssertionError(f"dryrun: a cell exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rows = [json.loads(out.read_text()) for out in outs]
    for r in rows[:-1]:
        terms = [r[k] for k in ("compute_term_s", "memory_term_s",
                                "memory_term_flash_s", "collective_term_s",
                                "flops_per_dev", "bytes_per_dev")]
        if not all(np.isfinite(terms)) or min(terms) <= 0 \
                or r["arg_bytes_per_dev"] <= 0:
            raise AssertionError(f"dryrun {r['arch']} {r['shape']}: {r}")
        log(f"[dryrun] {r['arch']} {r['shape']} 16x16 ({r['compile_s']} s): "
            f"C {r['compute_term_s'] * 1e3:.3f} ms, M "
            f"{r['memory_term_s'] * 1e3:.3f} ms, Mf "
            f"{r['memory_term_flash_s'] * 1e3:.3f} ms, N "
            f"{r['collective_term_s'] * 1e3:.3f} ms ({r['dominant']}; "
            f"{r['collective_calls']['all-reduce']} all-reduces), args "
            f"{r['arg_bytes_per_dev'] / 1e9:.2f} GB, temp "
            f"{r['temp_bytes_per_dev'] / 1e9:.2f} GB a device")
    slot = rows[-1]
    b, max_len = DRYRUN_SLOT
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    made = [t.clone() for t in _leaves(params)]
    made += list(_leaves(tf.init_cache(cfg, b, max_len, "cuda")))
    made.append(torch.zeros((b, 1), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    exact = sum(t.numel() * t.element_size() for t in made)
    # the caching allocator rounds each block up to a multiple of 512 bytes
    if slot["arg_bytes_per_dev"] != exact or not 0 <= grown - exact \
            < 512 * len(made):
        raise AssertionError(
            f"dryrun slot: arg_bytes_per_dev {slot['arg_bytes_per_dev']}, "
            f"the card's leaves {exact} B, memory_allocated grew {grown} B")
    del made
    torch.cuda.empty_cache()
    log(f"[dryrun] gemma_2b decode at ({b}, {max_len}) on (1, 1): "
        f"arg_bytes_per_dev {slot['arg_bytes_per_dev']} == the card's params, "
        f"caches and tokens (memory_allocated grew {grown} B, "
        f"{grown - exact} B of block rounding); C "
        f"{slot['compute_term_s'] * 1e3:.4f} ms, M "
        f"{slot['memory_term_s'] * 1e3:.4f} ms (eager bytes "
        f"{slot['bytes'] / 1e9:.3f} GB), Mf "
        f"{slot['memory_term_flash_s'] * 1e3:.4f} ms, N "
        f"{slot['collective_term_s'] * 1e3:.4f} ms; graphed slot decode "
        f"replay {graphed['slot.decode']:.3f} ms")
    log(f"[dryrun] ridge fits on the card: prediction error over the CPU "
        f"fit's at most {max(worst):.3f}x ({len(worst)} fits, limit "
        f"{RIDGE_FACTOR}x); phase {time.monotonic() - t0:.1f} s (the cells "
        f"started at the build)")


# the fleet simulator's runs (phase sim): llama3_70b on 4 clients at
# 2 requests/s, seed 0, each pipeline with the SystemSpec flag it needs
SIM_RUNS = (("regular", 100), ("rag", 100), ("kv", 100), ("reasoning", 50))


class _TimedFit:
    """Stands in for one of a ``ClientPerf``'s ridge models: counts its
    predictions (the memo misses that reach it), records each point's
    value and times each call with its copy to the host, the sync that
    ``ClientPerf``'s ``float()`` would make (the values are unchanged)."""

    def __init__(self, model):
        self.model = model
        self.points = {}
        self.calls = 0
        self.clashes = 0
        self.seconds = 0.0

    def predict(self, *args):
        t0 = time.perf_counter()
        out = self.model.predict(*args).cpu()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        v = float(out[0])
        self.clashes += self.points.setdefault(
            tuple(int(a[0]) for a in args), v) != v
        return out


def _sim_run(pipeline, n, device, fast_forward=True, fleet_index=True):
    """One seeded run of ``repro_torch.core`` with regression pricing on
    ``device``: its summary, the two timed models, wall seconds of the
    fits and of the run."""
    from repro_torch.core import (SystemSpec, WorkloadConfig, build_system,
                                  generate)
    from repro_torch.core.client import LLMClient
    from repro_torch.core.llm_scheduler import SchedulerLimits
    t0 = time.perf_counter()
    coord = build_system(SystemSpec(
        model="llama3_70b", n_llm_clients=4, use_regression=True,
        with_rag=pipeline == "rag", with_kv_retrieval=pipeline == "kv",
        fleet_index=fleet_index,
        limits=SchedulerLimits(fast_forward=fast_forward)), device=device)
    perf = next(c.scheduler.perf for c in coord.clients.values()
                if isinstance(c, LLMClient))
    perf.decode_model = _TimedFit(perf.decode_model)
    perf.prefill_model = _TimedFit(perf.prefill_model)
    t1 = time.perf_counter()
    coord.submit(generate(WorkloadConfig(rate=2.0, n_requests=n, seed=0,
                                         pipeline=pipeline)))
    summary = coord.run().summary(total_energy=coord.total_energy)
    t2 = time.perf_counter()
    if summary["n_serviced"] != n:
        raise AssertionError(f"sim {pipeline} on {device}: "
                             f"{summary['n_serviced']} of {n} serviced")
    return summary, (perf.decode_model, perf.prefill_model), t1 - t0, t2 - t1


def _same(a, b) -> bool:
    """``==`` with NaN equal to NaN, through dicts."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return a == b


def _sim_priced_errors(fits, cpu_models, cfg, cluster):
    """The card's predictions at the points the run priced against the
    CPU fit's prediction of each (one row a call, as the simulator asks):
    each one's largest error over the float64 fit's, of the largest
    float64 prediction, per kind."""
    out = {}
    for kind, fit, cpu in zip(("decode", "prefill"), fits, cpu_models):
        w, feats, _ = _ridge64(kind, cfg, cluster)
        pts = list(fit.points)
        want = feats(*zip(*pts)) @ w
        card = np.array([fit.points[p] for p in pts])
        host = np.array([float(cpu.predict(*[[v] for v in p])[0])
                         for p in pts])
        scale = np.abs(want).max()
        out[kind] = (float(np.abs(card - want).max() / scale),
                     float(np.abs(host - want).max() / scale), len(pts))
    return out


def phase_sim(card: str):
    """The fleet simulator ``repro_torch.core`` (host code: an event heap
    and numpy's seeded generators) with its regression pricing on the
    card: for each of ``SIM_RUNS``, the run with fast-forward and the
    fleet index on, then off in turn, summaries ``==`` (NaN-aware), and
    every point priced the same float in every run; the card's
    predictions against the CPU fit's (``RIDGE_FACTOR``, the dryrun
    gate); the same run priced on the CPU for its timings; then
    ``examples/serve_e2e_torch.py`` whole (the port's paged Engine at
    gemma_2b's full width, then its schedule replayed in the simulator)."""
    import importlib.util
    from repro_torch.configs import get_config
    from repro_torch.core.llm_scheduler import ClientPerf
    from repro_torch.perfmodel import hardware as hw
    t0 = time.monotonic()
    cfg = get_config("llama3_70b")
    cluster = hw.ClusterSpec(hw.H100, n_chips=2, tp=2, intra_link=hw.NVLINK)
    cpu_perf = ClientPerf(cfg, cluster, use_regression=True, device="cpu")
    cpu_models = (cpu_perf.decode_model, cpu_perf.prefill_model)
    log(f"[sim] {card}; llama3_70b, 4 clients (2 x H100 TP2 each), 2 "
        "requests/s, seed 0, ridge-fit pricing")
    for pipeline, n in SIM_RUNS:
        runs = {arm: _sim_run(pipeline, n, "cuda", **kw) for arm, kw in (
            ("on", {}), ("ff_off", dict(fast_forward=False)),
            ("index_off", dict(fleet_index=False)))}
        ref, fits, fit_s, wall = runs["on"]
        for arm in ("ff_off", "index_off"):
            if not _same(runs[arm][0], ref):
                diff = [k for k in ref if not _same(runs[arm][0][k], ref[k])]
                raise AssertionError(f"sim {pipeline} on the card: summary "
                                     f"with {arm} differs at {diff[:5]}")
            for a, b in zip(runs[arm][1], fits):
                clash = [p for p in set(a.points) & set(b.points)
                         if a.points[p] != b.points[p]]
                if clash or a.clashes or b.clashes:
                    raise AssertionError(
                        f"sim {pipeline}: points priced differently on the "
                        f"card, across runs {clash[:3]}, within runs "
                        f"{a.clashes + b.clashes}")
        errs = _sim_priced_errors(fits, cpu_models, cfg, cluster)
        for kind, (card_err, cpu_err, npts) in errs.items():
            if card_err > RIDGE_FACTOR * max(cpu_err, 1e-6):
                raise AssertionError(
                    f"sim {pipeline} {kind}: the card's error {card_err:.3g} "
                    f"against the CPU fit's {cpu_err:.3g} at {npts} points")
        host, host_fits, host_fit_s, host_wall = _sim_run(pipeline, n, "cpu")
        for dev, fs, f_s, w_s, s in (("cuda", fits, fit_s, wall, ref),
                                     ("cpu", host_fits, host_fit_s,
                                      host_wall, host)):
            misses = sum(f.calls for f in fs)
            miss_s = sum(f.seconds for f in fs)
            log(f"[sim] {pipeline} x {n} on {dev}: wall {w_s:.3f} s (fits "
                f"{f_s:.3f} s), {misses} memo misses, "
                f"{miss_s / max(misses, 1) * 1e6:.1f} us a miss "
                f"({miss_s:.3f} s), ttft_p50 {s['ttft_p50'] * 1e3:.2f} ms, "
                f"tpot_p50 {s['tpot_p50'] * 1e3:.3f} ms")
        log(f"[sim] {pipeline}: fast-forward off == on, fleet index off == "
            f"on (ff off {runs['ff_off'][3]:.3f} s, index off "
            f"{runs['index_off'][3]:.3f} s); the card's error over the "
            f"float64 fit's against the CPU's: " + ", ".join(
                f"{k} {c:.3g} / {h:.3g} ({m} points)"
                for k, (c, h, m) in errs.items()))
    spec = importlib.util.spec_from_file_location(
        "serve_e2e_torch", ROOT / "examples" / "serve_e2e_torch.py")
    e2e = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(e2e)
    done, s = e2e.main([])
    ttft = float(np.median([r.ttft for r in done]))
    tpot = float(np.median([r.tpot for r in done if r.tpot]))
    sims = (s["ttft_p50"], s["tpot_p50"])
    if len(done) != 10 or s["n_serviced"] != 10 \
            or not np.all(np.isfinite((ttft, tpot) + sims)):
        raise AssertionError(f"sim serve_e2e_torch: {len(done)} served, "
                             f"{s['n_serviced']} simulated, {ttft}, {tpot}, "
                             f"{sims}")
    log(f"[sim] serve_e2e_torch on {card}: measured ttft p50 "
        f"{ttft * 1e3:.2f} ms, tpot p50 {tpot * 1e3:.3f} ms; simulated "
        f"{sims[0] * 1e3:.2f} ms, {sims[1] * 1e3:.3f} ms; phase "
        f"{time.monotonic() - t0:.1f} s")


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


def _serve_line(tag, done, prompts, wall, steps, peak):
    toks = sum(len(r.tokens) for r in done)
    log(f"[{tag}] {len(done)} requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens, {toks} tokens generated; wall "
        f"{wall:.3f}s, {toks / wall:.2f} tok/s, TTFT mean "
        f"{np.mean([r.ttft for r in done]) * 1e3:.2f} ms, TPOT mean "
        f"{np.mean([r.tpot for r in done]) * 1e3:.2f} ms, engine steps "
        f"{steps}, peak allocated {peak[0] / 2**30:.2f} GiB, reserved "
        f"{peak[1] / 2**30:.2f} GiB")


def _means_ms(done):
    return (np.mean([r.ttft for r in done]) * 1e3,
            np.mean([r.tpot for r in done]) * 1e3)


def _arms(tag, make, prompts, max_new=64):
    """Serve ``prompts`` through ``make(cuda_graphs=True)`` (passes
    replayed as CUDA graphs), then ``make(cuda_graphs=False)`` (the same
    passes eagerly), each engine built before its launch counters are set
    to 0 and its peak memory reset, and freed before the next. Holds the
    graphed arm to the eager one: equal streams, equal launch counts (the
    graphs' replays added), every pass replayed. Prints both side by side;
    returns {"graphed": run, "eager": run}, each a dict of the finished
    requests, wall time, launch counts, replays, peak memory (allocated,
    reserved), the engine's kv/spec/transfer stats and steps."""
    from repro_torch.kernels import ops
    runs = {}
    for arm, flag in (("graphed", True), ("eager", False)):
        torch.cuda.empty_cache()
        eng = make(cuda_graphs=flag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.monotonic()
        done = _serve(eng, prompts, max_new)
        wall = time.monotonic() - t0
        passes = eng.passes()
        runs[arm] = dict(
            done=done, wall=wall, launches=ops.launch_counts(),
            replays={n: p.replays for n, p in passes.items()},
            capture_s={n: round(p.capture_s, 3) for n, p in passes.items()},
            peak=(torch.cuda.max_memory_allocated(),
                  torch.cuda.max_memory_reserved()),
            steps=eng.steps,
            kv=eng.kv_stats() if hasattr(eng, "kv_stats") else None,
            spec=eng.spec_stats() if getattr(eng, "spec", False) else None,
            transfer=(eng.transfer_stats()
                      if hasattr(eng, "transfer_stats") else None))
        cores = getattr(eng, "prefill", []) + getattr(eng, "decode", [])
        if not all(all(t.is_cuda for t in _leaves(c.caches))
                   and c.params["embed"].is_cuda for c in cores or [eng]):
            raise AssertionError(f"{tag}: caches or params not on the card")
        del eng, passes
    g, e = runs["graphed"], runs["eager"]
    _serve_line(f"{tag}", g["done"], prompts, g["wall"], g["steps"],
                g["peak"])
    toks = sum(len(r.tokens) for r in g["done"])
    (gt, gp), (et, ep) = _means_ms(g["done"]), _means_ms(e["done"])
    same = _streams(g["done"]) == _streams(e["done"])
    log(f"[{tag}] graphed | eager: tok/s {toks / g['wall']:.2f} | "
        f"{toks / e['wall']:.2f}; TTFT mean {gt:.2f} | {et:.2f} ms; TPOT "
        f"mean {gp:.2f} | {ep:.2f} ms; peak allocated "
        f"{g['peak'][0] / 2**30:.2f} | {e['peak'][0] / 2**30:.2f} GiB, "
        f"reserved {g['peak'][1] / 2**30:.2f} | {e['peak'][1] / 2**30:.2f} "
        f"GiB; wall {g['wall']:.3f} | {e['wall']:.3f} s; replays "
        f"{g['replays']}, capture s {g['capture_s']}; streams equal: {same}; "
        f"launch counts equal: {g['launches'] == e['launches']}")
    if not same:
        raise AssertionError(f"{tag}: graphed streams differ from eager")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"{tag}: graphed launches {g['launches']} != "
                             f"eager {e['launches']}")
    if not all(n > 0 for n in g["replays"].values()) \
            or any(e["replays"].values()):
        raise AssertionError(f"{tag}: replays graphed {g['replays']}, "
                             f"eager {e['replays']}")
    return runs


def _finished(tag, done, n, max_new=64):
    if len(done) != n or any(len(r.tokens) != max_new for r in done):
        raise AssertionError(f"{tag}: not every request finished with "
                             f"{max_new} tokens")


def phase_serve(cfg, params):
    prompts = _requests(cfg)
    _serve(_engine(cfg, params), prompts[:1], max_new=2)        # warm-up
    runs = _arms("serve", lambda **kw: _engine(cfg, params, **kw), prompts)
    g = runs["graphed"]
    done = g["done"]
    launches = {k: g["launches"][k]
                for k in ("flash_attention", "paged_decode_attention")}
    _finished("serve", done, len(prompts))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    log("[serve] gemma_2b full width (18 layers, d_model 2048, head dim "
        "256), bf16, max_batch=8, max_len=2048, block_tokens=16")
    log(f"[serve] launches on the main path: {launches}")
    return launches, prompts, _streams(done), (done, g["wall"])


def phase_preemption(cfg, params, prompts):
    four = prompts[:4]
    base = {r.rid: r.tokens for r in _serve(_engine(cfg, params), four)}
    pages = sum(-(-len(p) // 16) for p in four) + 4
    runs = _arms("preempt swap", lambda **kw: _engine(
        cfg, params, num_blocks=pages, preemption="swap", **kw), four)
    got = _streams(runs["graphed"]["done"])
    st = runs["graphed"]["kv"]
    log(f"[preempt] swap, {pages} pages: swap_outs={st['swap_outs']} "
        f"swap_ins={st['swap_ins']} page_faults={st['page_faults']}, "
        f"streams identical to the unpressured run: {got == base}")
    if st["swap_outs"] < 1 or got != base:
        raise AssertionError("swap pressure: no swap or streams differ")
    runs = _arms("preempt recompute", lambda **kw: _engine(
        cfg, params, num_blocks=pages, preemption="recompute", **kw), four)
    done, st = runs["graphed"]["done"], runs["graphed"]["kv"]
    log(f"[preempt] recompute, {pages} pages: "
        f"recompute_drops={st['recompute_drops']}, finished {len(done)}/4")
    if st["recompute_drops"] < 1:
        raise AssertionError("recompute pressure: no drop")
    _finished("recompute pressure", done, 4)


def phase_slot(cfg, params, prompts, paged_streams):
    """The dense SlotEngine over the same 16 requests, decoding through
    decode_attention; both engines decode at (8, 1), so the streams must be
    equal."""
    from repro_torch.engine.core import SlotEngine

    def slot(**kw):
        return SlotEngine(cfg, params=params, max_batch=8, max_len=2048,
                          device="cuda", **kw)
    _serve(slot(), prompts[:1], max_new=2)                    # warm-up
    g = _arms("slot", slot, prompts)["graphed"]
    launches = g["launches"]["decode_attention"]
    _finished("slot", g["done"], len(prompts))
    if launches <= 0:
        raise AssertionError("slot: decode_attention never launched")
    same = _streams(g["done"]) == paged_streams
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
    with layer_checks() as worst:
        _, ver, _ = steps.verify_step(params, toks, q_valid, caches, cfg)
    torch.cuda.synchronize()
    _held_line("spec", worst, {"paged_verify_attention": cfg.num_layers})
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
    eight = prompts[:8]
    draft = noisy_draft_params(params, cfg, SPEC_NOISE)
    runs = _arms("spec", lambda **kw: _engine(
        cfg, params, draft_params=draft,
        config=EngineConfig(draft_cfg=cfg, spec_k=SPEC_K), **kw), eight)
    g = runs["graphed"]
    done, st = g["done"], g["spec"]
    launches = g["launches"]["paged_verify_attention"]
    _finished("spec", done, 8)
    if launches <= 0:
        raise AssertionError("spec: paged_verify_attention never launched")
    log(f"[spec] draft = target + noise of {SPEC_NOISE} of each weight's "
        f"scale, spec_k={SPEC_K}")
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
    del draft
    phase_spec_logits(cfg, params)
    return launches


# chunked prefill: the chunk size of the chunked Engine, and the long
# prompt served past max_len = 2048 under max_context = 4096
CHUNK = 256
LONG_PROMPT, LONG_CONTEXT = 3000, 4096


def _chunked_prefill(params, cfg, prompt, chunk, bt=16, max_len=2048,
                     batch=8):
    """Prefill one prompt chunk by chunk through chunk_step into row 0 of a
    ``batch``-row paged cache whose table covers ``max_len`` (the other rows
    ride along with q_valid 0, as decode rows do in the engine). Returns
    (the last pass's logits of row 0, the caches, row 0's table)."""
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    mb = max_len // bt
    nb = batch * mb
    caches = tf.init_paged_cache(cfg, batch, nb, bt, mb, "cuda")
    tabs = torch.full((batch, mb), nb, dtype=torch.int32, device="cuda")
    tabs[0] = torch.arange(mb, dtype=torch.int32, device="cuda")
    got = 0
    while got < len(prompt):
        take = min(chunk, len(prompt) - got)
        toks = torch.zeros(batch, chunk, dtype=torch.int32, device="cuda")
        toks[0, :take] = torch.as_tensor(prompt[got:got + take],
                                         device="cuda")
        lens = torch.zeros(batch, dtype=torch.int32, device="cuda")
        lens[0] = got
        _set_rows(cfg, caches, tabs, lens)
        q_valid = torch.zeros(batch, dtype=torch.int32, device="cuda")
        q_valid[0] = take
        _, logits, caches = steps.chunk_step(params, toks, q_valid, caches,
                                             cfg)
        got += take
    return logits[0].float(), caches, tabs[0]


def _whole_prefill(params, cfg, prompt, max_len=2048):
    from repro_torch.models import steps
    logits, dense = steps.prefill_step(
        params, {"tokens": torch.as_tensor(prompt[None], device="cuda")},
        cfg, max_len)
    return logits[0].float(), dense


def _top2_gap(logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def phase_chunked_logits(cfg, params):
    """A 1024-token prompt prefilled in chunks of CHUNK against one whole
    prefill, both through the kernels: last-position logits within
    LOGIT_TOL of max |logit| with equal argmax; the written K/V's largest
    difference printed."""
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 1024
                                               ).astype(np.int32)
    want, dense = _whole_prefill(params, cfg, prompt)
    with layer_checks() as worst:
        got, caches, tab = _chunked_prefill(params, cfg, prompt, CHUNK)
    torch.cuda.synchronize()
    _held_line("chunked", worst, {"paged_chunk_attention":
                                  cfg.num_layers * (1024 // CHUNK)})
    if got.shape != (cfg.vocab_size,) or not torch.isfinite(got).all():
        raise AssertionError("chunked logits: bad shape or non-finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    argmax = int(got.argmax()) == int(want.argmax())
    kv = []
    for pk, dk in (("k_pool", "k"), ("v_pool", "v")):
        pool = caches["attn"][pk][:, tab[:1024 // 16].long()]
        paged = pool.reshape(pool.shape[0], 1024, *pool.shape[3:])
        kv.append(float((paged.float()
                         - dense["attn"][dk][:, 0, :1024].float()
                         ).abs().max()))
    log(f"[chunked] 1024-token prompt in chunks of {CHUNK} vs whole "
        f"prefill: max|logit diff| = {err:.4g} (max|logit| {scale:.4g}), "
        f"argmax equal: {argmax}, bitwise equal: {torch.equal(got, want)}; "
        f"written K/V largest difference over 18 layers: K {kv[0]:.4g}, "
        f"V {kv[1]:.4g}")
    if err > LOGIT_TOL * scale or not argmax:
        raise AssertionError(f"chunked logits off by {err}")


def _first_divergence(cfg, params, prompt, a, b):
    """(step, top-2 logit gap of the whole-prefill run, of the chunked run)
    at the first step where streams ``a`` (whole) and ``b`` (chunked)
    differ, each path's gap recomputed by prefilling the prompt and the
    shared tokens before that step through it."""
    i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
    ctx = np.concatenate([prompt, np.asarray(a[:i], np.int32)])
    whole = _whole_prefill(params, cfg, ctx, LONG_CONTEXT)[0]
    chunked = _chunked_prefill(params, cfg, ctx, CHUNK,
                               max_len=LONG_CONTEXT)[0]
    return i, _top2_gap(whole), _top2_gap(chunked)


def phase_chunked(cfg, params, prompts, paged_streams, whole):
    """The chunked Engine (chunk_size = CHUNK) over the 16 requests,
    through paged_chunk_attention, against the whole-prefill Engine's
    streams and its (finished requests, wall) ``whole`` from phase_serve;
    a swap-pressured chunked run; a LONG_PROMPT-token prompt under
    max_context LONG_CONTEXT against the SlotEngine. Returns the chunk
    kernel's launches on the path."""
    from repro_torch.engine.core import EngineConfig, SlotEngine
    phase_chunked_logits(cfg, params)
    chunked = lambda **kw: _engine(  # noqa: E731
        cfg, params, config=EngineConfig(chunk_size=CHUNK), **kw)
    _serve(chunked(), prompts[:1], max_new=2)                 # warm-up
    g = _arms("chunked", chunked, prompts)["graphed"]
    done, wall = g["done"], g["wall"]
    launches = g["launches"]["paged_chunk_attention"]
    _finished("chunked", done, len(prompts))
    if launches <= 0:
        raise AssertionError("chunked: paged_chunk_attention never launched")
    log(f"[chunked] Engine(config=EngineConfig(chunk_size={CHUNK})), "
        f"max_batch=8, max_len=2048, block_tokens=16, token budget "
        f"{8 + CHUNK}")
    whole, whole_wall = whole
    toks = sum(len(r.tokens) for r in done)
    (ct, cp), (wt, wp) = _means_ms(done), _means_ms(whole)
    log(f"[chunked] side by side (both graphed), chunked | whole prefill: "
        f"tok/s {toks / wall:.2f} | {toks / whole_wall:.2f}; TTFT mean "
        f"{ct:.2f} | {wt:.2f} ms; TPOT mean {cp:.2f} | {wp:.2f} ms; "
        f"paged_chunk_attention launches {launches}")
    got = _streams(done)
    diff = [rid for rid in got if got[rid] != paged_streams[rid]]
    log(f"[chunked] {len(got) - len(diff)} of {len(got)} streams identical "
        f"to the whole-prefill Engine's")
    for rid in diff:
        step, gw, gc = _first_divergence(cfg, params, prompts[rid],
                                         paged_streams[rid], got[rid])
        log(f"[chunked] request {rid} differs first at step {step}: top-2 "
            f"logit gap there {gw:.4g} (whole prefill), {gc:.4g} (chunked)")
    if diff:
        raise AssertionError(f"chunked streams differ: requests {diff}")

    four = prompts[:4]
    base = _streams(_serve(chunked(), four))
    pages = sum(-(-len(p) // 16) for p in four) + 4
    runs = _arms("chunked swap", lambda **kw: _engine(
        cfg, params, num_blocks=pages, preemption="swap",
        config=EngineConfig(chunk_size=CHUNK), **kw), four)
    got, st = _streams(runs["graphed"]["done"]), runs["graphed"]["kv"]
    log(f"[chunked] swap, {pages} pages: swap_outs={st['swap_outs']} "
        f"swap_ins={st['swap_ins']} page_faults={st['page_faults']}, "
        f"streams identical to the unpressured chunked run: {got == base}")
    if st["swap_outs"] < 1 or got != base:
        raise AssertionError("chunked swap pressure: no swap or streams "
                             "differ")

    long_p = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               LONG_PROMPT).astype(np.int32)
    try:
        _engine(cfg, params).submit(long_p)
    except ValueError as err:
        log(f"[chunked] whole prefill rejects the {LONG_PROMPT}-token prompt "
            f"at submit: {err}")
    else:
        raise AssertionError("whole prefill took a prompt past max_len")
    eng = _engine(cfg, params, config=EngineConfig(
        chunk_size=CHUNK, max_context=LONG_CONTEXT))
    got = _serve(eng, [long_p], max_new=16)[0].tokens
    slot = SlotEngine(cfg, params=params, max_batch=8, max_len=LONG_CONTEXT,
                      device="cuda")
    want = _serve(slot, [long_p], max_new=16)[0].tokens
    log(f"[chunked] {LONG_PROMPT}-token prompt, max_context={LONG_CONTEXT}: "
        f"16 tokens equal to SlotEngine(max_len={LONG_CONTEXT})'s: "
        f"{got == want}")
    if got != want:
        step, gw, gc = _first_divergence(cfg, params, long_p, want, got)
        log(f"[chunked] the long prompt differs first at step {step}: top-2 "
            f"logit gap there {gw:.4g} (whole prefill), {gc:.4g} (chunked)")
        raise AssertionError("long-context chunked stream differs from the "
                             "SlotEngine's")
    del eng, slot
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 11: disaggregated prefill/decode workers
# ---------------------------------------------------------------------------

def _disagg(cfg, params, own_cards=False, n_prefill=1, n_decode=1, **kw):
    """The ``DisaggEngine`` at the serving phases' geometry. Both roles on
    the one card the script holds (handoffs staged through host memory),
    unless ``own_cards``: then ``handoff_devices`` gives each role cards of
    its own."""
    from repro_torch.engine.workers import DisaggEngine
    devices = None if own_cards else ([None] * n_prefill, [None] * n_decode)
    return DisaggEngine(cfg, params, n_prefill=n_prefill, n_decode=n_decode,
                        max_batch=8, max_len=2048, block_tokens=16,
                        device="cuda", devices=devices, **kw)


def _page_bytes(cfg, block_tokens=16) -> int:
    """Bytes of one KV page: every layer's K and V of ``block_tokens``
    positions, bf16 (the pools' dtype)."""
    return block_tokens * cfg.num_layers * 2 * cfg.num_kv_heads \
        * cfg.head_dim * 2


def _handoff_line(tag, ts, largest=None):
    mb_s = ts["bytes"] / ts["total_s"] / 1e6 if ts["total_s"] else 0.0
    big = (f", largest handoff {largest[0]} pages = {largest[1]} B"
           if largest else "")
    log(f"[{tag}] handoffs {ts['handoffs']} ({ts['granularity']}, "
        f"{ts['mode']}): {ts['pages']} pages, {ts['bytes']} B{big}; "
        f"transfer total {ts['total_s'] * 1e3:.3f} ms, exposed "
        f"{ts['exposed_s'] * 1e3:.3f} ms, {mb_s:.1f} MB/s over "
        f"{len(ts['samples'])} timed transfers; dedup blocks "
        f"{ts['dedup_blocks']}; cross_device {ts['cross_device']}")


def _check_streams(tag, cfg, params, prompts, want, got):
    """Raise unless every stream of ``got`` equals ``want``; for each one
    that differs, print the first differing step and the top-2 logit gap
    there, through the kernels and through the plain attention versions."""
    diff = [rid for rid in want if got.get(rid) != want[rid]]
    log(f"[{tag}] {len(want) - len(diff)} of {len(want)} streams equal to "
        f"the paged Engine's")
    for rid in diff:
        a, b = want[rid], got.get(rid, [])
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        ctx = np.concatenate([prompts[rid], np.asarray(a[:i], np.int32)])
        gap = _top2_gap(_whole_prefill(params, cfg, ctx, LONG_CONTEXT)[0])
        with plain_attention():
            plain = _top2_gap(_whole_prefill(params, cfg, ctx,
                                             LONG_CONTEXT)[0])
        log(f"[{tag}] request {rid} differs first at step {i}: top-2 logit "
            f"gap there {gap:.4g} (kernels), {plain:.4g} (plain attention)")
    if diff:
        raise AssertionError(f"{tag}: streams differ: requests {diff}")


def _launched(tag, launches, names):
    got = {n: launches[n] for n in names}
    log(f"[{tag}] launches: {got}")
    if min(got.values()) <= 0:
        raise AssertionError(f"{tag}: a kernel never launched: {got}")


def _staging_probe(cfg, n_pages, reps=6):
    """One handoff's payload of ``n_pages`` pages (K and V, every layer)
    staged through the host five ways, each run ``reps`` times: the first
    run and the median of the others: ``.cpu()``, what ``move_pages``
    does (new pageable memory, which the host allocator may take from
    pages freed before); ``.cpu()`` with every result kept, so each run
    writes pages the process has never touched (as handoffs that wait in
    a decode worker's queue do); a copy into pageable memory already
    touched; a copy into pinned memory; and the admission's ``.to`` back
    from pageable memory."""
    shape = (cfg.num_layers, n_pages, 16, cfg.num_kv_heads, cfg.head_dim)
    src = [torch.randn(shape, device="cuda").to(torch.bfloat16)
           for _ in range(2)]
    touched = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]
    pinned = [torch.zeros(shape, dtype=torch.bfloat16, pin_memory=True)
              for _ in range(2)]
    nbytes = sum(t.numel() * t.element_size() for t in src)
    kept = []
    ways = (
        (".cpu() (move_pages)", lambda: [t.cpu() for t in src]),
        (".cpu(), every result kept",
         lambda: kept.extend(t.cpu() for t in src)),
        ("copy into touched pageable",
         lambda: [d.copy_(t) for d, t in zip(touched, src)]),
        ("copy into pinned",
         lambda: [d.copy_(t, non_blocking=True)
                  for d, t in zip(pinned, src)]),
        ("pageable to the card (admission)",
         lambda: [t.to("cuda") for t in touched]),
    )
    for name, fn in ways:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        kept.clear()
        med = float(np.median(times[1:]))
        log(f"[disagg staging] {n_pages} pages = {nbytes} B, {name}: "
            f"first {times[0] * 1e3:.3f} ms, {nbytes / times[0] / 1e9:.3f} "
            f"GB/s; then {med * 1e3:.3f} ms, {nbytes / med / 1e9:.3f} GB/s")


def phase_disagg(cfg, params, prompts, paged_streams, whole):
    """The disaggregated engine over the serving phase's requests, each arm
    with its launch counters reset just before and read just after:

    1. one prefill and one decode worker, local, full handoffs, through
       ``_arms`` (graphed, then eager), against the paged Engine's streams
       and its graphed run ``whole`` side by side; bytes == pages x one
       page's bytes;
    2. two decode workers (two pools and two decode graphs on the card),
       global, layerwise: one sample per layer per handoff;
    3. a chunked prefill worker (chunk CHUNK), layerwise, through
       ``paged_chunk_attention``;
    4. the first 4 requests under a decode pool of phase_preemption's size:
       swap (streams equal) and recompute (victims hand off again);
    5. the host link fitted to every host-staged sample (``fit_link_spec``),
       and the largest handoff staged through the host four ways
       (``_staging_probe``);
    6. with two cards or more, arm 1 with cards of their own for the roles.
    """
    from repro_torch.engine.core import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.perfmodel.regression import fit_link_spec
    page = _page_bytes(cfg)
    _serve(_disagg(cfg, params), prompts[:1], max_new=2)       # warm-up
    runs = _arms("disagg", lambda **kw: _disagg(cfg, params, **kw), prompts)
    g = runs["graphed"]
    _finished("disagg", g["done"], len(prompts))
    _check_streams("disagg", cfg, params, prompts, paged_streams,
                   _streams(g["done"]))
    _launched("disagg", g["launches"],
              ("flash_attention", "paged_decode_attention"))
    samples = []
    for arm in ("graphed", "eager"):
        ts = runs[arm]["transfer"]
        largest = max(b for b, _ in ts["samples"])     # one per handoff
        _handoff_line(f"disagg {arm}", ts, (largest // page, largest))
        log(f"[disagg {arm}] GB/s of each handoff in turn: "
            f"{[round(b / t / 1e9, 2) for b, t in ts['samples']]}")
        if ts["handoffs"] != len(prompts) or ts["bytes"] != ts["pages"] \
                * page or ts["cross_device"]:
            raise AssertionError(f"disagg {arm}: {ts['handoffs']} handoffs, "
                                 f"{ts['bytes']} B for {ts['pages']} pages "
                                 f"of {page} B, cross_device "
                                 f"{ts['cross_device']}")
        samples += ts["samples"]
    whole, whole_wall = whole
    toks = sum(len(r.tokens) for r in g["done"])
    (dt, dp), (wt, wp) = _means_ms(g["done"]), _means_ms(whole)
    log(f"[disagg] side by side (both graphed), disaggregated 1+1 | single "
        f"paged Engine: tok/s {toks / g['wall']:.2f} | "
        f"{toks / whole_wall:.2f}; TTFT mean {dt:.2f} | {wt:.2f} ms; TPOT "
        f"mean {dp:.2f} | {wp:.2f} ms")

    arms = (
        ("disagg 1+2 global layerwise", dict(n_decode=2, mode="global",
                                             granularity="layerwise"),
         ("flash_attention", "paged_decode_attention")),
        ("disagg chunked", dict(granularity="layerwise",
                                config=EngineConfig(chunk_size=CHUNK)),
         ("paged_chunk_attention", "paged_decode_attention")),
    )
    for tag, kw, names in arms:
        torch.cuda.empty_cache()
        eng = _disagg(cfg, params, **kw)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.monotonic()
        done = _serve(eng, prompts)
        wall = time.monotonic() - t0
        launches = ops.launch_counts()
        _finished(tag, done, len(prompts))
        _check_streams(tag, cfg, params, prompts, paged_streams,
                       _streams(done))
        _launched(tag, launches, names)
        ts = eng.transfer_stats()
        _handoff_line(tag, ts)
        toks = sum(len(r.tokens) for r in done)
        t, p = _means_ms(done)
        log(f"[{tag}] passes {sorted(eng.passes())}; tok/s "
            f"{toks / wall:.2f}, TTFT mean {t:.2f} ms, TPOT mean {p:.2f} ms")
        if (len(ts["samples"]) != cfg.num_layers * ts["handoffs"]
                or ts["handoffs"] != len(prompts)
                or ts["exposed_s"] > ts["total_s"]
                or ts["bytes"] != ts["pages"] * page):
            raise AssertionError(f"{tag}: {len(ts['samples'])} samples for "
                                 f"{ts['handoffs']} handoffs, exposed "
                                 f"{ts['exposed_s']} s of {ts['total_s']} s")
        samples += ts["samples"]
        del eng

    four = prompts[:4]
    want = {rid: paged_streams[rid] for rid in range(4)}
    pages = sum(-(-len(p) // 16) for p in four) + 4
    for policy in ("swap", "recompute"):
        tag = f"disagg {policy}"
        eng = _disagg(cfg, params, preemption=policy, decode_blocks=pages)
        done = _serve(eng, four)
        _finished(tag, done, 4)
        st, ts = eng.kv_stats()["decode0"], eng.transfer_stats()
        log(f"[{tag}] decode pool {pages} pages: swap_outs "
            f"{st['swap_outs']}, swap_ins {st['swap_ins']}, recompute_drops "
            f"{st['recompute_drops']}, page_faults {st['page_faults']}; "
            f"handoffs {ts['handoffs']} for 4 requests")
        _check_streams(tag, cfg, params, prompts, want, _streams(done))
        if policy == "swap" and st["swap_outs"] < 1:
            raise AssertionError("disagg swap pressure: no swap")
        if policy == "recompute" and ts["handoffs"] <= 4:
            raise AssertionError("disagg recompute pressure: no victim "
                                 "handed off again")
        del eng

    link = fit_link_spec(samples, "host-staged")
    log(f"[disagg] host link fitted to {len(samples)} host-staged samples "
        f"({min(b for b, _ in samples)}-{max(b for b, _ in samples)} B): "
        f"latency {link.latency * 1e6:.2f} us, bandwidth "
        f"{link.bandwidth / 1e9:.3f} GB/s")
    _staging_probe(cfg, max(b for b, _ in samples) // page)

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[disagg] the handoff between cards did not run: "
            f"torch.cuda.device_count() = {n}, it needs two cards")
        return
    eng = _disagg(cfg, params, own_cards=True)
    done = _serve(eng, prompts)
    ts = eng.transfer_stats()
    log(f"[disagg cards] prefill on {eng.prefill[0].device}, decode on "
        f"{eng.decode[0].device}")
    _handoff_line("disagg cards", ts)
    _check_streams("disagg cards", cfg, params, prompts, paged_streams,
                   _streams(done))
    if not ts["cross_device"]:
        raise AssertionError("disagg cards: the handoff did not cross cards")
    del eng


# ---------------------------------------------------------------------------
# phase 12: the other dense-attention configs
# ---------------------------------------------------------------------------

# (arch, layers served): every config at full width; depth cut where the
# whole model does not fit one card (llama3_70b: 80 layers are 141 GB;
# nemotron_4_340b: a layer is 6.9 GB and the embedding and head 9.4 GB
# each); None: every layer. The logits are held per layer at the served
# depth (``layer_checks``) and their end-to-end drift from plain
# attention's is printed, not gated: it grows with depth whatever rounds
# differently, and plain attention with P rounded to bf16 (the kernels'
# one rounding) already sits 0.0496 of max |logit| from plain attention
# at 48 layers of internlm2_20b and 0.0439 at 40 of pixtral_12b, beside
# LOGIT_TOL (tools/logit_depth.py, H100 80GB HBM3 at 700 W)
FAMILIES = (("internlm2_20b", None), ("llama3_70b", 16),
            ("nemotron_4_340b", 2), ("pixtral_12b", None))


def phase_reduced_families():
    """Each family's reduced config (head dim 8, or 16 for pixtral) with
    perturbed seeded weights served over the 16 requests on the card by
    the paged Engine and by the SlotEngine, with the launch counters reset
    just before each and read just after: the streams must be equal."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.engine.core import SlotEngine
    from repro_torch.kernels import ops
    for arch, _ in FAMILIES:
        cfg = get_reduced_config(arch)
        params = full_width_params(cfg)
        prompts = _requests(cfg)
        got = {}
        for name, make, kernels in (
                ("Engine", lambda: _engine(cfg, params),
                 ("flash_attention", "paged_decode_attention")),
                ("SlotEngine", lambda: SlotEngine(
                    cfg, params=params, max_batch=8, max_len=2048,
                    device="cuda"), ("flash_attention", "decode_attention"))):
            eng = make()
            ops.reset_launches()
            done = _serve(eng, prompts)
            _finished(f"families reduced {arch} {name}", done, len(prompts))
            _launched(f"families reduced {arch} {name}", ops.launch_counts(),
                      kernels)
            got[name] = _streams(done)
            del eng
        same = got["Engine"] == got["SlotEngine"]
        log(f"[families reduced] {cfg.name} (head dim "
            f"{cfg.resolved_head_dim}, {cfg.num_heads}/{cfg.num_kv_heads} "
            f"heads): 16 streams of the paged Engine equal to the "
            f"SlotEngine's: {same}")
        if not same:
            raise AssertionError(f"{arch} reduced: paged Engine streams "
                                 f"differ from the SlotEngine's")


def phase_families(card: str):
    """Each config of FAMILIES at full width (bf16, random seeded weights,
    every leaf perturbed) after the reduced configs: every layer's
    attention held against its plain version and the logits' drift from
    plain attention's printed (``phase_logits``), then the 16 requests
    through the paged Engine graphed and eagerly (``_arms``: equal streams
    and launch counts), and for internlm2_20b also through the graphed
    SlotEngine, whose streams must equal the paged Engine's. Prints tok/s,
    TTFT, TPOT and peak memory beside the card."""
    from repro_torch.configs import get_config
    from repro_torch.engine.core import SlotEngine
    from repro_torch.kernels import ops
    phase_reduced_families()
    for arch, layers in FAMILIES:
        full = get_config(arch)
        cfg = full.replace(num_layers=layers or full.num_layers)
        tag = f"families {arch}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        params = full_width_params(cfg)
        torch.cuda.synchronize()
        n = sum(v.numel() for v in _leaves(params))
        log(f"[{tag}] {cfg.num_layers} of {full.num_layers} layers, d_model "
            f"{cfg.d_model}, head dim {cfg.resolved_head_dim}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.mlp_type}: "
            f"{n / 1e9:.3f}B parameters, {2 * n / 1e9:.1f} GB bf16, made and "
            f"perturbed in {time.monotonic() - t0:.1f}s, peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        phase_logits(cfg, params, tag=tag, gate=False)
        prompts = _requests(cfg)
        _serve(_engine(cfg, params), prompts[:1], max_new=2)    # warm-up
        g = _arms(tag, lambda **kw: _engine(cfg, params, **kw),
                  prompts)["graphed"]
        _finished(tag, g["done"], len(prompts))
        _launched(tag, g["launches"],
                  ("flash_attention", "paged_decode_attention"))
        paged = _streams(g["done"])
        toks = sum(len(r.tokens) for r in g["done"])
        ttft, tpot = _means_ms(g["done"])
        read = _decode_bytes(cfg, params)
        bound_ms = read / PEAK_BYTES_PER_S * 1e3
        log(f"[{tag}] paged Engine, graphed: tok/s {toks / g['wall']:.2f}, "
            f"TTFT mean {ttft:.2f} ms, TPOT mean {tpot:.2f} ms, peak "
            f"allocated {g['peak'][0] / 2**30:.2f} GiB; a decode pass reads "
            f"{read / 1e9:.3f} GB of weights, {bound_ms:.3f} ms at "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s, TPOT / that "
            f"{tpot / bound_ms:.3f}; {card}")
        if arch == "internlm2_20b":
            # graphed only: phase slot holds the SlotEngine graphed == eager
            slot = SlotEngine(cfg, params=params, max_batch=8, max_len=2048,
                              device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.monotonic()
            done = _serve(slot, prompts)
            _serve_line(f"{tag} slot", done, prompts, time.monotonic() - t0,
                        slot.steps, (torch.cuda.max_memory_allocated(),
                                     torch.cuda.max_memory_reserved()))
            _finished(f"{tag} slot", done, len(prompts))
            _launched(f"{tag} slot", ops.launch_counts(),
                      ("decode_attention",))
            same = _streams(done) == paged
            log(f"[{tag} slot] 16 streams equal to the paged Engine's: "
                f"{same}")
            if not same:
                raise AssertionError(f"{arch}: SlotEngine streams differ "
                                     f"from the paged Engine's")
            del slot, done
        del params, g
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: MLA and MoE (minicpm3_4b, deepseek_v2_lite_16b, deepseek_v2_236b)
# ---------------------------------------------------------------------------

# flash at MLA prefill's shapes: (name, query/key head dim qk_nope +
# qk_rope, value head dim v_head_dim, heads[, batch, 1 if not given]), as
# many kv heads as heads; the last, a rank's share of deepseek_v2_236b's
# train step on (2, 2) (tools/dist_cards.py train_236b): half the batch
# of 4 and half the heads
MLA_SHAPES = (("reduced", 24, 16, 4), ("minicpm3_4b", 96, 64, 40),
              ("deepseek_v2_lite_16b", 192, 128, 16),
              ("deepseek_v2_236b", 192, 128, 128),
              ("deepseek_v2_236b_rank", 192, 128, 64, 2))
# (arch, layers served), every config at full width: MiniCPM3-4B (62
# layers, 8.1 GB) and DeepSeek-V2-Lite (27, 31.4 GB) whole; DeepSeek-V2-236B
# cut to its dense layer and 4 of its 59 MoE layers (a MoE layer is 7.9 GB,
# the whole model 472 GB)
LATENT = (("minicpm3_4b", None), ("deepseek_v2_lite_16b", None),
          ("deepseek_v2_236b", 5))


def _mla_case(gen, b, s, nh, dq, dv):
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(torch.bfloat16)
    return mk(b, s, nh, dq), mk(b, s, nh, dq), mk(b, s, nh, dv)


def phase_latent_kernels(gen):
    """flash_attention at MLA_SHAPES (dq != dv): against its plain version
    at lengths FLASH_S (b = 2, causal) and at the path's 1024-token
    prefill, where kernel, plain version and one
    scaled_dot_product_attention call (it takes dv != dq) are timed with
    the host queue held, beside the bound. Returns the kernels-line rows
    of these shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    for mangled, what in (("ILi4ELi4ELb0E", "dq = dv = 256"),
                          ("ILi3ELi2ELb0E", "dq/dv 192/128"),
                          ("ILi2ELi1ELb0E", "dq/dv 96/64"),
                          ("ILi1ELi1ELb0E", "dq, dv <= 64")):
        for ln in _ptxas_lines("flash_attention", mangled):
            log(f"[latent] flash_attention ptxas at {what}: {ln}")
    rows = []
    for arch, dq, dv, nh, *batch in MLA_SHAPES:
        b = batch[0] if batch else 1
        worst = [0.0, 0.0]
        for s in FLASH_S:
            q, k, v = _mla_case(gen, 2, s, nh, dq, dv)
            e, r = compare(f"flash_attention {arch} s={s}",
                           fa.flash_attention(q, k, v),
                           ref.flash_attention(q, k, v))
            worst = [max(worst[0], e), max(worst[1], r)]
        q, k, v = _mla_case(gen, b, 1024, nh, dq, dv)
        e, r = compare(f"flash_attention {arch} ({b}, 1024)",
                       fa.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v))
        ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v), hold=True)
        plain = cuda_time_ms(lambda: ref.flash_attention(q, k, v), hold=True)
        lib = cuda_time_ms(_sdpa_flash(q, k, v), hold=True)
        bound_ms, by = bound(*_flash_work(b, 1024, nh, nh, dq, dv),
                             PEAK_BF16_FLOPS)
        log(f"[latent] flash_attention {arch} dq/dv {dq}/{dv}, {nh}/{nh} "
            f"heads, causal: b=2 s in {FLASH_S} max_abs_err={worst[0]:.3g} "
            f"max_row_rel_err={worst[1]:.3g}; ({b}, 1024): max_abs_err="
            f"{e:.3g} max_row_rel_err={r:.3g} (atol {ATOL}, rtol {RTOL}, row "
            f"{ROW_RTOL}); host queue held: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound_ms:.4f} ms "
            f"({by}); kernel / sdpa {ms / lib:.2f}, bound / kernel "
            f"{bound_ms / ms:.3f}")
        rows.append(dict(shape=[b, 1024, nh, nh, dq, dv], arch=arch,
                         max_abs_err=max(worst[0], e),
                         max_row_rel_err=max(worst[1], r), ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                         bound_by=by))
        del q, k, v
    return rows


@contextlib.contextmanager
def _routed_experts(rows: int):
    """Keep the expert ids every MoE layer routes a ``rows``-token call to
    while ``rec["on"]`` (a copy on the device, no host sync): what the
    eager decode passes read of the experts."""
    from repro_torch.models import moe
    saved = moe._router
    rec = {"on": False, "idx": []}

    def router(params, x2d, cfg):
        out = saved(params, x2d, cfg)
        if rec["on"] and x2d.shape[0] == rows:
            rec["idx"].append(out[1].clone())
        return out
    moe._router = router
    try:
        yield rec
    finally:
        moe._router = saved


def _decode_bytes(cfg, params, experts_per_layer: float = 0.0) -> float:
    """Bytes of weights one decode pass reads: every weight once but the
    embedding rows it gathers (unless the embedding is the head), the
    frontend's projection and the experts it does not route to;
    ``experts_per_layer`` distinct experts of each MoE layer."""
    skip = ("frontend_proj",) + (() if cfg.tie_embeddings else ("embed",))
    total = sum(v.numel() * v.element_size() for k, v in params.items()
                if k not in skip and not isinstance(v, dict))
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        for path, leaf in _flat(v).items():
            size = leaf.numel() * leaf.element_size()
            if path.startswith("moe.w"):        # (L, E, ...) expert weights
                size = size / leaf.shape[1] * experts_per_layer
            total += size
    return total


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def phase_latent(card: str):
    """MLA and MoE on the card: flash at MLA's shapes
    (``phase_latent_kernels``), then each config of LATENT at full width
    (bf16, seeded perturbed weights) through ``make_engine``, which gives
    the SlotEngine: every layer's flash call held against its plain
    version on its own inputs and the logits' drift from plain attention
    printed (``phase_logits``), the 16 requests graphed and eagerly
    (``_arms``: equal streams and launch counts, flash launched), tok/s,
    TTFT, TPOT, peak memory and the weights a decode pass reads (MoE: the
    experts the eager passes routed to) against their byte bound; for
    minicpm3_4b also the absorbed decode (``MLAConfig.absorb``), graphed,
    its TPOT and how many of its streams equal the naive decode's (JAX
    holds the two paths equal to 2e-3 only, so nothing is gated on it).
    Returns (the flash rows at MLA_SHAPES, flash launches by config)."""
    from repro_torch.configs import get_config
    from repro_torch.engine.core import SlotEngine, make_engine
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(22)
    shapes = phase_latent_kernels(gen)
    launches = {}
    for arch, layers in LATENT:
        full = get_config(arch)
        cfg = full.replace(num_layers=layers or full.num_layers)
        tag = f"latent {arch}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        params = full_width_params(cfg)
        torch.cuda.synchronize()
        n = sum(v.numel() for v in _leaves(params))
        m = cfg.mla
        moe_txt = (f", MoE {cfg.moe.num_experts} experts top-"
                   f"{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared "
                   f"(first {cfg.moe.first_k_dense} dense)" if cfg.moe
                   else "")
        log(f"[{tag}] {cfg.num_layers} of {full.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads, MLA kv_lora "
            f"{m.kv_lora_rank} q_lora {m.q_lora_rank} dq/dv "
            f"{m.qk_nope_head_dim + m.qk_rope_head_dim}/{m.v_head_dim}"
            f"{moe_txt}: {n / 1e9:.3f}B parameters, {2 * n / 1e9:.1f} GB "
            f"bf16, made and perturbed in {time.monotonic() - t0:.1f}s, peak "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        phase_logits(cfg, params, tag=tag, gate=False)
        prompts = _requests(cfg)

        def make(c=cfg, **kw):
            eng = make_engine(c, params=params, max_batch=8, max_len=2048,
                              device="cuda", **kw)
            if not isinstance(eng, SlotEngine):
                raise AssertionError(f"{arch}: make_engine gave "
                                     f"{type(eng).__name__}")
            return eng
        _serve(make(), prompts[:1], max_new=2)                  # warm-up
        with _routed_experts(8) as rec:
            def arm(**kw):
                eng = make(**kw)
                rec["on"] = not kw["cuda_graphs"]
                return eng
            runs = _arms(tag, arm, prompts)
        g = runs["graphed"]
        _finished(tag, g["done"], len(prompts))
        _launched(tag, g["launches"], ("flash_attention",))
        launches[arch] = g["launches"]["flash_attention"]
        toks = sum(len(r.tokens) for r in g["done"])
        ttft, tpot = _means_ms(g["done"])
        routed = ""
        per_layer = 0.0
        if rec["idx"]:
            distinct = [int(torch.unique(i).numel()) for i in rec["idx"]]
            per_layer = float(np.mean(distinct))
            routed = (f"; the eager decode passes routed to {per_layer:.2f} "
                      f"distinct experts of {cfg.moe.num_experts} a MoE "
                      f"layer on average ({len(distinct)} layer calls)")
        read = _decode_bytes(cfg, params, per_layer)
        bound_ms = read / PEAK_BYTES_PER_S * 1e3
        log(f"[{tag}] SlotEngine, graphed: tok/s {toks / g['wall']:.2f}, "
            f"TTFT mean {ttft:.2f} ms, TPOT mean {tpot:.2f} ms, peak "
            f"allocated {g['peak'][0] / 2**30:.2f} GiB; a decode pass reads "
            f"{read / 1e9:.3f} GB of weights{routed}, {bound_ms:.3f} ms at "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s, TPOT / that "
            f"{tpot / bound_ms:.3f}; {card}")
        if arch == "minicpm3_4b":
            acfg = cfg.replace(mla=dataclasses.replace(cfg.mla, absorb=True))
            eng = make(acfg)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.monotonic()
            done = _serve(eng, prompts)
            wall = time.monotonic() - t0
            _finished(f"{tag} absorbed", done, len(prompts))
            naive = _streams(g["done"])
            same = sum(naive[r.rid] == list(r.tokens) for r in done)
            atoks = sum(len(r.tokens) for r in done)
            log(f"[{tag} absorbed] SlotEngine graphed, absorb=True: tok/s "
                f"{atoks / wall:.2f}, TTFT mean {_means_ms(done)[0]:.2f} ms, "
                f"TPOT mean {_means_ms(done)[1]:.2f} ms (naive {tpot:.2f}); "
                f"{same} of {len(done)} streams equal the naive decode's "
                f"(not gated); {card}")
            del eng, done
        del params, g, runs
        torch.cuda.empty_cache()
    return shapes, launches


# ---------------------------------------------------------------------------
# phase 14: the recurrent families (zamba2_7b, xlstm_1_3b)
# ---------------------------------------------------------------------------

# zamba2_7b's shared attention block: MHA, 32/32 heads at head dim 112
ZAMBA_HEADS, ZAMBA_D = 32, 112
# prompt lengths the recurrent prefill takes (at most one chunk of 256 or a
# multiple of it), drawn with default_rng(0)
RECURRENT_PROMPTS = (64, 128, 256, 512, 768, 1024)
# chunked prefill against the token-by-token recurrence, fp32 on the card:
# max error within this share of the recurrence's max |y|
RECURRENCE_REL = 1e-3
RECURRENT = ("zamba2_7b", "xlstm_1_3b")


def _recurrent_requests(cfg, n=16):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, int(p)).astype(np.int32)
            for p in rng.choice(RECURRENT_PROMPTS, n)]


def phase_recurrent_kernels(gen):
    """flash and dense decode at zamba2's shared-block shape (group 1, d =
    112): flash against its plain version at b = 2 over lengths FLASH_S,
    causal and not, and at the path's (1, 1024) causal prefill; dense
    decode at b = 8, S = 2048, DEC_LENGTHS and the straddling lengths.
    Each timed at the path's shape with the host queue held beside one
    scaled_dot_product_attention call and the bound. Returns the
    kernels-line entries {name: shape dict}."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    nh, d = ZAMBA_HEADS, ZAMBA_D
    out = {}
    worst = [0.0, 0.0]
    for s_ in FLASH_S:
        for causal in (True, False):
            q, k, v = _flash_case(gen, 2, s_, nh, nh, d)
            e, r = compare(f"flash_attention d={d} s={s_} causal={causal}",
                           fa.flash_attention(q, k, v, causal=causal),
                           ref.flash_attention(q, k, v, causal=causal))
            worst = [max(worst[0], e), max(worst[1], r)]
    q, k, v = _flash_case(gen, 1, 1024, nh, nh, d)
    e, r = compare("flash_attention zamba2 (1, 1024)",
                   fa.flash_attention(q, k, v), ref.flash_attention(q, k, v))
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v), hold=True)
    plain = cuda_time_ms(lambda: ref.flash_attention(q, k, v), hold=True)
    lib = cuda_time_ms(_sdpa_flash(q, k, v), hold=True)
    bound_ms, by = bound(*_flash_work(1, 1024, nh, nh, d), PEAK_BF16_FLOPS)
    log(f"[recurrent] flash_attention zamba2 shared block {nh}/{nh} heads, "
        f"d {d}: b=2 s in {FLASH_S} causal and not max_abs_err="
        f"{worst[0]:.3g} max_row_rel_err={worst[1]:.3g}; (1, 1024) causal: "
        f"max_abs_err={e:.3g} max_row_rel_err={r:.3g} (atol {ATOL}, rtol "
        f"{RTOL}, row {ROW_RTOL}); host queue held: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by}); kernel / sdpa {ms / lib:.2f}, bound / kernel "
        f"{bound_ms / ms:.3f}")
    out["flash_attention"] = dict(
        shape=[1, 1024, nh, nh, d], max_abs_err=max(worst[0], e),
        max_row_rel_err=max(worst[1], r), ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=bound_ms, bound_by=by)
    del q, k, v
    worst = [0.0, 0.0]
    for lengths in (straddle_lengths(_build.DECODE_SPLIT) + [2048, 1],
                    DEC_LENGTHS):
        q, k, v, lens = _dense_case(gen, len(lengths), 2048, nh, nh, d,
                                    lengths)
        e, r = _check_rows(f"decode_attention zamba2 {lengths}",
                           da.decode_attention(q, k, v, lens),
                           ref.decode_attention(q, k, v, lens), lengths)
        worst = [max(worst[0], e), max(worst[1], r)]
    t = _decode_times(
        f"decode_attention zamba2 shared block (8, 2048, {nh}/{nh}, {d})",
        lambda: da.decode_attention(q, k, v, lens),
        lambda: ref.decode_attention(q, k, v, lens),
        _sdpa_dense(q, k, v, lens),
        _decode_work(DEC_LENGTHS, nh, nh, d, 2048))
    bound_ms, by = bound(*t.pop("bound"), PEAK_BF16_FLOPS)
    log(f"[recurrent] decode_attention zamba2 shared block: b=8 S=2048 "
        f"lengths {DEC_LENGTHS} and straddling the split max_abs_err="
        f"{worst[0]:.3g} max_row_rel_err={worst[1]:.3g}")
    out["decode_attention"] = dict(
        shape=[8, 2048, nh, nh, d], max_abs_err=worst[0],
        max_row_rel_err=worst[1], bound_ms=bound_ms, bound_by=by, **t)
    del q, k, v, lens
    return out


def _layer_params(init_fn, key, cfg, gen):
    """One layer's seeded weights at cfg's dtypes on the card, every leaf
    perturbed as ``_perturb`` perturbs a layer of the stack ``key``."""
    from repro_torch.models.layers import Initializer
    p = init_fn(Initializer(cfg, gen, "cuda"), cfg)
    _perturb({key: {k: v[None] for k, v in p.items()}}, cfg, gen)
    return p


def _held_to_recurrence(name, got, want):
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[recurrent] {name}: max|chunked - recurrence| = {err:.4g}, max|y| "
        f"{scale:.4g}, share {err / scale:.3g} (limit {RECURRENCE_REL})")
    if not scale > 0 or err > RECURRENCE_REL * scale:
        raise AssertionError(f"{name}: off by {err} of {scale}")


def phase_recurrent_layers(gen):
    """One full-width layer of each recurrent block at fp32 on the card
    (TF32 off, PyTorch's default), seeded perturbed weights: the Mamba2
    and the mLSTM chunked prefill over 512 tokens (two chunks) against
    their token-by-token decode from zero state, and ``slstm_forward`` in
    one call against one call a token with the state carried; each within
    RECURRENCE_REL of the recurrence's max |y|, and the final states
    too."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import xlstm as xl
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the fp32 checks need "
                             "them off")
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    zcfg = get_config("zamba2_7b").replace(**fp32)
    xcfg = get_config("xlstm_1_3b").replace(**fp32)
    x = torch.randn(1, 512, zcfg.d_model, generator=gen, device="cuda") * 0.5
    p = _layer_params(m2.init_mamba2, "mamba", zcfg, gen)
    y, st = m2.mamba2_forward(p, x, zcfg, return_state=True)
    _held_to_recurrence("Mamba2 (1, 512, 3584)", y,
                        m2.mamba2_reference(p, x, zcfg))
    del p
    x = torch.randn(1, 512, xcfg.d_model, generator=gen, device="cuda") * 0.5
    p = _layer_params(xl.init_mlstm, "mlstm", xcfg, gen)
    y, st = xl.mlstm_forward(p, x, xcfg, return_state=True)
    d_in, nh, hd = xl._mlstm_dims(xcfg)
    state = {"C": x.new_zeros(1, nh, hd, hd), "n": x.new_zeros(1, nh, hd),
             "m": x.new_full((1, nh), -1e30)}
    ys = [xl.mlstm_decode(p, x[:, t:t + 1], xcfg, state)[0]
          for t in range(x.shape[1])]
    _held_to_recurrence("mLSTM (1, 512, 2048)", y, torch.cat(ys, 1))
    _held_to_recurrence("mLSTM final C", st["C"], state["C"])
    del p, state, ys
    p = _layer_params(xl.init_slstm, "slstm", xcfg, gen)
    y, st = xl.slstm_forward(p, x, xcfg, return_state=True)
    carry, ys = None, []
    for t in range(x.shape[1]):
        yt, carry = xl.slstm_forward(p, x[:, t:t + 1], xcfg, state=carry,
                                     return_state=True)
        ys.append(yt)
    _held_to_recurrence("sLSTM (1, 512, 2048), one call vs a call a token",
                        y, torch.cat(ys, 1))
    _held_to_recurrence("sLSTM final h", st["h"], carry["h"])


def _recurrent_bytes(cfg, params, prompts, max_new=64, batch=8):
    """Bytes one decode pass at ``batch`` slots reads and writes, by part:
    every weight once (the gathered embedding rows aside) but the hybrid's
    shared block, which each of its applications reads again; the
    recurrent state read and written; the shared block's K/V over each
    slot's mean context (mean prompt + max_new / 2) in every application."""
    from repro_torch.models import transformer as tf
    state = tf.init_cache(cfg, batch, 1, "meta")
    st = sum(t.numel() * t.element_size() for g, c in state.items()
             if "length" not in c for t in c.values())
    shared = 0
    apps = 0
    kv = 0
    if cfg.family == "hybrid":
        apps = cfg.num_layers // cfg.shared_attn_every
        shared = sum(t.numel() * t.element_size()
                     for t in _leaves(params["shared"]))
        ctx = float(np.mean([len(p) for p in prompts])) + max_new / 2
        kv = apps * batch * ctx * 2 * cfg.num_kv_heads \
            * cfg.resolved_head_dim * 2
    weights_ = _decode_bytes(cfg, params) - shared
    return {"weights": weights_, "shared": shared * apps, "state": 2 * st,
            "kv": kv}


def _prefill_peak(cfg, params, n=1024):
    """Peak memory a prefill of ``n`` tokens allocates above what was
    allocated before it (a fresh (1, n) cache, the activations)."""
    from repro_torch.models import steps
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tok = torch.as_tensor(np.arange(n, dtype=np.int32)[None] % cfg.vocab_size,
                          device="cuda")
    t0 = time.monotonic()
    logits, caches = steps.prefill_step(params, {"tokens": tok}, cfg, n)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    del logits, caches
    return torch.cuda.max_memory_allocated() - base, wall


def phase_recurrent(card: str):
    """The recurrent families on the card: flash and dense decode at
    zamba2's shared-block shape (``phase_recurrent_kernels``); one
    full-width layer of Mamba2, mLSTM and sLSTM at fp32 against its
    recurrence (``phase_recurrent_layers``); then zamba2_7b (81 layers)
    and xlstm_1_3b (48) at full width, bf16, seeded perturbed weights,
    nothing cut, through ``make_engine``, which gives the SlotEngine:
    zamba2's every shared-block flash and dense decode call held against
    its plain version on its own inputs and its logits' drift from plain
    attention printed (``phase_logits``, a 512-token prompt); the peak
    memory of a 1024-token prefill; the 16 requests (prompts of 64-1024
    tokens) graphed and eagerly (``_arms``: equal streams and launch
    counts; zamba2 through flash and dense decode), tok/s, TTFT, TPOT,
    peak memory and the bytes a decode pass reads and writes, by part,
    against their byte bound. Returns {kernel: (zamba2-shape entry,
    zamba2's graphed launches)} for flash and dense decode."""
    from repro_torch.configs import get_config
    from repro_torch.engine.core import SlotEngine, make_engine
    gen = torch.Generator(device="cuda").manual_seed(23)
    shapes = phase_recurrent_kernels(gen)
    phase_recurrent_layers(gen)
    launches = {}
    for arch in RECURRENT:
        cfg = get_config(arch)
        tag = f"recurrent {arch}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        params = full_width_params(cfg)
        torch.cuda.synchronize()
        n = sum(v.numel() for v in _leaves(params))
        what = (f"Mamba2 d_inner {cfg.ssm.expand * cfg.d_model}, state "
                f"{cfg.ssm.state_dim}, shared GQA block every "
                f"{cfg.shared_attn_every} layers ({cfg.num_heads}/"
                f"{cfg.num_kv_heads} heads, d {cfg.resolved_head_dim})"
                if cfg.family == "hybrid" else
                f"mLSTM x {cfg.xlstm.slstm_every - 1} + sLSTM groups, "
                f"{cfg.num_heads} heads")
        log(f"[{tag}] {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{what}: {n / 1e9:.3f}B parameters, {2 * n / 1e9:.1f} GB bf16, "
            f"made and perturbed in {time.monotonic() - t0:.1f}s, peak "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if cfg.family == "hybrid":
            phase_logits(cfg, params, tag=tag, gate=False, prompt_len=512)
        else:
            # each mLSTM layer's decode step against the fp32 step, at the
            # weights phase train starts xLSTM from (TRAIN_SHARE): at full
            # scale the gate pre-activations reach ~1e4 in the late layers,
            # where bf16 rounds them by tens
            prompt = np.random.default_rng(1).integers(
                0, cfg.vocab_size, 64).astype(np.int32)
            check = full_width_params(cfg, share=TRAIN_SHARE[arch])
            with layer_checks() as worst:
                _prefill_and_decode_dense(check, cfg, prompt, steps=1)
            del check
            n_groups = cfg.num_layers // cfg.xlstm.slstm_every
            _held_line(tag, worst, {"mlstm_decode": n_groups * (
                cfg.xlstm.slstm_every - 1)})
        peak, wall = _prefill_peak(cfg, params)
        log(f"[{tag}] a 1024-token prefill: {wall * 1e3:.1f} ms (eager, "
            f"first of its length), peak {peak / 2**30:.3f} GiB above the "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        prompts = _recurrent_requests(cfg)

        def make(**kw):
            eng = make_engine(cfg, params=params, max_batch=8, max_len=2048,
                              device="cuda", **kw)
            if not isinstance(eng, SlotEngine):
                raise AssertionError(f"{arch}: make_engine gave "
                                     f"{type(eng).__name__}")
            return eng
        _serve(make(), prompts[:1], max_new=2)                  # warm-up
        g = _arms(tag, make, prompts)["graphed"]
        _finished(tag, g["done"], len(prompts))
        if cfg.family == "hybrid":
            _launched(tag, g["launches"],
                      ("flash_attention", "decode_attention"))
            launches = {k: g["launches"][k]
                        for k in ("flash_attention", "decode_attention")}
        toks = sum(len(r.tokens) for r in g["done"])
        ttft, tpot = _means_ms(g["done"])
        parts = _recurrent_bytes(cfg, params, prompts)
        total = sum(parts.values())
        bound_ms = total / PEAK_BYTES_PER_S * 1e3
        log(f"[{tag}] SlotEngine, graphed: tok/s {toks / g['wall']:.2f}, "
            f"TTFT mean {ttft:.2f} ms, TPOT mean {tpot:.2f} ms, peak "
            f"allocated {g['peak'][0] / 2**30:.2f} GiB; a decode pass at 8 "
            f"slots reads and writes {total / 1e9:.3f} GB ("
            + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items())
            + f" GB), {bound_ms:.3f} ms at {PEAK_BYTES_PER_S / 1e12:.2f} "
            f"TB/s, TPOT / that {tpot / bound_ms:.3f}; {card}")
        del params, g
        torch.cuda.empty_cache()
    return {k: (shapes[k], launches[k]) for k in shapes}


# ---------------------------------------------------------------------------
# phase 15: training at full width
# ---------------------------------------------------------------------------

# the backward kernel's shapes, (b, s, nh, kvh, dq, dv) and causal: Gemma-
# 2B's prefill attention (the row's shape) and its training batch of 4 (the
# row's launches), HuBERT-XLarge's non-causal encoder at the training
# batch, a value head narrower than the query's (MLA's 192/128), and the
# training shapes of MiniCPM3-4B (MLA 96/64 x 40 heads), DeepSeek-V2-Lite
# (MLA 192/128 x 16) and Zamba2-7B's shared block (32 heads, d 112)
BWD_SHAPES = (("gemma_2b", (1, 1024, 8, 1, 256, 256), True),
              ("gemma_2b_train", (4, 1024, 8, 1, 256, 256), True),
              ("hubert_xlarge", (4, 1024, 16, 16, 80, 80), False),
              ("dv<dq", (1, 512, 16, 16, 192, 128), True),
              ("minicpm3_4b", (4, 1024, 40, 40, 96, 64), True),
              ("deepseek_v2_lite_16b", (4, 1024, 16, 16, 192, 128), True),
              ("zamba2_7b", (4, 1024, 32, 32, 112, 112), True),
              # a rank's share on (2, 2) (phase dist_train_all,
              # tools/dist_cards.py train_whole): half the batch and
              # half the heads
              ("zamba2_7b_rank", (2, 1024, 16, 16, 112, 112), True),
              ("internlm2_20b_rank", (2, 1024, 24, 4, 128, 128), True),
              # tools/dist_cards.py train_236b
              ("deepseek_v2_236b_rank", (2, 1024, 64, 64, 192, 128), True))
# the gradient kernel against its plain version on the same bf16 inputs,
# each of dq, dk, dv: relative norm per (batch, head) slab <= GRAD_SLAB_RTOL
# and |err| <= GRAD_TOL (max |plain| + |plain|) elementwise; the plain
# version forms P and every product in fp32, the kernel rounds P and dS to
# bf16 for its products and its outputs to bf16
GRAD_SLAB_RTOL = 0.01
GRAD_TOL = 0.02
# lse: both sum exp of the same fp32 scores, in other orders
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# full-width launch.train runs, 6 steps of 4 x 1024 tokens: (arch, layers
# trained (None: all), remat). The GQA configs and v2-lite train with remat
# "none", as the launcher trains. The train state takes 12 B a parameter
# (bf16 parameter and gradient, fp32 m and v): v2-lite's 27 layers are
# 175.5 GiB and zamba2's 81 are 75.4, so they train the dense layer and 4
# MoE layers, and 26 Mamba2 layers with 2 applications of the shared
# block. Under "none" MiniCPM3-4B's 62 layers (45.5 GiB of state) and
# zamba2's 26 ran out of the card's 80 GB (peaks 76.47 and 77.86 GiB
# allocated when they failed, an H100 80GB HBM3 at 700 W), so they train
# under remat "full" (the configs' default), as does xLSTM (48 layers,
# 40.3 GiB of state, ~0.8 GB of mLSTM chunk states a layer under "none";
# it trains 16, two mLSTM x 7 + sLSTM groups: its host-paced steps, ~10 s
# each at 48 layers, leave no room for phase dist_train_all in the
# script's time limit).
# The restart runs hubert_xlarge at RESTART_LAYERS of its 48 layers (its
# checkpoint ~1 GB; Gemma-2B's state would be ~25 GB)
TRAIN_RUNS = (("gemma_2b", None, "none"), ("hubert_xlarge", None, "none"),
              ("minicpm3_4b", None, "full"),
              ("deepseek_v2_lite_16b", 5, "none"),
              ("zamba2_7b", 26, "full"), ("xlstm_1_3b", 16, "full"))
TRAIN_ARCHS = tuple(arch for arch, _, _ in TRAIN_RUNS)
# the share of each weight's scale that perturbs a run's start, where not
# 1 (phase recurrent's mLSTM step check takes the same weights): at 1
# xLSTM's residual stream (which its mLSTM and sLSTM read without a norm,
# as in the JAX package) grows ~1.37x a layer, its gradient norm
# overflowed fp32 on the card (inf at step 1; 4.5e15 at 48 reduced layers
# on the CPU); at 0.3 the stream stays O(1) (RMS 0.95-1.64 over 48 reduced
# layers)
TRAIN_SHARE = {"xlstm_1_3b": 0.3}
# the leaves of a run that may keep a layer unmoved in bf16 though its
# gradient arrives: xLSTM's gate biases (-3 and +3 plus noise of 0.15),
# where half a bf16 gap (>= 7.8e-3) exceeds the largest AdamW step (lr <=
# 3e-3, its weight decay 0.1 x |x| x lr); zamba2's Mamba2 D (1 plus noise
# of 0.09), whose clipped gradient in the last layers is below AdamW's eps
# (1e-8), which holds its steps under half a bf16 gap (the run prints each
# unmoved row's largest sqrt(v)). Every other (leaf, layer) must move
TRAIN_STUCK = {"zamba2_7b": {"mamba.D"}, "xlstm_1_3b": {"mlstm.b_if"}}
# xLSTM's bf16 steps against fp32 gradients at the same weights
# (``_xlstm_witness``): one mLSTM x 7 + sLSTM group, 6 steps. The first
# step, at the start weights, is gated: its norms within
# WITNESS_NORM_RTOL and the gradients' cosine >= WITNESS_COS (read at 1.9e-4
# and 0.99993 on an H100 80GB HBM3 at 700 W); after one AdamW step at lr
# 3e-3 the gradient is ill-conditioned (bf16 and fp32 cosines 0.01-0.66 at
# the same weights), so the later steps are printed
WITNESS_LAYERS, WITNESS_STEPS = 8, 6
WITNESS_NORM_RTOL, WITNESS_COS = 0.005, 0.999
# MiniCPM3-4B's gradients of one batch under the three remats, at a depth
REMAT_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_ARGV = ("--steps", "6", "--batch", str(TRAIN_BATCH), "--seq",
              str(TRAIN_SEQ), "--log-every", "1")
RESTART_LAYERS = 4
# values of each layer of a stacked leaf (of the leaf elsewhere) kept to
# show that the training run moved it
SNAP_ELEMS = 4096


def compare_grads(name: str, got, want):
    """(max abs error, max slab relative error) of a gradient of shape (b,
    n, heads, d) against its plain version; raises past GRAD_TOL or
    GRAD_SLAB_RTOL."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel gradient")
    err = (got - want).abs()
    bad = err > GRAD_TOL * float(want.abs().max()) + GRAD_TOL * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {float(err.max()):.4g}")
    slab = lambda x: x.permute(0, 2, 1, 3).flatten(2)        # noqa: E731
    rel = float((slab(got - want).norm(dim=-1)
                 / slab(want).norm(dim=-1).clamp(min=1e-30)).max())
    if rel > GRAD_SLAB_RTOL:
        raise AssertionError(f"{name}: a (batch, head) slab is off by "
                             f"{rel:.4g} of its norm")
    return float(err.max()), rel


def _bwd_work(b, s, nh, kvh, dq, dv, causal):
    """(bytes, operations) of the attention backward: q, k, v, o, dO, lse
    read and dq, dk, dv written once; 2.5 x the forward's operations."""
    nbytes = (2 * 2 * b * s * (nh * dq + kvh * dq + kvh * dv + nh * dv)
              + 4 * b * nh * s)
    pairs = s * (s + 1) // 2 if causal else s * s
    return nbytes, 2.5 * 2 * (dq + dv) * nh * b * pairs


def _sdpa_bwd(q, k, v, do, causal):
    """The yardstick: autograd's backward of one
    scaled_dot_product_attention on the same inputs (GQA by
    ``enable_gqa``), timed alone; the port never calls it."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal,
        enable_gqa=q.shape[2] != k.shape[2])
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def _bwd_ptxas():
    """Registers and spill bytes of the backward library's kernels, from
    nvcc's -Xptxas -v report."""
    from repro_torch.kernels import _build
    rep = _build.ptxas_reports.get("flash_attention_bwd", "")
    regs = [int(x.split("Used ")[1].split()[0]) for x in rep.splitlines()
            if "registers" in x]
    spills = [int(x.split("bytes spill stores")[0].split(",")[-1])
              for x in rep.splitlines() if "spill stores" in x]
    return (f"{len(regs)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, "
            f"{max(spills, default=0)} B spilled at most")


def phase_train_kernels(gen):
    """The backward kernel at BWD_SHAPES: the forward with lse ==
    the launch without it (``torch.equal``) and its lse against the plain
    version's; the backward against ``ref.flash_attention_bwd`` on the same
    bf16 inputs (``compare_grads``), two launches equal, and kernel, plain
    version and sdpa's backward timed with the host queue held beside the
    bound; each shape's launch plan logged. Returns the kernels-line row
    (Gemma's shape; the others under "shapes")."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    mk = lambda *shape: torch.randn(                          # noqa: E731
        *shape, generator=gen, device="cuda").to(torch.bfloat16)
    shapes = {}
    for tag, (b, s, nh, kvh, dq, dv), causal in BWD_SHAPES:
        q, k, v = mk(b, s, nh, dq), mk(b, s, kvh, dq), mk(b, s, kvh, dv)
        do = mk(b, s, nh, dv)
        o, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
        if not torch.equal(o, tfa.flash_attention(q, k, v, causal=causal)):
            raise AssertionError(f"{tag}: the lse launch's output is not "
                                 "the plain launch's")
        _, want_lse = ref.flash_attention_lse(q, k, v, causal=causal)
        lse_err = float((lse - want_lse).abs().max())
        if ((lse - want_lse).abs() > LSE_ATOL
                + LSE_RTOL * want_lse.abs()).any():
            raise AssertionError(f"{tag}: lse off by {lse_err:.3g}")
        run = lambda: tfa.flash_attention_bwd(                # noqa: E731
            q, k, v, o, lse, do, causal=causal)
        got = run()
        want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal)
        errs = [compare_grads(f"flash_attention_bwd {tag} {n}", g, w)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        del want
        if not all(torch.equal(x, y) for x, y in zip(got, run())):
            raise AssertionError(f"{tag}: two backward launches differ")
        ms = cuda_time_ms(run, hold=True)
        plain_ms = cuda_time_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, lse, do, causal), iters=5, warmup=1, hold=True)
        library_ms = cuda_time_ms(_sdpa_bwd(q, k, v, do, causal), hold=True)
        b_ms, b_by = bound(*_bwd_work(b, s, nh, kvh, dq, dv, causal),
                           PEAK_BF16_FLOPS)
        plan = tfa.backward_plan(b, s, s, nh, kvh, dq, dv, q.device)
        shapes[tag] = {
            "shape": [b, s, nh, kvh, dq, dv], "causal": causal,
            "plan": plan,
            "max_abs_err": max(e for e, _ in errs),
            "max_row_rel_err": max(r for _, r in errs), "lse_err": lse_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}
        log(f"[train] flash_attention_bwd {tag} ({b}, {s}, {nh}/{kvh}, "
            f"{dq}/{dv}, causal={causal}): dq/dk/dv max_abs_err "
            + "/".join(f"{e:.3g}" for e, _ in errs) + ", slab rel err "
            + "/".join(f"{r:.3g}" for _, r in errs)
            + f" (limits {GRAD_TOL}, {GRAD_SLAB_RTOL}); lse err "
            f"{lse_err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa backward {library_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), kernel / bound {ms / b_ms:.2f}, kernel / sdpa "
            f"{ms / library_ms:.2f}")
        log(f"[train] flash_attention_bwd {tag} plan: {plan['splits']} "
            f"head splits, {plan['dkdv_blocks']} dK/dV blocks "
            f"({plan['dkdv_stages']} ring stages, {plan['dkdv_smem']} B), "
            f"{plan['dq_blocks']} dQ blocks ({plan['dq_stages']} stages, "
            f"{plan['dq_smem']} B), {plan['partial_bytes']} B of partials")
        del q, k, v, do, o, lse, got
    ptxas = _bwd_ptxas()
    log(f"[train] flash_attention_bwd ptxas: {ptxas}")
    row = dict(shapes["gemma_2b"])
    row.update(shapes={k: v for k, v in shapes.items() if k != "gemma_2b"},
               ptxas=ptxas)
    return row


@contextlib.contextmanager
def backward_checks():
    """While ``on[0]`` is true, hold every backward kernel call against
    ``ref.flash_attention_bwd`` on that call's own inputs (``compare_grads``),
    the kernel's gradients going on into the model. Yields (on, worst):
    worst is [calls, max abs error, max slab relative error]."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    kernel = tfa.flash_attention_bwd
    on, worst = [True], [0, 0.0, 0.0]

    def run(q, k, v, o, lse, do, *, causal=True, scale=None):
        got = kernel(q, k, v, o, lse, do, causal=causal, scale=scale)
        if on[0]:
            want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                           scale)
            for n, g, w in zip(("dq", "dk", "dv"), got, want):
                e, r = compare_grads(f"backward call {worst[0]} {n}", g, w)
                worst[1], worst[2] = max(worst[1], e), max(worst[2], r)
            worst[0] += 1
        return got
    tfa.flash_attention_bwd = run
    try:
        yield on, worst
    finally:
        tfa.flash_attention_bwd = kernel


def _state_fn(seed: int = 0, share: float = 1.0):
    """launch.train's start: seeded full-width weights, every leaf
    perturbed by ``share`` of its scale (the JAX init zeroes the output
    projections), fresh AdamW moments."""
    def make(cfg, device):
        from repro_torch.models.optim import init_opt_state
        params = full_width_params(cfg, seed, share)
        return {"params": params, "opt": init_opt_state(params)}
    return make


# the matrix-product weights _train_flops counts (by their last key)
_PRODUCT_WEIGHTS = ("wq", "wk", "wv", "wo", "wi", "wdq", "wuq", "wdkv",
                    "wkr", "wuk", "wuv", "router", "in_proj", "out_proj",
                    "up", "down", "wif", "wx", "r", "ff_wi", "ff_wo",
                    "head")


def _attn_layers(cfg) -> int:
    """How many attention calls one forward makes (the hybrid's shared
    block once an application; the ssm family none)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return 0 if cfg.family == "ssm" else cfg.num_layers


def _train_flops(cfg, b, s) -> float:
    """6 x the matrix-product weights a token reads x tokens (a routed MoE
    expert's at top_k / experts; the hybrid's shared block once an
    application; a tied embedding as the head), plus 3 x the causal (or
    full) attention's forward products. The recurrent scans' own products
    (chunk-quadratic terms, the sLSTM's state) are left out."""
    from repro_torch.models import transformer as tf
    flat = _flat(tf.init_model(cfg, torch.Generator(), "meta"))
    n = 0.0
    for path, v in flat.items():
        last = path.split(".")[-1]
        if path == "embed" and cfg.tie_embeddings:
            n += v.numel()
        elif last in _PRODUCT_WEIGHTS and path != "embed":
            share = 1.0
            routed = ".moe." in path and ".shared." not in path
            if routed and last != "router":
                share = cfg.moe.top_k / cfg.moe.num_experts
            if path.startswith("shared."):
                share = _attn_layers(cfg)
            n += v.numel() * share
    if cfg.attn_type == "mla":
        dq = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dq = dv = cfg.resolved_head_dim
    pairs = s * (s + 1) // 2 if not cfg.encoder_only else s * s
    attn = 3 * 2 * (dq + dv) * cfg.num_heads * b * pairs * _attn_layers(cfg)
    return 6.0 * n * b * s + attn


@contextlib.contextmanager
def _launch_patched(init_state, layers=None, after_step=None, remat=None):
    """While open, launch.train.main starts from ``init_state(cfg, device)``
    in place of its seed-0 state, trains its config cut to ``layers``
    layers (full width) when given, with ``remat`` in place of the
    launcher's "none" when given, and calls ``after_step(state, metrics,
    the step's OptConfig)`` after each train step."""
    from repro_torch.launch import train
    from repro_torch.models import steps
    saved = train.get_config, steps.init_train_state, steps.train_step
    get_config, train_step = saved[0], saved[2]

    def config(arch):
        cfg = get_config(arch)
        return cfg if layers is None else cfg.replace(num_layers=layers)

    def step(state, batch, cfg, opt, **kw):
        if remat is not None:
            cfg = cfg.replace(remat=remat)
        state, metrics = train_step(state, batch, cfg, opt, **kw)
        if after_step is not None:
            after_step(state, metrics, opt)
        return state, metrics
    train.get_config = config
    steps.init_train_state = lambda cfg, gen, device: init_state(cfg, device)
    steps.train_step = step
    try:
        yield
    finally:
        train.get_config, steps.init_train_state, steps.train_step = saved


def _train_run(arch, init_state, layers=None, remat="none"):
    """launch.train.main at full width (TRAIN_ARGV) from ``init_state``,
    cut to ``layers`` layers when given, under ``remat``, in a fresh
    checkpoint directory (6 steps write no checkpoint at the default
    interval of 20), the launch counters reset just before and read just
    after, every backward call of its first step held against the plain
    version. Returns (losses, grad norms, aux losses, step seconds,
    launches, worst, state, cfg, the launcher's OptConfig)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    got = {"gn": [], "aux": [], "t": [], "state": None}

    def after_step(state, metrics, opt):
        got["opt"] = opt
        torch.cuda.synchronize()
        got["t"].append(time.perf_counter())
        got["gn"].append(float(metrics["grad_norm"]))
        got["aux"].append(float(metrics["aux_loss"]))
        got["state"] = state
        checks[0][0] = False

    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp, \
            backward_checks() as checks, \
            _launch_patched(init_state, layers, after_step, remat):
        argv = ["--arch", arch, *TRAIN_ARGV, "--ckpt-dir", tmp]
        torch.cuda.synchronize()
        ops.reset_launches()
        got["t"] = [time.perf_counter()]
        losses = train.main(argv)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=layers or cfg.num_layers, remat=remat)
    steps_s = np.diff(got["t"])
    return (losses, got["gn"], got["aux"], steps_s, launches, checks[1],
            got["state"], cfg, got["opt"])


# the params keys whose leaves stack layers on their first axis
STACKED = ("layers", "dense_layers", "mamba", "mlstm", "slstm")


def _layer_sample(path, v, rows=None):
    """The first SNAP_ELEMS values of each layer of a stacked leaf, one row
    a layer; of the leaf itself elsewhere, one row; of an untied embedding
    the token rows ``rows`` (the others get no gradient)."""
    if path == "embed" and rows is not None:
        return v[rows]
    n = v.shape[0] if path.split(".")[0] in STACKED else 1
    return v.reshape(n, -1)[:, :SNAP_ELEMS]


def _unmoved(state, snap, rows):
    """The sampled (leaf, layer) rows of a train state (``_layer_sample``
    with ``rows``; frontend_proj left out) whose second moments are all 0,
    as (leaf, layer), and those whose values are ``snap``'s, as (leaf,
    layer, the largest sqrt(v) of the row)."""
    flat_v = _flat(state["opt"]["v"])
    no_grad, unmoved = [], []
    for k, v in _flat(state["params"]).items():
        if k == "frontend_proj":
            continue
        rms = _layer_sample(k, flat_v[k], rows).amax(dim=1).sqrt().tolist()
        moved = (_layer_sample(k, v, rows) != snap[k]).any(dim=1).tolist()
        no_grad += [(k, i) for i, r in enumerate(rms) if r == 0]
        unmoved += [(k, i, r) for i, (m, r) in enumerate(zip(moved, rms))
                    if not m]
    return no_grad, unmoved


@contextlib.contextmanager
def _floor_overflows():
    """While open, count the entries of the chunked mLSTM's floor exp(-m)
    that overflow to inf (m below -88.7), where autograd's exp backward
    would give 0 x inf = NaN and ``xlstm._exp_floor`` gives 0, over every
    forward and remat recompute. Yields a list that holds, at exit, (that
    count, the least m)."""
    from repro_torch.models import xlstm as xl
    floor, seen, out = xl._exp_floor, [], []

    def rec(m):
        y = floor(m)
        seen.append(torch.stack([torch.isinf(y).sum().float(),
                                 m.detach().amin().float()]))
        return y
    xl._exp_floor = rec
    try:
        yield out
    finally:
        xl._exp_floor = floor
        if seen:
            s = torch.stack(seen)
            out += [int(s[:, 0].sum()), float(s[:, 1].min())]


def _flash_counts(launches):
    return launches["flash_attention"], launches["flash_attention_bwd"]


def _remat_and_drift(params, cfg, batch, card):
    """Gradients of one batch under remat "full" and "none": equal
    (``torch.equal``), flash's forward launched 2 x layers times under
    "full" and layers times under "none", its backward layers times, and
    the "none" run's every backward call held
    against its plain version on its own inputs (``backward_checks``) at
    these weights; then the gradients against plain attention's and
    against plain attention's with P rounded to bf16 before P·V
    (``flash_p_bf16``), printed: loss, global grad norm, their drift, the
    gradients' cosine and the leaves that differ the most."""
    from repro_torch.kernels import ops
    from repro_torch.models import optim, steps

    def grads(remat, counted=True):
        L = cfg.num_layers
        ops.reset_launches()
        (tot, _), g = steps.value_and_grad(params, batch,
                                           cfg.replace(remat=remat))
        got = _flash_counts(ops.launch_counts())
        want = (2 * L if remat == "full" else L, L)
        if counted and got != want:
            raise AssertionError(f"remat {remat}: flash launches {got} "
                                 f"(forward, backward); want {want}")
        return float(tot), _flat(g)
    tot_f, flat_f = grads("full")
    with backward_checks() as (_, worst):
        tot_n, flat_n = grads("none")
    same = tot_f == tot_n and all(torch.equal(flat_f[k], flat_n[k])
                                  for k in flat_f)
    del flat_n
    if not same:
        raise AssertionError("gradients differ under remat full and none")
    if worst[0] != cfg.num_layers:
        raise AssertionError(f"{worst[0]} backward calls held")
    log(f"[train] gemma_2b: one batch's gradients torch.equal under remat "
        f"full and none (flash {2 * cfg.num_layers} / {cfg.num_layers} "
        f"forward launches, {cfg.num_layers} backward each); every "
        f"backward call at the trained weights held "
        f"({worst[0]} calls, max_abs_err {worst[1]:.3g}, slab rel err "
        f"{worst[2]:.3g})")
    gn = float(optim.global_norm(flat_f))
    for tag, plain in (("plain attention", None),
                       ("plain attention, P in bf16", flash_p_bf16)):
        with plain_attention():                 # restores ops on exit
            if plain is not None:
                ops.flash_attention = plain
            tot_p, flat_p = grads("none", counted=False)
        gp = float(optim.global_norm(flat_p))
        cos = sum(float((flat_f[k].float() * flat_p[k].float()).sum())
                  for k in flat_f) / (gn * gp)
        diff = sorted(((float((flat_f[k].float() - flat_p[k].float()
                               ).norm()), k) for k in flat_f),
                      reverse=True)[:3]
        log(f"[train] gemma_2b against {tag} (printed, not gated): loss "
            f"{tot_f:.6f} / {tot_p:.6f}, global grad norm {gn:.6g} / "
            f"{gp:.6g}, drift {abs(gn - gp) / gp:.4g}, cosine of the "
            f"gradients {cos:.6f}; largest |kernels - plain| "
            + ", ".join(f"{k} {d:.4g}" for d, k in diff) + f"; {card}")
        del flat_p


def _memory_report(top: int = 6):
    """What is still allocated on the card: the active blocks of
    ``torch.cuda.memory_snapshot()`` grouped by size, each group with its
    memory pool (a CUDA graph's pool is not (0, 0)), stream and, where
    ``main`` recorded allocation history, the Python stack of its first
    block's allocation (innermost frames of the repo). Returns the
    allocated GiB."""
    groups = {}
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = blk.get("frames", [])
            where = tuple(
                f"{f['filename'].split('/')[-1]}:{f['line']} {f['name']}"
                for f in frames if "repro" in f["filename"]
                or "chip_smoke" in f["filename"])[:4]
            key = (blk["size"], tuple(seg.get("segment_pool_id", (0, 0))),
                   where or (("no Python frame of the repo",) if frames
                             else ("no recorded stack",)))
            g = groups.setdefault(key, [0, set()])
            g[0] += 1
            g[1].add(seg.get("stream", 0))
    allocated = torch.cuda.memory_allocated() / 2**30
    log(f"[memory] {allocated:.3f} GiB allocated in "
        f"{sum(g[0] for g in groups.values())} blocks")
    for (size, pool, where), (n, streams) in sorted(
            groups.items(), key=lambda kv: -kv[0][0] * kv[1][0])[:top]:
        log(f"[memory]   {n} x {size / 2**20:.2f} MiB, pool {pool}, on "
            f"{len(streams)} stream(s): " + " <- ".join(where))
    return allocated


def device_busy(fn):
    """Run ``fn`` once under ``torch.profiler`` (device activity only: an
    xLSTM step launches ~10^5 kernels): (wall s, the device's summed
    kernel time s)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = 0.0
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0)
        if dev > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            busy += dev / 1e6
    return wall, busy


def _xlstm_witness(opt, card):
    """xlstm_1_3b cut to WITNESS_LAYERS layers (full width, remat "full"),
    from its training run's start (weights perturbed at TRAIN_SHARE), bf16,
    WITNESS_STEPS AdamW steps of launch.train's batches under its
    OptConfig ``opt``, each step as ``steps.train_step`` takes it; before
    each update the bf16 gradients against fp32 gradients at the same
    weights (the bf16 parameters in fp32) on the same batch, the fp32 path
    being the one the CPU tests hold against JAX: at the first step the
    global norms within WITNESS_NORM_RTOL of each other and the cosine of
    the two gradients at least WITNESS_COS; every step's loss, norms and
    cosine printed, so that the growth of the norms from step to step shows
    in fp32 as well as in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import optim, steps
    from repro_torch import tree
    arch = "xlstm_1_3b"
    cfg = get_config(arch).replace(num_layers=WITNESS_LAYERS,
                                   param_dtype="bfloat16",
                                   compute_dtype="bfloat16", remat="full")
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    state = _state_fn(share=TRAIN_SHARE[arch])(cfg, "cuda")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH)
    rows = []
    for i in range(WITNESS_STEPS):
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch_at(dc, i).items()}
        p32 = tree.map_tree(lambda t: t.float(), state["params"])
        (_, (l32, _)), g32 = steps.value_and_grad(p32, batch, cfg32)
        del p32
        n32 = optim.global_norm(g32)
        (_, (l16, _)), g16 = steps.value_and_grad(state["params"], batch,
                                                  cfg)
        n16 = optim.global_norm(g16)
        cos = sum(torch.sum((a.float() / n16) * (b / n32))
                  for a, b in zip(tree.leaves(g16), tree.leaves(g32)))
        del g32
        state["params"], state["opt"], _ = optim.adamw_update(
            state["params"], g16, state["opt"], opt)
        del g16
        rows.append((float(l16), float(l32), float(n16), float(n32),
                     float(cos)))
    log(f"[train] xlstm_1_3b at {WITNESS_LAYERS} of 48 layers, weights "
        f"perturbed at {TRAIN_SHARE[arch]}, {WITNESS_STEPS} bf16 steps, "
        f"each step's gradients against fp32's at the same weights: "
        + "; ".join(f"step {i + 1} loss {a:.4f} / {b:.4f}, grad norm "
                    f"{c:.6g} / {d:.6g} (rel {abs(c / d - 1):.3g}), cosine "
                    f"{e:.6f}" for i, (a, b, c, d, e) in enumerate(rows))
        + f" (limits at step 1: norm rel {WITNESS_NORM_RTOL}, cosine >= "
        f"{WITNESS_COS}); {card}")
    _, _, c, d, e = rows[0]
    if not (abs(c / d - 1) <= WITNESS_NORM_RTOL and e >= WITNESS_COS):
        raise AssertionError(f"xlstm witness: step 1 off fp32 {rows[0]}")


def _remat_grads_equal(card):
    """MiniCPM3-4B at REMAT_LAYERS layers, full width: one batch's loss
    and gradients ``torch.equal`` under remat "none", "full" and "dots",
    flash's forward launched layers times under "none" and twice that
    under "full" and "dots" (its forward is not a product: "dots"
    recomputes it), its backward layers times each; every backward call of
    the "none" run held (``backward_checks``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.models import steps
    cfg = get_config("minicpm3_4b").replace(num_layers=REMAT_LAYERS)
    params = full_width_params(cfg, seed=3)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batch_at(dc, 100).items()}
    L, out, peaks = cfg.num_layers, {}, {}
    for remat in ("none", "full", "dots"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launches()
        with backward_checks() as (_, worst):
            (tot, _), g = steps.value_and_grad(params, batch,
                                               cfg.replace(remat=remat))
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
        got = _flash_counts(ops.launch_counts())
        want = (L if remat == "none" else 2 * L, L)
        if got != want or worst[0] != L:
            raise AssertionError(f"remat {remat}: flash launches {got}, "
                                 f"want {want}; {worst[0]} backward calls "
                                 "held")
        out[remat] = (tot, _flat(g))
        del g
    same = {r: torch.equal(out[r][0], out["none"][0]) and all(
        torch.equal(v, out["none"][1][k]) for k, v in out[r][1].items())
        for r in ("full", "dots")}
    log(f"[train] minicpm3_4b at {L} of 62 layers, one batch of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss and gradients torch.equal under "
        f"remat full / dots and none: {same['full']} / {same['dots']}; flash "
        f"{L} / {2 * L} / {2 * L} forward and {L} backward launches (none / "
        f"full / dots); peak above the weights {peaks['none']:.2f} / "
        f"{peaks['full']:.2f} / {peaks['dots']:.2f} GiB; {card}")
    if not all(same.values()):
        raise AssertionError(f"gradients differ across remats: {same}")


def phase_train(card: str):
    """Training on the card: the backward kernel (``phase_train_kernels``);
    launch.train.main at full width for each of TRAIN_RUNS (gemma_2b,
    hubert_xlarge, minicpm3_4b, deepseek_v2_lite_16b, zamba2_7b and
    xlstm_1_3b at their depths and remats), 6 steps of 4 x 1024 tokens
    from seeded perturbed weights (``_launch_patched``), bf16: finite
    losses and gradient norms, MoE's aux finite and > 0, every layer of
    every leaf changed, flash forward launches = attention layers x steps
    (twice that under a remat that wraps them) and backward = attention
    layers x steps, every backward call of the first step held against the
    plain version on its own inputs (``backward_checks``); xlstm's device
    busy share of one more step (host-paced: the sLSTM's loop over time);
    gemma's gradients of one batch equal under remat "full" and "none"
    (``_remat_and_drift``) and their norm's drift from plain attention
    printed; MiniCPM3-4B's under "none", "full" and "dots"
    (``_remat_grads_equal``); one HuBERT step from seeded embeds through
    frontend_proj and its serving entry ``prefill_step`` on them (every
    flash call held, ``layer_checks``); the restart: hubert_xlarge at
    RESTART_LAYERS layers, 6 steps, stopped after step 4 (its newest
    checkpoint at 3) and resumed, the resumed losses equal to the
    uninterrupted run's. Step time, tokens/s, peak memory and the achieved
    TFLOP/s against the model's products are printed. Returns (the
    backward kernel's row, {arch: flash forward and backward launches})."""
    import gc
    import tempfile
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import steps
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    # what the earlier phases leave on the card: the largest live tensors
    live = sorted(((o.numel() * o.element_size(), tuple(o.shape),
                    str(o.dtype)) for o in gc.get_objects()
                   if torch.is_tensor(o) and o.is_cuda), reverse=True)
    log(f"[train] {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated before the phase; largest live tensors: "
        + ", ".join(f"{n / 2**20:.0f} MiB {shape} {dt}"
                    for n, shape, dt in live[:4]))
    _memory_report()
    torch.cuda.memory._record_memory_history(enabled=None)
    gen = torch.Generator(device="cuda").manual_seed(24)
    row = phase_train_kernels(gen)
    launches, opts = {}, {}
    for arch, layers, remat in TRAIN_RUNS:
        torch.cuda.reset_peak_memory_stats()
        snap = {}
        dc = DataConfig(vocab_size=get_config(arch).vocab_size,
                        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        # an untied embedding moves only at the tokens read: sample the
        # first step's first tokens
        seen = torch.as_tensor(batch_at(dc, 0)["tokens"][0, :2],
                               device="cuda").long()

        def snap_state(cfg, device,
                       _make=_state_fn(share=TRAIN_SHARE.get(arch, 1.0))):
            state = _make(cfg, device)
            rows = None if cfg.tie_embeddings else seen
            snap.update({k: _layer_sample(k, v, rows).clone()
                         for k, v in _flat(state["params"]).items()})
            return state
        with _floor_overflows() as floor:
            (losses, gns, auxs, step_s, counts, worst, state, cfg,
             opt) = _train_run(arch, snap_state, layers, remat)
        peak = torch.cuda.max_memory_allocated() / 2**30
        L, n_steps, A = cfg.num_layers, len(losses), _attn_layers(cfg)
        twice = remat != "none" and cfg.family != "hybrid"
        fwd, bwd = _flash_counts(counts)
        want = (A * n_steps * (2 if twice else 1), A * n_steps)
        if (fwd, bwd) != want:
            raise AssertionError(f"{arch}: flash launches {fwd} forward, "
                                 f"{bwd} backward; want {want}")
        if not all(np.isfinite(losses + gns + auxs)):
            raise AssertionError(f"{arch}: non-finite loss, grad norm or "
                                 "aux")
        if (cfg.family == "moe") != all(a > 0 for a in auxs):
            raise AssertionError(f"{arch}: aux losses {auxs}")
        # every layer of every leaf the token steps read; frontend_proj (a
        # stub frontend's, read only from embeds) gets a zero gradient, and
        # in bf16 its weight decay alone rounds away: the embeds step below
        # moves it. Each (leaf, layer) got a gradient (a second moment not
        # all 0) and moved; one that did not move must be of a leaf that
        # TRAIN_STUCK names, and the leaves with one must be those it names
        no_grad, unmoved = _unmoved(
            state, snap, None if cfg.tie_embeddings else seen)
        stuck = {k for k, _, _ in unmoved}
        if no_grad or stuck != TRAIN_STUCK.get(arch, set()):
            raise AssertionError(
                f"{arch}: (leaf, layer) with no gradient {no_grad}; "
                f"unmoved {unmoved}, want only leaves "
                f"{TRAIN_STUCK.get(arch, set())}")
        if worst[0] != A:
            raise AssertionError(f"{arch}: {worst[0]} backward calls held, "
                                 f"{A} expected")
        launches[arch] = {"flash_attention": fwd, "flash_attention_bwd": bwd}
        opts[arch] = opt
        b, s = TRAIN_BATCH, TRAIN_SEQ
        med = float(np.median(step_s[1:]))
        flops = _train_flops(cfg, b, s)
        full_layers = get_config(arch).num_layers
        share = TRAIN_SHARE.get(arch, 1.0)
        log(f"[train] {arch} ({L} of {full_layers} layers, remat {remat}"
            + (f", weights perturbed at {share} of their scale"
               if share != 1.0 else "") + "): losses "
            + " ".join(f"{x:.4f}" for x in losses)
            + "; grad norms " + " ".join(f"{x:.4f}" for x in gns)
            + ("; aux losses " + " ".join(f"{x:.6f}" for x in auxs)
               if cfg.family == "moe" else "")
            + (f"; the mLSTM floor exp(-m) overflowed at {floor[0]} "
               f"entries over the forwards and recomputes (least m "
               f"{floor[1]:.4g}), where autograd's exp would give the "
               f"gradient NaN and _exp_floor gives 0" if floor else "")
            + f"; launches flash {fwd} forward, {bwd} backward; every "
            f"layer of every leaf got a gradient and moved, but "
            f"{len(unmoved)} (leaf, layer) of {sorted(stuck)}"
            + "".join(f"; unmoved {k} layer {i}: largest sqrt(v) {r:.3g}"
                      for k, i, r in unmoved[:3])
            + "; every "
            f"backward call of step 1 held ({worst[0]} calls, max_abs_err "
            f"{worst[1]:.3g}, slab rel err {worst[2]:.3g}); step s "
            + " ".join(f"{x:.3f}" for x in step_s)
            + f", median of steps 2-6 {med:.4f} s, {b * s / med:.1f} "
            f"tokens/s, {flops / med / 1e12:.1f} TFLOP/s of the model's "
            f"products ({flops / 1e12:.1f} TFLOP a step), "
            f"{flops / med / PEAK_BF16_FLOPS:.3f} of "
            f"{PEAK_BF16_FLOPS / 1e12:.0f}; peak {peak:.2f} GiB; {card}")
        batch = None
        if arch == "gemma_2b":
            one = DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                             global_batch=1)
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in batch_at(one, 100).items()}
            _remat_and_drift(state["params"], cfg, batch, card)
        elif arch == "xlstm_1_3b":
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in batch_at(dc, 6).items()}
            wall, busy = device_busy(
                lambda: steps.train_step(state, batch, cfg))
            log(f"[train] xlstm_1_3b, one more step under the profiler: "
                f"{wall:.3f} s, the device busy {busy:.3f} s; idle (host-"
                f"paced: the sLSTM's loop over {TRAIN_SEQ} steps, forward and "
                f"backward) {1 - busy / wall:.3f} of it; {card}")
        elif arch == "hubert_xlarge":
            rng = torch.Generator(device="cuda").manual_seed(25)
            emb = torch.randn(b, s, cfg.frontend_dim, generator=rng,
                              device="cuda").to(torch.bfloat16)
            batch = {"embeds": emb, "labels": torch.randint(
                0, cfg.vocab_size, (b, s), generator=rng, device="cuda",
                dtype=torch.int32)}
            m0 = state["opt"]["m"]["frontend_proj"].abs().max().item()
            ops.reset_launches()
            state, met = steps.train_step(state, batch, cfg)
            fwd, bwd = _flash_counts(ops.launch_counts())
            m1 = state["opt"]["m"]["frontend_proj"].abs().max().item()
            if (fwd, bwd) != (L, L) or not (
                    np.isfinite(float(met["loss"])) and m0 == 0 < m1):
                raise AssertionError(f"embeds step: launches {fwd}/{bwd}, "
                                     f"loss {float(met['loss'])}, "
                                     f"frontend_proj m {m0} -> {m1}")
            with torch.no_grad(), layer_checks() as held:
                logits, caches = steps.prefill_step(
                    state["params"], {"embeds": emb}, cfg, s)
            n_held = held.get("flash_attention", (0, 0, 0))[0]
            if (caches is not None or logits.shape != (b, s, cfg.vocab_size)
                    or not torch.isfinite(logits).all() or n_held != L):
                raise AssertionError(f"prefill_step: {tuple(logits.shape)}, "
                                     f"{n_held} flash calls held")
            log(f"[train] hubert_xlarge from embeds {tuple(emb.shape)}: "
                f"loss {float(met['loss']):.4f}, grad norm "
                f"{float(met['grad_norm']):.4f}, frontend_proj's first "
                f"moment 0 -> {m1:.3g}, flash {fwd} forward / {bwd} "
                f"backward; prefill_step logits {tuple(logits.shape)}, "
                f"caches None, every flash call held ({n_held})")
            del logits
        del state, snap, batch
        gc.collect()
        torch.cuda.empty_cache()
    _xlstm_witness(opts["xlstm_1_3b"], card)
    gc.collect()
    torch.cuda.empty_cache()
    _remat_grads_equal(card)
    gc.collect()
    torch.cuda.empty_cache()

    # restart: 6 steps with checkpoints every 3, against a run stopped
    # after step 4 (its newest checkpoint is step 3's) and resumed
    class Stop(Exception):
        pass
    calls = []

    def stop(state, metrics, opt):
        calls.append(1)
        if len(calls) == 4:
            raise Stop
    argv = ["--arch", "hubert_xlarge", *TRAIN_ARGV, "--ckpt-every", "3"]
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        t0 = time.perf_counter()
        with _launch_patched(_state_fn(), RESTART_LAYERS):
            whole = train.main(argv + ["--ckpt-dir", f"{tmp}/a"])
        t1 = time.perf_counter()
        with _launch_patched(_state_fn(), RESTART_LAYERS, stop):
            try:
                train.main(argv + ["--ckpt-dir", f"{tmp}/b"])
            except Stop:
                pass
        if ckpt.latest_step(f"{tmp}/b") != 3:
            raise AssertionError("restart: no checkpoint at step 3")
        with _launch_patched(_state_fn(), RESTART_LAYERS):
            resumed = train.main(argv + ["--ckpt-dir", f"{tmp}/b"])
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(f"{tmp}/b/step_00000003")
                   for f in fs)
    log(f"[train] restart, hubert_xlarge at {RESTART_LAYERS} of 48 layers: "
        f"uninterrupted losses " + " ".join(f"{x:.6f}" for x in whole)
        + "; resumed from step 3 " + " ".join(f"{x:.6f}" for x in resumed)
        + f"; checkpoint {size / 1e9:.3f} GB; 6 steps with 2 saves "
        f"{t1 - t0:.2f} s")
    if resumed != whole[3:]:
        raise AssertionError(f"restart: {resumed} != {whole[3:]}")
    log(f"[train] phase seconds {time.monotonic() - t_phase:.1f}; {card}")
    return row, launches


# phase dist: several ranks on the one card over gloo (NCCL refuses two
# ranks on one device), mesh ("data", "model") = DIST_MESH; full width,
# depth the only cut (the one-process reference, the 4 ranks' state and
# their CUDA contexts share the card's 80 GB: gemma_2b's 18 layers and
# v2-lite's 27 would not fit beside it)
DIST_MESH = (2, 2)
DIST_RUNS = (("gemma_2b", 6), ("deepseek_v2_lite_16b", 3),
             # the GShard dispatch einsum with its experts over "model"
             ("deepseek_v2_lite_16b", 3, "dispatch"))
DIST_STEPS, DIST_SEED = 2, 7
# the sharded step's loss against the one-process step's (bf16, the same
# weights and batch; other reduction orders): relative, per step. Read
# 7.2e-5 (gemma_2b) and 7.3e-5 (v2-lite) on an H100 80GB HBM3 at 700 W
DIST_LOSS_RTOL = 5e-4
# each gradient leaf's cosine to the one-process gradient; for MoE with
# the one process routed as the ranks routed: bf16 sums in another order
# move a hidden state by an ulp, which flips the top-k of a token at a
# near tie (v2-lite's free-routing cosines read 0.992 at 3 layers)
DIST_COS = 0.999
# the loss, aux and grad norm every rank reports (all-reduced, so alike up
# to the order of a rank's own replicated sums): their relative spread
DIST_SPREAD = 1e-6


def _dist_batches(cfg, n=DIST_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.data.pipeline import DataConfig, batch_at
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch)
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in batch_at(dc, i).items()} for i in range(n)]


def _dist_rank(rank, world, out_dir, mesh_shape=DIST_MESH, runs=DIST_RUNS):
    """One rank of phase dist (and of ``tools/dist_cards.py``): for each
    of ``runs`` at full width, its shards of seeded perturbed weights
    (``full_width_params``, the same on every rank), the sharded gradient
    of step 1 gathered to rank 0, then DIST_STEPS sharded train steps with
    the launch counters reset just before and read just after, every
    flash forward and backward call of step 1 held against its plain
    version (``layer_checks``, ``backward_checks``); then rank 0 alone
    runs the same steps in one process from the same weights and batches
    and compares. Writes ``rank{r}.json`` to ``out_dir``."""
    import gc
    import torch.distributed as dist
    from repro_torch import tree, weights
    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.optim import OptConfig, init_opt_state
    mesh = compat_make_mesh(mesh_shape, ("data", "model"))
    rules = sharding.ShardingRules(mesh)
    opt = OptConfig()
    out = {"backend": dist.get_backend(), "device": torch.cuda.current_device()}
    for arch, layers, *flags in runs:
        cfg = _serve_cfg(arch, layers, flags=flags).replace(remat="none")
        full = full_width_params(cfg, DIST_SEED)
        specs = sharding.tree_specs(rules, full, tf.param_axes(cfg))
        params = weights.shard_params(full, specs, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        batches = _dist_batches(cfg)
        # step 1's sharded gradient, gathered leaf by leaf to rank 0's
        # host, and each MoE layer's routing of the whole batch
        with _routes_recorded() as routes:
            _, grads = steps.value_and_grad(params, batches[0], cfg, rules,
                                            mesh)
        routes = [weights.gather_params(i, (("pod", "data"), None),
                                        mesh).cpu() for i in routes]
        flat_specs = tree.flatten(specs)
        gathered = {}
        for path, g in tree.flatten(grads).items():
            whole = weights.gather_params(g, flat_specs[path], mesh)
            if rank == 0:
                gathered[path] = whole.cpu()
            del whole
        del grads
        state = {"params": params, "opt": init_opt_state(params)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        mets, secs = [], []

        def step(batch):
            nonlocal state
            t0 = time.perf_counter()
            state, met = steps.train_step(state, batch, cfg, opt,
                                          rules=rules, mesh=mesh)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in met.items()})
        with layer_checks() as held, backward_checks() as (_, worst):
            step(batches[0])
        for batch in batches[1:]:
            step(batch)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the replicated metrics: their spread over every rank
        m = torch.tensor([[x[k] for k in ("loss", "aux_loss", "grad_norm")]
                          for x in mets], device="cuda")
        hi, lo = m.clone(), -m
        dist.all_reduce(hi, dist.ReduceOp.MAX)
        dist.all_reduce(lo, dist.ReduceOp.MAX)
        r = {"mets": mets, "secs": secs, "peak_gib": peak,
             "fwd": counts["flash_attention"],
             "bwd": counts["flash_attention_bwd"],
             "fwd_held": held.get("flash_attention", (0, 0.0, 0.0)),
             "bwd_held": list(worst),
             "spread": float(((hi + lo) / hi.abs().clamp(min=1e-30)).max()),
             "staged": D.staged_calls}
        del state, params, batches
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            r.update(_dist_one_process(cfg, opt, gathered, routes))
        del gathered
        dist.barrier()
        out[" ".join((arch, *flags))] = r
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@contextlib.contextmanager
def _routes_recorded():
    """Each MoE layer's expert choices (``moe._route``'s idx) while open,
    in call order."""
    from repro_torch.models import moe
    saved, got = moe._route, []

    def route(logits, cfg, data=None):
        out = saved(logits, cfg, data)
        got.append(out[1].detach().clone())
        return out
    moe._route = route
    try:
        yield got
    finally:
        moe._route = saved


@contextlib.contextmanager
def _routed_as(routes):
    """While open, the single-card router takes the experts of ``routes``
    (one (tokens, k) idx a call, in order) and computes its weights and
    aux from its own probabilities at them, as ``moe._route`` does."""
    from repro_torch.models import moe
    saved, calls = moe._router, iter(routes)

    def router(params, x2d, cfg):
        m = cfg.moe
        probs = torch.softmax(x2d.float() @ params["router"].float(), -1)
        idx = next(calls).to(x2d.device)
        w = torch.gather(probs, 1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        density = moe._one_hot(idx, m.num_experts).mean(dim=(0, 1))
        aux = (m.num_experts * torch.sum(density * probs.mean(0))
               * m.aux_loss_coef)
        return w, idx, aux
    moe._router = router
    try:
        yield
    finally:
        moe._router = saved


def _flipped(free, routes) -> int:
    """Tokens whose set of experts differs between two recordings of the
    same router calls (``_routes_recorded``)."""
    return sum(int((a.sort(-1).values != b.to(a.device).sort(-1).values)
                   .any(-1).sum()) for a, b in zip(free, routes))


def _dist_one_process(cfg, opt, gathered, routes):
    """The same weights, batches and steps in this one process, no mesh:
    the gradient of step 1 (each leaf's cosine to the sharded one,
    ``gathered``; for MoE also with the ranks' routing, ``routes``, and
    the tokens whose expert choices differ from the ranks'), the losses,
    step seconds and peak memory."""
    import gc
    from repro_torch import tree
    from repro_torch.models import steps
    from repro_torch.models.optim import init_opt_state
    params = full_width_params(cfg, DIST_SEED)
    batches = _dist_batches(cfg)

    def cosines(grads):
        out = {}
        for path, g in tree.flatten(grads).items():
            a = g.float().flatten()
            b = gathered[path].to(g.device).float().flatten()
            den = float(a.norm() * b.norm())
            out[path] = float(a @ b) / den if den else float(torch.equal(a, b))
        return out
    with _routes_recorded() as free:
        _, grads = steps.value_and_grad(params, batches[0], cfg)
    cos = cosines(grads)
    del grads
    out = {"cos": cos, "cos_routed": cos, "flipped": 0}
    if routes:
        with _routed_as(routes):
            _, grads = steps.value_and_grad(params, batches[0], cfg)
        out["cos_routed"] = cosines(grads)
        del grads
        out["flipped"] = _flipped(free, routes)
        out["routed_rows"] = sum(int(a.shape[0]) for a in free)
    gc.collect()
    torch.cuda.empty_cache()
    state = {"params": params, "opt": init_opt_state(params)}
    torch.cuda.reset_peak_memory_stats()
    mets, secs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, met = steps.train_step(state, batch, cfg, opt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "one_mets": mets, "one_secs": secs, "one_peak_gib": peak}


def dist_report(tag, card, mesh_shape, ranks, transport):
    """Gate and print one run of ``_dist_rank`` (``ranks``: each rank's
    JSON): every flash forward and backward launch count equal to
    attention layers x steps on every rank, every held call within its
    tolerance (raised in the rank), the replicated loss, aux and grad norm
    equal on every rank, each step's loss within DIST_LOSS_RTOL of the
    one-process step's, every gathered gradient leaf's cosine to the
    one-process gradient >= DIST_COS. Returns the flash forward and
    backward launches summed over the ranks."""
    from repro_torch.configs import get_config
    fwd = bwd = 0
    for arch, layers, *flags in DIST_RUNS:
        want = layers * DIST_STEPS
        name = " ".join((arch, *flags))
        per = [r[name] for r in ranks]
        for i, r in enumerate(per):
            if (r["fwd"], r["bwd"]) != (want, want) or \
                    r["fwd_held"][0] != layers or r["bwd_held"][0] != layers:
                raise AssertionError(
                    f"{tag} {name} rank {i}: flash {r['fwd']}/{r['bwd']} "
                    f"launches, {r['fwd_held'][0]}/{r['bwd_held'][0]} held; "
                    f"want {want}/{want}, {layers}/{layers}")
            if r["spread"] > DIST_SPREAD:
                raise AssertionError(f"{tag} {name}: the replicated metrics "
                                     f"differ across ranks by "
                                     f"{r['spread']} of their size")
        fwd += sum(r["fwd"] for r in per)
        bwd += sum(r["bwd"] for r in per)
        r0 = per[0]
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(r0["mets"], r0["one_mets"])]
        low = sorted(r0["cos_routed"].items(), key=lambda kv: kv[1])[:2]
        free = sorted(r0["cos"].items(), key=lambda kv: kv[1])[:1]
        if max(rel) > DIST_LOSS_RTOL or low[0][1] < DIST_COS or not all(
                np.isfinite(x[k]) for x in r0["mets"] for k in x):
            raise AssertionError(
                f"{tag} {name}: loss rel diff {rel}, least gradient cosine "
                f"{low} (free routing {free})")
        log(f"[{tag}] {name} ({layers} of {get_config(arch).num_layers} "
            f"layers, "
            f"full width, bf16, mesh (data, model) = {mesh_shape}, "
            f"{transport}): losses "
            + " ".join(f"{x['loss']:.5f}" for x in r0["mets"])
            + " vs one process " + " ".join(f"{x['loss']:.5f}"
                                            for x in r0["one_mets"])
            + f" (rel diff {max(rel):.3g}); aux "
            + " ".join(f"{x['aux_loss']:.6g}" for x in r0["mets"])
            + (" (the whole batch's)" if "dispatch" in flags
               else " (mean of the data shards')") + " vs one process "
            + " ".join(f"{x['aux_loss']:.6g}" for x in r0["one_mets"])
            + "; grad norm " + " ".join(f"{x['grad_norm']:.5f}"
                                        for x in r0["mets"])
            + " vs " + " ".join(f"{x['grad_norm']:.5f}"
                                for x in r0["one_mets"])
            + f"; least gradient cosine {low[0][1]:.6f} ({low[0][0]}) over "
            f"{len(r0['cos'])} leaves"
            + (f" with the ranks' routing (free routing: {free[0][1]:.6f} "
               f"({free[0][0]}), {r0['flipped']} of {r0['routed_rows']} "
               f"routed rows chose other experts)"
               if r0["flipped"] or "routed_rows" in r0 else "")
            + f"; flash {want}/{want} launches a rank, "
            f"step 1's {layers} forward and {layers} backward calls held "
            f"on every rank (worst abs err "
            f"{max(r['fwd_held'][1] for r in per):.3g} / "
            f"{max(r['bwd_held'][1] for r in per):.3g}); step s a rank "
            + "; ".join(" ".join(f"{t:.3f}" for t in r["secs"]) for r in per)
            + f" vs one process " + " ".join(f"{t:.3f}"
                                              for t in r0["one_secs"])
            + "; peak GiB a rank "
            + " ".join(f"{r['peak_gib']:.2f}" for r in per)
            + f" vs one process {r0['one_peak_gib']:.2f}; collectives "
            f"staged through host memory {r0['staged']}; {card}")
    return fwd, bwd


def phase_dist(card: str):
    """Distribution on the one card: ``_dist_rank`` in 4 processes (mesh
    ("data", "model") = DIST_MESH over gloo, several ranks a card), for
    gemma_2b (MQA: its one kv head's head dim split over "model" and
    gathered before rope, the tied vocabulary split over "model", flash
    forward and backward on 4 of 8 heads a rank) and
    deepseek_v2_lite_16b (MLA on 8 of 16 heads a rank, its MoE layers on
    32 of 64 experts a rank; again with the dispatch einsum, whose slots
    are the whole batch's: the lower data rank's assignments counted
    before a rank's own); DIST_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens through ``steps.train_step(..., rules=, mesh=)``; each rank's
    exit code checked (``mesh.spawn``), then ``dist_report``'s gates. The
    ranks' times and memory are gloo's, which stages CUDA tensors through
    host memory: not the card's collective speed. Returns the flash
    forward and backward launches of the ranks' steps."""
    import gc
    import shutil
    from repro_torch.launch import mesh
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "dist"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = int(np.prod(DIST_MESH))
    mesh.spawn(_dist_rank, world, (str(out_dir),))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    fwd, bwd = dist_report("dist", card, DIST_MESH, ranks,
                           f"{world} ranks on one card over gloo "
                           f"({ranks[0]['backend']}): times and memory "
                           f"gloo-staged, not the card's collectives")
    log(f"[dist] phase seconds {time.monotonic() - t0:.1f}; {card}")
    return fwd, bwd


# phase dist_serve: serving under a mesh, 4 ranks on the one card over
# gloo as phase dist runs them; (arch, layers, mesh (data, model),
# MLA absorbed). Full width, depth the only cut (the ranks, their CUDA
# contexts and the one-process reference share the card's 80 GB)
DIST_SERVE_RUNS = (("gemma_2b", 6, (2, 2), False),
                   ("llama3_70b", 4, (1, 4), False),
                   ("deepseek_v2_lite_16b", 3, (2, 2), False),
                   ("deepseek_v2_lite_16b", 3, (2, 2), True),
                   # and the layouts that split the caches' positions or
                   # the weights (a run's fifth and sixth entries: its
                   # flags and serve_steps, ``_serve_flags``):
                   # gemma_2b's one kv head leaves "model" to shard_v2's
                   # cache_seq (the positions over the model ranks);
                   # v2-lite's latent cache's positions over the data
                   # ranks; the dispatch einsum with its experts over
                   # "model"; FSDP in serving. 8 steps: gloo stages FSDP's
                   # gathers of every weight through host memory
                   ("gemma_2b", 6, (2, 2), False, ("shard_v2",), 8),
                   ("deepseek_v2_lite_16b", 3, (2, 2), False,
                    ("seq_sharded",), 8),
                   ("deepseek_v2_lite_16b", 3, (2, 2), False,
                    ("dispatch",), 8),
                   ("gemma_2b", 6, (2, 2), False, ("fsdp",), 8))
DIST_SERVE_BATCH, DIST_SERVE_PROMPT, DIST_SERVE_STEPS = 8, 512, 32
# seeded weights are drawn in blocks of at most this many values, each
# block from its own generator (``seeded_params``)
SEED_ELEMS = 2 ** 26


def _seed_of(*key) -> int:
    import zlib
    return zlib.crc32(repr(key).encode())


def _seeded(shape, sd: float, key, dtype):
    """N(0, sd^2) of ``shape`` on the card, drawn in blocks of rows of at
    most SEED_ELEMS values, block j from a generator seeded by ``key`` and
    j."""
    out = torch.empty(shape, dtype=dtype, device="cuda")
    rows = max(1, SEED_ELEMS // max(1, int(np.prod(shape[1:]))))
    for j, part in enumerate(out.split(rows)):
        gen = torch.Generator(device="cuda").manual_seed(_seed_of(*key, j))
        part.copy_(torch.randn(part.shape, generator=gen, device="cuda")
                   * sd)
    return out


def _nested(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


# the stacked layers whose seeded weights ``seeded_params`` draws around
# the init: their block initializers
_LAYER_INITS = {"mamba": ("mamba2", "init_mamba2"),
                "mlstm": ("xlstm", "init_mlstm"),
                "slstm": ("xlstm", "init_slstm")}


def _init_layer(cfg, group: str, seed: int, i: int):
    """Layer ``i`` of the stack ``group`` as the init draws it (on the
    card, from a generator seeded by ``seed``, the group and ``i``), by
    leaf name."""
    import importlib
    from repro_torch.models.layers import Initializer
    mod, fn = _LAYER_INITS[group]
    init = getattr(importlib.import_module(f"repro_torch.models.{mod}"), fn)
    gen = torch.Generator(device="cuda").manual_seed(
        _seed_of(seed, group, i, "init"))
    return _flat(init(Initializer(cfg, gen, "cuda"), cfg))


def seeded_params(cfg, seed: int, rules=None, mesh=None, share: float = 1.0):
    """Seeded weights on the card, leaf by leaf and layer by layer: each
    layer of each leaf N(0, (``share`` x ``_weight_std``)^2) from
    generators seeded by (``seed``, leaf path, layer) (``_seeded``); the
    Mamba2, mLSTM and sLSTM layers are the init's (``_init_layer``: its
    fan-in draws, zero projections, the gates' biases, D) plus that
    noise, as ``full_width_params`` perturbs a whole model by ``share``:
    their regime (a forget gate's bias of 3, D of 1) is the one the
    recurrent steps' checks were set at. With
    ``rules``/``mesh`` only this rank's shards are kept (the port's
    layout, ``transformer.param_specs``): each layer's whole leaf exists
    only while its shard is cut (``weights.shard_params``), so no rank
    holds the whole model, and the shards are those of the whole tree."""
    from repro_torch import weights
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import PartitionSpec
    dtype = getattr(torch, cfg.param_dtype)
    axes = tf.param_axes(cfg)
    shapes = tf.param_shapes(cfg)
    specs = None if rules is None else tf.param_specs(cfg, rules)

    def cut(part, path, stacked):
        if specs is None:
            return part
        spec = specs[path]
        return weights.shard_params(
            part, PartitionSpec(*spec[1:]) if stacked else spec, mesh)
    inited = {p.split(".")[0] for p in shapes} & set(_LAYER_INITS)
    flat = {}
    for path, shape in shapes.items():
        stacked = axes[path][:1] == ("scan",)
        if path.split(".")[0] in inited:
            continue
        sd = share * _weight_std(cfg, path, shape)
        out = None
        for i in (range(shape[0]) if stacked else (None,)):
            part = cut(_seeded(shape[1:] if stacked else shape, sd,
                               (seed, path, i), dtype), path, stacked)
            if not stacked:
                out = part
                break
            if out is None:
                out = part.new_empty((shape[0], *part.shape))
            out[i] = part
            del part
        flat[path] = out
    for group in sorted(inited):
        n = next(shape[0] for p, shape in shapes.items()
                 if p.startswith(group + "."))
        for i in range(n):
            for leaf, v in _init_layer(cfg, group, seed, i).items():
                path = f"{group}.{leaf}"
                sd = share * _weight_std(cfg, path, shapes[path])
                part = cut((v.float() + _seeded(v.shape, sd, (seed, path, i),
                                                torch.float32)).to(dtype),
                           path, True)
                if path not in flat:
                    flat[path] = part.new_empty((n, *part.shape))
                flat[path][i] = part
    return _nested(flat)


def _serve_cfg(arch, layers, absorb=False, flags=()):
    """The config of a serving run: ``flags`` may name "shard_v2" (JAX's
    v2 cache layout) and "dispatch" (the MoE dispatch einsum)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(num_layers=layers,
                                   shard_v2="shard_v2" in flags)
    if absorb:
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, absorb=True))
    if "dispatch" in flags:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  impl="dispatch_einsum"))
    return cfg


def _serve_rules(mesh, flags=()):
    """The rules of a serving run: ``flags`` may name "seq_sharded" and
    "fsdp"."""
    from repro_torch.models import sharding
    return sharding.ShardingRules(mesh, seq_sharded="seq_sharded" in flags,
                                  fsdp="fsdp" in flags)


def _serve_flags(run):
    """(arch, layers, mesh, absorbed, flags, serve_steps) of a
    DIST_SERVE_RUNS entry (flags () and DIST_SERVE_STEPS where it has no
    fifth and sixth entries)."""
    arch, layers, shape, absorb, *rest = run
    return (arch, layers, shape, absorb, tuple(rest[0]) if rest else (),
            rest[1] if len(rest) > 1 else DIST_SERVE_STEPS)


def _serve_tag(arch, absorb, flags=()) -> str:
    return " ".join((arch + (" absorbed" if absorb else ""), *flags))


class _StubMesh:
    """A mesh as ``ShardingRules`` reads it (axis names and a device
    array's shape), for the layout a report states without ranks."""

    def __init__(self, shape, names=("data", "model")):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _rows_whole(cfg, rules) -> bool:
    """Whether every rank holds every row of the batch (``seq_sharded``):
    what a rank records of them is then not gathered over the data
    ranks."""
    from repro_torch import distributed as D
    return not D.cache_groups(cfg, rules)[0]


def _serve_prompts(cfg, batch=DIST_SERVE_BATCH, n=DIST_SERVE_PROMPT):
    rng = np.random.default_rng(DIST_SEED)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, n)),
                           dtype=torch.int32, device="cuda")


def _serve_passes(cfg, params, prompts, max_len, n_steps, rules=None,
                  mesh=None, feed=None, checked=True):
    """``prefill_step`` then ``n_steps`` ``serve_step``s (under
    ``rules``/``mesh`` when given), fed their own greedy tokens or those
    of ``feed``; with ``checked`` the prefill and the first step run
    inside ``layer_checks``. Returns (each pass's logits on the host, the
    tokens fed, the caches, each pass's seconds, the held readings)."""
    from repro_torch.models import steps
    logits, fed, secs, state = [], [], [], {}

    def run(i):
        t0 = time.perf_counter()
        if i == 0:
            lg, state["caches"] = steps.prefill_step(
                params, {"tokens": prompts}, cfg, max_len, rules, mesh)
        else:
            tok = state["tok"] if feed is None else feed[i - 1]
            fed.append(tok)
            _, lg, state["caches"] = steps.serve_step(
                params, tok[:, None], state["caches"], cfg, rules, mesh)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        state["tok"] = torch.argmax(lg, -1).to(torch.int32)
        logits.append(lg.float().cpu())
    with torch.no_grad():
        with (layer_checks() if checked else contextlib.nullcontext(
                _Held())) as held:
            run(0)
            run(1)
        for i in range(2, n_steps + 1):
            run(i)
    return logits, fed, state["caches"], secs, held


def _dist_serve_rank(rank, world, out_dir, runs=DIST_SERVE_RUNS):
    """One rank of phase dist_serve (and of ``tools/dist_cards.py``): for
    each of ``runs`` at full width, its shards of the seeded weights
    (``seeded_params``, the same on every rank), ``prefill_step`` of
    DIST_SERVE_BATCH prompts of DIST_SERVE_PROMPT tokens and
    DIST_SERVE_STEPS ``serve_step``s under the mesh, the launch counters
    reset just before and read just after, the prefill's and the first
    step's flash and ``decode_attention`` calls held against their plain
    versions (``layer_checks``), each MoE layer's routing recorded; the
    caches gathered to rank 0, which then runs the same passes in one
    process from the whole weights, fed the ranks' tokens (MoE routed as
    the ranks routed), and holds each layer's cache against its own
    (``compare``). Writes ``rank{r}.json`` to ``out_dir``."""
    import gc
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch import weights
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding
    from repro_torch.models import transformer as tf
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    for run in runs:
        arch, layers, shape, absorb, flags, n_steps = _serve_flags(run)
        mesh = compat_make_mesh(shape, ("data", "model"))
        D.axis(mesh, ("pod", "data", "model"))   # every rank, in order
        rules = _serve_rules(mesh, flags)
        cfg = _serve_cfg(arch, layers, absorb, flags)
        params = seeded_params(cfg, DIST_SEED, rules, mesh)
        prompts = _serve_prompts(cfg)
        max_len = DIST_SERVE_PROMPT + n_steps
        staged = D.staged_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with _routes_recorded() as routes, _block_inputs() as xs, \
                _allreduce_timed() as ar:
            logits, fed, caches, secs, held = _serve_passes(
                cfg, params, prompts, max_len, n_steps, rules, mesh)
        counts = ops.launch_counts()
        r = {"secs": secs, "staged": D.staged_calls - staged,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": {k: counts[k] for k in ("flash_attention",
                                                 "decode_attention")},
             "held": dict(held), "allreduce_ms": _ms(ar),
             "allreduces": len(ar)}
        whole = weights.gather_params(
            caches, tf.cache_specs(cfg, rules, DIST_SERVE_BATCH, max_len),
            mesh)
        # the routes and each layer's input over the passes, the whole
        # batch (every rank holds it under seq_sharded)
        rows = None if _rows_whole(cfg, rules) else ("pod", "data")
        routes = [weights.gather_params(i, (rows, None), mesh).cpu()
                  for i in routes]
        n = sum(k for _, _, k in tf._groups(cfg))
        xs = [torch.cat([weights.gather_params(x, (rows, None, None), mesh)
                         for x in xs[j::n]], dim=1).cpu() for j in range(n)]
        whole = {g: {k: v.cpu() for k, v in c.items()}
                 for g, c in whole.items()} if rank == 0 else None
        del params, caches
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            r.update(_serve_one_process(cfg, prompts, logits, fed, whole,
                                        routes, xs, n_steps))
        del whole, logits, xs
        dist.barrier()
        out[_serve_tag(arch, absorb, flags)] = r
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@contextlib.contextmanager
def _block_inputs():
    """Each attention block's input while open, in call order (pass by
    pass, layer by layer)."""
    from repro_torch.models import transformer as tf
    saved, got = tf._block_fwd, []

    def block(p, x, *args, **kw):
        got.append(x.detach().clone())
        return saved(p, x, *args, **kw)
    tf._block_fwd = block
    try:
        yield got
    finally:
        tf._block_fwd = saved


def _layer_caches(cfg, params, xs):
    """Each layer's cache entries as this one process projects them from
    ``xs`` (each layer's inputs over the passes, (b, prompt + steps, d)):
    K/V, or MLA's latent and rope key, at positions 0 .. prompt + steps -
    1, as the prefill and the decode steps write them."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import apply_norm
    out, j = {}, 0
    for pkey, ckey, n in tf._groups(cfg):
        out[ckey] = []
        for i in range(n):
            p = tf.layer_slice(params[pkey], i)
            x = xs[j].cuda()
            pos = torch.arange(x.shape[1], dtype=torch.int32,
                               device=x.device)[None, :]
            h = apply_norm(p["ln1"], x, cfg)
            if cfg.attn_type == "mla":
                _, _, c_kv, k_rope = attn._mla_inputs(p["attn"], h, pos, cfg)
                out[ckey].append({"c_kv": c_kv, "k_rope": k_rope[:, :, 0]})
            else:
                _, k, v = attn._qkv(p["attn"], h, pos, cfg)
                out[ckey].append({"k": k, "v": v})
            j += 1
    return out


def _serve_one_process(cfg, prompts, logits, fed, caches, routes, xs,
                       n_steps=DIST_SERVE_STEPS):
    """The same passes in this one process from the whole seeded weights,
    fed the ranks' tokens, MoE routed as the ranks routed (``routes``):
    each pass's largest logit difference as a share of the largest logit,
    the first token's agreement wherever this process's top-2 margin
    exceeds twice the row's largest difference, the stream tokens that
    equal this process's argmax, and how far its caches drifted from the
    ranks'. Each layer's gathered cache is held against what this process
    projects from that layer's own inputs in the ranks' run (``xs``;
    ``compare``, the elementwise bound of the largest entry), as
    ``layer_checks`` holds a layer: rounding compounded through the
    layers does not enter."""
    import gc
    params = seeded_params(cfg, DIST_SEED)
    ctx = _routed_as(routes) if routes else contextlib.nullcontext()
    with ctx:
        one, _, one_caches, secs, _ = _serve_passes(
            cfg, params, prompts, DIST_SERVE_PROMPT + n_steps, n_steps,
            feed=fed, checked=False)
    agree = _logit_agreement(logits, one, fed)
    drift, worst = {}, {}
    with torch.no_grad():
        mine = _layer_caches(cfg, params, xs)
    for g, c in caches.items():
        if not torch.equal(c["length"], one_caches[g]["length"].cpu()):
            raise AssertionError(f"cache {g}: lengths differ")
        for k, v in c.items():
            if k == "length":
                continue
            ref = one_caches[g][k].cpu().float()
            d = v.shape[-1]
            drift[k] = max(drift.get(k, 0.0), float(
                ((v.float() - ref).reshape(-1, d).norm(dim=1)
                 / ref.reshape(-1, d).norm(dim=1).clamp(min=1e-30)).max()))
            for i in range(v.shape[0]):
                e, row = compare(f"{cfg.name} cache {g}.{k} layer {i}",
                                 v[i].cuda(), mine[g][i][k], of_max=True)
                w = worst.get(k, (0.0, 0.0))
                worst[k] = (max(w[0], e), max(w[1], row))
    del params, one_caches, mine
    gc.collect()
    torch.cuda.empty_cache()
    return {**agree, "cache_worst": worst, "cache_drift": drift,
            "one_secs": secs}


def _logit_agreement(logits, one, fed):
    """The ranks' passes (``logits``, the tokens ``fed``) against one
    process's (``one``): each pass's largest logit difference as a share
    of the largest logit, the first token's agreement wherever the one
    process's top-2 margin exceeds twice the row's largest difference,
    the stream tokens that equal the one process's argmax, finiteness."""
    share = [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(logits, one)]
    diff = (logits[0] - one[0]).abs().amax(-1)
    top2 = one[0].topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
    first_equal = logits[0].argmax(-1) == one[0].argmax(-1)
    stream = [f.cpu() for f in fed] + [logits[-1].argmax(-1)]
    equal = sum(int((s == o.argmax(-1)).sum()) for s, o in zip(stream, one))
    return {"share": share, "first_sure": int(sure.sum()),
            "first_sure_equal": int((first_equal & sure).sum()),
            "first_equal": int(first_equal.sum()),
            "stream_equal": equal, "stream_tokens": sum(
                int(s.numel()) for s in stream),
            "finite": all(bool(torch.isfinite(x).all()) for x in logits)}


def dist_serve_report(tag, card, ranks, transport, runs=DIST_SERVE_RUNS):
    """Gate and print one run of ``_dist_serve_rank`` (``ranks``: each
    rank's JSON): on every rank flash launches = attention layers (the
    prefill) and ``decode_attention`` launches = GQA layers x steps, the
    prefill's and first step's calls all held; on rank 0 (against one
    process) each pass's logits within LOGIT_TOL of the largest, finite,
    the first token equal wherever the one process's margin is sure.
    Returns the flash and decode_attention launches summed over the
    ranks."""
    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    total = {"flash_attention": 0, "decode_attention": 0}
    for run in runs:
        arch, layers, shape, absorb, flags, n_steps = _serve_flags(run)
        name = _serve_tag(arch, absorb, flags)
        mla = get_config(arch).attn_type == "mla"
        want = {"flash_attention": layers,
                "decode_attention": 0 if mla else layers * n_steps}
        held = {"flash_attention": layers}
        if not mla:
            held["decode_attention"] = layers
            # where the positions split, each merged decode too
            if D.cache_groups(_serve_cfg(arch, layers, absorb, flags),
                              _serve_rules(_StubMesh(shape), flags))[1]:
                held["seq_decode_attention"] = layers
        per = [r[name] for r in ranks]
        for i, r in enumerate(per):
            got_held = {k: n for k, (n, _, _) in r["held"].items()}
            if r["launches"] != want or got_held != held:
                raise AssertionError(
                    f"{tag} {name} rank {i}: launches {r['launches']}, held "
                    f"{got_held}; want {want}, {held}")
        for k in total:
            total[k] += sum(r["launches"][k] for r in per)
        r0 = per[0]
        if max(r0["share"]) > LOGIT_TOL or not r0["finite"] or \
                r0["first_sure_equal"] != r0["first_sure"]:
            raise AssertionError(
                f"{tag} {name}: logits off one process by {r0['share']} of "
                f"max |logit|, first tokens {r0['first_sure_equal']} of "
                f"{r0['first_sure']} sure rows equal, finite "
                f"{r0['finite']}")
        errs = {k: max(r["held"][k][1] for r in per) for k in held}
        pre = [r["secs"][0] for r in per]
        step = [float(np.mean(r["secs"][2:])) for r in per]
        log(f"[{tag}] {name} ({layers} of {get_config(arch).num_layers} "
            f"layers, full width, bf16, mesh (data, model) = {shape}, "
            f"{_layout_text(arch, layers, absorb, shape, flags)}, "
            f"{transport}): prefill {DIST_SERVE_BATCH} x "
            f"{DIST_SERVE_PROMPT} + {n_steps} serve_steps; logits "
            f"vs one process: largest share of max |logit| "
            f"{max(r0['share']):.4g} (limit {LOGIT_TOL}; prefill "
            f"{r0['share'][0]:.4g}); first tokens equal "
            f"{r0['first_equal']}/{DIST_SERVE_BATCH} "
            f"({r0['first_sure_equal']}/{r0['first_sure']} rows with a "
            f"sure margin); stream tokens equal to one process's argmax "
            f"{r0['stream_equal']}/{r0['stream_tokens']}; each layer's "
            f"cache vs one process's projection of that layer's inputs: "
            + ", ".join(f"{k} max_abs_err={e:.3g} max_row_rel_err={row:.3g}"
                        for k, (e, row) in r0["cache_worst"].items())
            + f" (atol {ATOL} of max, rtol {RTOL}, row {ROW_RTOL}); drift "
            "from one process's own caches, largest row " + ", ".join(
                f"{k} {v:.3g}" for k, v in r0["cache_drift"].items())
            + f"; launches a rank {want} (held "
            + ", ".join(f"{k} {n} calls max_abs_err={errs[k]:.3g}"
                        for k, n in held.items())
            + f"); prefill s a rank " + " ".join(f"{t:.3f}" for t in pre)
            + f" vs one process {r0['one_secs'][0]:.3f}; step s a rank "
            + " ".join(f"{t:.4f}" for t in step)
            + f" vs one process {np.mean(r0['one_secs'][2:]):.4f}; peak "
            f"GiB a rank " + " ".join(f"{r['peak_gib']:.2f}" for r in per)
            + f"; all-reduce {r0.get('allreduce_ms', 0.0):.1f} ms in "
            f"{r0.get('allreduces', 0)} calls over the passes on rank 0; "
            f"collectives staged through host memory {r0['staged']}; "
            f"{card}")
    return total


def _layout_text(arch, layers, absorb, shape, flags) -> str:
    """The rows' and the attention caches' positions' axes of a serving
    run, and its flags, for a log line."""
    from repro_torch import distributed as D
    rows, seq = D.cache_groups(_serve_cfg(arch, layers, absorb, flags),
                               _serve_rules(_StubMesh(shape), flags))
    return (f"rows over {rows or 'no axis'}, cache positions over "
            f"{seq or 'no axis'}" + (f", {'+'.join(flags)}" if flags else ""))


def phase_dist_serve(card: str):
    """Serving under a mesh on the one card: ``_dist_serve_rank`` in 4
    processes over gloo, for DIST_SERVE_RUNS: gemma_2b (MQA: its one kv
    head whole on every model rank, the tied vocabulary split),
    llama3_70b (16 of 64 query heads and 2 of 8 kv heads a rank on
    (1, 4)), deepseek_v2_lite_16b naive and absorbed (MLA on 8 of 16
    heads and the whole latent, 32 of 64 experts a rank), and the
    layouts that split the positions or the weights: gemma_2b under
    shard_v2 (the cache's positions over the model ranks, every query
    head gathered for the decode and merged by the lse), v2-lite's
    latent cache under seq_sharded (over the data
    ranks, the whole batch on each), v2-lite with the dispatch einsum
    and gemma_2b under FSDP in serving (each layer's weights gathered over
    the data ranks in every pass); first dense decode with its lse at one
    rank's slice of gemma_2b's decode_32k cell under shard_v2
    (``phase_v2_kernel``); each rank's exit code checked
    (``mesh.spawn``), then ``dist_serve_report``'s gates. Times are
    gloo's, staged through host memory. Returns (the flash and
    decode_attention launches of the ranks' passes, the shard_v2
    kernels-line entry)."""
    import gc
    import shutil
    from repro_torch.launch import mesh
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    v2_row = phase_v2_kernel()
    out_dir = ROOT / "build" / "dist_serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = 4
    mesh.spawn(_dist_serve_rank, world, (str(out_dir),))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    total = dist_serve_report(
        "dist_serve", card, ranks,
        f"{world} ranks on one card over gloo ({ranks[0]['backend']}): "
        f"times gloo-staged, not the card's collectives")
    log(f"[dist_serve] phase seconds {time.monotonic() - t0:.1f}; {card}")
    return total, v2_row


# one model rank's slice of gemma_2b's decode_32k cell (batch 128 over 2
# data ranks, 32,768 positions over 2 model ranks) under shard_v2: every
# query head over the rank's positions of its one kv head
V2_SLICE = (64, 16_384, 8, 1, 256)


def phase_v2_kernel():
    """Dense decode with its lse at one rank's slice of the decode_32k
    cell under shard_v2 (V2_SLICE, every row at the slice's length):
    against its plain version (output rows and lse), ``out`` ``torch.
    equal`` to the call without the lse, and timed with the host queue
    held beside its plain version, one scaled_dot_product_attention call
    on the same slice and the byte bound. Returns the kernels-line
    entry."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(31)
    b, S, h, kvh, d = V2_SLICE
    q, k, v, lens = _dense_case(gen, b, S, h, kvh, d, [S] * b)
    out, lse = da.decode_attention(q, k, v, lens, return_lse=True)
    want, wlse = ref.decode_attention(q, k, v, lens, return_lse=True)
    e, r = _check_rows("decode_attention shard_v2 slice", out, want, [S] * b)
    le = _check_lse("decode_attention shard_v2 slice lse", lse, wlse,
                    [S] * b)
    if not torch.equal(out, da.decode_attention(q, k, v, lens)):
        raise AssertionError("decode_attention: out with the lse differs "
                             "from out without it")
    del want, wlse
    nbytes, ops_ = _decode_work([S] * b, h, kvh, d, S)
    t = _decode_times(
        f"decode_attention with lse, shard_v2 slice ({b}, {S}, {h}/{kvh}, "
        f"{d})", lambda: da.decode_attention(q, k, v, lens, return_lse=True),
        lambda: ref.decode_attention(q, k, v, lens, return_lse=True),
        _sdpa_dense(q, k, v, lens), (nbytes + 4 * h * b, ops_))
    bound_ms, by = bound(*t.pop("bound"), PEAK_BF16_FLOPS)
    log(f"[dist_serve] decode_attention with lse at the shard_v2 slice: "
        f"max_abs_err={e:.3g} max_row_rel_err={r:.3g}, lse max |err| "
        f"{le:.3g} (limit {LSE_RTOL} of max(1, |lse|)); out torch.equal "
        f"to the call without the lse")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(shape=list(V2_SLICE), max_abs_err=e, max_row_rel_err=r,
                lse_max_abs_err=le, bound_ms=bound_ms, bound_by=by, **t)


# phase dist_recurrent: the recurrent families served under a mesh, 4
# ranks on the one card over gloo as phase dist_serve runs them: (arch,
# layers, mesh (data, model), seq_sharded, batch, prompt, cache positions,
# steps). Full width, bf16, depth the only cut: zamba2_7b at 14 of 81
# layers (one shared-block application), and again under seq_sharded with
# batch 1, a 4096-token prompt (the chunked scan takes multiples of 256)
# in an 8200-position cache, two slices of 4100, so that its 16 steps
# cross from data rank 0's slice into rank 1's; xlstm_1_3b at 8 of 48 (7
# mLSTM + 1 sLSTM) on (1, 4), one head a rank
DIST_RECURRENT_RUNS = (
    ("zamba2_7b", 14, (2, 2), False, 8, 512, 544, 32),
    ("zamba2_7b", 14, (2, 2), True, 1, 4096, 8200, 16),
    ("xlstm_1_3b", 8, (1, 4), False, 8, 512, 544, 32),
)
# the long_500k cell's decode on one data rank of (2, 2) (tools/
# dist_cards.py long): batch 1, half of zamba2_7b's 524,296-position
# cache, its 16 of 32 kv heads a model rank, d 112
LONG_SLICE = 524_296 // 2


def _recurrent_tag(arch, seq) -> str:
    return arch + (" seq_sharded" if seq else "")


def _dist_recurrent_rank(rank, world, out_dir, runs=DIST_RECURRENT_RUNS):
    """One rank of phase dist_recurrent: for each of ``runs`` at full
    width, its shards of the seeded weights (``seeded_params``, xlstm's at
    TRAIN_SHARE), ``prefill_step`` and ``serve_step``s
    under the mesh, the launch counters reset just before and read just
    after, the prefill's and first step's flash, ``decode_attention``
    (with its lse under seq_sharded), merged decode, Mamba2 and mLSTM
    decode calls held (``layer_checks``); the caches gathered to rank 0,
    which then runs the same passes in one process, fed the ranks'
    tokens. Writes ``rank{r}.json`` to ``out_dir``."""
    import gc
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch import weights
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding
    from repro_torch.models import transformer as tf
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    for arch, layers, shape, seq, batch, n, max_len, n_steps in runs:
        mesh = compat_make_mesh(shape, ("data", "model"))
        rules = sharding.ShardingRules(mesh, seq_sharded=seq)
        cfg = _serve_cfg(arch, layers)
        share = TRAIN_SHARE.get(arch, 1.0)
        params = seeded_params(cfg, DIST_SEED, rules, mesh, share)
        prompts = _serve_prompts(cfg, batch, n)
        staged = D.staged_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        logits, fed, caches, secs, held = _serve_passes(
            cfg, params, prompts, max_len, n_steps, rules, mesh)
        counts = ops.launch_counts()
        r = {"secs": secs, "staged": D.staged_calls - staged,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": {k: counts[k] for k in ("flash_attention",
                                                 "decode_attention")},
             "held": dict(held), "controls": held.controls,
             "bounds": held.bounds, "lse": held.lse}
        whole = weights.gather_params(
            caches, tf.cache_specs(cfg, rules, batch, max_len), mesh)
        whole = {g: {k: v.cpu() for k, v in c.items()}
                 for g, c in whole.items()} if rank == 0 else None
        del params, caches
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            r.update(_recurrent_one_process(cfg, share, prompts, logits, fed,
                                            whole, max_len, n_steps))
        del whole, logits
        dist.barrier()
        out[_recurrent_tag(arch, seq)] = r
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _recurrent_one_process(cfg, share, prompts, logits, fed, caches,
                           max_len, n_steps):
    """The same passes in this one process from the whole seeded weights,
    fed the ranks' tokens: ``_logit_agreement``, and each state and K/V
    leaf's drift from this process's, its largest row (last dim) error
    relative to the row (printed, not gated: it compounds through the
    layers and steps)."""
    import gc
    params = seeded_params(cfg, DIST_SEED, share=share)
    one, _, one_caches, secs, _ = _serve_passes(
        cfg, params, prompts, max_len, n_steps, feed=fed, checked=False)
    drift = {}
    for g, c in caches.items():
        for k, v in c.items():
            ref_ = one_caches[g][k].cpu()
            if k == "length":
                if not torch.equal(v, ref_):
                    raise AssertionError(f"cache {g}: lengths differ")
                continue
            d = v.shape[-1]
            ref_ = ref_.float().reshape(-1, d)
            drift[f"{g}.{k}"] = float(
                ((v.float().reshape(-1, d) - ref_).norm(dim=1)
                 / ref_.norm(dim=1).clamp(min=1e-30)).max())
    del params, one_caches
    gc.collect()
    torch.cuda.empty_cache()
    return {**_logit_agreement(logits, one, fed), "cache_drift": drift,
            "one_secs": secs}


def dist_recurrent_report(tag, card, ranks, transport,
                          runs=DIST_RECURRENT_RUNS):
    """Gate and print one run of ``_dist_recurrent_rank``: on every rank
    flash launches = shared-block applications (the prefill) and
    ``decode_attention`` launches = applications x steps (none for the
    ssm family), the prefill's and first step's calls all held (flash,
    dense decode and its lse, under seq_sharded each merged decode, every
    Mamba2 / mLSTM decode step); on rank 0 each pass's logits within
    LOGIT_TOL of one process's, finite, the first token equal wherever
    the one process's margin is sure. Returns the flash and
    decode_attention launches summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    total = {"flash_attention": 0, "decode_attention": 0}
    for arch, layers, shape, seq, batch, n, max_len, n_steps in runs:
        name = _recurrent_tag(arch, seq)
        cfg = _serve_cfg(arch, layers)
        apps = tf._n_apps(cfg)
        want = {"flash_attention": apps,
                "decode_attention": apps * n_steps}
        if cfg.family == "hybrid":
            held = {"flash_attention": apps, "decode_attention": apps,
                    "mamba2_decode": layers}
            if seq:
                held["seq_decode_attention"] = apps
        else:
            n_groups, n_m, _ = tf._ssm_layout(cfg)
            held = {"mlstm_decode": n_groups * n_m}
        per = [r[name] for r in ranks]
        for i, r in enumerate(per):
            got_held = {k: c for k, (c, _, _) in r["held"].items()}
            if r["launches"] != want or got_held != held:
                raise AssertionError(
                    f"{tag} {name} rank {i}: launches {r['launches']}, held "
                    f"{got_held}; want {want}, {held}")
        for k in total:
            total[k] += sum(r["launches"][k] for r in per)
        r0 = per[0]
        if max(r0["share"]) > LOGIT_TOL or not r0["finite"] or \
                r0["first_sure_equal"] != r0["first_sure"]:
            raise AssertionError(
                f"{tag} {name}: logits off one process by {r0['share']} of "
                f"max |logit|, first tokens {r0['first_sure_equal']} of "
                f"{r0['first_sure']} sure rows equal, finite "
                f"{r0['finite']}")
        errs = {k: max(r["held"][k][1] for r in per) for k in held}
        rows = {k: max(r["held"][k][2] for r in per) for k in held}
        steps_txt = "".join(
            f"; {k}: elementwise <= {max(r['bounds'][k] for r in per):.3g} "
            f"of its bound, row error <= {rows[k]:.4g} (limit "
            f"{STEP_ROW_RTOL[k]}), control's >= "
            f"{min(r['controls'][k] for r in per):.4g}"
            for k in held if k in STEP_ROW_RTOL)
        pre = [r["secs"][0] for r in per]
        step = [float(np.mean(r["secs"][2:])) for r in per]
        log(f"[{tag}] {name} ({layers} of {get_config(arch).num_layers} "
            f"layers, full width, bf16, mesh (data, model) = {shape}"
            f"{', seq_sharded' if seq else ''}, {transport}): prefill "
            f"{batch} x {n} in a {max_len}-position cache + {n_steps} "
            f"serve_steps; logits vs one process: largest share of max "
            f"|logit| {max(r0['share']):.4g} (limit {LOGIT_TOL}; prefill "
            f"{r0['share'][0]:.4g}); first tokens equal "
            f"{r0['first_equal']}/{batch} ({r0['first_sure_equal']}/"
            f"{r0['first_sure']} rows with a sure margin); stream tokens "
            f"equal to one process's argmax {r0['stream_equal']}/"
            f"{r0['stream_tokens']}; drift of the gathered states and K/V "
            "from one process's, largest row " + ", ".join(
                f"{k} {v:.3g}" for k, v in r0["cache_drift"].items())
            + f"; launches a rank {want}; held: " + ", ".join(
                f"{k} {c} calls max_abs_err={errs[k]:.3g} "
                f"max_row_rel_err={rows[k]:.3g}" for k, c in held.items())
            + (f", dense decode lse max |err| "
               f"{max(r['lse'] for r in per):.3g} (limit {LSE_RTOL} of "
               f"max(1, |lse|))" if seq else "")
            + f" (atol {ATOL}, rtol {RTOL}, row {ROW_RTOL}){steps_txt}; "
            f"prefill s a rank " + " ".join(f"{t:.3f}" for t in pre)
            + f" vs one process {r0['one_secs'][0]:.3f}; step s a rank "
            + " ".join(f"{t:.4f}" for t in step)
            + f" vs one process {np.mean(r0['one_secs'][2:]):.4f}; peak "
            f"GiB a rank " + " ".join(f"{r['peak_gib']:.2f}" for r in per)
            + f"; all-reduce {r0.get('allreduce_ms', 0.0):.1f} ms in "
            f"{r0.get('allreduces', 0)} calls over the passes on rank 0; "
            f"collectives staged through host memory {r0['staged']}; "
            f"{card}")
    return total


def _layout_text(arch, layers, absorb, shape, flags) -> str:
    """The rows' and the attention caches' positions' axes of a serving
    run, and its flags, for a log line."""
    from repro_torch import distributed as D
    rows, seq = D.cache_groups(_serve_cfg(arch, layers, absorb, flags),
                               _serve_rules(_StubMesh(shape), flags))
    return (f"rows over {rows or 'no axis'}, cache positions over "
            f"{seq or 'no axis'}" + (f", {'+'.join(flags)}" if flags else ""))


def phase_long_kernel():
    """Dense decode with its lse at the long_500k cell's shape on one data
    rank (batch 1, LONG_SLICE positions, 16/16 heads, d 112): against its
    plain version (output rows and lse), ``out`` ``torch.equal`` to the
    call without the lse, and timed with the host queue held beside its
    plain version, one scaled_dot_product_attention call on the same
    slice and the byte bound. Returns the kernels-line entry."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(29)
    S, h, d = LONG_SLICE, ZAMBA_HEADS // 2, ZAMBA_D
    q, k, v, lens = _dense_case(gen, 1, S, h, h, d, [S])
    out, lse = da.decode_attention(q, k, v, lens, return_lse=True)
    want, wlse = ref.decode_attention(q, k, v, lens, return_lse=True)
    e, r = _check_rows("decode_attention long_500k slice", out, want, [S])
    le = _check_lse("decode_attention long_500k slice lse", lse, wlse, [S])
    if not torch.equal(out, da.decode_attention(q, k, v, lens)):
        raise AssertionError("decode_attention: out with the lse differs "
                             "from out without it")
    del want, wlse
    nbytes, ops_ = _decode_work([S], h, h, d, S)
    t = _decode_times(
        f"decode_attention with lse, long_500k slice (1, {S}, {h}/{h}, {d})",
        lambda: da.decode_attention(q, k, v, lens, return_lse=True),
        lambda: ref.decode_attention(q, k, v, lens, return_lse=True),
        _sdpa_dense(q, k, v, lens), (nbytes + 4 * h, ops_))
    bound_ms, by = bound(*t.pop("bound"), PEAK_BF16_FLOPS)
    log(f"[dist_recurrent] decode_attention with lse at the long_500k "
        f"slice: max_abs_err={e:.3g} max_row_rel_err={r:.3g}, lse max |err| "
        f"{le:.3g} (limit {LSE_RTOL} of max(1, |lse|)); out torch.equal "
        f"to the call without the lse")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(shape=[1, S, h, h, d], max_abs_err=e, max_row_rel_err=r,
                lse_max_abs_err=le, bound_ms=bound_ms, bound_by=by, **t)


def phase_dist_recurrent(card: str):
    """The recurrent families served under a mesh on the one card: dense
    decode with its lse at the long_500k slice (``phase_long_kernel``),
    then ``_dist_recurrent_rank`` in 4 processes over gloo for
    DIST_RECURRENT_RUNS (zamba2_7b on (2, 2): 16 of 32 heads and 56 of
    112 Mamba2 heads a rank, the rows over the data ranks, then under
    seq_sharded with the cache's positions over them; xlstm_1_3b on (1,
    4): one mLSTM and sLSTM head a rank); each rank's exit code checked
    (``mesh.spawn``), then ``dist_recurrent_report``'s gates. Times are
    gloo's, staged through host memory. Returns (the ranks' flash and
    decode_attention launches, the long_500k kernels-line entry)."""
    import gc
    import shutil
    from repro_torch.launch import mesh
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    long_row = phase_long_kernel()
    out_dir = ROOT / "build" / "dist_recurrent"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = 4
    mesh.spawn(_dist_recurrent_rank, world, (str(out_dir),))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    total = dist_recurrent_report(
        "dist_recurrent", card, ranks,
        f"{world} ranks on one card over gloo ({ranks[0]['backend']}): "
        f"times gloo-staged, not the card's collectives")
    log(f"[dist_recurrent] phase seconds {time.monotonic() - t0:.1f}; "
        f"{card}")
    return total, long_row


# phase dist_train_all: training the recurrent families and under FSDP,
# the 4 gloo ranks of phase dist; (arch, layers, mesh (data, model), fsdp,
# batch, tokens a row). Full width, bf16, depth the only cut (the ranks
# and the one-process reference share the card's 80 GB), the configs'
# remat "full"
DIST_TRAIN_RUNS = (
    ("zamba2_7b", 14, (2, 2), False, 4, 1024),
    ("xlstm_1_3b", 8, (1, 4), False, 4, 512),
    ("gemma_2b", 6, (2, 2), True, 4, 1024),
    ("zamba2_7b", 14, (2, 2), True, 4, 1024),
)
# launch.train's optimizer at 6 steps: at OptConfig's default lr (3e-4,
# 100 warm-up steps) a first step moves no bf16 weight of O(0.02)
DIST_TRAIN_OPT = dict(lr=3e-3, warmup_steps=2, total_steps=6)
# zamba2's bf16 gradient is ill-conditioned at these weights: the one
# process's own is 0.968-0.999 in cosine to the fp32 gradient at the same
# weights (Mamba2's D least), so two bf16 gradients that sum in other
# orders part by more than DIST_COS (0.998 read). For the hybrid family
# the ranks' gradient is held instead to the fp32 gradient, as a whole
# ("*") and in all its Mamba2 B and C pieces ("*:BC", what the sum over
# "model" of ``Plan.reduce_grad`` makes): 1 - cosine within
# DIST_COND_FACTOR x that of the one process's bf16 gradient summed from
# its data shards' as the ranks sum theirs (floored at 1e-6); the control,
# the B and C pieces as a rank holds them before that sum, must fail it.
# Read over seeds 0-6 by tools/recurrent_step_tol.py --train on an H100
# 80GB HBM3 at 700 W: "*" 0.99-7.71, "*:BC" <= 5.71, the control
# 21.3-66.4; a fault planted outside B and C (the gated norms' model sum
# with the identity backward) reads 13.8 in "*" at seed 0. Single leaves
# are printed, not gated: at seeds 1 and 6 Mamba2's D reads 35-36 and
# conv_b up to 16, past the least single-leaf control (11.9). That
# excess comes with the model split in bf16 (data ranks alone read 1.00;
# the ranks in fp32 are within 1.3e-8 of the one process), its cause not
# found (PERF.md section 6)
DIST_COND_FACTOR = 10.0
COND_GATED = ("*", "*:BC")


@contextlib.contextmanager
def _allreduce_timed():
    """CUDA event pairs around each outermost ``distributed.all_reduce``
    while open (a bf16 sum over more than two ranks calls it again in
    fp32: counted once)."""
    from repro_torch import distributed as D
    saved, pairs, depth = D.all_reduce, [], [0]

    def timed(t, ax, op="sum"):
        if ax.size == 1 or depth[0]:
            return saved(t, ax, op)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        depth[0] += 1
        a.record()
        try:
            return saved(t, ax, op)
        finally:
            b.record()
            depth[0] -= 1
            pairs.append((a, b))
    D.all_reduce = timed
    try:
        yield pairs
    finally:
        D.all_reduce = saved


def _ms(pairs) -> float:
    torch.cuda.synchronize()
    return float(sum(a.elapsed_time(b) for a, b in pairs))


@contextlib.contextmanager
def _adamw_timed():
    """CUDA event pairs around each AdamW update of ``steps.train_step``
    while open (after the gradient's global norm, which the sharded step
    all-reduces before it)."""
    from repro_torch.models import steps
    saved, pairs = steps.adamw_update, []

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            return saved(*args, **kw)
        finally:
            b.record()
            pairs.append((a, b))
    steps.adamw_update = timed
    try:
        yield pairs
    finally:
        steps.adamw_update = saved


def _train_gate_layers(cfg):
    """(layer index in forward order, its stack, its index there) of the
    layers a whole run holds against the unsharded layer: 1, 40 and the
    last of the one stack (the Mamba2 layers for the hybrid); for the moe
    family its first dense layer and its first and last MoE layers."""
    if cfg.family == "moe":
        kd, n = cfg.moe.first_k_dense, cfg.num_layers
        return ((0, "dense_layers", 0), (kd, "layers", 0),
                (n - 1, "layers", n - 1 - kd))
    group = "mamba" if cfg.family == "hybrid" else "layers"
    return tuple((i, group, i) for i in (0, 39, cfg.num_layers - 1))


def _strided(path, v):
    """Up to SNAP_ELEMS values of each layer of a stacked leaf (of the leaf
    elsewhere), one row a layer, strided over the whole layer (an
    embedding's sampled rows spread over its vocabulary)."""
    n = v.shape[0] if path.split(".")[0] in STACKED else 1
    flat = v.reshape(n, -1)
    return flat[:, ::max(1, flat.shape[1] // SNAP_ELEMS)][
        :, :SNAP_ELEMS].clone()


def _gate_layer_specs(cfg, rules, group):
    """One layer of the stack ``group``: its leaves' specs, the "scan"
    entry dropped."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import PartitionSpec
    return _nested({p[len(group) + 1:]: PartitionSpec(*spec[1:])
                    for p, spec in tf.param_specs(cfg, rules).items()
                    if p.startswith(group + ".")})


@contextlib.contextmanager
def _bodies_captured(cfg, which):
    """(input, output) of the layer bodies of mode "train" (the Mamba2
    body for the hybrid, the attention block otherwise) whose layer index
    is in ``which``, at their first call (the forward, not remat's
    recompute), while open."""
    from repro_torch.models import transformer as tf
    name = "_train_mamba" if cfg.family == "hybrid" else "_train_block"
    saved, got, calls = getattr(tf, name), {}, [0]

    def body(p, x, *args, **kw):
        out = saved(p, x, *args, **kw)
        i = calls[0]
        if i in which and i not in got:
            y = out[0] if isinstance(out, tuple) else out
            got[i] = (x.detach().clone(), y.detach().clone())
        calls[0] = (i + 1) % cfg.num_layers
        return out
    setattr(tf, name, body)
    try:
        yield got
    finally:
        setattr(tf, name, saved)


@contextlib.contextmanager
def _grads_captured():
    """The gradients ``steps.value_and_grad`` returns while open (a train
    step's, before AdamW consumes them), in call order."""
    from repro_torch.models import steps
    saved, got = steps.value_and_grad, []

    def vg(*args, **kw):
        out = saved(*args, **kw)
        got.append(out[1])
        return out
    steps.value_and_grad = vg
    try:
        yield got
    finally:
        steps.value_and_grad = saved


def _bc_pieces(spec, g, size: int):
    """The B and C pieces of a Mamba2 leaf's gradient ``g`` laid out by
    ``spec`` over a model axis of ``size`` (1: the whole leaf), those
    every model rank holds whole (``distributed.read_parts``); none for
    another leaf."""
    from repro_torch import distributed as D
    return [p for p, whole in D.read_parts(spec, g, size) if whole]


def _cos_terms(pairs):
    """(sum a.b, sum a.a, sum b.b) in float64 over (a, b) pairs, a slice
    of each at a time (``optim.slices``)."""
    from repro_torch.models.optim import slices
    acc = torch.zeros(3, dtype=torch.float64,
                      device=pairs[0][0].device if pairs else "cpu")
    for a, b in pairs:
        for x, y in zip(slices(a), slices(b)):
            x, y = x.double(), y.double()
            acc += torch.stack([(x * y).sum(), (x * x).sum(), (y * y).sum()])
    return acc


def _leaf_cosines(grads, want, specs):
    """Each leaf's cosine of the whole gradient ``grads`` (flat by path)
    to ``want``, of a Mamba2 leaf's B and C pieces (``path:BC``), and
    ``_cosines``' aggregates."""
    keys, sums = [], []
    for k, v in grads.items():
        keys.append(k)
        sums.append(_cos_terms([(v, want[k])]))
        spec = specs[k.replace("/", ".")]
        bc = list(zip(_bc_pieces(spec, v, 1), _bc_pieces(spec, want[k], 1)))
        if bc:
            keys.append(f"{k}:BC")
            sums.append(_cos_terms(bc))
    return _cosines(keys, torch.stack(sums).tolist())


def _cos_of(dot, na, nb) -> float:
    den = (na * nb) ** 0.5
    return dot / den if den else float(na == nb)


def _cosines(keys, sums):
    """Each key's cosine from its (dot, |a|^2, |b|^2) sums, and the
    whole gradient's ("*": every leaf), its B and C pieces' ("*:BC") and
    their control's ("*:BC control"), each from its keys' summed sums."""
    out, agg = {}, {}
    for k, v in zip(keys, sums):
        out[k] = _cos_of(*v)
        tail = k.split(":", 1)[1] if ":" in k else ""
        a = agg.setdefault("*" + (":" + tail if tail else ""), [0.0] * 3)
        for i in range(3):
            a[i] += v[i]
    out.update({k: _cos_of(*v) for k, v in agg.items()})
    return out


def _train_reference(cfg, opt, share, batches, out_dir, fp32, specs, seed,
                     data, routes=None, whole_g=None):
    """Rank 0: the same seeded weights, batches and steps in this one
    process, no mesh. Writes step 1's gradient to ``ref_grad.pt`` (host
    memory, flat by path) and, with ``fp32``, the gradient of the same
    batch at the same weights in fp32 (plain attention: the kernels take
    bf16) to ``ref_grad32.pt``, with each leaf's cosine to it (and of a
    Mamba2 leaf's B and C pieces, ``path:BC``; ``specs``: the leaves'
    specs, ``_leaf_cosines``) of the bf16 gradient and of the bf16
    gradient summed from ``data`` shards of the batch's rows as the ranks'
    data-axes all-reduce sums theirs (each shard's gradient over the
    batch's token count, summed in fp32 and rounded once). With
    ``routes`` (a MoE model, after the ranks' run with their state freed:
    step i's expert choices over the data ranks, in call order, remat's
    recompute too) every router call of step i takes the experts the
    ranks chose in that call (``_routed_as``), and step 1's gradient is
    held here against the ranks' (``whole_g``, flat on the host) instead
    of written: each leaf's cosine routed (``cos``) and routed freely
    (``cos_free``, with the forward's tokens whose free choice differs
    from the ranks', ``flipped`` of ``routed_rows``). Returns the losses,
    step seconds, peak memory and those cosines."""
    import gc
    from repro_torch import tree
    from repro_torch.models import steps
    from repro_torch.models.optim import init_opt_state

    def cosines(grads):
        return {path: _cos_of(*_cos_terms([(g, whole_g[path].to(g.device))
                                           ]).tolist())
                for path, g in tree.flatten(grads).items()}
    params = seeded_params(cfg, seed, share=share)
    out = {}
    g32 = None
    if routes:
        n_moe = cfg.num_layers - cfg.moe.first_k_dense
        with _routes_recorded() as free:
            _, g = steps.value_and_grad(params, batches[0], cfg)
        out.update(cos_free=cosines(g),
                   flipped=_flipped(free[:n_moe], routes[0]),
                   routed_rows=sum(int(a.shape[0]) for a in free[:n_moe]))
        del g, free
    if fp32:
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        p32 = tree.map_tree(lambda t: t.float(), params)
        with plain_attention():
            _, g = steps.value_and_grad(p32, batches[0], cfg32)
        del p32
        g32 = tree.flatten(g)
        del g
        torch.save({k: v.cpu() for k, v in g32.items()},
                   os.path.join(out_dir, "ref_grad32.pt"))
        split, n = {}, len(batches[0]["labels"]) // data
        for d in range(data):
            part = {k: v[d * n:(d + 1) * n] for k, v in batches[0].items()}
            _, g = steps.value_and_grad(params, part, cfg)
            for k, v in tree.flatten(g).items():
                if d:
                    split[k][0].add_(v.float() / data)
                else:
                    split[k] = (v.float() / data, v.dtype)
            del g
        split = {k: v.to(dt) for k, (v, dt) in split.items()}
        out["split_cos32"] = _leaf_cosines(split, g32, specs)
        del split
    gc.collect()
    torch.cuda.empty_cache()
    state = {"params": params, "opt": init_opt_state(params)}
    torch.cuda.reset_peak_memory_stats()
    mets, secs = [], []
    for i, batch in enumerate(batches):
        with (_routed_as(routes[i]) if routes
              else contextlib.nullcontext()), _grads_captured() as got:
            t0 = time.perf_counter()
            state, met = steps.train_step(state, batch, cfg, opt)
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})
        if i == 0 and routes:
            out["cos"] = cosines(got[0])
        elif i == 0:
            g = tree.flatten(got[0])
            torch.save({k: v.cpu() for k, v in g.items()},
                       os.path.join(out_dir, "ref_grad.pt"))
            if g32 is not None:
                out["one_cos32"] = _leaf_cosines(g, g32, specs)
            del g
        del got
    out.update(one_mets=mets, one_secs=secs,
               one_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del state, params, g32
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _partials_captured(plan):
    """While open, copies of the B and C pieces of each Mamba2 leaf's
    gradient as this rank holds them when ``Plan.reduce_grad`` is called,
    summed over the data axes (as the rest) once it closes: the gradient a
    schedule that forgot their sum over "model" would keep, the control
    of the hybrid family's gradient gate."""
    from repro_torch import distributed as D
    saved, got = plan.reduce_grad, {}

    def reduce(path, g):
        if plan.model.size > 1:
            pieces = [p.clone(memory_format=torch.contiguous_format) for p
                      in _bc_pieces(plan.specs[path], g, plan.model.size)]
            if pieces:
                got[path] = pieces
        return saved(path, g)
    plan.reduce_grad = reduce
    try:
        yield got
    finally:
        plan.reduce_grad = saved
    for path, pieces in got.items():
        for p in pieces:
            D.all_reduce(p, plan.rest[path])


def _sharded_cosines(grads, plan, specs, mesh, path_file, partials=None):
    """Each leaf's cosine of the sharded gradient (``grads``: this rank's
    shards, ``reduce_grad``'s) to a whole gradient saved in
    ``path_file``, without gathering: every rank cuts its shards of the
    whole (``weights.shard_params``) and sums its products and squares
    over what it alone holds (a piece model ranks hold alike on model
    rank 0 only, a leaf the data ranks hold alike on data rank 0 only),
    then the sums are all-reduced over the ranks. A Mamba2 leaf's B and
    C pieces also on their own (``path:BC``), and with ``partials``
    (``_partials_captured``) those of the control (``path:BC control``)."""
    import torch.distributed as dist
    from repro_torch import tree, weights
    ref_ = torch.load(path_file, mmap=True)
    flat_specs = tree.flatten(specs)
    keys, sums = [], []
    for path, g in tree.flatten(grads).items():
        dotted = path.replace("/", ".")
        want = weights.shard_params(ref_[path], flat_specs[path], mesh,
                                    device=g.device)
        own_data = dotted in plan.fsdp or plan.data.index == 0
        own = [(a, b) for (a, whole), (b, _) in zip(plan.parts(dotted, g),
                                                   plan.parts(dotted, want))
               if own_data and (not whole or plan.model.index == 0)]
        keys.append(path)
        sums.append(_cos_terms(own).to(g.device))
        spec = plan.specs[dotted]
        mine = own_data and plan.model.index == 0
        bc_want = _bc_pieces(spec, want, plan.model.size)
        if bc_want:
            keys.append(f"{path}:BC")
            sums.append(_cos_terms(list(zip(
                _bc_pieces(spec, g, plan.model.size), bc_want))
                if mine else []).to(g.device))
            if partials is not None and dotted in partials:
                keys.append(f"{path}:BC control")
                sums.append(_cos_terms(list(zip(partials[dotted], bc_want))
                                       if mine else []).to(g.device))
        del want
    total = torch.stack(sums)
    dist.all_reduce(total)
    return _cosines(keys, total.tolist())


def _dist_train_rank(rank, world, out_dir, runs=DIST_TRAIN_RUNS,
                     n_steps=DIST_STEPS, gates=False, seed=DIST_SEED):
    """One rank of phase dist_train_all (and of ``tools/dist_cards.py
    train_whole``): for each of ``runs`` at full width, its shards of the
    seeded weights (``seeded_params``, xlstm's at TRAIN_SHARE) under
    ``ShardingRules(mesh, fsdp=)``, fresh AdamW moments (each of its
    shard's shape), then ``n_steps`` sharded train steps with the launch
    counters reset just before and read just after, every flash forward
    and backward call of step 1 held against its plain version
    (``layer_checks``, ``backward_checks``), each step's wall time and
    all-reduce time, and which (leaf, layer) rows of its shards the steps
    left unmoved. Without ``gates``, rank 0 first runs the same steps in
    one process (``_train_reference``, once for runs of the same model,
    depth and batch; for the hybrid family also the fp32 gradient of step
    1; for the moe family after the ranks, routed as they routed, with
    step 1's gradient gathered to rank 0's host), and each leaf's cosine of step 1's sharded gradient to the
    one process's (and to the fp32 one, with the control's:
    ``_partials_captured``) is summed over the ranks' shards
    (``_sharded_cosines``). ``seed`` seeds the weights. With ``gates`` (whole models: no
    one-process reference fits) the layer bodies of layers 1, 40 and the
    last are captured in step 1's forward and rank 0 runs each unsharded
    from its gathered weights (gathered before the steps) on rank 0's
    input (``compare``). Writes ``train_rank{r}.json``."""
    import gc
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch import tree, weights
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import sharding, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.optim import OptConfig, init_opt_state
    opt = OptConfig(**DIST_TRAIN_OPT)
    out = {"backend": dist.get_backend(), "device": torch.cuda.current_device()}
    refs, ref_key = {}, None
    for arch, layers, shape, fsdp, batch, seq in runs:
        mesh = compat_make_mesh(shape, ("data", "model"))
        rules = sharding.ShardingRules(mesh, fsdp=fsdp)
        cfg = get_config(arch).replace(num_layers=layers)
        share = TRAIN_SHARE.get(arch, 1.0)
        batches = _dist_batches(cfg, n_steps, batch, seq)
        fp32 = cfg.family == "hybrid"
        # MoE: the one process runs after the ranks, routed as they routed
        moe = cfg.family == "moe"
        routed = moe and not gates
        pspecs = tf.param_specs(cfg, rules)
        r = {}
        t_run = time.perf_counter()
        if rank == 0 and not gates and not moe:
            key = (arch, layers, batch, seq, shape[0])
            if key != ref_key:
                refs = _train_reference(cfg, opt, share, batches, out_dir,
                                        fp32, pspecs, seed, shape[0])
                ref_key = key
            r.update(refs)
        dist.barrier()
        r["ref_s"] = time.perf_counter() - t_run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = seeded_params(cfg, seed, rules, mesh, share)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        plan = D.plan(cfg, rules, mesh)
        specs = _nested(pspecs)
        gate_at = _train_gate_layers(cfg) if gates else ()
        gate_w = {}
        for i, group, j in gate_at:
            whole = weights.gather_params(
                tf.layer_slice(params[group], j),
                _gate_layer_specs(cfg, rules, group), mesh)
            if rank == 0:
                gate_w[i] = tree.map_tree(lambda t: t.cpu(), whole)
            del whole
        state = {"params": params, "opt": init_opt_state(params)}
        shapes = tf.param_shapes(cfg)
        moments_shaped = all(
            tuple(t.shape) == D.local_shape(shapes[p], pspecs[p], mesh)
            for mv in ("m", "v") for p, t in _flat(state["opt"][mv]).items())
        local = sum(t.numel() for t in _leaves(params))
        state_bytes = sum(t.numel() * t.element_size()
                          for part in (params, state["opt"]["m"],
                                       state["opt"]["v"])
                          for t in _leaves(part))
        snap = {k: _strided(k, v) for k, v in _flat(params).items()}
        staged = D.staged_calls
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        mets, secs, ar_ms, ar_calls, opt_ms = [], [], [], [], []
        grads1, partials, routes = [], {}, []

        def step(b, capture):
            # step 1's gradient and the control's pieces when compared
            # with the one process; their copies and all-reduces fall
            # outside the timed step. MoE: each step's expert choices
            nonlocal state
            with (_partials_captured(plan) if capture
                  else contextlib.nullcontext({})) as bc, \
                    (_grads_captured() if capture
                     else contextlib.nullcontext([])) as vg, \
                    (_routes_recorded() if moe
                     else contextlib.nullcontext([])) as rt:
                with _allreduce_timed() as pairs, _adamw_timed() as adamw:
                    t0 = time.perf_counter()
                    state, met = steps.train_step(state, b, cfg, opt,
                                                  rules=rules, mesh=mesh)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            grads1.extend(vg)
            partials.update(bc)
            routes.append(rt)
            ar_ms.append(_ms(pairs))
            ar_calls.append(len(pairs))
            opt_ms.append(_ms(adamw))
            mets.append({k: float(v) for k, v in met.items()})
        with layer_checks() as held, backward_checks() as (_, worst), \
                _bodies_captured(cfg, {i for i, _, _ in gate_at}) as got:
            step(batches[0], not gates)
        for b in batches[1:]:
            step(b, False)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        unmoved = [
            (k, i) for k, v in _flat(state["params"]).items()
            for i, same in enumerate(
                (_strided(k, v) == snap[k]).all(dim=1).tolist()) if same]
        m = torch.tensor([[x[k] for k in ("loss", "aux_loss", "grad_norm")]
                          for x in mets], device="cuda")
        hi, lo = m.clone(), -m
        dist.all_reduce(hi, dist.ReduceOp.MAX)
        dist.all_reduce(lo, dist.ReduceOp.MAX)
        r.update({
            "mets": mets, "secs": secs, "allreduce_ms": ar_ms,
            "allreduces": ar_calls, "adamw_ms": opt_ms, "peak_gib": peak,
            "build_s": build_s,
            "fwd": counts["flash_attention"],
            "bwd": counts["flash_attention_bwd"],
            "fwd_held": held.get("flash_attention", (0, 0.0, 0.0)),
            "bwd_held": list(worst),
            "spread": float(((hi + lo) / hi.abs().clamp(min=1e-30)).max()),
            "staged": D.staged_calls - staged, "unmoved": unmoved,
            "moments_shaped": moments_shaped, "local_params": local,
            "state_bytes": state_bytes})
        del state, params, snap
        gc.collect()
        torch.cuda.empty_cache()
        t_cos = time.perf_counter()
        if routed:
            # step 1's gradient and every step's routing on rank 0's host
            # (the routes over the data ranks, in call order), then the
            # one process on rank 0's card with the ranks' state freed
            flat_specs = tree.flatten(specs)
            whole_g = {}
            for path, g in tree.flatten(grads1.pop()).items():
                whole = weights.gather_params(g, flat_specs[path], mesh)
                if rank == 0:
                    whole_g[path] = whole.cpu()
                del whole
            routes = [[weights.gather_params(i, (("pod", "data"), None),
                                             mesh).cpu() for i in rt]
                      for rt in routes]
            gc.collect()
            torch.cuda.empty_cache()
            if rank == 0:
                r.update(_train_reference(cfg, opt, share, batches, out_dir,
                                          fp32, pspecs, seed, shape[0],
                                          routes, whole_g))
            del whole_g
            dist.barrier()
        elif grads1:
            r["cos"] = _sharded_cosines(grads1[0], plan, specs, mesh,
                                        os.path.join(out_dir, "ref_grad.pt"))
            if fp32:
                r["cos32"] = _sharded_cosines(
                    grads1[0], plan, specs, mesh,
                    os.path.join(out_dir, "ref_grad32.pt"), partials)
        del grads1, partials
        r["cos_s"] = time.perf_counter() - t_cos
        if rank == 0 and gates:
            # a MoE layer unsharded routes as rank 0 routed its rows in
            # step 1's forward (the forward's calls come first)
            pos = torch.arange(seq, dtype=torch.int32, device="cuda")[None]
            gates_out = {}
            for i, group, j in gate_at:
                x, y = got[i]
                w = tree.map_tree(lambda t: t.cuda(), gate_w.pop(i))
                ctx = (_routed_as([routes[0][j]])
                       if moe and group == "layers"
                       else contextlib.nullcontext())
                with torch.no_grad(), ctx:
                    want = (tf._train_mamba(w, x, cfg) if group == "mamba"
                            else tf._train_block(w, x, pos, cfg)[0])
                gates_out[i + 1] = compare(f"{arch} layer {i + 1}", y, want,
                                           of_max=True)
                del w, want
            r["gates"] = gates_out
        del batches, got, routes
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        r["run_s"] = time.perf_counter() - t_run
        out[_train_tag(arch, layers, shape, fsdp)] = r
    with open(os.path.join(out_dir, f"train_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def cond_ratios(r):
    """A hybrid run's readings (rank 0's JSON of ``_dist_train_rank``):
    per leaf, B/C piece and aggregate, (1 - the ranks' cosine to the fp32
    gradient) / max(1e-6, 1 - that of the one process's gradient summed
    from its data shards'); and the same of the controls' B/C pieces."""
    own = r["split_cos32"]
    ratio, ctrl = {}, {}
    for k, v in r["cos32"].items():
        base = k.split(" ")[0]
        (ctrl if k.endswith(" control") else ratio)[k] = (
            (1 - v) / max(1e-6, 1 - own[base]))
    return ratio, ctrl


def cond_gate(r):
    """(the gated ratios' largest (key, ratio), the control's) of a hybrid
    run (``cond_ratios``; COND_GATED): the ratios must stay within
    DIST_COND_FACTOR, the control must exceed it."""
    ratio, ctrl = cond_ratios(r)
    worst = max(((k, ratio[k]) for k in COND_GATED), key=lambda kv: kv[1])
    return worst, (("*:BC control", ctrl["*:BC control"])
                   if "*:BC control" in ctrl else ("none", 0.0))


def _capacity_text(cfg, shape, tokens) -> str:
    """The MoE layers' capacities (``moe._capacity``) against the rows
    routed to them, on a rank (its data shard's rows, its model rank's
    experts) and in one process: the rows either drops."""
    from repro_torch.models import moe
    m = cfg.moe
    rank_t, local = tokens // shape[0], m.num_experts // shape[1]
    cap = moe._capacity(rank_t, m.top_k, m.num_experts, local,
                        m.capacity_slack)
    one = moe._capacity(tokens, m.top_k, m.num_experts, m.num_experts,
                        m.capacity_slack)
    return (f"capacity slack {m.capacity_slack}: a rank takes {cap} of its "
            f"{rank_t * m.top_k} routed rows at most (any rows routed to "
            f"its {local} experts), one process {one} of "
            f"{tokens * m.top_k}: rows dropped "
            f"{max(0, rank_t * m.top_k - cap)} and "
            f"{max(0, tokens * m.top_k - one)} at most")


def _train_tag(arch, layers, shape, fsdp) -> str:
    return f"{arch} {layers} {shape}" + (" fsdp" if fsdp else "")


def _attn_launches(cfg):
    """(flash forward, backward) launches of one train step: an attention
    call's forward runs again in remat's recompute, but for the hybrid's
    shared block, which no remat wraps."""
    n = _attn_layers(cfg)
    again = cfg.remat != "none" and cfg.family != "hybrid"
    return n * (2 if again else 1), n


def dist_train_report(tag, card, ranks, transport, runs=DIST_TRAIN_RUNS,
                      n_steps=DIST_STEPS, one_process=True):
    """Gate and print each run of ``_dist_train_rank`` (``ranks``: each
    rank's JSON): on every rank the flash forward and backward launch
    counts (``_attn_launches`` x steps) and step 1's calls all held, the
    replicated loss, aux and grad norm equal (DIST_SPREAD), finite, every
    (leaf, layer) of its shards moved (but TRAIN_STUCK's) and its m and v
    of its shards' shape; with ``one_process``, rank 0's loss of each
    step within DIST_LOSS_RTOL of the one process's and every gradient
    leaf's cosine to the one process's >= DIST_COS (the hybrid instead:
    ``cond_gate``'s ratios within DIST_COND_FACTOR, its control over
    it); else each captured layer within ``compare``'s bounds
    (raised in the rank). Every number is printed
    before a gate raises. Returns the flash forward and backward launches
    summed over the ranks and the runs."""
    from repro_torch.configs import get_config
    fwd = bwd = 0
    bad = []
    for arch, layers, shape, fsdp, batch, seq in runs:
        run = _train_tag(arch, layers, shape, fsdp)
        cfg = get_config(arch).replace(num_layers=layers)
        f1, b1 = _attn_launches(cfg)
        per = [r[run] for r in ranks]
        r0 = per[0]
        fwd += sum(r["fwd"] for r in per)
        bwd += sum(r["bwd"] for r in per)
        stuck = TRAIN_STUCK.get(arch, set())
        for i, r in enumerate(per):
            if (r["fwd"], r["bwd"]) != (f1 * n_steps, b1 * n_steps) or \
                    (r["fwd_held"][0], r["bwd_held"][0]) != (f1, b1):
                bad.append(f"{run} rank {i}: flash {r['fwd']}/{r['bwd']} "
                           f"launches, {r['fwd_held'][0]}/"
                           f"{r['bwd_held'][0]} held; want "
                           f"{f1 * n_steps}/{b1 * n_steps}, {f1}/{b1}")
            if r["spread"] > DIST_SPREAD:
                bad.append(f"{run}: the replicated metrics differ across "
                           f"ranks by {r['spread']} of their size")
            moved = [u for u in r["unmoved"] if u[0] not in stuck]
            if moved or not r["moments_shaped"] or not all(
                    np.isfinite(x[k]) for x in r["mets"] for k in x):
                bad.append(f"{run} rank {i}: unmoved {moved[:8]}, moments "
                           f"of the shards' shape {r['moments_shaped']}")
        text = (f"[{tag}] {arch} ({layers} of "
                f"{get_config(arch).num_layers} layers, full width, bf16, "
                f"remat {cfg.remat}, mesh (data, model) = {shape}"
                f"{', fsdp=True' if fsdp else ''}, {batch} x {seq} tokens, "
                f"{transport}): losses "
                + " ".join(f"{x['loss']:.5f}" for x in r0["mets"]))
        if one_process:
            rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(r0["mets"], r0["one_mets"])]
            low = sorted(r0["cos"].items(), key=lambda kv: kv[1])[:2]
            text += (" vs one process " + " ".join(
                f"{x['loss']:.5f}" for x in r0["one_mets"])
                + f" (rel diff {max(rel):.3g}, limit {DIST_LOSS_RTOL}); "
                f"grad norm " + " ".join(f"{x['grad_norm']:.5f}"
                                         for x in r0["mets"])
                + " vs " + " ".join(f"{x['grad_norm']:.5f}"
                                    for x in r0["one_mets"])
                + f"; least gradient cosine {low[0][1]:.6f} ({low[0][0]}), "
                f"next {low[1][1]:.6f} ({low[1][0]}) over "
                f"{len(r0['cos'])} leaves (limit {DIST_COS})")
            if "cos_free" in r0:
                free = min(r0["cos_free"].items(), key=lambda kv: kv[1])
                text += (
                    f", the one process routed as the ranks routed (free "
                    f"routing: least cosine {free[1]:.6f} ({free[0]}), "
                    f"{r0['flipped']} of {r0['routed_rows']} tokens of "
                    f"step 1's forward chose other experts); "
                    + _capacity_text(cfg, shape, batch * seq))
            held_to_fp32 = "cos32" in r0
            if held_to_fp32:
                ratio, ctrl = cond_ratios(r0)
                worst, least = cond_gate(r0)
                text += (
                    f" (the hybrid: held to the fp32 gradient instead); "
                    f"against the fp32 gradient, 1 - cosine of the ranks' "
                    f"over that of the one process's summed from its "
                    f"{shape[0]} data shards': whole gradient and B/C "
                    f"pieces at most {worst[1]:.3f} ({worst[0]}), limit "
                    f"{DIST_COND_FACTOR}; the control (B and C before "
                    f"their sum over 'model') {least[1]:.3g}, must exceed "
                    f"it; single leaves (printed) " + ", ".join(
                        f"{k} {v:.3f}" for k, v in sorted(
                            {**ratio, **ctrl}.items()))
                    + "; cosines (ranks / data shards summed / one process "
                    "whole batch) " + ", ".join(
                        f"{k} {v:.5f}/{r0['split_cos32'][k.split(' ')[0]]:.5f}"
                        f"/{r0['one_cos32'][k.split(' ')[0]]:.5f}"
                        for k, v in sorted(r0["cos32"].items())))
                if worst[1] > DIST_COND_FACTOR \
                        or least[1] <= DIST_COND_FACTOR:
                    bad.append(f"{run}: fp32-relative gradient ratio "
                               f"{worst}, control {least}")
            text += (f"; one process step s " + " ".join(
                f"{t:.3f}" for t in r0["one_secs"])
                + f", peak {r0['one_peak_gib']:.2f} GiB")
            if max(rel) > DIST_LOSS_RTOL or (
                    low[0][1] < DIST_COS and not held_to_fp32):
                bad.append(f"{run}: loss rel diff {rel}, least gradient "
                           f"cosine {low}")
        else:
            text += "; grad norm " + " ".join(f"{x['grad_norm']:.5f}"
                                              for x in r0["mets"])
            text += "; layers " + ", ".join(
                f"{k}: max_abs_err={e:.3g} max_row_rel_err={w:.3g}"
                for k, (e, w) in r0["gates"].items()) + (
                f" against the unsharded layer on card 0 (atol {ATOL} of "
                f"max, rtol {RTOL}, row {ROW_RTOL})")
        log(text + f"; flash {f1 * n_steps}/{b1 * n_steps} launches a "
            f"rank, step 1's {f1} forward and {b1} backward calls held "
            f"(worst abs err {max(r['fwd_held'][1] for r in per):.3g} / "
            f"{max(r['bwd_held'][1] for r in per):.3g}); step s a rank "
            + "; ".join(" ".join(f"{t:.3f}" for t in r["secs"]) for r in per)
            + "; all-reduce ms a step (calls) "
            + " ".join(f"{t:.1f} ({n})" for t, n in zip(r0["allreduce_ms"],
                                                       r0["allreduces"]))
            + "; AdamW ms a step (share of the step) " + " ".join(
                f"{t:.1f} ({t / 1e3 / w:.3f})"
                for t, w in zip(r0["adamw_ms"], r0["secs"]))
            + "; peak GiB a rank " + " ".join(f"{r['peak_gib']:.2f}"
                                              for r in per)
            + "; train state (params, m, v) GB a rank "
            + " ".join(f"{r['state_bytes'] / 1e9:.2f}" for r in per)
            + f" ({max(r['local_params'] for r in per) / 1e9:.3f}B "
            f"parameters at most); seconds waiting on the one process "
            f"{r0['ref_s']:.1f}, comparing gradients "
            f"{max(r['cos_s'] for r in per):.1f}; unmoved (leaf, layer) "
            f"{sorted(set(tuple(u) for r in per for u in r['unmoved']))[:6]}"
            f" (allowed {sorted(stuck)}); weights made in "
            f"{r0['build_s']:.1f} s; the run {r0['run_s']:.1f} s; "
            f"collectives staged through host memory {r0['staged']}; "
            f"{card}")
    if bad:
        raise AssertionError("; ".join(bad))
    return fwd, bwd


def phase_dist_train_all(card: str):
    """Training under a mesh on the one card: ``_dist_train_rank`` in 4
    processes (mesh ("data", "model") over gloo) for DIST_TRAIN_RUNS
    (zamba2_7b on (2, 2): 56 of 112 Mamba2 heads and 16 of 32 shared-block
    heads a rank; xlstm_1_3b on (1, 4): one mLSTM and sLSTM head a rank;
    gemma_2b and zamba2_7b under ``fsdp=True`` on (2, 2)); each rank's
    exit code checked (``mesh.spawn``), then ``dist_train_report``'s
    gates. Times are gloo's, staged through host memory. Returns the
    ranks' flash forward and backward launches."""
    import gc
    import shutil
    from repro_torch.launch import mesh
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "dist_train_all"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = 4
    mesh.spawn(_dist_train_rank, world, (str(out_dir),))
    ranks = [json.loads((out_dir / f"train_rank{r}.json").read_text())
             for r in range(world)]
    total = dist_train_report(
        "dist_train_all", card, ranks,
        f"{world} ranks on one card over gloo ({ranks[0]['backend']}): "
        f"times gloo-staged, not the card's collectives")
    log(f"[dist_train_all] phase seconds {time.monotonic() - t0:.1f}; "
        f"{card}")
    return total


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
        # flash at MLA's shapes (phase latent), flash and dense decode at
        # zamba2's shared-block shape (phase recurrent), and their launches
        # there; flash's launches in the training runs and the backward
        # kernel's other shapes and ptxas report (phase train)
        out[-1].update({k: r[k] for k in ("mla_shapes", "mla_launches",
                                          "zamba2_shape", "zamba2_launches",
                                          "train_launches", "shapes",
                                          "ptxas", "long_500k", "shard_v2")
                        if k in r})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import gemma_2b
    t0 = time.monotonic()
    marks = [t0]

    def lap(name):
        marks.append(time.monotonic())
        log(f"[time] {name}: {marks[-1] - marks[-2]:.1f}s; "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    line = phase_device()
    phase_build()
    dryrun = start_dryrun()
    # the Python stack of every live allocation, for phase train's report
    # of what the serving phases leave allocated (``_memory_report``)
    torch.cuda.memory._record_memory_history(
        enabled="state", context="alloc", stacks="python")
    lap("device and build")
    rows = phase_kernels()
    lap("kernels")
    rows["pq_scan"], rag_launches = phase_rag()
    lap("rag")
    cfg = gemma_2b.CONFIG
    params = full_width_params(cfg)
    log(f"[params] {sum(v.numel() for v in _leaves(params)) / 1e9:.3f}B "
        f"parameters on the card")
    phase_logits(cfg, params)
    graphed = phase_graphs(cfg, params)
    lap("logits and graphs")
    phase_dryrun(cfg, params, graphed, dryrun)
    lap("dryrun")
    phase_sim(line)
    lap("sim")
    launches, prompts, streams, whole = phase_serve(cfg, params)
    launches["pq_scan"] = rag_launches
    phase_preemption(cfg, params, prompts)
    launches["decode_attention"] = phase_slot(cfg, params, prompts, streams)
    launches["paged_verify_attention"] = phase_spec(cfg, params, prompts,
                                                    streams)
    lap("serve, preemption, slot and spec")
    launches["paged_chunk_attention"] = phase_chunked(cfg, params, prompts,
                                                      streams, whole)
    lap("chunked")
    phase_disagg(cfg, params, prompts, streams, whole)
    lap("disagg")
    del params, whole
    phase_families(line)
    lap("families")
    (rows["flash_attention"]["mla_shapes"],
     rows["flash_attention"]["mla_launches"]) = phase_latent(line)
    lap("latent")
    for name, (shape, n) in phase_recurrent(line).items():
        rows[name].update(zamba2_shape=shape, zamba2_launches=n)
    lap("recurrent")
    rows["flash_attention_bwd"], train_launches = phase_train(line)
    # the training path's launches are gemma_2b's run (phase train)
    launches["flash_attention_bwd"] = train_launches["gemma_2b"][
        "flash_attention_bwd"]
    rows["flash_attention"]["train_launches"] = {
        arch: n["flash_attention"] for arch, n in train_launches.items()}
    lap("train")
    # the distributed steps' flash launches, summed over the ranks
    fwd, bwd = phase_dist(line)
    launches["flash_attention"] += fwd
    launches["flash_attention_bwd"] += bwd
    lap("dist")
    # serving under a mesh: the ranks' flash and dense decode launches;
    # dense decode with its lse at a rank's shard_v2 slice
    counts, rows["decode_attention"]["shard_v2"] = phase_dist_serve(line)
    for name, n in counts.items():
        launches[name] += n
    lap("dist_serve")
    # the recurrent families under a mesh: the ranks' flash and dense
    # decode launches; dense decode with its lse at the long_500k slice
    counts, rows["decode_attention"]["long_500k"] = phase_dist_recurrent(
        line)
    for name, n in counts.items():
        launches[name] += n
    lap("dist_recurrent")
    # training the recurrent families and under FSDP on a mesh: the
    # ranks' flash launches
    fwd, bwd = phase_dist_train_all(line)
    launches["flash_attention"] += fwd
    launches["flash_attention_bwd"] += bwd
    lap("dist_train_all")
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
