"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, the two bitwise contracts between the decode-shaped kernels (and
dense decode's lse output: the same ``out``, the plain lse, offsets near
2^31 elements), the
chunk kernel's rows against the flash kernel's, and the paths through the
kernels (the paged, chunked, dense slot and speculative engines, the
recurrent families' slot engines, the disaggregated prefill/decode workers
and the RAG retrieval scan), and training: flash attention's lse output,
its backward kernel and the autograd Function around both.

Every test here needs an NVIDIA card and carries the ``cuda`` marker; it
skips (in a fixture) without one. The file imports neither JAX nor
``repro``, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import gemma_2b, get_reduced_config, guard_2b
from repro_torch.engine.core import (Engine, EngineConfig, SlotEngine,
                                     make_engine)
from repro_torch.engine.workers import DisaggEngine
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import paged_chunk_attention as tpca
from repro_torch.kernels import pq_scan as tpq
from repro_torch.kernels import ref
from repro_torch.launch import rag
from repro_torch.models import steps
from repro_torch.models import transformer as ttf

pytestmark = pytest.mark.cuda

# bf16 outputs of O(1); kernel and plain version round P and the output at
# different points. Each output row (query position, head) must also agree
# to ROW_RTOL of its norm: a long row averages many values, so its entries
# are far below the elementwise atol.
BF16 = dict(atol=2e-2, rtol=2e-2)
ROW_RTOL = 1e-2
# the IVF-PQ scan: fp32 on both sides, only the summation order differs
FP32 = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, device, *shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                        device=device).to(torch.bfloat16)


def _np(t):
    return t.float().cpu().numpy()


def _assert_close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, **BF16)
    d = got.shape[-1]
    rel = (np.linalg.norm((got - want).reshape(-1, d), axis=1)
           / np.linalg.norm(want.reshape(-1, d), axis=1))
    assert rel.max() <= ROW_RTOL, rel.max()


def _assert_live_close(got, want, lengths):
    """_assert_close over the rows with length > 0; a length-0 decode row
    (the kernel merges no split) must only be finite."""
    assert torch.isfinite(got.float()).all()
    live = [i for i, n in enumerate(lengths) if n > 0]
    _assert_close(got[live], want[live])


# the decode body splits each row every DECODE_SPLIT tokens: lengths one
# short of, at, one past a boundary and past the second; from SPLIT - 3,
# verify's lengths + j + 1 (s = 5) cross it; a dead length-0 row
SPLIT = _build.DECODE_SPLIT
STRADDLE = [SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 3, SPLIT - 3, 0]
# a capacity (max_blocks · bt = 4096) far past every length: most split
# blocks exit at once
SHORT = [63, 1, 40, 0, 17]


# the kernel's edges: one, one tile, one row past it and a ragged 1000
# rows; 1, 2 and 8 kv heads under 8 query heads; head dims of 16 (one k16
# step, 48 zero columns), 64, 128 and 256 (one to four swizzle atoms)
FLASH_EDGES = [((2, s, 8, kvh, d), causal)
               for s in (1, 64, 65, 1000) for kvh in (1, 2, 8)
               for d in (16, 64, 128, 256) for causal in (True, False)]


@pytest.mark.parametrize("shape,causal", [
    ((1, 300, 8, 1, 256), True),
    ((2, 100, 4, 1, 16), True),
    ((2, 65, 4, 2, 64), False),
    ((1, 1024, 8, 1, 256), True),           # the path's prefill shape
] + FLASH_EDGES)
def test_flash_kernel_matches_plain(cuda, shape, causal):
    b, s, nh, kvh, d = shape
    rng = np.random.default_rng(30)
    q, k, v = (_bf16(rng, cuda, b, s, n, d) for n in (nh, kvh, kvh))
    n0 = tfa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1
    _assert_close(got, ref.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("d,g,bt,lengths,mb", [
    (256, 8, 16, [2048, 1, 300, 17], None),
    (16, 4, 8, [5, 37, 1], None),
    (256, 8, 16, STRADDLE + [2048], None),
    (16, 4, 8, STRADDLE, None),
    (256, 8, 16, SHORT, 256),
])
def test_paged_decode_kernel_matches_plain(cuda, d, g, bt, lengths, mb):
    """Shuffled block table, trash-padded tails full of large garbage."""
    rng = np.random.default_rng(31)
    b, mb = len(lengths), mb or max(lengths) // bt + 1
    nb = b * mb + 1
    q = _bf16(rng, cuda, b, 1, g, d)
    kp, vp = _bf16(rng, cuda, nb, bt, 1, d), _bf16(rng, cuda, nb, bt, 1, d)
    kp[nb - 1], vp[nb - 1] = 1e4, -1e4
    perm = rng.permutation(nb - 1)
    tab = np.full((b, mb), nb - 1, np.int32)
    for i, n in enumerate(lengths):
        tab[i, :-(-n // bt)] = perm[i * mb:i * mb - (-n // bt)]
    tab = torch.tensor(tab, device=cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n0 = tpa.launches
    got = ops.paged_decode_attention(q, kp, vp, tab, lens)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    _assert_live_close(got, ref.paged_decode_attention(q, kp, vp, tab, lens),
                       lengths)


def _pool(rng, cuda, d, g, bt, lengths, s, mb=None, kvh=1):
    """q (b, s, g·kvh, d), pools of ``kvh`` kv heads with a shuffled table
    of ``mb`` pages a row (default: enough for the lengths + s positions
    verify reads) covering those positions, and a trash page (the last) of
    large garbage."""
    b = len(lengths)
    mb = mb or (max(lengths) + s) // bt + 1
    nb = b * mb + 1
    q = _bf16(rng, cuda, b, s, g * kvh, d)
    kp, vp = (_bf16(rng, cuda, nb, bt, kvh, d) for _ in range(2))
    kp[nb - 1], vp[nb - 1] = 1e4, -1e4
    perm = rng.permutation(nb - 1)
    tab = np.full((b, mb), nb - 1, np.int32)
    for i, n in enumerate(lengths):
        live = -(-(n + s) // bt)
        tab[i, :live] = perm[i * mb:i * mb + live]
    return (q, kp, vp, torch.tensor(tab, device=cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("d,g,S,lengths", [
    (256, 8, 2048, [2048, 1, 300, 17]),
    (16, 4, 48, [5, 37, 1, 100]),          # a length past S reads as S
    (256, 8, 2048, STRADDLE + [2048]),
    (16, 4, 4 * SPLIT, STRADDLE),
    (256, 8, 4096, SHORT),
])
def test_decode_kernel_matches_plain(cuda, d, g, S, lengths):
    """Padded cache whose content past each row's length is large garbage;
    a length-0 row must come out finite."""
    rng = np.random.default_rng(32)
    b = len(lengths)
    q = _bf16(rng, cuda, b + 1, 1, g, d)
    k, v = _bf16(rng, cuda, b + 1, S, 1, d), _bf16(rng, cuda, b + 1, S, 1, d)
    for i, n in enumerate(lengths):
        k[i, n:], v[i, n:] = 1e4, -1e4
    lens = torch.tensor(lengths + [0], dtype=torch.int32, device=cuda)
    n0 = tda.launches
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert tda.launches == n0 + 1
    _assert_live_close(got, ref.decode_attention(q, k, v, lens),
                       lengths + [0])


@pytest.mark.parametrize("d,g,s,bt,lengths,mb", [
    (256, 8, 5, 16, [2043, 1, 300, 17], None),  # 40 query rows: 3 tiles
    (16, 4, 5, 8, [0, 5, 37], None),     # 20 rows; a dead length-0 row
    (256, 8, 5, 16, STRADDLE + [2043], None),
    (16, 4, 5, 8, STRADDLE, None),
    (256, 8, 5, 16, SHORT, 256),
])
def test_verify_kernel_matches_plain(cuda, d, g, s, bt, lengths, mb):
    rng = np.random.default_rng(33)
    case = _pool(rng, cuda, d, g, bt, lengths, s=s, mb=mb)
    n0 = tpa.verify_launches
    got = ops.paged_verify_attention(*case)
    torch.cuda.synchronize()
    assert tpa.verify_launches == n0 + 1
    _assert_close(got, ref.paged_verify_attention(*case))


# head dims that are multiples of 8 and not of 16: the reduced dense GQA
# configs' 8 (Q K^T is one k16 step over 8 zeroed pad columns) and 24 (one
# full step and that half one), at their 8 query heads over 2 kv heads
ODD_D = (8, 24)


@pytest.mark.parametrize("d", ODD_D)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_takes_head_dims_of_8(cuda, d, causal):
    rng = np.random.default_rng(40)
    q, k, v = (_bf16(rng, cuda, 2, s, n, d)
               for s, n in ((100, 8), (100, 2), (100, 2)))
    _assert_close(ops.flash_attention(q, k, v, causal=causal),
                  ref.flash_attention(q, k, v, causal=causal))


# MLA prefill: query/key head dim qk_nope + qk_rope, value head dim
# v_head_dim, as many kv heads as query heads: reduced (24/16), MiniCPM3-4B
# (96/64, 40 heads), DeepSeek-V2-Lite (192/128, 16) and DeepSeek-V2-236B
# (192/128, 128)
MLA_SHAPES = [(24, 16, 4), (96, 64, 40), (192, 128, 16), (192, 128, 128)]


@pytest.mark.parametrize("dq,dv,nh", MLA_SHAPES)
@pytest.mark.parametrize("s,causal", [(1, True), (65, False), (300, True)])
def test_flash_kernel_takes_dq_other_than_dv(cuda, dq, dv, nh, s, causal):
    rng = np.random.default_rng(41)
    q, k = (_bf16(rng, cuda, 2, s, nh, dq) for _ in range(2))
    v = _bf16(rng, cuda, 2, s, nh, dv)
    n0 = tfa.launches
    got = ops.flash_attention(q, k, v, causal=causal)    # scale dq ** -0.5
    assert tfa.launches == n0 + 1 and got.shape == (2, s, nh, dv)
    _assert_close(got, ref.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("d", ODD_D)
@pytest.mark.parametrize("kernel", ["paged_decode", "decode", "verify",
                                    "chunk"])
def test_paged_and_decode_kernels_take_head_dims_of_8(cuda, kernel, d):
    """Each decode-shaped kernel and the chunk kernel against its plain
    version at 8 query heads over 2 kv heads, across the split boundaries
    and with a dead length-0 row."""
    rng = np.random.default_rng(41)
    s = {"verify": 5, "chunk": 37}.get(kernel, 1)
    lengths = STRADDLE + [300]
    case = _pool(rng, cuda, d, 4, 16, lengths, s=s, kvh=2)
    q, kp, vp, tab, lens = case
    if kernel == "paged_decode":
        _assert_live_close(ops.paged_decode_attention(*case),
                           ref.paged_decode_attention(*case), lengths)
    elif kernel == "decode":
        k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
        _assert_live_close(ops.decode_attention(q, k, v, lens),
                           ref.decode_attention(q, k, v, lens), lengths)
    elif kernel == "verify":
        _assert_close(ops.paged_verify_attention(*case),
                      ref.paged_verify_attention(*case))
    else:
        _assert_close(ops.paged_chunk_attention(*case),
                      ref.paged_chunk_attention(*case))


@pytest.mark.parametrize("lengths,mb", [
    ([700, 1, 130, 64], None),
    (STRADDLE + [700], None),
    (SHORT, 256),
])
@pytest.mark.parametrize("d,g", [(256, 8), (16, 4), (8, 4)])
def test_decode_shaped_kernels_agree_bitwise(cuda, d, g, lengths, mb):
    """verify position j == paged decode at lengths + j + 1, and dense
    decode == paged decode on the same logical cache, with torch.equal,
    across the split boundaries."""
    rng = np.random.default_rng(34)
    s, bt = 5, 16
    q, kp, vp, tab, lens = _pool(rng, cuda, d, g, bt, lengths, s=s, mb=mb)
    out = ops.paged_verify_attention(q, kp, vp, tab, lens)
    for j in range(s):
        dec = ops.paged_decode_attention(q[:, j:j + 1].contiguous(), kp, vp,
                                         tab, lens + j + 1)
        assert torch.equal(out[:, j:j + 1], dec), j
    k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
    q0 = q[:, :1].contiguous()
    assert torch.equal(ops.decode_attention(q0, k, v, lens + 3),
                       ops.paged_decode_attention(q0, kp, vp, tab, lens + 3))
    assert torch.equal(ops.decode_attention(q0, k, v, lens),
                       ops.paged_decode_attention(q0, kp, vp, tab, lens))


# the lse the merge writes: fp32 on both sides (bf16 x bf16 scores are
# exact in fp32), only the order of the sums and exp/log differ; within
# LSE_RTOL of max(1, |lse|)
LSE_RTOL = 1e-5


def _assert_lse_close(got, want, lengths):
    """Each live row's lse within LSE_RTOL; a length-0 row's is -inf."""
    live = torch.tensor([n > 0 for n in lengths], device=got.device)
    assert torch.isneginf(got[~live]).all() and torch.isneginf(
        want[~live]).all()
    g, w = got[live], want[live]
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= LSE_RTOL * w.abs().clamp(min=1.0)).all(), \
        float((g - w).abs().max())


@pytest.mark.parametrize("lengths,mb", [
    ([700, 1, 130, 64], None),
    (STRADDLE + [700], None),
    (SHORT, 256),
])
@pytest.mark.parametrize("d,g", [(112, 1), (256, 8), (16, 4), (8, 4)])
def test_decode_kernel_lse(cuda, d, g, lengths, mb):
    """The dense decode kernel's lse output (``return_lse``): within
    LSE_RTOL of the plain lse, -inf for a length-0 row; ``out`` with the
    lse requested ``torch.equal`` to ``out`` without it, and to paged
    decode on the same logical cache."""
    rng = np.random.default_rng(39)
    q, kp, vp, tab, lens = _pool(rng, cuda, d, g, 16, lengths, s=1, mb=mb,
                                 kvh=2)
    k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
    n0 = tda.launches
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    assert tda.launches == n0 + 1
    assert lse.shape == (len(lengths), 2 * g) and lse.dtype == torch.float32
    assert torch.equal(out, ops.decode_attention(q, k, v, lens))
    assert torch.equal(out, ops.paged_decode_attention(q, kp, vp, tab, lens))
    want, wlse = ref.decode_attention(q, k, v, lens, return_lse=True)
    _assert_live_close(out, want, lengths)
    _assert_lse_close(lse, wlse, lengths)


def test_decode_kernel_offsets_near_2_31(cuda):
    """At b = 1 and S x kvh x d just under 2^31 (32 kv heads at d = 112,
    zamba2_7b's shared block, S = 599,186: 8.6 GB of K/V) the kernel's
    output and lse against the plain version over eight slices of the
    cache merged by their lse (``attention.merge_stacked``, the arithmetic
    ``tests/test_torch_dist_recurrent.py`` holds equal to the whole)."""
    from repro_torch.models import attention as tattn
    kvh, d = 32, 112
    S = (2 ** 31 - 1) // (kvh * d)
    gen = torch.Generator(device=cuda).manual_seed(40)
    q = torch.randn(1, 1, kvh, d, generator=gen, device=cuda).to(
        torch.bfloat16)
    k = torch.randn(1, S, kvh, d, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    v = torch.randn(1, S, kvh, d, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    lens = torch.tensor([S], dtype=torch.int32, device=cuda)
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    bounds = np.linspace(0, S, 9).astype(int)
    outs, lses = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        o, l_ = ref.decode_attention(
            q, k[:, lo:hi], v[:, lo:hi],
            torch.tensor([hi - lo], dtype=torch.int32, device=cuda),
            return_lse=True)
        outs.append(o.float())
        lses.append(l_)
    want = tattn.merge_stacked(outs, lses)
    wlse = torch.logsumexp(torch.stack(lses), 0)
    _assert_live_close(out, want.to(torch.bfloat16), [S])
    _assert_lse_close(lse, wlse, [S])


def test_decode_kernel_refuses_more_splits_than_the_grid_holds(cuda):
    q = torch.zeros(1, 1, 1, 8, device=cuda, dtype=torch.bfloat16)
    S = tda.MAX_SPLITS * _build.DECODE_SPLIT + 1
    k = torch.zeros(1, S, 1, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="splits"):
        ops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                 device=cuda))


@pytest.mark.parametrize("d,g", [(256, 8), (16, 4), (8, 4)])
def test_decode_shaped_kernels_are_deterministic(cuda, d, g):
    """No atomics in the merge: two calls on the same inputs give
    torch.equal outputs, for each of the three kernels."""
    rng = np.random.default_rng(38)
    q, kp, vp, tab, lens = _pool(rng, cuda, d, g, 16, STRADDLE + [700],
                                 s=5)
    q0 = q[:, :1].contiguous()
    k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
    for run in (lambda: ops.paged_decode_attention(q0, kp, vp, tab, lens),
                lambda: ops.decode_attention(q0, k, v, lens),
                lambda: ops.paged_verify_attention(q, kp, vp, tab, lens)):
        assert torch.equal(run(), run())


# chunk attention: the path's contexts (capped so that context + chunk fits
# the 2048-token table) at chunks of 256 and 100; head dim 16 at bt 8 and
# 64, a dead length-0 row; head dim 64 with two kv heads at bt 32
CHUNK_CASES = [
    (256, 8, 1, 16, 256, [1792, 1, 17, 300, 1024, 1537, 640, 1792], 128),
    (256, 8, 1, 16, 100, [1948, 1, 17, 300, 1024, 1537, 640, 1948], 128),
    (16, 4, 1, 8, 37, [0, 5, 37, 100], None),
    (16, 4, 1, 64, 70, [0, 5, 130, 63], None),
    (64, 8, 2, 32, 65, [3, 64, 500], None),
]


@pytest.mark.parametrize("d,nh,kvh,bt,s,lengths,mb", CHUNK_CASES)
def test_chunk_kernel_matches_plain(cuda, d, nh, kvh, bt, s, lengths, mb):
    """Shuffled block table covering lengths + s, unused and trash pages
    full of large garbage; every query row against the plain version, and
    two calls equal."""
    rng = np.random.default_rng(35)
    b = len(lengths)
    mb = mb or (max(lengths) + s) // bt + 1
    nb = b * mb + 1
    q = _bf16(rng, cuda, b, s, nh, d)
    kp, vp = (_bf16(rng, cuda, nb, bt, kvh, d) for _ in range(2))
    perm = rng.permutation(nb - 1)
    tab = np.full((b, mb), nb - 1, np.int32)
    for i, n in enumerate(lengths):
        live = -(-(n + s) // bt)
        tab[i, :live] = perm[i * mb:i * mb + live]
        unused = torch.tensor(perm[i * mb + live:(i + 1) * mb], device=cuda)
        kp[unused], vp[unused] = 1e4, -1e4
    kp[nb - 1], vp[nb - 1] = 1e4, -1e4
    tab = torch.tensor(tab, device=cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n0 = tpca.launches
    got = ops.paged_chunk_attention(q, kp, vp, tab, lens)
    torch.cuda.synchronize()
    assert tpca.launches == n0 + 1
    _assert_close(got, ref.paged_chunk_attention(q, kp, vp, tab, lens))
    assert torch.equal(got, ops.paged_chunk_attention(q, kp, vp, tab, lens))


@pytest.mark.parametrize("chunk", [64, 100, 256])
@pytest.mark.parametrize("d", [256, 16, 8])
def test_chunk_kernel_rows_equal_flash_rows(cuda, chunk, d):
    """One 1000-token prompt's q, k, v, the K/V also paged through a
    shuffled table: prefilled chunk by chunk, every chunk's rows equal the
    flash kernel's rows at the same positions bit for bit."""
    rng = np.random.default_rng(36)
    P, bt, nh = 1000, 16, 8
    q, k, v = (_bf16(rng, cuda, 1, P, n, d) for n in (nh, 1, 1))
    whole = ops.flash_attention(q, k, v)
    mb = 2048 // bt
    ids = torch.tensor(rng.permutation(mb), device=cuda)
    kp = torch.zeros(mb + 1, bt, 1, d, device=cuda, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    n = -(-P // bt)
    pad = lambda x: torch.cat([x[0], x.new_zeros(n * bt - P, 1, d)])
    kp[ids[:n]] = pad(k).reshape(n, bt, 1, d)
    vp[ids[:n]] = pad(v).reshape(n, bt, 1, d)
    tab = ids.to(torch.int32)[None]
    for L in range(0, P, chunk):
        take = min(chunk, P - L)
        qc = torch.zeros(1, chunk, nh, d, device=cuda, dtype=torch.bfloat16)
        qc[0, :take] = q[0, L:L + take]
        out = ops.paged_chunk_attention(
            qc, kp, vp, tab, torch.tensor([L], dtype=torch.int32,
                                          device=cuda))
        assert torch.equal(out[0, :take], whole[0, L:L + take]), L


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)                 # fp32
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    qb = torch.zeros(1, 8, 2, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                           # d % 8 != 0
        ops.flash_attention(qb, qb[:, :, :1], qb[:, :, :1])
    q24 = torch.zeros(1, 8, 2, 24, device=cuda, dtype=torch.bfloat16)
    assert ops.flash_attention(q24, q24, q24[..., :16]).shape == (1, 8, 2,
                                                                  16)
    for q_, v_ in ((qb, qb[..., :8]),                         # dq % 8 != 0
                   (q24, qb),                                 # dv % 8 != 0
                   (q24[..., :16], q24)):                     # dv > dq
        with pytest.raises(ValueError):
            ops.flash_attention(q_, q_, v_)
    q1 = torch.zeros(2, 1, 4, 32, device=cuda, dtype=torch.bfloat16)
    kc = torch.zeros(2, 8, 1, 32, device=cuda, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                           # dv != d
        ops.decode_attention(q1, kc, kc[..., :16], lens)
    with pytest.raises(ValueError):                           # int64 lengths
        ops.decode_attention(q1, kc, kc, lens.long())
    tab = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                           # g = 32 > 16
        ops.paged_verify_attention(
            torch.zeros(2, 3, 32, 32, device=cuda, dtype=torch.bfloat16),
            kc, kc, tab, lens)
    z12 = lambda *shape: torch.zeros(*shape, 12, device=cuda,  # noqa: E731
                                     dtype=torch.bfloat16)
    for call in (                                             # d % 8 != 0
            lambda: ops.decode_attention(z12(2, 1, 4), z12(2, 8, 1),
                                         z12(2, 8, 1), lens),
            lambda: ops.paged_decode_attention(z12(2, 1, 4), z12(3, 16, 1),
                                               z12(3, 16, 1), tab, lens),
            lambda: ops.paged_verify_attention(z12(2, 3, 4), z12(3, 16, 1),
                                               z12(3, 16, 1), tab, lens),
            lambda: ops.paged_chunk_attention(z12(2, 8, 4), z12(3, 16, 1),
                                              z12(3, 16, 1), tab, lens)):
        with pytest.raises(ValueError):
            call()
    qc = torch.zeros(2, 8, 4, 32, device=cuda, dtype=torch.bfloat16)
    for bt in (12, 4):                       # 64 % bt != 0, bt < 8
        pool = torch.zeros(3, bt, 1, 32, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            ops.paged_chunk_attention(qc, pool, pool, tab, lens)
    pool = torch.zeros(3, 16, 1, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                           # dv != dq
        ops.paged_chunk_attention(qc, pool, pool[..., :16], tab, lens)
    with pytest.raises(ValueError):                           # fp32
        ops.paged_chunk_attention(qc.float(), pool.float(), pool.float(),
                                  tab, lens)


def test_engine_main_path_runs_through_both_kernels(cuda):
    """Reduced Gemma-2B (head dim 16) in bf16 on the card."""
    eng = Engine(gemma_2b.reduced(), max_batch=2, max_len=64,
                 block_tokens=16, device=cuda)
    rng = np.random.default_rng(1)
    n0 = (tfa.launches, tpa.launches)
    for n in (12, 30, 7):
        eng.submit(rng.integers(0, 512, n).astype(np.int32),
                   max_new_tokens=5)
    done = eng.run()
    assert len(done) == 3 and all(len(r.tokens) == 5 for r in done)
    assert tfa.launches > n0[0] and tpa.launches > n0[1]
    assert eng.caches["attn"]["k_pool"].is_cuda


def test_chunked_engine_runs_through_chunk_kernel(cuda):
    """Reduced Gemma-2B in bf16 on the card: the chunked Engine prefills
    through paged_chunk_attention, a prompt past max_len included, and its
    streams equal the whole-prefill Engine's."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (12, 30, 7)]
    streams = []
    n0 = tpca.launches
    for cfg in (EngineConfig(), EngineConfig(chunk_size=8)):
        eng = Engine(gemma_2b.reduced(), max_batch=2, max_len=64, seed=5,
                     block_tokens=16, device=cuda, config=cfg)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        streams.append({r.rid: r.tokens for r in eng.run()})
    assert tpca.launches > n0
    assert streams[0] == streams[1] and len(streams[0]) == 3
    long_p = rng.integers(0, 512, 100).astype(np.int32)
    eng = Engine(gemma_2b.reduced(), max_batch=2, max_len=64, seed=5,
                 block_tokens=16, device=cuda,
                 config=EngineConfig(chunk_size=16, max_context=128))
    eng.submit(long_p, max_new_tokens=6)
    want = SlotEngine(gemma_2b.reduced(), max_batch=2, max_len=128, seed=5,
                      device=cuda)
    want.submit(long_p, max_new_tokens=6)
    assert eng.run()[0].tokens == want.run()[0].tokens


def test_slot_engine_runs_through_decode_kernel(cuda):
    """Reduced Gemma-2B in bf16 on the card: the dense SlotEngine decodes
    through decode_attention and gives the paged Engine's streams."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (12, 30, 7)]
    streams = []
    n0 = tda.launches
    for cls, kw in ((SlotEngine, {}), (Engine, {"block_tokens": 16})):
        eng = cls(gemma_2b.reduced(), max_batch=2, max_len=64, seed=4,
                  device=cuda, **kw)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        streams.append({r.rid: r.tokens for r in eng.run()})
    assert tda.launches > n0
    assert streams[0] == streams[1] and len(streams[0]) == 3


@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_lite_16b"])
def test_mla_slot_engine_runs_through_flash_kernel(cuda, arch):
    """Reduced MLA configs (dq 24, dv 16) in bf16 on the card: make_engine
    gives the SlotEngine, which prefills through flash_attention at dq !=
    dv; its decode pass graphed gives the eager pass's streams."""
    cfg = get_reduced_config(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (12, 30, 7)]
    streams = []
    for graphs in (True, False):
        eng = make_engine(cfg, max_batch=2, max_len=64, seed=4, device=cuda,
                          block_tokens=16, cuda_graphs=graphs)
        assert isinstance(eng, SlotEngine)
        n0 = tfa.launches
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        streams.append({r.rid: r.tokens for r in eng.run()})
        assert tfa.launches >= n0 + 3 * cfg.num_layers
    assert streams[0] == streams[1] and len(streams[0]) == 3


# zamba2_7b's shared attention block: MHA, 32/32 heads at head dim 112
# (two 64-column atoms, the second half zero-filled by TMA; the decode
# body's query group of 1 in its m16 tile)
@pytest.mark.parametrize("s,causal", [(1, True), (65, False), (300, True),
                                      (1024, True)])
def test_flash_kernel_at_the_hybrid_shared_block_shape(cuda, s, causal):
    rng = np.random.default_rng(36)
    q, k, v = (_bf16(rng, cuda, 1, s, 32, 112) for _ in range(3))
    n0 = tfa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1
    _assert_close(got, ref.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("lengths", [
    [2048, 1, 17, 300, 1024, 1537, 640, 2000],      # the path's decode
    STRADDLE + [2048, 1],
])
def test_decode_kernel_at_the_hybrid_shared_block_shape(cuda, lengths):
    """b = 8, S = 2048, 32/32 heads (query group 1), d = 112, content past
    each row's length large garbage."""
    rng = np.random.default_rng(37)
    b = len(lengths)
    q = _bf16(rng, cuda, b, 1, 32, 112)
    k, v = (_bf16(rng, cuda, b, 2048, 32, 112) for _ in range(2))
    for i, n in enumerate(lengths):
        k[i, n:], v[i, n:] = 1e4, -1e4
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n0 = tda.launches
    got = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert tda.launches == n0 + 1
    _assert_live_close(got, ref.decode_attention(q, k, v, lens), lengths)


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_1_3b"])
def test_recurrent_slot_engine_graphed_equals_eager(cuda, arch):
    """Reduced recurrent configs in bf16 on the card: make_engine gives
    the SlotEngine; graphed and eager decode passes give equal streams over
    five requests through two slots (slots reused); the hybrid's shared
    block prefills through flash_attention and decodes through
    decode_attention."""
    cfg = get_reduced_config(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (24, 64, 7, 32, 96)]
    streams = []
    for graphs in (True, False):
        eng = make_engine(cfg, max_batch=2, max_len=160, seed=4,
                          device=cuda, block_tokens=16, cuda_graphs=graphs)
        assert isinstance(eng, SlotEngine)
        assert (eng._decode.graph is not None) == graphs
        n0 = (tfa.launches, tda.launches)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        streams.append({r.rid: r.tokens for r in eng.run()})
        if arch == "zamba2_7b":
            apps = cfg.num_layers // cfg.shared_attn_every
            assert tfa.launches == n0[0] + apps * len(prompts)
            assert tda.launches > n0[1]
    assert streams[0] == streams[1] and len(streams[0]) == 5


def test_spec_engine_runs_through_verify_kernel(cuda):
    """Reduced Gemma-2B target, reduced Guard-2B draft, bf16 on the card."""
    eng = Engine(gemma_2b.reduced(), max_batch=2, max_len=64,
                 block_tokens=16, device=cuda, config=EngineConfig(
                     draft_cfg=guard_2b.reduced(), spec_k=3))
    rng = np.random.default_rng(3)
    n0 = tpa.verify_launches
    for n in (12, 30, 7):
        eng.submit(rng.integers(0, 512, n).astype(np.int32),
                   max_new_tokens=6)
    done = eng.run()
    assert len(done) == 3 and all(len(r.tokens) == 6 for r in done)
    assert tpa.verify_launches > n0 and eng.spec_stats()["row_steps"] > 0
    assert not eng.store.forks and eng.store.used_blocks == 0


def _pq_case(rng, cuda, n, m, k, dtype):
    codes = torch.tensor(rng.integers(0, k, (n, m)), dtype=dtype,
                         device=cuda)
    lut = torch.tensor(rng.standard_normal((m, k)).astype(np.float32),
                       device=cuda)
    return codes, lut


def _pq_assert(codes, lut):
    """The kernel through ``ops``: counted, within FP32 of ``ref.pq_scan``
    and equal to the in-order plain version bit for bit."""
    n0 = tpq.launches
    got = ops.pq_scan(codes, lut)
    torch.cuda.synchronize()
    assert tpq.launches == n0 + 1
    np.testing.assert_allclose(_np(got), _np(ref.pq_scan(codes, lut)), **FP32)
    assert torch.equal(got, ref.pq_scan_in_order(codes, lut))
    return got


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("m", [8, 16, 32, 227])
@pytest.mark.parametrize("n", [1, 31, 513, 1037, 250_000])
def test_pq_scan_kernel_equals_in_order_plain_version(cuda, n, m, dtype,
                                                      offset):
    """Every path of the launch plan equals the in-order sum bit for bit:
    aligned rows of 1, 2 or 4 16-byte vectors loaded in batches (uint8 at
    M = 16 and 32, int32 at M = 8 and 16); row by row otherwise (uint8 at
    M = 8, int32 at M = 32, M = 227, and codes one element past a 16-byte
    boundary, one byte for uint8); the plain LUT fill at M = 227, where
    the LUT takes all of shared memory. N = 1037 leaves a short last batch
    whose rows are not a multiple of 16."""
    rng = np.random.default_rng(38)
    buf = torch.tensor(rng.integers(0, 256, n * m + 16), dtype=dtype,
                       device=cuda)
    codes = buf[offset:offset + n * m].view(n, m)
    assert (codes.data_ptr() % 16 == 0) == (offset == 0)
    lut = torch.tensor(rng.standard_normal((m, 256)).astype(np.float32),
                       device=cuda)
    _pq_assert(codes, lut)


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
@pytest.mark.parametrize("n,m,k", [
    (1000, 16, 256),            # uint8: one 16-byte load per row
    (4096, 8, 256),             # uint8: 8-byte rows, code by code
    (513, 32, 64),
    (1, 16, 256),               # N = 1
    (200_000, 16, 256),         # more rows than the grid has threads
])
def test_pq_scan_kernel_matches_plain(cuda, n, m, k, dtype):
    _pq_assert(*_pq_case(np.random.default_rng(35), cuda, n, m, k, dtype))


@pytest.mark.parametrize("dtype,k,bad", [
    (torch.int32, 256, [-1, 256, 2 ** 30]),
    (torch.uint8, 64, [64, 200, 255]),
])
def test_pq_scan_kernel_out_of_range_codes_add_zero(cuda, dtype, k, bad):
    rng = np.random.default_rng(36)
    codes, lut = _pq_case(rng, cuda, 777, 16, k, dtype)
    hit = torch.tensor(rng.random((777, 16)) < 0.3, device=cuda)
    pick = torch.tensor(rng.choice(bad, (777, 16)), dtype=dtype, device=cuda)
    codes = torch.where(hit, pick, codes)
    got = _pq_assert(codes, lut)
    only_bad = torch.tensor([bad[:1] * 16], dtype=dtype, device=cuda)
    assert torch.equal(ops.pq_scan(only_bad, lut),
                       torch.zeros(1, device=cuda))
    assert torch.isfinite(got).all()


def test_pq_scan_kernel_shared_memory_limit(cuda):
    """M * K * 4 = 232,448 bytes (M = 227, K = 256) runs; one column more
    raises in the wrapper."""
    rng = np.random.default_rng(37)
    _pq_assert(*_pq_case(rng, cuda, 2000, 227, 256, torch.uint8))
    codes, lut = _pq_case(rng, cuda, 10, 227, 257, torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        ops.pq_scan(codes, lut)


def test_launch_rag_on_the_card_runs_through_the_kernel(cuda):
    """The default path: the top-5 ids equal the plain version's on the
    same inputs on the card."""
    n0 = tpq.launches
    ids = rag.main(["--n", "20000"])
    assert tpq.launches == n0 + 1
    codes, lut = rag.make_inputs(20000, 16, 256, seed=0, device=cuda)
    assert ids == rag.nearest(ref.pq_scan(codes, lut))


def _perturbed_params(cfg, device, seed):
    """Seeded weights with every leaf perturbed (the init zeroes the output
    projections, which would make the output ignore attention)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ttf.init_model(cfg, gen, device)

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            else:
                noise = torch.randn(v.shape, generator=gen, device=device)
                v.add_((noise * 0.1).to(v.dtype))
    walk(params)
    return params


def _disagg_case(cuda):
    cfg = gemma_2b.reduced()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (12, 30, 7, 41)]
    params = _perturbed_params(cfg, cuda, 6)
    geom = dict(max_batch=2, max_len=64, block_tokens=16)
    eng = Engine(cfg, params=params, device=cuda, **geom)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    want = {r.rid: r.tokens for r in eng.run()}
    return cfg, params, prompts, geom, want


def _serve_disagg(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    return {r.rid: r.tokens for r in eng.run()}


@pytest.mark.parametrize("cuda_graphs", [True, False])
def test_disagg_streams_equal_paged_engine(cuda, cuda_graphs):
    """Reduced Gemma-2B in bf16 on the card: one prefill and two decode
    workers (local and global, full and layerwise handoffs) and a chunked
    prefill worker give the paged Engine's streams, through flash, the
    chunk kernel and paged decode; layerwise handoffs time one sample per
    layer."""
    cfg, params, prompts, geom, want = _disagg_case(cuda)
    n0 = (tfa.launches, tpa.launches, tpca.launches)
    for kw in (dict(n_decode=2, mode="local", granularity="full"),
               dict(n_decode=2, mode="global", granularity="layerwise"),
               dict(granularity="layerwise",
                    config=EngineConfig(chunk_size=16))):
        eng = DisaggEngine(cfg, params, device=cuda, cuda_graphs=cuda_graphs,
                           **geom, **kw)
        assert _serve_disagg(eng, prompts) == want
        ts = eng.transfer_stats()
        assert ts["handoffs"] == len(prompts)
        per = cfg.num_layers if ts["granularity"] == "layerwise" else 1
        assert len(ts["samples"]) == per * ts["handoffs"]
        assert ts["exposed_s"] <= ts["total_s"]
        assert all((p.graph is not None) == cuda_graphs
                   for p in eng.passes().values())
    assert tfa.launches > n0[0] and tpa.launches > n0[1] \
        and tpca.launches > n0[2]


def test_disagg_handoff_between_two_cards(cuda):
    """With two or more cards the roles take cards of their own: the
    handoff is a copy between cards and the streams stay the paged
    Engine's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards for a handoff between cards")
    cfg, params, prompts, geom, want = _disagg_case(cuda)
    eng = DisaggEngine(cfg, params, device=cuda, **geom)
    assert eng.prefill[0].device != eng.decode[0].device
    assert _serve_disagg(eng, prompts) == want
    assert eng.transfer_stats()["cross_device"]


# ---------------------------------------------------------------------------
# training: flash attention's lse output, its backward kernel and the
# autograd Function around both
# ---------------------------------------------------------------------------

# (b, s, t, nh, kvh, dq, dv): groups 1/2/8, head dims 8/80/128/256 and MLA's
# 192/128, s off the 64-row tile and s = 1 (one query over 70 keys; under
# causal it sees one key, and dq, dk are 0 up to rounding: not a case); an
# MQA group of 8 at Gemma-2B's s = 1024, d = 256, at b = 1 (the group split
# 8 ways, partials summed) and at the training batch b = 4 (fewer splits),
# with more q tiles than the dK/dV ring has stages
BWD_SHAPES = [
    (2, 100, 100, 4, 4, 80, 80),
    (2, 130, 130, 4, 2, 128, 128),
    (1, 200, 200, 8, 1, 256, 256),
    (2, 77, 77, 8, 4, 8, 8),
    (1, 96, 96, 4, 4, 192, 128),
    (2, 1, 70, 8, 1, 256, 256),
    (1, 64, 64, 2, 1, 24, 16),
    (1, 1024, 1024, 8, 1, 256, 256),
    (4, 1024, 1024, 8, 1, 256, 256),
]
BWD_CASES = [(shape, causal) for shape in BWD_SHAPES
             for causal in (True, False) if shape[1] > 1 or not causal]


def _grad_close(name, got, want):
    """The backward tolerance: per (batch, head) slab a relative norm <=
    0.01, elementwise |err| <= 0.02 max|plain| + 0.02 |plain|."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), name
    err = (got - want).abs()
    assert (err <= 0.02 * want.abs().max() + 0.02 * want.abs()).all(), \
        (name, float(err.max()))
    slab = lambda x: x.permute(0, 2, 1, 3).flatten(2)   # noqa: E731
    rel = (slab(got - want).norm(dim=-1)
           / slab(want).norm(dim=-1).clamp(min=1e-30))
    assert float(rel.max()) <= 0.01, (name, float(rel.max()))


def _bwd_case(rng, device, b, s, t, nh, kvh, dq, dv, causal):
    q = _bf16(rng, device, b, s, nh, dq)
    k = _bf16(rng, device, b, t, kvh, dq)
    v = _bf16(rng, device, b, t, kvh, dv)
    do = _bf16(rng, device, b, s, nh, dv)
    o, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("shape,causal", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, shape, causal):
    rng = np.random.default_rng(60)
    q, k, v, o, lse, do = _bwd_case(rng, cuda, *shape, causal)
    n0 = tfa.backward_launches
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert tfa.backward_launches == n0 + 1
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16
        _grad_close(name, g, w)


@pytest.mark.parametrize("shape,causal", BWD_CASES)
def test_flash_lse_output_is_bitwise_the_plain_launch(cuda, shape, causal):
    """The forward with lse gives the output of the launch without it bit
    for bit, and its lse matches the plain version's."""
    rng = np.random.default_rng(61)
    q, k, v, _, lse, _ = _bwd_case(rng, cuda, *shape, causal)
    out, lse2 = tfa.flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(out, tfa.flash_attention(q, k, v, causal=causal))
    assert torch.equal(lse, lse2)
    _, want = ref.flash_attention_lse(q, k, v, causal=causal)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


def test_chunk_rows_still_equal_flash_rows_with_lse(cuda):
    """The lse launch's rows equal the chunk kernel's over the same K/V."""
    rng = np.random.default_rng(62)
    P, bt, nh, d, L = 300, 16, 8, 256, 128
    q, k, v = (_bf16(rng, cuda, 1, P, n, d) for n in (nh, 1, 1))
    whole, _ = tfa.flash_attention_lse(q, k, v)
    mb = 512 // bt
    kp = torch.zeros(mb + 1, bt, 1, d, device=cuda, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    n = -(-P // bt)
    pad = lambda x: torch.cat([x[0], x.new_zeros(n * bt - P, 1, d)])  # noqa
    kp[:n] = pad(k).reshape(n, bt, 1, d)
    vp[:n] = pad(v).reshape(n, bt, 1, d)
    tab = torch.arange(mb, dtype=torch.int32, device=cuda)[None]
    out = ops.paged_chunk_attention(
        q[:, L:], kp, vp, tab, torch.tensor([L], dtype=torch.int32,
                                            device=cuda))
    assert torch.equal(out[0], whole[0, L:])


@pytest.mark.parametrize("shape", [(1, 200, 200, 8, 1, 256, 256),
                                   (2, 130, 130, 4, 2, 128, 128),
                                   (1, 1024, 1024, 8, 1, 256, 256)])
def test_flash_bwd_kernel_is_deterministic(cuda, shape):
    rng = np.random.default_rng(63)
    args = _bwd_case(rng, cuda, *shape, True)
    a = tfa.flash_attention_bwd(*args)
    b = tfa.flash_attention_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_function_under_checkpoint(cuda):
    """ops.flash_attention under autograd is the Function: its gradients
    are the backward kernel's, and under torch.utils.checkpoint (the
    forward run again in the backward) they are bit for bit the same."""
    rng = np.random.default_rng(64)
    q, k, v, _, _, do = _bwd_case(rng, cuda, 2, 130, 130, 8, 2, 64, 64,
                                  True)

    def grads(use_ckpt):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn = lambda a, b_, c: ops.flash_attention(a, b_, c) * 1.0  # noqa
        out = (torch.utils.checkpoint.checkpoint(fn, *leaves,
                                                 use_reentrant=False)
               if use_ckpt else fn(*leaves))
        out.backward(do)
        return [x.grad for x in leaves]
    n0, b0 = tfa.launches, tfa.backward_launches
    plain = grads(False)
    assert (tfa.launches, tfa.backward_launches) == (n0 + 1, b0 + 1)
    ckpt = grads(True)
    assert (tfa.launches, tfa.backward_launches) == (n0 + 3, b0 + 2)
    assert all(torch.equal(x, y) for x, y in zip(plain, ckpt))
    o, lse = tfa.flash_attention_lse(q, k, v)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, True)
    for name, g, w in zip(("dq", "dk", "dv"), plain, want):
        _grad_close(name, g, w)
    with torch.no_grad():                       # serving: the plain launch
        x = q.clone().requires_grad_(True)
        ops.flash_attention(x, k, v)
    assert tfa.launches == n0 + 5 and tfa.backward_launches == b0 + 2


def test_flash_bwd_raises_on_what_it_does_not_take(cuda):
    rng = np.random.default_rng(65)
    q, k, v, o, lse, do = _bwd_case(rng, cuda, 1, 16, 16, 2, 1, 16, 16,
                                    True)
    for bad in (
            (q.float(), k, v, o, lse, do),                    # fp32
            (q, k, v, o, lse.double(), do),                   # lse dtype
            (q, k, v, o, lse[:, :1], do),                     # lse shape
            (q, k, v, o, lse, do[..., :8]),                   # dO shape
            (q[..., :12], k[..., :12], v[..., :12], o[..., :12], lse,
             do[..., :12])):                                  # d % 8 != 0
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd(*bad)
    with pytest.raises(ValueError):                           # fp32 leaves
        ops.flash_attention(q.float().requires_grad_(True), k.float(),
                            v.float())


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


@pytest.mark.parametrize("arch,remat", [("gemma_2b", "full"),
                                        ("hubert_xlarge", "none")])
def test_train_step_runs_through_both_flash_kernels(cuda, arch, remat):
    """A reduced bf16 train step on the card: every layer's attention
    forward is the kernel (twice under remat "full": once more in the
    backward's recompute) and its backward the gradient kernel."""
    cfg = get_reduced_config(arch).replace(remat=remat)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = steps.init_train_state(cfg, gen, cuda)
    # the init zeroes the output projections, and then attention gets no
    # gradient: perturb every leaf
    for leaf in _leaves(state["params"]):
        leaf.add_((torch.randn(leaf.shape, generator=gen, device=cuda)
                   * 0.05).to(leaf.dtype))
    rng = np.random.default_rng(66)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 96)),
                             dtype=torch.int32, device=cuda)
             for k in ("tokens", "labels")}
    before = state["params"]["layers"]["attn"]["wq"].clone()
    n0, b0 = tfa.launches, tfa.backward_launches
    state, metrics = steps.train_step(state, batch, cfg)
    torch.cuda.synchronize()
    assert tfa.launches - n0 == cfg.num_layers * (2 if remat == "full"
                                                  else 1)
    assert tfa.backward_launches - b0 == cfg.num_layers
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])
    assert not torch.equal(before, state["params"]["layers"]["attn"]["wq"])


# the training shapes of MiniCPM3-4B (MLA 96/64 x 40 heads), DeepSeek-V2-
# Lite (MLA 192/128 x 16) and Zamba2-7B's shared block (32 heads, d 112):
# (b, s, nh, kvh, dq, dv), causal
TRAIN_SHAPES = [(4, 1024, 40, 40, 96, 64), (4, 1024, 16, 16, 192, 128),
                (4, 1024, 32, 32, 112, 112)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_flash_function_gradient_at_the_families_training_shapes(cuda,
                                                                 shape):
    """ops.flash_attention under autograd at the shapes the MLA and hybrid
    families train at: the gradients (the backward kernel's, through
    FlashAttentionFn) within the backward tolerance of the plain version,
    and two launches torch.equal."""
    b, s, nh, kvh, dq, dv = shape
    rng = np.random.default_rng(67)
    q, k, v, o, lse, do = _bwd_case(rng, cuda, b, s, s, nh, kvh, dq, dv,
                                    True)

    def grads():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ops.flash_attention(*leaves).backward(do)
        return [x.grad for x in leaves]
    b0 = tfa.backward_launches
    first, second = grads(), grads()
    assert tfa.backward_launches == b0 + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, True)
    for name, g, w in zip(("dq", "dk", "dv"), first, want):
        _grad_close(name, g, w)


def _fp32_calls(cuda):
    """Each hand-written bf16 kernel's wrapper called on fp32 inputs of
    shapes it takes."""
    f = lambda *shape: torch.zeros(*shape, device=cuda)       # noqa: E731
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    tab = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    q, pool = f(2, 8, 4, 32), f(3, 16, 1, 32)
    lse = torch.zeros(2, 4, 8, device=cuda)
    return {
        "flash_attention": lambda: tfa.flash_attention(q, q, q),
        "flash_attention_lse": lambda: tfa.flash_attention_lse(q, q, q),
        "flash_attention_bwd": lambda: tfa.flash_attention_bwd(
            q, q, q, q, lse, q),
        "paged_decode_attention": lambda: tpa.paged_decode_attention(
            q[:, :1], pool, pool, tab, lens),
        "paged_verify_attention": lambda: tpa.paged_verify_attention(
            q[:, :3], pool, pool, tab, lens),
        "decode_attention": lambda: tda.decode_attention(
            q[:, :1], f(2, 8, 1, 32), f(2, 8, 1, 32), lens),
        "paged_chunk_attention": lambda: tpca.paged_chunk_attention(
            q, pool, pool, tab, lens),
    }


@pytest.mark.parametrize("kernel", list(_fp32_calls(torch.device("cpu"))))
def test_kernel_wrappers_refuse_fp32_naming_bf16(cuda, kernel):
    """The reference's ops fall back to jnp for a dtype its Pallas kernels
    do not take; the port's wrappers have no fallback: fp32 on the card
    raises ValueError naming bf16 (the README's port section)."""
    with pytest.raises(ValueError, match="bf16"):
        _fp32_calls(cuda)[kernel]()


def test_grouped_mm_backward_on_the_card(cuda):
    """moe.ragged_dot's gradient in bf16 on the card, given an expanded
    (stride-0) incoming gradient: the per-group products' gradients, an
    empty group's zero."""
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda).manual_seed(68)
    x = torch.randn(96, 64, generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn(4, 64, 128, generator=gen, device=cuda).to(
        torch.bfloat16)
    sizes = torch.tensor([40, 0, 32, 24], device=cuda)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    moe.ragged_dot(xg, wg, sizes).sum().backward()
    xr, wr = x.float().requires_grad_(True), w.float().requires_grad_(True)
    lo = 0
    for g, n in enumerate(sizes.tolist()):
        (xr[lo:lo + n] @ wr[g]).sum().backward()
        lo += n
    torch.testing.assert_close(xg.grad.float(), xr.grad, **BF16)
    torch.testing.assert_close(wg.grad.float(), wr.grad, atol=0.5,
                               rtol=2e-2)
    assert not wg.grad[1].any()


@pytest.mark.parametrize("arch,remat", [("minicpm3_4b", "dots"),
                                        ("deepseek_v2_lite_16b", "none"),
                                        ("zamba2_7b", "full"),
                                        ("xlstm_1_3b", "none")])
def test_family_train_step_on_the_card(cuda, arch, remat):
    """A reduced bf16 train step of each newly trained family on the card:
    finite loss and grad norm, MoE's aux > 0, flash's forward launched
    once an attention call (twice for a block under remat "full" or
    "dots"; the hybrid's shared block is not rematerialised) and its
    backward once."""
    cfg = get_reduced_config(arch).replace(remat=remat)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = steps.init_train_state(cfg, gen, cuda)
    for leaf in _leaves(state["params"]):
        leaf.add_((torch.randn(leaf.shape, generator=gen, device=cuda)
                   * 0.05).to(leaf.dtype))
    rng = np.random.default_rng(69)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 64)),
                             dtype=torch.int32, device=cuda)
             for k in ("tokens", "labels")}
    attn = {"hybrid": cfg.num_layers // max(1, cfg.shared_attn_every),
            "ssm": 0}.get(cfg.family, cfg.num_layers)
    twice = remat != "none" and cfg.family != "hybrid"
    n0, b0 = tfa.launches, tfa.backward_launches
    state, metrics = steps.train_step(state, batch, cfg)
    torch.cuda.synchronize()
    assert tfa.launches - n0 == attn * (2 if twice else 1)
    assert tfa.backward_launches - b0 == attn
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])
    assert (float(metrics["aux_loss"]) > 0) == (cfg.family == "moe")


def test_fp32_accumulated_product_gradient_on_the_card(cuda):
    """``layers.mm_fp32`` (one product with an fp32 output, the partial
    product a row-parallel sum takes) under autograd on bf16 operands:
    its output and both gradients against autograd of the upcast product
    ``x.float() @ w.float()``, given the gradient a bf16 consumer hands
    back (the product rounded to bf16, as ``Layout.row_parallel``
    rounds it). The output is the upcast product's within fp32 rounding;
    the gradients within the bf16 rounding of each."""
    from repro_torch.models.layers import mm_fp32
    gen = torch.Generator(device=cuda).manual_seed(70)
    x = torch.randn(3, 40, 96, generator=gen, device=cuda).to(
        torch.bfloat16)
    w = (torch.randn(96, 72, generator=gen, device=cuda) * 0.1).to(
        torch.bfloat16)
    g = torch.randn(3, 40, 72, generator=gen, device=cuda).to(torch.bfloat16)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = mm_fp32(xg, wg)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    y.to(torch.bfloat16).backward(g)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yr = xr.float() @ wr.float()
    yr.to(torch.bfloat16).backward(g)
    torch.testing.assert_close(y, yr.detach(), atol=1e-4, rtol=1e-5)
    assert xg.grad.dtype == wg.grad.dtype == torch.bfloat16
    torch.testing.assert_close(xg.grad, xr.grad, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(wg.grad, wr.grad, atol=2e-2, rtol=1e-2)
    # no gradient asked for: the plain call, no graph
    with torch.no_grad():
        assert mm_fp32(xg, wg).grad_fn is None


# the sharded step against one process on the same card, bf16: the
# loss's relative difference and each gradient leaf's cosine (phase dist's
# gates, chip_smoke.DIST_LOSS_RTOL and DIST_COS)
DIST_LOSS_RTOL, DIST_COS = 2e-3, 0.999


def _sharded_gemma(tmp_path, world, shape):
    import json

    import _torch_dist_jobs as jobs
    from repro_torch.launch import mesh
    mesh.spawn(jobs.card, world, (str(tmp_path), shape))
    out = json.loads((tmp_path / "card.json").read_text())
    layers = get_reduced_config("gemma_2b").num_layers
    assert (out["fwd"], out["bwd"]) == (layers, layers)
    for a, b in (out["loss"], out["step_loss"]):
        assert abs(a - b) <= DIST_LOSS_RTOL * abs(b), out
    assert min(out["cos"].values()) >= DIST_COS, out["cos"]


def test_sharded_gemma_step_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on the one card over gloo, mesh ("data", "model") = (1,
    2): reduced gemma_2b's sharded step through both flash kernels (2 of
    4 heads a rank) equals the one-process step."""
    _sharded_gemma(tmp_path, 2, (1, 2))


def test_sharded_gemma_step_four_cards_over_nccl(cuda, tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one NCCL rank a card)")
    _sharded_gemma(tmp_path, 4, (2, 2))
