"""PyTorch port, kernels: the plain PyTorch versions against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode on the same
numpy inputs. The CUDA kernels are held against the plain versions on the
card in ``test_torch_cuda.py``."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_attention import \
    paged_decode_attention as pallas_paged
from repro.kernels.paged_attention import \
    paged_verify_attention as pallas_verify
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref

# fp32: both sides compute in fp32, only the summation order differs
FP32 = dict(atol=2e-5, rtol=2e-5)
# bf16: both sides round the output (and the decode path P) to bf16 at
# different points; outputs are O(1), a bf16 ulp there is <= 2**-7
BF16 = dict(atol=2e-2, rtol=2e-2)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _qkv(rng, b, s, nh, kvh, d):
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(b, s, nh, d), f(b, s, kvh, d), f(b, s, kvh, d)


def _pool_case(rng, b, kvh, g, d, bt, mb, lengths, s=1, cover=0):
    """Pool with a shuffled block table; entries past each row's live pages
    (covering ``lengths + cover`` positions) point at the trash page (the
    last page), filled with large garbage. q holds ``s`` positions."""
    nb = b * mb + 1
    trash = nb - 1
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q = f(b, s, kvh * g, d)
    kp, vp = f(nb, bt, kvh, d), f(nb, bt, kvh, d)
    kp[trash], vp[trash] = 1e4, -1e4
    perm = rng.permutation(nb - 1)
    tab = np.full((b, mb), trash, np.int32)
    for i, n in enumerate(lengths):
        live = -(-(n + cover) // bt)
        tab[i, :live] = perm[i * mb:i * mb + live]
    return q, kp, vp, tab, np.asarray(lengths, np.int32)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_ref_and_pallas(g, causal):
    rng = np.random.default_rng(10 + g)
    q, k, v = _qkv(rng, 2, 48, 2 * g, 2, 32)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jref.flash_attention(jq, jk, jv, causal=causal)
    pallas = pallas_flash(jq, jk, jv, causal=causal, interpret=True,
                          block_q=16, block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), **FP32)
    np.testing.assert_allclose(_np(got), _np(pallas), **FP32)


def test_flash_bf16_matches_jax_ref():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 40, 8, 2, 16)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = ref.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jref.flash_attention(jq, jk, jv)),
                               **BF16)


@pytest.mark.parametrize("bq,bk", [(16, 16), (24, 40)])
def test_chunked_flash_matches_jax_chunked(bq, bk):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 40, 4, 2, 16)
    for causal in (True, False):
        got = ref.chunked_flash_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
            block_q=bq, block_k=bk)
        want = jref.chunked_flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=causal, block_q=bq,
            block_k=bk)
        np.testing.assert_allclose(_np(got), _np(want), **FP32)
        np.testing.assert_allclose(
            _np(got), _np(ref.flash_attention(torch.tensor(q), torch.tensor(k),
                                              torch.tensor(v), causal=causal)),
            **FP32)


def test_cpu_dispatch_takes_chunked_path_for_long_sequences():
    """s * t > 2048**2 on the CPU goes through the chunked form, as
    ``repro.kernels.ops`` does off-TPU; results equal the dense form."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 2049, 1, 1, 16)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(
        _np(got), _np(ref.chunked_flash_attention(tq, tk, tv)), atol=0)
    np.testing.assert_allclose(_np(got),
                               _np(ref.flash_attention(tq, tk, tv)), **FP32)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvh,g,bt,lengths", [
    (1, 1, 8, [1, 17, 32, 9]),
    (2, 4, 8, [31, 1, 24]),
    (1, 4, 16, [48, 5]),
])
def test_paged_decode_matches_jax_ref_and_pallas(kvh, g, bt, lengths):
    rng = np.random.default_rng(20 + g + bt)
    q, kp, vp, tab, lens = _pool_case(rng, len(lengths), kvh, g, 32, bt,
                                      max(lengths) // bt + 1, lengths)
    got = ops.paged_decode_attention(*map(torch.tensor, (q, kp, vp, tab,
                                                         lens)))
    jargs = tuple(map(jnp.asarray, (q, kp, vp, tab, lens)))
    np.testing.assert_allclose(_np(got), _np(jref.paged_decode_attention(
        *jargs)), **FP32)
    np.testing.assert_allclose(_np(got), _np(pallas_paged(
        *jargs, interpret=True)), **FP32)


def test_paged_decode_bf16_matches_jax_ref():
    rng = np.random.default_rng(6)
    q, kp, vp, tab, lens = _pool_case(rng, 3, 1, 4, 16, 8, 5, [33, 2, 40])
    tq, tkp, tvp = (torch.tensor(a).to(torch.bfloat16) for a in (q, kp, vp))
    got = ref.paged_decode_attention(tq, tkp, tvp, torch.tensor(tab),
                                     torch.tensor(lens))
    want = jref.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tab), jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_gather_paged_kv_matches_jax():
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    tab = rng.permutation(9)[:8].reshape(2, 4).astype(np.int32)
    np.testing.assert_array_equal(
        ref.gather_paged_kv(torch.tensor(pool), torch.tensor(tab)).numpy(),
        np.asarray(jref.gather_paged_kv(jnp.asarray(pool), jnp.asarray(tab))))


def test_cpu_tensors_never_launch_kernels():
    rng = np.random.default_rng(8)
    counts = lambda: (tfa.launches, tpa.launches, tpa.verify_launches,
                      tda.launches)
    before = counts()
    q, k, v = _qkv(rng, 1, 8, 2, 1, 16)
    ops.flash_attention(*map(torch.tensor, (q, k, v)))
    case = _pool_case(rng, 2, 1, 2, 16, 4, 3, [5, 9])
    ops.paged_decode_attention(*map(torch.tensor, case))
    case = _pool_case(rng, 2, 1, 2, 16, 4, 4, [5, 9], s=3, cover=3)
    ops.paged_verify_attention(*map(torch.tensor, case))
    ops.decode_attention(torch.tensor(q[:, :1]), torch.tensor(k),
                         torch.tensor(v), torch.tensor([3], dtype=torch.int32))
    assert counts() == before


# ---------------------------------------------------------------------------
# dense decode attention and speculative verify attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvh,g,S,lengths", [
    (1, 4, 40, [1, 17, 40]),
    (2, 1, 32, [9, 32, 2, 20]),
])
def test_decode_matches_jax_ref_and_pallas(kvh, g, S, lengths):
    """Dense decode against a padded cache whose content past each row's
    length is large garbage; lengths >= 1, as the Pallas kernel needs, and
    S a multiple of its block_s (a ragged last tile reads out of bounds)."""
    rng = np.random.default_rng(40 + g)
    b = len(lengths)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v = f(b, 1, kvh * g, 32), f(b, S, kvh, 32), f(b, S, kvh, 32)
    for i, n in enumerate(lengths):
        k[i, n:], v[i, n:] = 1e4, -1e4
    lens = np.asarray(lengths, np.int32)
    got = ops.decode_attention(*map(torch.tensor, (q, k, v, lens)))
    jargs = tuple(map(jnp.asarray, (q, k, v, lens)))
    np.testing.assert_allclose(_np(got), _np(jref.decode_attention(*jargs)),
                               **FP32)
    np.testing.assert_allclose(_np(got), _np(pallas_decode(
        *jargs, interpret=True, block_s=8)), **FP32)


def test_decode_bf16_matches_jax_ref():
    rng = np.random.default_rng(41)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v = f(3, 1, 4, 16), f(3, 24, 1, 16), f(3, 24, 1, 16)
    lens = np.asarray([24, 3, 11], np.int32)
    got = ref.decode_attention(*(torch.tensor(a).to(torch.bfloat16)
                                 for a in (q, k, v)), torch.tensor(lens))
    want = jref.decode_attention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)), jnp.asarray(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("kvh,g,s,bt,lengths", [
    (2, 1, 3, 8, [1, 17, 30]),
    (1, 4, 5, 8, [7, 1, 26]),          # s * g = 20 query rows per kv head
])
def test_paged_verify_matches_jax_ref_and_pallas(kvh, g, s, bt, lengths):
    rng = np.random.default_rng(50 + g)
    q, kp, vp, tab, lens = _pool_case(rng, len(lengths), kvh, g, 32, bt,
                                      (max(lengths) + s) // bt + 1, lengths,
                                      s=s, cover=s)
    got = ops.paged_verify_attention(*map(torch.tensor,
                                          (q, kp, vp, tab, lens)))
    assert got.shape == q.shape
    jargs = tuple(map(jnp.asarray, (q, kp, vp, tab, lens)))
    np.testing.assert_allclose(_np(got), _np(jref.paged_verify_attention(
        *jargs)), **FP32)
    np.testing.assert_allclose(_np(got), _np(pallas_verify(
        *jargs, interpret=True)), **FP32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_verify_and_dense_equal_paged_decode_bitwise(dtype):
    """The two bitwise contracts on the plain path: verify position j ==
    paged decode at lengths + j + 1, and dense decode == paged decode on
    the same logical cache."""
    rng = np.random.default_rng(60)
    bt, mb, s = 8, 5, 4
    q, kp, vp, tab, lens = (torch.tensor(a) for a in _pool_case(
        rng, 3, 1, 4, 16, bt, mb, [0, 9, 35], s=s, cover=s))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    out = ops.paged_verify_attention(q, kp, vp, tab, lens)
    for j in range(s):
        assert torch.equal(out[:, j:j + 1], ops.paged_decode_attention(
            q[:, j:j + 1], kp, vp, tab, lens + j + 1)), j
    k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
    assert k.shape[1] == mb * bt
    assert torch.equal(ops.decode_attention(q[:, :1], k, v, lens + 2),
                       ops.paged_decode_attention(q[:, :1], kp, vp, tab,
                                                  lens + 2))


# ---------------------------------------------------------------------------
# the decode body's split over the sequence (csrc/decode_body.cuh): its
# width, and a torch emulation of split-then-merge against the plain versions
# ---------------------------------------------------------------------------

SPLIT = _build.DECODE_SPLIT
# across the split boundaries; verify's lengths + j + 1 (s = 5) cross one
# from SPLIT - 3; a dead length-0 row
STRADDLE = [SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 3, SPLIT - 3, 0]


def test_decode_split_width_is_mirrored_by_the_wrappers():
    """The split width in the CUDA header is a multiple of the 64-token
    chunk and equals the mirror that sizes the wrappers' scratch."""
    text = (_build.CSRC / "decode_body.cuh").read_text()
    (width,) = re.findall(r"^#define DECODE_SPLIT (\d+)$", text, re.M)
    (chunk,) = re.findall(r"constexpr int kChunk = (\d+);", text)
    assert int(chunk) == 64
    assert int(width) % 64 == 0 and int(width) == SPLIT
    rows, cap, d = 3 * 5 * 4, 2 * SPLIT + 1, 32
    scratch = _build.decode_scratch(rows, cap, d, "cpu")
    assert scratch.dtype == torch.float32
    assert scratch.numel() == rows * 3 * (d + 2)
    assert _build._target("decode_attention") != _build._target(
        "decode_attention", ("-DDECODE_SPLIT=128",))


def _split_partials(qr, k, v, length, len_max, scale):
    """One query row's per-split (m, l, acc) as the decode body computes
    them, fp32: split i starts from (-inf, 0, 0) and walks its 64-token
    chunks up to the block's longest row ``len_max`` (>= ``length``;
    tokens past it zero-filled) with an online softmax, masking positions
    >= ``length``. Only the splits that the row reaches are kept."""
    d = qr.shape[0]
    parts = []
    for s0 in range(0, length, SPLIT):
        m = torch.tensor(ref.NEG_INF)
        l, acc = torch.tensor(0.0), torch.zeros(d)
        for c0 in range(s0, min(s0 + SPLIT, len_max), 64):
            n = min(c0 + 64, len_max) - c0
            kc, vc = torch.zeros(64, d), torch.zeros(64, d)
            kc[:n], vc[:n] = k[c0:c0 + n], v[c0:c0 + n]
            sc = torch.where(torch.arange(c0, c0 + 64) < length,
                             (kc @ qr) * scale, torch.tensor(ref.NEG_INF))
            m_new = torch.maximum(m, sc.max())
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum()
            acc = acc * alpha + p @ vc
            m = m_new
        parts.append((m, l, acc))
    return parts


def _merge(parts, d):
    """The merge: splits in order, M = max m_i, sum acc_i·e^(m_i - M) over
    sum l_i·e^(m_i - M); no split gives zeros."""
    if not parts:
        return torch.zeros(d)
    big = max(m for m, _, _ in parts)
    o, l_sum = torch.zeros(d), torch.tensor(0.0)
    for m, l, acc in parts:
        w = torch.exp(m - big)
        o = o + acc * w
        l_sum = l_sum + l * w
    return o / l_sum


def _emulate(q, k, v, lengths, verify=False):
    """Split-then-merge over a dense logical cache k/v (b, S, kvh, d), fp32:
    q (b, s, nh, d); query row r = j·g + h of kv head kh sits in 16-row
    tile r // 16, whose longest row sets ``len_max``; position j attends to
    tokens < lengths + j + 1 (verify) or < lengths (decode, s = 1)."""
    b, s, nh, d = q.shape
    S, kvh = k.shape[1], k.shape[2]
    g = nh // kvh
    out = torch.zeros(b, s, nh, d)
    for bi in range(b):
        for kh in range(kvh):
            def len_of(r):
                j = r // g
                return max(min(int(lengths[bi]) + (j + 1 if verify else 0),
                               S), 0)
            for r in range(s * g):
                tile_end = min((r // 16 + 1) * 16, s * g)
                j, h = r // g, kh * g + r % g
                parts = _split_partials(q[bi, j, h], k[bi, :, kh],
                                        v[bi, :, kh], len_of(r),
                                        len_of(tile_end - 1), d ** -0.5)
                out[bi, j, h] = _merge(parts, d)
    return out


@pytest.mark.parametrize("kernel", ["paged_decode", "decode", "verify"])
def test_split_merge_emulation_matches_plain_versions(kernel):
    """At lengths straddling the split boundaries (and length 0), the split
    points and merge of the CUDA decode body compute what the plain
    versions compute, to fp32 summation order."""
    rng = np.random.default_rng(70)
    bt, s = 16, (5 if kernel == "verify" else 1)
    lengths = STRADDLE + [3 * SPLIT + 7]
    mb = (max(lengths) + s) // bt + 1
    q, kp, vp, tab, lens = (torch.tensor(a) for a in _pool_case(
        rng, len(lengths), 1, 4, 16, bt, mb, lengths, s=s,
        cover=s if s > 1 else 0))
    k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
    got = _emulate(q, k, v, lens, verify=kernel == "verify")
    if kernel == "verify":
        want = ref.paged_verify_attention(q, kp, vp, tab, lens)
    elif kernel == "paged_decode":
        want = ref.paged_decode_attention(q, kp, vp, tab, lens)
    else:
        want = ref.decode_attention(q, k, v, lens)
    live = [i for i, n in enumerate(lengths) if n > 0 or s > 1]
    np.testing.assert_allclose(_np(got[live]), _np(want[live]), **FP32)
    assert torch.equal(got[[i for i in range(len(lengths)) if i not in live]],
                       torch.zeros_like(got[:len(lengths) - len(live)]))


def test_split_merge_emulation_verify_equals_decode_exactly():
    """Verify position j == decode at lengths + j + 1, bit for bit in fp32:
    a tile's longer rows make a split walk chunks wholly past a shorter
    row's length, and those leave its (m, l, acc) exactly as they were."""
    rng = np.random.default_rng(71)
    bt, s = 16, 5
    lengths = STRADDLE + [2 * SPLIT - 2]
    mb = (max(lengths) + s) // bt + 1
    q, kp, vp, tab, lens = (torch.tensor(a) for a in _pool_case(
        rng, len(lengths), 1, 4, 16, bt, mb, lengths, s=s, cover=s))
    k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
    ver = _emulate(q, k, v, lens, verify=True)
    for j in range(s):
        assert torch.equal(ver[:, j:j + 1],
                           _emulate(q[:, j:j + 1], k, v, lens + j + 1)), j


# ---------------------------------------------------------------------------
# every wrapper launches with its tensors' device current
# ---------------------------------------------------------------------------

def test_wrappers_launch_under_their_tensors_device(monkeypatch):
    """Each kernel wrapper calls its C entry inside ``torch.cuda.device``
    of its first tensor's device and passes that device's current stream
    (``_build.launching``), so a kernel launches on whichever card holds its
    inputs. Checked on the CPU by patching the CUDA calls and the entries:
    nothing launches."""
    from repro_torch.kernels import paged_chunk_attention as tpca
    from repro_torch.kernels import pq_scan as tpq
    current: list = []
    streams: list = []

    class Scope:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    class Stream:
        def __init__(self, device):
            self.cuda_stream = 4242
            streams.append(device)

    calls: list = []

    def entry(*args):
        calls.append((list(current), args[-1]))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Scope)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for mod in (tfa, tda, tpa, tpca, tpq):
        monkeypatch.setattr(mod, "_entry", lambda *a: entry)
        monkeypatch.setattr(mod, "launches", mod.launches)
    monkeypatch.setattr(tpa, "verify_launches", tpa.verify_launches)

    rng = np.random.default_rng(2)
    bf = lambda *s: torch.tensor(rng.standard_normal(s),  # noqa: E731
                                 dtype=torch.bfloat16)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    q, k = bf(1, 4, 2, 16), bf(1, 4, 1, 16)
    pool, tab, lens = bf(5, 8, 1, 16), i32([[0, 1], [2, 3]]), i32([5, 9])
    codes = torch.tensor(rng.integers(0, 16, (33, 8)), dtype=torch.uint8)
    lut = torch.tensor(rng.standard_normal((8, 16)), dtype=torch.float32)
    runs = [
        lambda: tfa.flash_attention(q, k, k),
        lambda: tda.decode_attention(bf(2, 1, 2, 16), bf(2, 9, 1, 16),
                                     bf(2, 9, 1, 16), lens),
        lambda: tpa.paged_decode_attention(bf(2, 1, 2, 16), pool, pool, tab,
                                           lens),
        lambda: tpa.paged_verify_attention(bf(2, 3, 2, 16), pool, pool, tab,
                                           lens),
        lambda: tpca.paged_chunk_attention(bf(2, 4, 2, 16), pool, pool, tab,
                                           lens),
        lambda: tpq.pq_scan(codes, lut),
    ]
    for run in runs:
        run()
        assert calls[-1] == ([torch.device("cpu")], 4242)
        assert streams[-1] == torch.device("cpu") and current == []
    assert len(calls) == len(runs)

    def plan_entry(*args):
        calls.append((list(current), None))
        return 0
    tpq.plan(codes, lut, lib=type("Lib", (), {"pq_scan_plan": plan_entry}))
    assert calls[-1] == ([torch.device("cpu")], None)
