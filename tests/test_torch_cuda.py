"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, the two bitwise contracts between the decode-shaped kernels, and
the engines' paths through the kernels (paged, dense slot, speculative).

Every test here needs an NVIDIA card and carries the ``cuda`` marker; it
skips (in a fixture) without one. The file imports neither JAX nor
``repro``, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import gemma_2b, guard_2b
from repro_torch.engine.core import Engine, EngineConfig, SlotEngine
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

# bf16 outputs of O(1); kernel and plain version round P and the output at
# different points. Each output row (query position, head) must also agree
# to ROW_RTOL of its norm: a long row averages many values, so its entries
# are far below the elementwise atol.
BF16 = dict(atol=2e-2, rtol=2e-2)
ROW_RTOL = 1e-2


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


@pytest.mark.parametrize("shape,causal", [
    ((1, 300, 8, 1, 256), True),
    ((2, 100, 4, 1, 16), True),
    ((2, 65, 4, 2, 64), False),
])
def test_flash_kernel_matches_plain(cuda, shape, causal):
    b, s, nh, kvh, d = shape
    rng = np.random.default_rng(30)
    q, k, v = (_bf16(rng, cuda, b, s, n, d) for n in (nh, kvh, kvh))
    n0 = tfa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1
    _assert_close(got, ref.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("d,g,bt,lengths", [
    (256, 8, 16, [2048, 1, 300, 17]),
    (16, 4, 8, [5, 37, 1]),
])
def test_paged_decode_kernel_matches_plain(cuda, d, g, bt, lengths):
    """Shuffled block table, trash-padded tails full of large garbage."""
    rng = np.random.default_rng(31)
    b, mb = len(lengths), max(lengths) // bt + 1
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
    _assert_close(got, ref.paged_decode_attention(q, kp, vp, tab, lens))


def _pool(rng, cuda, d, g, bt, lengths, s):
    """q (b, s, g, d), pools with a shuffled table covering the lengths + s
    positions verify reads per row, and a trash page (the last) of large
    garbage."""
    b = len(lengths)
    mb = (max(lengths) + s) // bt + 1
    nb = b * mb + 1
    q = _bf16(rng, cuda, b, s, g, d)
    kp, vp = _bf16(rng, cuda, nb, bt, 1, d), _bf16(rng, cuda, nb, bt, 1, d)
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
    assert torch.isfinite(got[b].float()).all()
    _assert_close(got[:b], ref.decode_attention(q, k, v, lens)[:b])


@pytest.mark.parametrize("d,g,s,bt,lengths", [
    (256, 8, 5, 16, [2043, 1, 300, 17]),   # 40 query rows: three tiles
    (16, 4, 5, 8, [0, 5, 37]),             # 20 rows; a dead length-0 row
])
def test_verify_kernel_matches_plain(cuda, d, g, s, bt, lengths):
    rng = np.random.default_rng(33)
    case = _pool(rng, cuda, d, g, bt, lengths, s=s)
    n0 = tpa.verify_launches
    got = ops.paged_verify_attention(*case)
    torch.cuda.synchronize()
    assert tpa.verify_launches == n0 + 1
    _assert_close(got, ref.paged_verify_attention(*case))


@pytest.mark.parametrize("d,g", [(256, 8), (16, 4)])
def test_decode_shaped_kernels_agree_bitwise(cuda, d, g):
    """verify position j == paged decode at lengths + j + 1, and dense
    decode == paged decode on the same logical cache, with torch.equal."""
    rng = np.random.default_rng(34)
    s, bt = 5, 16
    q, kp, vp, tab, lens = _pool(rng, cuda, d, g, bt, [700, 1, 130, 64],
                                 s=s)
    out = ops.paged_verify_attention(q, kp, vp, tab, lens)
    for j in range(s):
        dec = ops.paged_decode_attention(q[:, j:j + 1].contiguous(), kp, vp,
                                         tab, lens + j + 1)
        assert torch.equal(out[:, j:j + 1], dec), j
    k, v = ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab)
    q0 = q[:, :1].contiguous()
    assert torch.equal(ops.decode_attention(q0, k, v, lens + 3),
                       ops.paged_decode_attention(q0, kp, vp, tab, lens + 3))


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)                 # fp32
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    qb = torch.zeros(1, 8, 2, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                           # d % 16 != 0
        ops.flash_attention(qb, qb[:, :, :1], qb[:, :, :1])
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
