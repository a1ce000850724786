"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the engine's main path through both kernels.

Every test here needs an NVIDIA card and carries the ``cuda`` marker; it
skips (in a fixture) without one. The file imports neither JAX nor
``repro``, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import gemma_2b
from repro_torch.engine.core import Engine
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


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)                 # fp32
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    qb = torch.zeros(1, 8, 2, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                           # d % 16 != 0
        ops.flash_attention(qb, qb[:, :, :1], qb[:, :, :1])


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
