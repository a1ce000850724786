"""PyTorch port, kernels: the plain PyTorch versions against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode on the same
numpy inputs. The CUDA kernels are held against the plain versions on the
card in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_attention import \
    paged_decode_attention as pallas_paged
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


def _pool_case(rng, b, kvh, g, d, bt, mb, lengths):
    """Pool with a shuffled block table; entries past each row's live pages
    point at the trash page (the last page), filled with large garbage."""
    nb = b * mb + 1
    trash = nb - 1
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q = f(b, 1, kvh * g, d)
    kp, vp = f(nb, bt, kvh, d), f(nb, bt, kvh, d)
    kp[trash], vp[trash] = 1e4, -1e4
    perm = rng.permutation(nb - 1)
    tab = np.full((b, mb), trash, np.int32)
    for i, n in enumerate(lengths):
        live = -(-n // bt)
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
    before = (tfa.launches, tpa.launches)
    q, k, v = _qkv(rng, 1, 8, 2, 1, 16)
    ops.flash_attention(*map(torch.tensor, (q, k, v)))
    case = _pool_case(rng, 2, 1, 2, 16, 4, 3, [5, 9])
    ops.paged_decode_attention(*map(torch.tensor, case))
    assert (tfa.launches, tpa.launches) == before
