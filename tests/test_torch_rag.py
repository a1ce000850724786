"""PyTorch port, RAG retrieval: the plain IVF-PQ scan against the JAX
oracle (``repro.kernels.ref.pq_scan``) and the Pallas kernel in interpret
mode on the same numpy inputs, the launch entry point against the JAX
example's computation, and the copied ``IVFPQConfig``. The CUDA kernel is
held against the plain version on the card in ``test_torch_cuda.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pq_scan import pq_scan as pallas_pq_scan
from repro.perfmodel import rag_model as jrag
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import pq_scan as tpq
from repro_torch.kernels import ref
from repro_torch.launch import rag
from repro_torch.perfmodel import rag_model

# fp32 on both sides, only the summation order differs (tests/test_kernels.py)
FP32 = dict(atol=1e-4, rtol=1e-5)


def _case(seed, n, m, k, dtype):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(dtype)
    lut = rng.standard_normal((m, k)).astype(np.float32)
    return codes, lut


@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
@pytest.mark.parametrize("N,M,K,block", [
    (1000, 16, 256, 256),
    (4096, 8, 256, 1024),
    (513, 32, 64, 128),
])
def test_plain_pq_scan_matches_jax_ref_and_pallas(N, M, K, block, dtype):
    codes, lut = _case(40, N, M, K, dtype)
    got = ref.pq_scan(torch.from_numpy(codes), torch.from_numpy(lut))
    assert got.dtype == torch.float32 and got.shape == (N,)
    want_ref = jref.pq_scan(jnp.asarray(codes), jnp.asarray(lut))
    want_pallas = pallas_pq_scan(jnp.asarray(codes), jnp.asarray(lut),
                                 interpret=True, block_n=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **FP32)


@pytest.mark.parametrize("dtype,K,bad", [
    (np.int32, 64, [-1, 64, 2 ** 30, -2 ** 31]),
    (np.uint8, 64, [64, 200, 255]),
])
def test_out_of_range_codes_add_zero_as_in_pallas(dtype, K, bad):
    """A code outside [0, K) adds exactly 0 in the Pallas kernel (its
    one-hot compare matches no column). The JAX reference differs there:
    take_along_axis gives NaN at or past K and wraps a negative code, so
    the port follows the kernel, not the reference."""
    n, m = 300, 8
    codes, lut = _case(41, n, m, K, dtype)
    rng = np.random.default_rng(42)
    hit = rng.random((n, m)) < 0.3
    codes[hit] = rng.choice(np.asarray(bad, dtype), int(hit.sum()))
    got = ref.pq_scan(torch.from_numpy(codes), torch.from_numpy(lut))
    want = pallas_pq_scan(jnp.asarray(codes), jnp.asarray(lut),
                          interpret=True, block_n=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    inside = codes.astype(np.int64)
    keep = (inside >= 0) & (inside < K)
    exact = np.where(keep, lut[np.arange(m), np.clip(inside, 0, K - 1)],
                     0).sum(-1, dtype=np.float64)
    np.testing.assert_allclose(got.numpy(), exact, **FP32)


def test_ops_casts_other_integer_codes_to_int32():
    codes, lut = _case(43, 700, 16, 256, np.int32)
    c32 = torch.from_numpy(codes)
    lut_t = torch.from_numpy(lut)
    want = ops.pq_scan(c32, lut_t)
    assert torch.equal(ops.pq_scan(c32.long(), lut_t), want)
    assert torch.equal(ops.pq_scan(c32.to(torch.int16), lut_t.double()),
                       want)
    assert torch.equal(ops.pq_scan(c32.to(torch.uint8), lut_t), want)
    with pytest.raises(ValueError, match="integer codes"):
        ops.pq_scan(c32.float(), lut_t)


@pytest.mark.parametrize("codes", ["int32", "uint8"])
def test_launch_rag_gives_the_jax_example_top5(codes):
    """The live half of examples/rag_pipeline.py at its seed and sizes:
    ``repro.kernels.ops.pq_scan`` then ``np.argsort``."""
    rng = np.random.default_rng(0)
    N, M, K = 200_000, 16, 256
    c = rng.integers(0, K, (N, M)).astype(np.int32)
    lut = rng.random((M, K)).astype(np.float32)
    dist = np.asarray(jops.pq_scan(jnp.asarray(c), jnp.asarray(lut)))
    want = np.argsort(dist)[:5].tolist()
    assert rag.main(["--device", "cpu", "--codes", codes]) == want


def test_launch_rag_make_inputs_follow_the_example_order():
    codes, lut = rag.make_inputs(50, 4, 16, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(codes.numpy(),
                                  rng.integers(0, 16, (50, 4)))
    np.testing.assert_array_equal(lut.numpy(),
                                  rng.random((4, 16)).astype(np.float32))
    assert codes.dtype == torch.int32
    c8, _ = rag.make_inputs(50, 4, 16, seed=3, codes="uint8", device="cpu")
    assert c8.dtype == torch.uint8 and torch.equal(c8.int(), codes)
    with pytest.raises(ValueError):
        rag.make_inputs(5, 4, 300, seed=3, codes="uint8", device="cpu")


def test_ivfpq_config_is_a_field_for_field_copy():
    ours, theirs = rag_model.IVFPQConfig(), jrag.IVFPQConfig()
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(theirs)])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_kernel_wrapper_refuses_before_it_builds(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    codes = torch.zeros(8, 16, dtype=torch.int32)
    lut = torch.zeros(16, 256)
    n0 = tpq.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpq.pq_scan(codes, lut)                                  # on the CPU
    with pytest.raises(ValueError, match="uint8 or int32"):
        tpq.pq_scan(codes.float(), lut)
    with pytest.raises(ValueError, match="fp32 lut"):
        tpq.pq_scan(codes, lut.double())
    with pytest.raises(ValueError, match="shared memory"):
        tpq.pq_scan(torch.zeros(8, 228, dtype=torch.int32),
                    torch.zeros(228, 256))
    with pytest.raises(ValueError, match="shapes"):
        tpq.pq_scan(codes[:0], lut)                              # N = 0
    assert tpq.launches == n0


# --- the in-order contract of the CUDA kernel, and its launch plan --------

@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
@pytest.mark.parametrize("N,M,K,block", [
    (1000, 16, 256, 256),
    (4096, 8, 256, 1024),
    (513, 32, 64, 128),
])
def test_in_order_plain_version_matches_jax_ref_and_pallas(N, M, K, block,
                                                           dtype):
    """The kernel's bitwise contract, ``ref.pq_scan_in_order``, against
    ``ref.pq_scan``, the JAX reference and the Pallas kernel at the JAX
    test's shapes and tolerance."""
    codes, lut = _case(44, N, M, K, dtype)
    c, l = torch.from_numpy(codes), torch.from_numpy(lut)
    got = ref.pq_scan_in_order(c, l)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), ref.pq_scan(c, l).numpy(),
                               **FP32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.pq_scan(jnp.asarray(codes),
                                             jnp.asarray(lut))), **FP32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_pq_scan(
            jnp.asarray(codes), jnp.asarray(lut), interpret=True,
            block_n=block)), **FP32)


@pytest.mark.parametrize("dtype,K,bad", [
    (np.int32, 64, [-1, 64, 2 ** 30, -2 ** 31]),
    (np.uint8, 64, [64, 200, 255]),
])
def test_in_order_out_of_range_codes_add_zero_as_in_pallas(dtype, K, bad):
    n, m = 300, 8
    codes, lut = _case(45, n, m, K, dtype)
    rng = np.random.default_rng(46)
    hit = rng.random((n, m)) < 0.3
    codes[hit] = rng.choice(np.asarray(bad, dtype), int(hit.sum()))
    codes[0] = bad[0]                              # a row with no code in range
    c, l = torch.from_numpy(codes), torch.from_numpy(lut)
    got = ref.pq_scan_in_order(c, l)
    assert float(got[0]) == 0.0
    want = pallas_pq_scan(jnp.asarray(codes), jnp.asarray(lut),
                          interpret=True, block_n=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(got.numpy(), ref.pq_scan(c, l).numpy(),
                               **FP32)


def test_in_order_plain_version_adds_in_order_and_masks_nan():
    """Row by row: ((0 + lut[0, c0]) + lut[1, c1]) + ..., in fp32; a NaN in
    a LUT column that only out-of-range codes reach (through the clamp)
    stays out, one that an in-range code reads comes in."""
    lut = np.zeros((3, 4), np.float32)
    lut[:, 0] = [1e8, 1.0, -1e8]     # in order 0; summed otherwise often 1
    lut[:, 3] = np.nan
    codes = np.array([[0, 0, 0], [9, 0, -1], [0, 3, 0]], np.int32)
    got = ref.pq_scan_in_order(torch.from_numpy(codes), torch.from_numpy(lut))
    acc = np.zeros(3, np.float32)
    for j in range(3):
        c = codes[:, j]
        inside = (c >= 0) & (c < 4)
        acc = acc + np.where(inside, lut[j, np.clip(c, 0, 3)],
                             np.float32(0))
    assert got[0] == 0.0 and got[1] == 1.0 and np.isnan(got[2].item())
    np.testing.assert_array_equal(got.numpy(), acc)


def _dealt_batches(batches, grid):
    """The batch indices the blocks of ``pq_scan.cu`` walk: block b takes
    ``mine`` of them, its i-th starting at row (i * grid + b) * batch."""
    mine = (batches - np.arange(grid) + grid - 1) // grid
    block = np.repeat(np.arange(grid), mine)
    turn = np.arange(mine.sum()) - np.repeat(np.cumsum(mine) - mine, mine)
    return turn * grid + block


def _rows_in_batch(start, n, threads, per_thread):
    """The rows the threads take in the batch at ``start``: thread t its
    rows start + j * threads + t, j < per_thread, if below n."""
    rows = start + (np.arange(per_thread)[:, None] * threads
                    + np.arange(threads)[None, :]).ravel()
    return rows[rows < n]


@pytest.mark.parametrize("grid", [1, 132, 528, "batches"])
@pytest.mark.parametrize("threads,per_thread", [(256, 1), (256, 4),
                                                (1024, 1)])
@pytest.mark.parametrize("n", [1, 31, 513, 250_000, 2 ** 28])
def test_kernel_deals_every_row_once(n, threads, per_thread, grid):
    """The kernel's batches, dealt to a grid of at most one block a batch
    (the C entry caps it so), cover rows 0 … n-1 exactly once, whatever
    the grid: each batch index is walked once, a full batch covers its
    rows once and the last, short one stops at n. The row-by-row path's
    grid-stride loop is the case of one row a thread."""
    batch = threads * per_thread
    batches = -(-n // batch)
    grid = batches if grid == "batches" else min(grid, batches)
    walked = _dealt_batches(batches, grid)
    np.testing.assert_array_equal(np.sort(walked), np.arange(batches))
    for b in {0, batches - 1}:
        rows = _rows_in_batch(b * batch, n, threads, per_thread)
        want = np.arange(b * batch, min(n, (b + 1) * batch))
        assert rows.size == want.size
        np.testing.assert_array_equal(np.sort(rows), want)
