// Decode and speculative-verify attention over a paged KV pool, bf16 in and
// out, fp32 online-softmax state. Hopper (sm_90a), plain C interface for
// ctypes. Both run the shared decode body of decode_body.cuh: a split
// kernel and the merge behind it, from one C entry point.
//
// Replaces: src/repro/kernels/paged_attention.py, `paged_decode_attention`
// (Pallas body `_paged_decode_kernel`) and `paged_verify_attention` (body
// `_paged_verify_kernel`). The TPU kernels prefetch the block table as
// scalars and walk the pages on the sequential minor grid axis. Here the
// grid is (batch row, kv head, split) -- for verify (row, kv head, tile of
// 16 of its s·g query rows x split) -- with ceil(mb·bt / kSplit) splits a
// row; each block looks up the page ids of its own split's tokens once, and
// tokens past the block's longest row are never read, so dead-row tables
// that point at the trash page (and rows with length 0) are safe. The merge
// sums each output row's splits in order.
//
// What bounds them on the H100: bytes. Each step reads K and V once,
// 2 · Σ lengths · kvh · d · 2 B per layer, against ~2·g flops per byte (s·g
// for verify), far below the ~295 operations per byte where the tensor
// cores would limit. What a decode step lacks is bytes in flight across the
// card: one block per (row, kv head) left most of the 132 SMs idle at small
// batch, each walking its row 64 tokens at a time. The split puts one block
// on every kSplit tokens of every row, so a batch of 8 rows of up to 2048
// tokens fills the card in one wave, each block with its K/V chunks (64 KB
// at d = 256) in flight through cp.async, gathering token rows through the
// block table, and up to 16 query rows of the kv head run together through
// `mma.sync.m16n8k16`, so each page is read once for all of them (verify at
// g = 8, s = 5 has 40 rows: three tiles, each reading the pages again,
// mostly from L2). `mma.sync`, not `wgmma`: a tile has 8 query rows (40 for
// verify), under wgmma's 64, and the tensor cores are not what bounds it.
//
// Numerics: the reference normalises before rounding P to bf16 and these
// kernels after, so kernel and reference agree to bf16 rounding, not
// bitwise. Verify position j and paged decode at lengths + j + 1 agree
// bitwise: the same split points, chunks and merge for every row of the
// same length (decode_body.cuh).
#include "decode_body.cuh"

using namespace repro_attn;

namespace {

template <bool kHalf>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int nh, int kvh, int d, int bt, int mb,
    int nsplit, float scale) {
  const int bi = blockIdx.x, kh = blockIdx.y;
  const int g = nh / kvh;
  const int len = min(lengths[bi], mb * bt);
  const int* tab = tables + (long)bi * mb;
  const int row0 = bi * nh + kh * g;
  decode_split_block<kHalf>(
      q, k_pool, v_pool, part_acc, part_ml, d, g, blockIdx.z, nsplit, mb * bt,
      len,
      [=](int i) { return row0 + i; }, [=](int) { return len; },
      [=](int p) { return ((long)tab[p / bt] * bt + p % bt) * kvh + kh; },
      scale);
}

// Row r of the flattened (position-major) s·g query rows of a kv head is
// draft position j = r / g, query head kh·g + r % g; it attends to pooled
// positions < lengths + j + 1. Grid axis z is tile · nsplit + split.
template <bool kHalf>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int s, int nh, int kvh, int d, int bt,
    int mb, int nsplit, float scale) {
  const int bi = blockIdx.x, kh = blockIdx.y;
  const int tile = blockIdx.z / nsplit;
  const int r0 = tile * kRows;
  const int g = nh / kvh;
  const int n_valid = min(kRows, s * g - r0);
  const int cap = mb * bt;
  const int base = lengths[bi];
  const int len_max = min(base + (r0 + n_valid - 1) / g + 1, cap);
  const int* tab = tables + (long)bi * mb;
  decode_split_block<kHalf>(
      q, k_pool, v_pool, part_acc, part_ml, d, n_valid,
      blockIdx.z - tile * nsplit, nsplit, cap, len_max,
      [=](int i) {
        const int r = r0 + i, j = r / g;
        return (bi * s + j) * nh + kh * g + (r - j * g);
      },
      [=](int i) { return min(base + (r0 + i) / g + 1, cap); },
      [=](int p) { return ((long)tab[p / bt] * bt + p % bt) * kvh + kh; },
      scale);
}

}  // namespace

// Dynamic shared memory of one split block at head dim d (both kernels).
extern "C" int paged_decode_attention_smem_bytes(int d) {
  return decode_smem_bytes(d);
}

// q (b, 1, nh, d); k_pool/v_pool (num_pages, bt, kvh, d); tables (b, mb) int32
// (every entry a valid page); lengths (b,) int32; out (b, 1, nh, d). bf16,
// contiguous; d % 8 == 0, d <= 256, nh / kvh <= 16 (the Python wrapper
// checks). scratch: b·nh·n_splits(mb·bt)·(d + 2) fp32. Launches the split
// kernel and the merge; returns the CUDA error (0 = cudaSuccess).
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool,
                                           const void* tables,
                                           const void* lengths, void* out,
                                           void* scratch, int b, int nh,
                                           int kvh, int d, int bt, int mb,
                                           float scale, void* stream) {
  const int smem = decode_smem_bytes(d);
  const bool half = d % 16 != 0;  // Q K^T ends on a half k16 step
  const auto kernel = half ? paged_decode_kernel<true>
                            : paged_decode_kernel<false>;
  static int granted[2][repro_dev::kMaxDevices] = {};
  if (int err = repro_dev::grant_smem(kernel, smem, granted[half]))
    return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nsplit = n_splits(mb * bt);
  const long rows = (long)b * nh;
  float* acc = static_cast<float*>(scratch);
  float2* ml = part_ml_of(scratch, rows, nsplit, d);
  if (nsplit > 0) {
    kernel<<<dim3(b, kvh, nsplit), kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
        (const int*)tables, (const int*)lengths, acc, ml, nh, kvh, d, bt, mb,
        nsplit, scale);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return launch_merge(acc, ml, (const int*)lengths, (bf16*)out, rows, 1, nh,
                      d, nsplit, mb * bt, 0, st);
}

// q (b, s, nh, d), the s = spec_k + 1 feed positions of each row; pools,
// tables and lengths as for decode; out (b, s, nh, d); scratch
// b·s·nh·n_splits(mb·bt)·(d + 2) fp32. Same checks.
extern "C" int paged_verify_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool,
                                           const void* tables,
                                           const void* lengths, void* out,
                                           void* scratch, int b, int s,
                                           int nh, int kvh, int d, int bt,
                                           int mb, float scale,
                                           void* stream) {
  const int smem = decode_smem_bytes(d);
  const bool half = d % 16 != 0;  // Q K^T ends on a half k16 step
  const auto kernel = half ? paged_verify_kernel<true>
                            : paged_verify_kernel<false>;
  static int granted[2][repro_dev::kMaxDevices] = {};
  if (int err = repro_dev::grant_smem(kernel, smem, granted[half]))
    return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int g = nh / kvh;
  const int tiles = (s * g + kRows - 1) / kRows;
  const int nsplit = n_splits(mb * bt);
  const long rows = (long)b * s * nh;
  float* acc = static_cast<float*>(scratch);
  float2* ml = part_ml_of(scratch, rows, nsplit, d);
  if (nsplit > 0) {
    kernel<<<dim3(b, kvh, tiles * nsplit), kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
        (const int*)tables, (const int*)lengths, acc, ml, s, nh, kvh, d, bt,
        mb, nsplit, scale);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return launch_merge(acc, ml, (const int*)lengths, (bf16*)out, rows, s, nh,
                      d, nsplit, mb * bt, 1, st);
}
