// Decode and speculative-verify attention over a paged KV pool, bf16 in and
// out, fp32 online-softmax state. Hopper (sm_90a), plain C interface for
// ctypes. Both run the shared decode body of decode_body.cuh.
//
// Replaces: src/repro/kernels/paged_attention.py, `paged_decode_attention`
// (Pallas body `_paged_decode_kernel`) and `paged_verify_attention` (body
// `_paged_verify_kernel`). The TPU kernels prefetch the block table as
// scalars and walk the pages on the sequential minor grid axis. Here one
// thread block owns one (batch row, kv head) -- and for verify one tile of
// 16 of its s·g query rows -- reads its own page ids from the block table,
// and loops over the live tokens 64 at a time; tokens past the block's
// longest row are never read, so dead-row tables that point at the trash
// page (and rows with length 0) are safe.
//
// What bounds them on the H100: bytes. Each step reads K and V once,
// 2 · Σ lengths · kvh · d · 2 B per layer, against ~2·g flops per byte (s·g
// for verify), far below the ~295 operations per byte where the tensor
// cores would limit. The design issues every 16-byte load of a 64-token K/V
// chunk at once with cp.async (64 KB in flight per block at d = 256),
// gathering token rows through the block table, and runs up to 16 query
// rows of the kv head together through `mma.sync.m16n8k16`, so each page is
// read once for all of them (verify at g = 8, s = 5 has 40 rows: three
// tiles, three blocks, each reading the pages again, mostly from L2). With
// no split over the sequence (kept out on purpose: a split changes the
// reduction order the bitwise contracts rest on), the grid is only
// b · kvh (· tiles) blocks, so at small batch most SMs idle and the kernels
// stay well under the card's memory rate.
//
// Numerics: the reference normalises before rounding P to bf16 and these
// kernels after, so kernel and reference agree to bf16 rounding, not
// bitwise. Verify position j and paged decode at lengths + j + 1 agree
// bitwise (decode_body.cuh).
#include "decode_body.cuh"

using namespace repro_attn;

namespace {

__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, bf16* __restrict__ out, int nh, int kvh,
    int d, int bt, int mb, float scale) {
  const int bi = blockIdx.x, kh = blockIdx.y;
  const int g = nh / kvh;
  const int len = min(lengths[bi], mb * bt);
  const int* tab = tables + (long)bi * mb;
  const long q0 = ((long)bi * nh + (long)kh * g) * d;
  decode_block(
      q, k_pool, v_pool, out, d, g, len,
      [=](int i) { return q0 + (long)i * d; }, [=](int) { return len; },
      [=](int p) { return ((long)tab[p / bt] * bt + p % bt) * kvh + kh; },
      scale);
}

// Row r of the flattened (position-major) s·g query rows of a kv head is
// draft position j = r / g, query head kh·g + r % g; it attends to pooled
// positions < lengths + j + 1.
__global__ void __launch_bounds__(kWarps * 32) paged_verify_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, bf16* __restrict__ out, int s, int nh,
    int kvh, int d, int bt, int mb, float scale) {
  const int bi = blockIdx.x, kh = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int g = nh / kvh;
  const int n_valid = min(kRows, s * g - r0);
  const int cap = mb * bt;
  const int base = lengths[bi];
  const int len_max = min(base + (r0 + n_valid - 1) / g + 1, cap);
  const int* tab = tables + (long)bi * mb;
  decode_block(
      q, k_pool, v_pool, out, d, n_valid, len_max,
      [=](int i) {
        const int r = r0 + i, j = r / g;
        return (((long)bi * s + j) * nh + (long)kh * g + (r - j * g)) * d;
      },
      [=](int i) { return min(base + (r0 + i) / g + 1, cap); },
      [=](int p) { return ((long)tab[p / bt] * bt + p % bt) * kvh + kh; },
      scale);
}

}  // namespace

// Dynamic shared memory of one block at head dim d (both kernels).
extern "C" int paged_decode_attention_smem_bytes(int d) {
  return decode_smem_bytes(d);
}

// q (b, 1, nh, d); k_pool/v_pool (num_pages, bt, kvh, d); tables (b, mb) int32
// (every entry a valid page); lengths (b,) int32; out (b, 1, nh, d). bf16,
// contiguous; d % 16 == 0, d <= 256, nh / kvh <= 16 (the Python wrapper
// checks). Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool,
                                           const void* tables,
                                           const void* lengths, void* out,
                                           int b, int nh, int kvh, int d,
                                           int bt, int mb, float scale,
                                           void* stream) {
  const int smem = decode_smem_bytes(d);
  static int granted = 0;
  if (int err = grant_smem(paged_decode_kernel, smem, &granted)) return err;
  dim3 grid(b, kvh);
  paged_decode_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
      (const int*)tables, (const int*)lengths, (bf16*)out, nh, kvh, d, bt, mb,
      scale);
  return (int)cudaGetLastError();
}

// q (b, s, nh, d), the s = spec_k + 1 feed positions of each row; pools,
// tables and lengths as for decode; out (b, s, nh, d). Same checks.
extern "C" int paged_verify_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool,
                                           const void* tables,
                                           const void* lengths, void* out,
                                           int b, int s, int nh, int kvh,
                                           int d, int bt, int mb, float scale,
                                           void* stream) {
  const int smem = decode_smem_bytes(d);
  static int granted = 0;
  if (int err = grant_smem(paged_verify_kernel, smem, &granted)) return err;
  const int g = nh / kvh;
  dim3 grid(b, kvh, (s * g + kRows - 1) / kRows);
  paged_verify_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
      (const int*)tables, (const int*)lengths, (bf16*)out, s, nh, kvh, d, bt,
      mb, scale);
  return (int)cudaGetLastError();
}
