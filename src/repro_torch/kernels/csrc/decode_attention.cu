// One-token decode attention against a contiguous padded KV cache, bf16 in
// and out, fp32 online-softmax state. Hopper (sm_90a), plain C interface
// for ctypes. Runs the shared decode body of decode_body.cuh.
//
// Replaces: src/repro/kernels/decode_attention.py, `decode_attention` and
// its Pallas body `_decode_kernel`. The TPU kernel tiles the padded cache
// in block_s = 512 tiles on the sequential minor grid axis and skips tiles
// past `lengths`. Here one thread block owns one (batch row, kv head) and
// loops over that row's live tokens 64 at a time; rows at or past
// min(lengths, S) are never read, so the padding and stale content of a
// slot cache cost nothing and a length-0 row (a never-used slot) gives a
// finite row of zeros.
//
// What bounds it on the H100: bytes, as for paged decode: K and V of the
// live tokens are read once, against ~2·g flops per byte. The design is the
// paged decode kernel's with the token row taken from
// `cache + (bi·S + p)·kvh + kh` instead of the block table, so the g query
// heads of a kv head share each chunk through one 16-row mma tile, and
// dense decode gives the same bits as paged decode on the same logical
// cache (decode_body.cuh). No split over the sequence, so the grid is
// b · kvh blocks and at small batch most SMs idle.
#include "decode_body.cuh"

using namespace repro_attn;

namespace {

__global__ void __launch_bounds__(kWarps * 32) decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
    const bf16* __restrict__ v_cache, const int* __restrict__ lengths,
    bf16* __restrict__ out, int S, int nh, int kvh, int d, float scale) {
  const int bi = blockIdx.x, kh = blockIdx.y;
  const int g = nh / kvh;
  const int len = min(lengths[bi], S);
  const long q0 = ((long)bi * nh + (long)kh * g) * d;
  const long row0 = (long)bi * S;
  decode_block(
      q, k_cache, v_cache, out, d, g, len,
      [=](int i) { return q0 + (long)i * d; }, [=](int) { return len; },
      [=](int p) { return (row0 + p) * kvh + kh; }, scale);
}

}  // namespace

// Dynamic shared memory of one block at head dim d.
extern "C" int decode_attention_smem_bytes(int d) {
  return decode_smem_bytes(d);
}

// q (b, 1, nh, d); k_cache/v_cache (b, S, kvh, d); lengths (b,) int32 (may
// exceed S: read as S); out (b, 1, nh, d). bf16, contiguous; d % 16 == 0,
// d <= 256, nh / kvh <= 16 (the Python wrapper checks). Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int decode_attention_bf16(const void* q, const void* k_cache,
                                     const void* v_cache, const void* lengths,
                                     void* out, int b, int S, int nh, int kvh,
                                     int d, float scale, void* stream) {
  const int smem = decode_smem_bytes(d);
  static int granted = 0;
  if (int err = grant_smem(decode_kernel, smem, &granted)) return err;
  dim3 grid(b, kvh);
  decode_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
      (const int*)lengths, (bf16*)out, S, nh, kvh, d, scale);
  return (int)cudaGetLastError();
}
