// One-token decode attention against a contiguous padded KV cache, bf16 in
// and out, fp32 online-softmax state. Hopper (sm_90a), plain C interface
// for ctypes. Runs the shared decode body of decode_body.cuh: a split
// kernel and the merge behind it, from one C entry point.
//
// Replaces: src/repro/kernels/decode_attention.py, `decode_attention` and
// its Pallas body `_decode_kernel`. The TPU kernel tiles the padded cache
// in block_s = 512 tiles on the sequential minor grid axis and skips tiles
// past `lengths`. Here the grid is (batch row, kv head, split), with
// ceil(S / kSplit) splits a row; a block whose split starts at or past
// min(lengths, S) exits at once and tokens past it are never read, so the
// padding and stale content of a slot cache cost nothing, and a length-0
// row (a never-used slot) merges no split and gives a row of zeros.
//
// What bounds it on the H100: bytes, as for paged decode: K and V of the
// live tokens are read once, against ~2·g flops per byte, and the split
// puts a block on every kSplit live tokens so that the card has the bytes
// in flight. The design is the paged decode kernel's with the token row
// taken from `cache + (bi·S + p)·kvh + kh` instead of the block table, so
// the g query heads of a kv head share each chunk through one 16-row mma
// tile, and dense decode gives the same bits as paged decode on the same
// logical cache: the same split points, chunks and merge (decode_body.cuh).
#include "decode_body.cuh"

using namespace repro_attn;

namespace {

template <bool kHalf>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
    const bf16* __restrict__ v_cache, const int* __restrict__ lengths,
    float* __restrict__ part_acc, float2* __restrict__ part_ml, int S,
    int nh, int kvh, int d, int nsplit, float scale) {
  const int bi = blockIdx.x, kh = blockIdx.y;
  const int g = nh / kvh;
  const int len = min(lengths[bi], S);
  const int row0 = bi * nh + kh * g;
  const long tok0 = (long)bi * S;
  decode_split_block<kHalf>(
      q, k_cache, v_cache, part_acc, part_ml, d, g, blockIdx.z, nsplit, S,
      len,
      [=](int i) { return row0 + i; }, [=](int) { return len; },
      [=](int p) { return (tok0 + p) * kvh + kh; }, scale);
}

}  // namespace

// Dynamic shared memory of one split block at head dim d.
extern "C" int decode_attention_smem_bytes(int d) {
  return decode_smem_bytes(d);
}

// q (b, 1, nh, d); k_cache/v_cache (b, S, kvh, d); lengths (b,) int32 (may
// exceed S: read as S); out (b, 1, nh, d). bf16, contiguous; d % 8 == 0,
// d <= 256, nh / kvh <= 16 (the Python wrapper checks). scratch:
// b·nh·n_splits(S)·(d + 2) fp32. lse: null, or (b, nh) fp32 that the merge
// fills with each row's log-sum-exp of its scaled scores (-inf for a
// length-0 row); `out` is the same either way. Launches the split kernel
// and the merge; returns the CUDA error (0 = cudaSuccess). Every offset
// into the caches and the scratch is 64-bit: at b = 1, S x kvh x d may
// come within a few percent of 2^31 (a 512k-token cache of 32 kv heads at
// d = 112 is 1.88e9 elements).
extern "C" int decode_attention_bf16(const void* q, const void* k_cache,
                                     const void* v_cache, const void* lengths,
                                     void* out, void* scratch, int b, int S,
                                     int nh, int kvh, int d, float scale,
                                     void* lse, void* stream) {
  const int smem = decode_smem_bytes(d);
  const bool half = d % 16 != 0;  // Q K^T ends on a half k16 step
  const auto kernel = half ? decode_kernel<true> : decode_kernel<false>;
  static int granted[2][repro_dev::kMaxDevices] = {};
  if (int err = repro_dev::grant_smem(kernel, smem, granted[half]))
    return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nsplit = n_splits(S);
  const long rows = (long)b * nh;
  float* acc = static_cast<float*>(scratch);
  float2* ml = part_ml_of(scratch, rows, nsplit, d);
  if (nsplit > 0) {
    kernel<<<dim3(b, kvh, nsplit), kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
        (const int*)lengths, acc, ml, S, nh, kvh, d, nsplit, scale);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return launch_merge(acc, ml, (const int*)lengths, (bf16*)out, rows, 1, nh,
                      d, nsplit, S, 0, st, static_cast<float*>(lse));
}
