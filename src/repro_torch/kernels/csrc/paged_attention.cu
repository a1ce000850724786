// One-token decode attention over a paged KV pool, bf16 in and out, fp32
// online-softmax state. Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/paged_attention.py, `paged_decode_attention`
// and its Pallas body `_paged_decode_kernel`. The TPU kernel prefetches the
// block table as scalars and walks the pages on the sequential minor grid
// axis. Here one thread block owns one (batch row, kv head), reads its own
// page ids from the block table, and loops over the row's live tokens
// 64 at a time; pages past `lengths` are never read, so dead-row tables that
// point at the trash page (and rows with length 0) are safe.
//
// What bounds it on the H100: bytes. Each step reads K and V once,
// 2 · Σ lengths · kvh · d · 2 B per layer, against ~2·g flops per byte, far
// below the ~295 operations per byte where the tensor cores would limit. The
// design issues every 16-byte load of a 64-token K/V chunk at once with
// cp.async (64 KB in flight per block at d = 256), gathering token rows
// through the block table, and runs the g query heads of the kv head
// together (padded to 16 rows) through `mma.sync.m16n8k16`, so each page is
// read once for all g heads. With no split over the sequence (kept out on
// purpose: a split changes the reduction order later bitwise contracts rest
// on), the grid is only b · kvh blocks, so at small batch most SMs idle and
// the kernel stays well under the card's memory rate.
//
// Numerics: bf16 x bf16 scores accumulated in fp32, fp32 softmax, bf16
// probabilities into P·V with fp32 accumulation, as the reference does; the
// reference normalises before rounding P and this kernel after, so the two
// agree to bf16 rounding, not bitwise.
#include "mma_bf16.cuh"

using namespace repro_attn;

namespace {

constexpr int kChunk = 64;  // tokens per loop step
constexpr int kRows = 16;   // query heads per kv head, padded to the mma M
constexpr int kWarps = 4;
constexpr int kLdP = kChunk + kPad;

__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, bf16* __restrict__ out, int nh, int kvh,
    int d, int bt, int mb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + kPad;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kRows * ld;
  bf16* sV = sK + kChunk * ld;
  bf16* sP = sV + kChunk * ld;                                // [16][kLdP]
  float* sS = reinterpret_cast<float*>(sP + kRows * kLdP);    // [16][64]
  float* sM = sS + kRows * kChunk;
  float* sL = sM + kRows;
  float* sA = sL + kRows;

  const int bi = blockIdx.x, kh = blockIdx.y;
  const int g = nh / kvh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int chunks = d / 8;  // 16-byte pieces of one row
  const int n_dt = d / 8;
  const int n_ks = d / 16;
  const int len = min(lengths[bi], mb * bt);
  const int* tab = tables + (long)bi * mb;

  // the g query rows of this kv head; rows g..15 are zero padding
  const bf16* qb = q + ((long)bi * nh + (long)kh * g) * d;
  for (int i = tid; i < kRows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r < g;
    cp_async16(sQ + r * ld + c * 8, ok ? qb + r * d + c * 8 : qb, ok ? 16 : 0);
  }
  cp_async_wait_all();
  if (tid < kRows) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  float acc[kMaxD / 32][4];  // n8 tiles j = warp + 4 * jj of the output
#pragma unroll
  for (int jj = 0; jj < kMaxD / 32; ++jj)
    acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;

  const int n_chunks = (len + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk;
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < kChunk * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i - r * chunks;
      const int p = c0 + r;
      const bool ok = p < len;
      long row = 0;
      if (ok) row = ((long)tab[p / bt] * bt + p % bt) * kvh + kh;
      cp_async16(sK + r * ld + c * 8, k_pool + row * d + c * 8, ok ? 16 : 0);
      cp_async16(sV + r * ld + c * 8, v_pool + row * d + c * 8, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 tokens (2 n8 tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kMaxD / 16; ++ks) {
      if (ks < n_ks) {
        const int c = ks * 16 + tig * 2;
        uint32_t a[4];
        a[0] = ld32(sQ + gid * ld + c);
        a[1] = ld32(sQ + (gid + 8) * ld + c);
        a[2] = ld32(sQ + gid * ld + c + 8);
        a[3] = ld32(sQ + (gid + 8) * ld + c + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* kr = sK + (warp * 16 + nt * 8 + gid) * ld + c;
          uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
          mma_bf16(sc[nt], a, b);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = warp * 16 + nt * 8 + tig * 2 + (e & 1);
        const int row = gid + (e >> 1) * 8;
        sS[row * kChunk + col] =
            (c0 + col < len) ? sc[nt][e] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over the chunk: 8 threads per head row, 8 tokens each
    {
      const int row = tid >> 3, sub = tid & 7;
      const float m_old = sM[row];
      float x[8];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = sS[row * kChunk + sub * 8 + i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = expf(x[i] - m_new);
        sum += p;
        sP[row * kLdP + sub * 8 + i] = __float2bfloat16(row < g ? p : 0.f);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (sub == 0) {
        const float alpha = expf(m_old - m_new);
        sA[row] = alpha;
        sL[row] = sL[row] * alpha + sum;
        sM[row] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V over this warp's output tiles
    const float al_a = sA[gid], al_b = sA[gid + 8];
#pragma unroll
    for (int jj = 0; jj < kMaxD / 32; ++jj) {
      if (warp + 4 * jj < n_dt) {
        acc[jj][0] *= al_a;
        acc[jj][1] *= al_a;
        acc[jj][2] *= al_b;
        acc[jj][3] *= al_b;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      uint32_t a[4];
      a[0] = ld32(sP + gid * kLdP + c);
      a[1] = ld32(sP + (gid + 8) * kLdP + c);
      a[2] = ld32(sP + gid * kLdP + c + 8);
      a[3] = ld32(sP + (gid + 8) * kLdP + c + 8);
#pragma unroll
      for (int jj = 0; jj < kMaxD / 32; ++jj) {
        const int j = warp + 4 * jj;
        if (j < n_dt) {
          const bf16* vc = sV + j * 8 + gid;
          uint32_t b[2] = {pack_cols(vc + c * ld, vc + (c + 1) * ld),
                           pack_cols(vc + (c + 8) * ld, vc + (c + 9) * ld)};
          mma_bf16(acc[jj], a, b);
        }
      }
    }
  }
  __syncthreads();

  const float inv_a = 1.f / fmaxf(sL[gid], 1e-30f);
  const float inv_b = 1.f / fmaxf(sL[gid + 8], 1e-30f);
  bf16* ob = out + ((long)bi * nh + (long)kh * g) * d + tig * 2;
#pragma unroll
  for (int jj = 0; jj < kMaxD / 32; ++jj) {
    const int j = warp + 4 * jj;
    if (j < n_dt) {
      if (gid < g)
        *reinterpret_cast<uint32_t*>(ob + gid * d + j * 8) =
            pack_f32(acc[jj][0] * inv_a, acc[jj][1] * inv_a);
      if (gid + 8 < g)
        *reinterpret_cast<uint32_t*>(ob + (gid + 8) * d + j * 8) =
            pack_f32(acc[jj][2] * inv_b, acc[jj][3] * inv_b);
    }
  }
}

}  // namespace

// Dynamic shared memory of one block at head dim d (Q rows, K/V chunk, P,
// scores, softmax state).
extern "C" int paged_decode_attention_smem_bytes(int d) {
  return (kRows + 2 * kChunk) * (d + kPad) * (int)sizeof(bf16) +
         kRows * kLdP * (int)sizeof(bf16) +
         (kRows * kChunk + 3 * kRows) * (int)sizeof(float);
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
  const int smem = paged_decode_attention_smem_bytes(d);
  static int smem_granted = 0;  // raise the opt-in limit once per size
  if (smem > smem_granted) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_granted = smem;
  }
  dim3 grid(b, kvh);
  paged_decode_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
      (const int*)tables, (const int*)lengths, (bf16*)out, nh, kvh, d, bt, mb,
      scale);
  return (int)cudaGetLastError();
}
