// Causal (or bidirectional) GQA flash attention for prefill, bf16 in and out,
// fp32 online-softmax state. Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` and its
// Pallas body `_flash_kernel`. The TPU kernel walks the kv tiles on the
// sequential minor grid axis and carries (m, l, acc) in VMEM scratch between
// grid steps. Hopper blocks run in no order, so here one thread block owns
// one (batch, q-head, 64-row q tile) and loops over the kv tiles itself,
// stopping at the causal diagonal; the running state never leaves registers.
//
// What bounds it on the H100: at prefill shapes (s = t >= 512, d = 256) the
// work is ~4·s·t·d/2 tensor-core operations against ~3·s·d·2 bytes, far above
// the card's ~295 operations per byte, so it is bound by operations. The
// design feeds the tensor cores with `mma.sync.m16n8k16` (bf16 operands,
// fp32 accumulation): each of the 4 warps owns 16 query rows, keeps its
// 16 x d fp32 output accumulator and its softmax state in registers, reuses
// the S = QK^T accumulator registers directly as the A operand of P·V (the
// FlashAttention-2 layout trick), and masks only the diagonal tile. Q, K and
// V tiles sit in dynamic shared memory (3 x 64 x (d + 8) bf16, ~101 KB at
// d = 256, above the 48 KB static limit, hence cudaFuncSetAttribute); the
// 8-element row pad keeps the fragment loads free of bank conflicts. The K/V
// of one kv head are re-read by the g query heads that share it through L2,
// not shared memory, and loads are not yet overlapped with the mma work
// (wgmma, TMA and pipelining are later work).
//
// Numerics: scores and softmax in fp32 like the reference; P is rounded to
// bf16 for the P·V product (the reference keeps it fp32), so the two agree
// to bf16 rounding, not bitwise.
#include "mma_bf16.cuh"

using namespace repro_attn;

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;

// Copy `rows` rows of width d (row r at src + r * stride) into smem rows of
// width ld; rows at or past `valid` are zero-filled, so masked keys multiply
// zeros, never stale shared memory.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int rows, int valid, long stride,
                                          int d, int ld) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r < valid;
    const bf16* g = ok ? src + r * stride + c * 8 : src;
    cp_async16(dst + r * ld + c * 8, g, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int s,
                     int t, int nh, int kvh, int d, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + kPad;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockQ * ld;
  bf16* sV = sK + kBlockK * ld;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = h / (nh / kvh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_dt = d / 8;   // n8 tiles of the output width
  const int n_ks = d / 16;  // k16 steps of the QK^T contraction

  const bf16* qbase = q + ((long)bi * s * nh + h) * d;
  const bf16* kbase = k + ((long)bi * t * kvh + kh) * d;
  const bf16* vbase = v + ((long)bi * t * kvh + kh) * d;
  const long q_stride = (long)nh * d, kv_stride = (long)kvh * d;

  load_rows(sQ, qbase + q0 * q_stride, kBlockQ, min(kBlockQ, s - q0),
            q_stride, d, ld);

  float acc[kMaxD / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int row_a = q0 + warp * 16 + gid;  // query positions of c0/c1, c2/c3
  const int row_b = row_a + 8;

  const int kend = causal ? min(t, q0 + kBlockQ) : t;
  const int n_kt = (kend + kBlockK - 1) / kBlockK;
  const bf16* qw = sQ + warp * 16 * ld;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows(sK, kbase + k0 * kv_stride, kBlockK, min(kBlockK, t - k0),
              kv_stride, d, ld);
    load_rows(sV, vbase + k0 * kv_stride, kBlockK, min(kBlockK, t - k0),
              kv_stride, d, ld);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n8 tiles)
    float sc[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMaxD / 16; ++ks) {
      if (ks < n_ks) {
        const int c = ks * 16 + tig * 2;
        uint32_t a[4];
        a[0] = ld32(qw + gid * ld + c);
        a[1] = ld32(qw + (gid + 8) * ld + c);
        a[2] = ld32(qw + gid * ld + c + 8);
        a[3] = ld32(qw + (gid + 8) * ld + c + 8);
#pragma unroll
        for (int nt = 0; nt < kBlockK / 8; ++nt) {
          const bf16* kr = sK + (nt * 8 + gid) * ld + c;
          uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
          mma_bf16(sc[nt], a, b);
        }
      }
    }

    // scale, mask, online softmax (rows row_a / row_b; a row's 64 scores
    // are spread over the 4 lanes of one quad)
    const bool diag = causal && (k0 + kBlockK - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        float x = sc[nt][e] * scale;
        if (col >= t || (diag && col > row)) x = kNegInf;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m_run[e >> 1]);
        sc[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < kMaxD / 8; ++j) {
      if (j < n_dt) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
    }

    // O += P V: the S accumulators of two adjacent n8 tiles are exactly the
    // A fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_f32(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_f32(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_f32(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const int kr = kk * 16 + tig * 2;
#pragma unroll
      for (int j = 0; j < kMaxD / 8; ++j) {
        if (j < n_dt) {
          const bf16* vc = sV + j * 8 + gid;
          uint32_t b[2] = {pack_cols(vc + kr * ld, vc + (kr + 1) * ld),
                           pack_cols(vc + (kr + 8) * ld, vc + (kr + 9) * ld)};
          mma_bf16(acc[j], a, b);
        }
      }
    }
  }

  // finalize: full row sums, divide, store bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv_a = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv_b = 1.f / fmaxf(l_run[1], 1e-30f);
  bf16* oa = o + (((long)bi * s + row_a) * nh + h) * d + tig * 2;
  bf16* ob = o + (((long)bi * s + row_b) * nh + h) * d + tig * 2;
#pragma unroll
  for (int j = 0; j < kMaxD / 8; ++j) {
    if (j < n_dt) {
      if (row_a < s)
        *reinterpret_cast<uint32_t*>(oa + j * 8) =
            pack_f32(acc[j][0] * inv_a, acc[j][1] * inv_a);
      if (row_b < s)
        *reinterpret_cast<uint32_t*>(ob + j * 8) =
            pack_f32(acc[j][2] * inv_b, acc[j][3] * inv_b);
    }
  }
}

}  // namespace

// Dynamic shared memory of one block at head dim d (Q, K, V tiles).
extern "C" int flash_attention_smem_bytes(int d) {
  return (kBlockQ + 2 * kBlockK) * (d + kPad) * (int)sizeof(bf16);
}

// q (b, s, nh, d), k/v (b, t, kvh, d), o (b, s, nh, d); all bf16, contiguous.
// d % 16 == 0, d <= 256, nh % kvh == 0 (the Python wrapper checks).
// Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int t, int nh, int kvh, int d, int causal,
                                    float scale, void* stream) {
  const int smem = flash_attention_smem_bytes(d);
  static int smem_granted = 0;  // raise the opt-in limit once per size
  if (smem > smem_granted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_granted = smem;
  }
  dim3 grid((s + kBlockQ - 1) / kBlockQ, nh, b);
  flash_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, s, t, nh, kvh,
      d, causal, scale);
  return (int)cudaGetLastError();
}
