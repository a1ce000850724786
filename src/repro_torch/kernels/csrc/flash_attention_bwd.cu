// The gradient of flash attention: dq, dk, dv of a GQA attention, causal or
// not, from q, k, v, the forward's output o and its row logsumexp lse, and
// the output's gradient dO. bf16 in and out, fp32 accumulation. Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces: the gradient the JAX package takes of its attention in a train
// step, jax.value_and_grad through ops.flash_attention, which autodiff
// computes from the jnp reference (src/repro/kernels/ref.py,
// `flash_attention`): the Pallas kernel has no VJP. With P = softmax(scale ·
// Q K^T) and O = P V:
//   dV = P^T dO,  dP = dO V^T,  dS = P ∘ (dP − D),  D = rowsum(dO ∘ O),
//   dQ = scale · dS K,  dK = scale · dS^T Q.
// P is rebuilt from lse (exp(scale · q·k − lse)), so nothing of size s x t
// is ever stored.
//
// What bounds it on the H100: the same as the forward, operations (five
// s x t x d products against the forward's two, on inputs read a few times
// each). This first design is simple and deterministic rather than fast:
// - D = rowsum(dO ∘ O) in fp32, one warp a (batch, position, head) row.
// - dK/dV: one block per (batch, kv head, 64-row kv tile). It loops over
//   the query heads of the GQA group and over the q tiles that see the kv
//   tile (causal: those from the diagonal on), so the group's sum is taken
//   in registers, in a fixed order, with no atomics. Each warp owns 16 kv
//   rows; it forms S^T = K Q^T and dP^T = V dO^T with `mma.sync`
//   m16n8k16 (mma_bf16.cuh), P^T and dS^T in fp32, and adds P^T dO and
//   dS^T Q with P^T and dS^T rounded to bf16 and taken straight from the
//   accumulator registers as A fragments. At head dims past 128 (query
//   plus value atoms past 4) the block has two warps per 16 rows, each
//   keeping half of dK's and dV's columns: they both form S^T and dP^T,
//   which costs those products twice but keeps the accumulators at 128
//   registers a thread. The q tile is taken 32 columns at a time, so S^T
//   and dP^T need 16 registers each.
// - dQ: one block per (batch, head, 64-row q tile), four warps of 16 q
//   rows, over the kv tiles up to the diagonal, 32 kv columns at a time;
//   the heaviest q tiles first, as in the forward.
// - Tiles arrive by 16-byte `cp.async` into padded rows (conflict-free
//   ldmatrix), one tile at a time; rows past s or t and columns past the
//   head dim (up to the next 16) arrive as zeros, and P is 0 at masked and
//   out-of-range positions, so they add nothing.
// Any dq % 8 == dv % 8 == 0 with dv <= dq <= 256 works (MLA's 192/128 too),
// as 64-column atoms DQA, DVA as in the forward; loops stop at the head dim
// rounded up to 16.
//
// Numerics: the reference rebuilds P in fp32 and forms every product in
// fp32; here the products take bf16 operands (P^T and dS^T rounded), with
// fp32 accumulation, and the outputs are rounded to bf16. The kernel agrees
// with the reference to bf16 rounding, not bitwise; two launches on the
// same inputs agree bit for bit.
#include <type_traits>

#include "mma_bf16.cuh"
#include "per_device.cuh"

using namespace repro_attn;

namespace {

constexpr int kBlock = 64;   // q rows and kv rows a tile
constexpr int kSub = 32;     // columns of S^T / S a warp forms at a time
constexpr float kLog2e = 1.4426950408889634f;

// Warps a 16-row strip of dK/dV: two past four 64-column atoms, so that the
// accumulators stay at 128 fp32 registers a thread.
__host__ __device__ constexpr int parts(int dqa, int dva) {
  return dqa + dva > 4 ? 2 : 1;
}

// Dynamic shared memory of either pass: a Q-width and a V-width tile twice
// (K, V and Q, dO), rows padded by 8 bf16, and 2 x 64 fp32 row statistics.
__host__ __device__ constexpr int smem_bytes(int dqa, int dva) {
  return 2 * kBlock * ((64 * dqa + 8) + (64 * dva + 8)) * 2 +
         2 * kBlock * 4;
}

// D[bi, h, i] = sum_c dO[bi, i, h, c] · O[bi, i, h, c] in fp32; one warp a
// (bi, i, h) row, rows in memory order.
__global__ void bwd_dot_kernel(const bf16* __restrict__ o,
                               const bf16* __restrict__ dout,
                               float* __restrict__ dsum, int b, int s, int nh,
                               int dv) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= (long)b * s * nh) return;
  const int lane = threadIdx.x & 31;
  const bf16* po = o + row * dv;
  const bf16* pd = dout + row * dv;
  float acc = 0.f;
  for (int c = lane * 2; c < dv; c += 64) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(po + c));
    const float2 d =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pd + c));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % nh);
    const long bs = row / nh;
    const int i = (int)(bs % s), bi = (int)(bs / s);
    dsum[((long)bi * nh + h) * s + i] = acc;
  }
}

// Rows r0..r0+63 of head `hd` of batch row bi of a (n, len, heads, d) bf16
// tensor into `sm` (row stride ld), columns [0, d16) with d16 = d rounded up
// to 16: rows past len and columns past d arrive as zeros.
template <int kThreads>
__device__ __forceinline__ void load_tile(bf16* sm, int ld,
                                          const bf16* __restrict__ g, int bi,
                                          int r0, int hd, int len, int heads,
                                          int d, int d16) {
  const int pieces = d16 / 8;
  for (int i = threadIdx.x; i < kBlock * pieces; i += kThreads) {
    const int r = i / pieces, c = i - r * pieces;
    const bool ok = r0 + r < len && c * 8 < d;
    const bf16* src =
        ok ? g + ((((long)bi * len + r0 + r) * heads + hd) * d + c * 8) : g;
    cp_async16(sm + r * ld + c * 8, src, ok ? 16 : 0);
  }
}

// Fragment addresses, per lane, of the m16n8k16 operands from row-major
// tiles (see mma_bf16.cuh): an A tile (16 rows x k16), two B n8 tiles held
// as rows n with k contiguous (non-trans), and two B n8 tiles held as rows
// k with n contiguous (trans).
struct Lanes {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ explicit Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8),
        a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8),
        b_col(((lane >> 3) & 1) * 8),
        t_row((lane & 7) + ((lane >> 3) & 1) * 8),
        t_col((lane >> 4) * 8) {}
};

// acc[n] (16 x kSub, n8 tiles) += A (16 rows of sA from row a0) · B^T (kSub
// rows of sB from row b0), over depth [0, d16).
template <int KA>
__device__ __forceinline__ void product_abt(float (&acc)[kSub / 8][4],
                                            const bf16* sA, int a0,
                                            const bf16* sB, int b0, int ld,
                                            int d16, const Lanes& ln) {
#pragma unroll
  for (int ks = 0; ks < 4 * KA; ++ks) {
    if (ks * 16 < d16) {
      uint32_t a[4];
      ldsm_x4(a, sA + (a0 + ln.a_row) * ld + ks * 16 + ln.a_col);
#pragma unroll
      for (int np = 0; np < kSub / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, sB + (b0 + np * 16 + ln.b_row) * ld + ks * 16 + ln.b_col);
        mma_bf16(acc[2 * np], a, bb);
        mma_bf16(acc[2 * np + 1], a, bb + 2);
      }
    }
  }
}

// The n8 tiles of a 16 x kSub fp32 accumulator as bf16 A fragments of
// kSub / 16 k16 steps (tiles 2kk and 2kk + 1 are step kk).
__device__ __forceinline__ void to_a(uint32_t (&out)[kSub / 16][4],
                                     const float (&c)[kSub / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kSub / 16; ++kk) {
    out[kk][0] = pack_f32(c[2 * kk][0], c[2 * kk][1]);
    out[kk][1] = pack_f32(c[2 * kk][2], c[2 * kk][3]);
    out[kk][2] = pack_f32(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    out[kk][3] = pack_f32(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc[pp] (16 x 16 column pairs p0 + pp) += A (kSub k from registers) ·
// sB rows b0..b0+kSub (k), columns of the pairs (n), for pairs below d16.
template <int NP>
__device__ __forceinline__ void product_ab(float (&acc)[NP][2][4],
                                           const uint32_t (&a)[kSub / 16][4],
                                           const bf16* sB, int b0, int ld,
                                           int p0, int d16, const Lanes& ln) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
    const int c0 = (p0 + pp) * 16;
    if (c0 < d16) {
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, sB + (b0 + kk * 16 + ln.t_row) * ld + c0 + ln.t_col);
        mma_bf16(acc[pp][0], a[kk], bb);
        mma_bf16(acc[pp][1], a[kk], bb + 2);
      }
    }
  }
}

// Store acc (rows ra, ra + 8 of a 16-row strip; column pairs p0 + pp) times
// `mul` as bf16 into out (n, len, heads, d) at (bi, ·, hd), rows < len and
// columns < d only.
template <int NP>
__device__ __forceinline__ void store(bf16* __restrict__ out,
                                      const float (&acc)[NP][2][4], float mul,
                                      int bi, int ra, int hd, int len,
                                      int heads, int d, int p0, int tig) {
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = (p0 + pp) * 16 + half * 8 + tig * 2;
      if (col >= d) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ra + 8 * r;
        if (row < len)
          *reinterpret_cast<uint32_t*>(
              out + (((long)bi * len + row) * heads + hd) * d + col) =
              pack_f32(acc[pp][half][2 * r] * mul,
                       acc[pp][half][2 * r + 1] * mul);
      }
    }
  }
}

// dK and dV of one (batch row, kv head, 64-row kv tile).
template <int DQA, int DVA>
__global__ void __launch_bounds__(128 * parts(DQA, DVA), 1)
    bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, bf16* __restrict__ dk,
                    bf16* __restrict__ dv_out, int s, int t, int nh, int kvh,
                    int dq, int dv, int causal, float scale) {
  constexpr int NS = parts(DQA, DVA);
  constexpr int kThreads = 128 * NS;
  constexpr int LDQ = 64 * DQA + 8, LDV = 64 * DVA + 8;
  constexpr int NPQ = 4 * DQA / NS, NPV = 4 * DVA / NS;  // column pairs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBlock * LDQ;
  bf16* sQ = sV + kBlock * LDV;
  bf16* sO = sQ + kBlock * LDQ;                 // dO
  float* sL = reinterpret_cast<float*>(sO + kBlock * LDV);  // lse · log2 e
  float* sD = sL + kBlock;

  const int n_kt = (t + kBlock - 1) / kBlock;
  const int kt = blockIdx.x % n_kt;
  const int kh = blockIdx.x / n_kt % kvh, bi = blockIdx.x / n_kt / kvh;
  const int k0 = kt * kBlock, g = nh / kvh;
  const int dq16 = (dq + 15) & ~15, dv16 = (dv + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3, part = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr_a = k0 + wr * 16 + gid;          // kv rows of c[0..1], +8
  const float scale_log2 = scale * kLog2e;
  const Lanes ln(lane);

  load_tile<kThreads>(sK, LDQ, k, bi, k0, kh, t, kvh, dq, dq16);
  load_tile<kThreads>(sV, LDV, v, bi, k0, kh, t, kvh, dv, dv16);
  cp_async_commit();

  float acc_k[NPQ][2][4], acc_v[NPV][2][4];
#pragma unroll
  for (int i = 0; i < NPQ; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_k[i][e >> 2][e & 3] = 0.f;
#pragma unroll
  for (int i = 0; i < NPV; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_v[i][e >> 2][e & 3] = 0.f;

  const int n_qt = (s + kBlock - 1) / kBlock;
  const int qt0 = causal ? k0 / kBlock : 0;     // q rows >= k0 see the tile
  for (int j = 0; j < g; ++j) {
    const int h = kh * g + j;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();                           // the last tile is read
      load_tile<kThreads>(sQ, LDQ, q, bi, q0, h, s, nh, dq, dq16);
      load_tile<kThreads>(sO, LDV, dout, bi, q0, h, s, nh, dv, dv16);
      cp_async_commit();
      for (int i = threadIdx.x; i < kBlock; i += kThreads) {
        const bool ok = q0 + i < s;
        const long at = ((long)bi * nh + h) * s + q0 + i;
        sL[i] = ok ? lse[at] * kLog2e : 0.f;
        sD[i] = ok ? dsum[at] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

#pragma unroll 1
      for (int c0 = 0; c0 < kBlock; c0 += kSub) {
        if (q0 + c0 >= s || (causal && q0 + c0 + kSub - 1 < k0 + wr * 16))
          continue;                              // no live (q, kv) pair
        // P^T = exp2(scale·log2e · K Q^T − lse·log2e), masked to 0
        float pt[kSub / 8][4];
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
          pt[n][0] = pt[n][1] = pt[n][2] = pt[n][3] = 0.f;
        product_abt<DQA>(pt, sK, wr * 16, sQ, c0, LDQ, dq16, ln);
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c0 + n * 8 + tig * 2 + (e & 1);
            const int kr = kr_a + ((e & 2) ? 8 : 0);
            float p = exp2f(pt[n][e] * scale_log2 - sL[qi]);
            if (q0 + qi >= s || kr >= t || (causal && kr > q0 + qi)) p = 0.f;
            pt[n][e] = p;
          }
        }
        uint32_t pa[kSub / 16][4];
        to_a(pa, pt);
        product_ab<NPV>(acc_v, pa, sO, c0, LDV, part * NPV, dv16, ln);
        // dS^T = P^T ∘ (V dO^T − D)
        float ds[kSub / 8][4];
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
          ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
        product_abt<DVA>(ds, sV, wr * 16, sO, c0, LDV, dv16, ln);
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c0 + n * 8 + tig * 2 + (e & 1);
            ds[n][e] = pt[n][e] * (ds[n][e] - sD[qi]);
          }
        }
        uint32_t da[kSub / 16][4];
        to_a(da, ds);
        product_ab<NPQ>(acc_k, da, sQ, c0, LDQ, part * NPQ, dq16, ln);
      }
    }
  }
  store<NPQ>(dk, acc_k, scale, bi, kr_a, kh, t, kvh, dq, part * NPQ, tig);
  store<NPV>(dv_out, acc_v, 1.f, bi, kr_a, kh, t, kvh, dv, part * NPV, tig);
}

// dQ of one (batch row, head, 64-row q tile).
template <int DQA, int DVA>
__global__ void __launch_bounds__(128, 1)
    bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, bf16* __restrict__ dq_out,
                  int b, int s, int t, int nh, int kvh, int dq, int dv,
                  int causal, float scale) {
  constexpr int LDQ = 64 * DQA + 8, LDV = 64 * DVA + 8;
  constexpr int NPQ = 4 * DQA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kBlock * LDQ;                 // dO
  bf16* sK = sO + kBlock * LDV;
  bf16* sV = sK + kBlock * LDQ;

  // heaviest q tiles first (under causal the last ones see the most keys)
  const int rows = nh * b;
  const int n_qt = (s + kBlock - 1) / kBlock;
  const int qt = n_qt - 1 - (int)(blockIdx.x / rows);
  const int h = blockIdx.x % rows % nh, bi = blockIdx.x % rows / nh;
  const int kh = h / (nh / kvh);
  const int q0 = qt * kBlock;
  const int dq16 = (dq + 15) & ~15, dv16 = (dv + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ra = q0 + warp * 16 + gid;          // q rows of c[0..1], +8
  const float scale_log2 = scale * kLog2e;
  const Lanes ln(lane);

  load_tile<128>(sQ, LDQ, q, bi, q0, h, s, nh, dq, dq16);
  load_tile<128>(sO, LDV, dout, bi, q0, h, s, nh, dv, dv16);
  cp_async_commit();
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    const long at = ((long)bi * nh + h) * s + row;
    l2[r] = row < s ? lse[at] * kLog2e : 0.f;
    dd[r] = row < s ? dsum[at] : 0.f;
  }

  float acc[NPQ][2][4];
#pragma unroll
  for (int i = 0; i < NPQ; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e >> 2][e & 3] = 0.f;

  const int kend = causal ? min(t, q0 + kBlock) : t;
  const int n_kt = (kend + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();                             // the last tile is read
    load_tile<128>(sK, LDQ, k, bi, k0, kh, t, kvh, dq, dq16);
    load_tile<128>(sV, LDV, v, bi, k0, kh, t, kvh, dv, dv16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += kSub) {
      if (k0 + c0 >= t || (causal && k0 + c0 > q0 + warp * 16 + 15))
        continue;                                // no live (q, kv) pair
      float p[kSub / 8][4], ds[kSub / 8][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.f;
      product_abt<DQA>(p, sQ, warp * 16, sK, c0, LDQ, dq16, ln);
      product_abt<DVA>(ds, sO, warp * 16, sV, c0, LDV, dv16, ln);
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c0 + n * 8 + tig * 2 + (e & 1);
          const int row = ra + ((e & 2) ? 8 : 0);
          float pv = exp2f(p[n][e] * scale_log2 - l2[e >> 1]);
          if (col >= t || row >= s || (causal && col > row)) pv = 0.f;
          ds[n][e] = pv * (ds[n][e] - dd[e >> 1]);
        }
      }
      uint32_t da[kSub / 16][4];
      to_a(da, ds);
      product_ab<NPQ>(acc, da, sK, c0, LDQ, 0, dq16, ln);
    }
  }
  store<NPQ>(dq_out, acc, scale, bi, ra, h, s, nh, dq, 0, tig);
}

template <int DQA, int DVA>
int launch_da(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
              const bf16* dout, const float* lse, float* dsum, bf16* dq_out,
              bf16* dk, bf16* dv_out, int b, int s, int t, int nh, int kvh,
              int dq, int dv, int causal, float scale, cudaStream_t stream) {
  const int smem = smem_bytes(DQA, DVA);
  // raise the opt-in limits once per instance and device
  static int granted_kv[repro_dev::kMaxDevices] = {};
  static int granted_q[repro_dev::kMaxDevices] = {};
  if (int err = repro_dev::grant_smem(bwd_dkdv_kernel<DQA, DVA>, smem,
                                      granted_kv))
    return err;
  if (int err = repro_dev::grant_smem(bwd_dq_kernel<DQA, DVA>, smem,
                                      granted_q))
    return err;
  const long rows = (long)b * s * nh;
  bwd_dot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, dsum, b, s, nh, dv);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const long kv_blocks = (long)b * kvh * ((t + kBlock - 1) / kBlock);
  bwd_dkdv_kernel<DQA, DVA>
      <<<(unsigned)kv_blocks, 128 * parts(DQA, DVA), smem, stream>>>(
          q, k, v, dout, lse, dsum, dk, dv_out, s, t, nh, kvh, dq, dv, causal,
          scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const long q_blocks = (long)b * nh * ((s + kBlock - 1) / kBlock);
  bwd_dq_kernel<DQA, DVA><<<(unsigned)q_blocks, 128, smem, stream>>>(
      q, k, v, dout, lse, dsum, dq_out, b, s, t, nh, kvh, dq, dv, causal,
      scale);
  return (int)cudaGetLastError();
}

// The instance for (DQA, dva), every dva <= DQA.
template <int DQA>
int launch_dq(int dva, const bf16* q, const bf16* k, const bf16* v,
              const bf16* o, const bf16* dout, const float* lse, float* dsum,
              bf16* dq_out, bf16* dk, bf16* dv_out, int b, int s, int t,
              int nh, int kvh, int dq, int dv, int causal, float scale,
              cudaStream_t stream) {
  auto go = [&](auto dva_c) {
    return launch_da<DQA, decltype(dva_c)::value>(
        q, k, v, o, dout, lse, dsum, dq_out, dk, dv_out, b, s, t, nh, kvh, dq,
        dv, causal, scale, stream);
  };
  if (dva == DQA) return go(std::integral_constant<int, DQA>{});
  if constexpr (DQA > 1)
    if (dva == 1) return go(std::integral_constant<int, 1>{});
  if constexpr (DQA > 2)
    if (dva == 2) return go(std::integral_constant<int, 2>{});
  if constexpr (DQA > 3)
    if (dva == 3) return go(std::integral_constant<int, 3>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one block of either pass at query/key head dim
// dq and value head dim dv.
extern "C" int flash_attention_bwd_smem_bytes(int dq, int dv) {
  return smem_bytes((dq + 63) / 64, (dv + 63) / 64);
}

// q (b, s, nh, dq), k (b, t, kvh, dq), v (b, t, kvh, dv), o and dout (b, s,
// nh, dv), all bf16; lse (b, nh, s) fp32, the forward's natural-log row
// logsumexp of the scaled scores; dsum (b, nh, s) fp32 scratch; outputs dq
// (b, s, nh, dq), dk (b, t, kvh, dq), dv (b, t, kvh, dv) bf16. Contiguous,
// 16-byte aligned; dq % 8 == dv % 8 == 0, dv <= dq <= 256, nh % kvh == 0
// (the Python wrapper checks). Three launches on `stream`: D, dK/dV, dQ.
// Returns the CUDA error of the launches (0 = cudaSuccess).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* dsum, void* dq_out, void* dk,
                                        void* dv_out, int b, int s, int t,
                                        int nh, int kvh, int dq, int dv,
                                        int causal, float scale,
                                        void* stream) {
  const int dva = (dv + 63) / 64;
  auto go = [&](auto dqa_c) {
    return launch_dq<decltype(dqa_c)::value>(
        dva, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
        (const bf16*)dout, lse, dsum, (bf16*)dq_out, (bf16*)dk,
        (bf16*)dv_out, b, s, t, nh, kvh, dq, dv, causal, scale,
        (cudaStream_t)stream);
  };
  switch ((dq + 63) / 64) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 3: return go(std::integral_constant<int, 3>{});
    case 4: return go(std::integral_constant<int, 4>{});
  }
  return (int)cudaErrorInvalidValue;
}
