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
// What bounds it on the H100: operations. Five s x t x d products (2.5 x
// the forward's) on inputs of a few MB; at Gemma-2B's (1, 1024, 8/1, 256)
// causal the bound is 0.011 ms. What keeps a kernel from it: too few blocks
// for 132 SMs (an MQA group of 8 at batch 1 has 16 kv tiles), causal
// masking that leaves most of the card idle while the heaviest blocks
// finish, copies that wait for the products, and products that run twice.
// The design, in three passes and a sum, all products `wgmma`
// (wgmma_bf16.cuh), every tile by TMA (4-d tensor maps, 128-byte swizzle,
// as flash_attention.cu):
// - D = rowsum(dO ∘ O) in fp32, a row to a group of lanes in 16-byte loads.
// - dK/dV: one block per (batch, kv head, kv tile, head split). K and V
//   arrive once; one producer warp keeps a ring of (Q, dO) tiles full, each
//   with its 64 lse and D values, with full and empty `mbarrier`s, so the
//   next tile's copy runs under this tile's products. Two consumer
//   warpgroups form nothing twice. S^T = K Q^T and dP^T = V dO^T are
//   m64n64k16 with both operands K-major (the forward's S with K in Q's
//   place); P^T = exp2(scale·log2e · S^T − lse·log2e) (0 where masked) and
//   dS^T = P^T ∘ (dP^T − D) in fp32; dV += P^T dO and dK += dS^T Q take
//   P^T, dS^T packed to bf16 from the accumulators as the A operand in
//   registers and dO, Q MN-major (the forward's P V). Two layouts:
//   - dq, dv <= 128 (DQA + DVA <= 4: dK and dV of 64 rows fit 128 fp32
//     registers a thread): a 128-row kv tile, each warpgroup all four
//     products of its 64 rows. The two warpgroups run independent chains
//     that interleave on the tensor cores, and each (Q, dO) tile serves 128
//     kv rows.
//   - larger (Gemma's 256/256, MLA's 192/128): a 64-row kv tile; the dV
//     warpgroup forms S^T, P^T and dV, the dK warpgroup forms dP^T, takes
//     P^T in fp32 from the other through 16 KB of shared memory (two named
//     barriers) and adds dK. Each holds one accumulator of at most 64 x 256
//     fp32 and runs the same share of products; forming S^T and dP^T in
//     both would cost 1.5 x the pass's products.
//   `setmaxnreg` gives the consumers 240 registers a thread and the
//   producer warpgroup 24 (384 threads alone would leave 168).
//   The GQA group's query heads are split over blocks: the smallest divisor
//   of the group that gives a block per SM (or the whole group). A block
//   walks its heads and, under causal masking, the q tiles from the
//   diagonal on, and sums in registers. With more than one split each block
//   writes fp32 partials into the caller's scratch, and a sum pass adds them
//   in split order, scales dK and rounds: no atomics, so two launches agree
//   bit for bit. Blocks of kv tile 0 (under causal, the most q tiles) go
//   first.
// - dQ: one block per (batch, head, 64-row q tile), the forward's shape:
//   Q and dO arrive once, K and V through a two-stage ring; S = Q K^T and dP
//   = dO V^T (both operands K-major), dS in fp32, dQ += dS K (dS packed from
//   the accumulators, K MN-major). The heaviest q tiles go first. It reads
//   nothing the dK/dV pass writes, so it launches as that grid's
//   programmatic dependent: its blocks take the SMs that dK/dV blocks leave
//   (on an H100 at Gemma's causal shape, a third of the backward's time),
//   and it ends only after the dK/dV grid. Keeping dQ in its own pass costs
//   two more products (seven against the five of a design that adds dQ
//   with atomics from the dK/dV blocks) and keeps every sum in a fixed
//   order.
// The launch plan (head splits, blocks, ring stages, scratch) is made here,
// in the C entry; `flash_attention_bwd_plan` reports it.
// Edges: rows past s or t and columns past the head dim arrive as TMA's
// zero fill (k16 steps past the head dim multiply zeros, as in the
// forward), and P is 0 at masked and out-of-range positions. Any dq % 8 ==
// dv % 8 == 0 with dv <= dq <= 256 works (MLA's 192/128 too), as 64-column
// atoms DQA, DVA as in the forward: a row is d·2 bytes, a multiple of the
// 16 that TMA needs.
//
// Numerics: the reference rebuilds P in fp32 and forms every product in
// fp32; here the products take bf16 operands (P^T and dS^T rounded, dS^T
// from the fp32 P^T), with fp32 accumulation, and the outputs are rounded
// to bf16. The kernel agrees with the reference to bf16 rounding, not
// bitwise; two launches on the same inputs agree bit for bit.
#include <cuda.h>

#include <type_traits>

#include "per_device.cuh"
#include "wgmma_bf16.cuh"

using namespace repro_wgmma;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 64;                        // q rows and kv rows a tile
constexpr uint32_t kAtomBytes = kBlock * 64 * 2;  // 64 rows x 128 bytes
constexpr int kSmemMax = 232448;                  // one block's, on an H100
constexpr float kLog2e = 1.4426950408889634f;
// dK/dV: two consumer warpgroups and a producer warpgroup, of
// which one warp works. Warps w, w + 4 and w + 8 share one of the SM's four
// 16,384-register files, so each thread starts at 168 registers; the
// producer gives registers up (`setmaxnreg` acts on whole warpgroups) and
// the consumers take 240: 24 + 240 + 240 (x 32 lanes) fit a file.
constexpr int kKvThreads = 3 * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr uint32_t kXBytes = 128 * 32 * 4;        // P^T, fp32, 16 KB
constexpr int kXFull = 1, kXEmpty = 2;            // its named barriers
// dQ: one consumer warpgroup and one producer warp, a two-stage K/V ring
constexpr int kQThreads = 128 + 32;
constexpr int kQStages = 2;

// The dK/dV tile: where dK and dV of 64 rows fit 128 accumulators a thread
// together (DQA + DVA <= 4), 128 kv rows, each consumer warpgroup all four
// products of its 64; else 64 rows, dK in one warpgroup and dV in the
// other, P^T exchanged.
__host__ __device__ constexpr bool split_rows(int dqa, int dva) {
  return dqa + dva <= 4;
}

__host__ __device__ constexpr int kv_rows(int dqa, int dva) {
  return split_rows(dqa, dva) ? 2 * kBlock : kBlock;
}

// Dynamic shared memory of the dK/dV pass at `st` ring stages: K, V, the
// (Q, dO) ring, the P^T exchange, 2 x 64 floats (lse, D) a stage, the
// barriers and 1 KB to align the tiles.
__host__ __device__ constexpr int kv_smem(int dqa, int dva, int st) {
  return 1024 +
         (dqa + dva) * (int)kAtomBytes * (kv_rows(dqa, dva) / kBlock + st) +
         (split_rows(dqa, dva) ? 0 : (int)kXBytes) + st * 512 +
         8 * (2 * st + 1);
}

// Ring stages of the dK/dV pass: as many as fit, up to 4.
__host__ __device__ constexpr int kv_stages(int dqa, int dva) {
  return kv_smem(dqa, dva, 4) <= kSmemMax   ? 4
         : kv_smem(dqa, dva, 3) <= kSmemMax ? 3
                                            : 2;
}

// Dynamic shared memory of the dQ pass: Q, dO, the K/V ring, barriers.
__host__ __device__ constexpr int q_smem(int dqa, int dva) {
  return 1024 + (dqa + dva) * (int)kAtomBytes * (1 + kQStages) +
         8 * (2 * kQStages + 1);
}

// Two dQ blocks share an SM where their accumulators (64 x 64·DQA fp32)
// leave room for it (at most 204 registers a thread).
__host__ __device__ constexpr int q_min_blocks(int dqa) {
  return dqa <= 2 ? 2 : 1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[bi, h, i] = sum_c dO[bi, i, h, c] · O[bi, i, h, c] in fp32. A group of
// `lanes` lanes (a power of 2, 8 · lanes >= dv) takes a (bi, i, h) row in
// 16-byte pieces, rows in memory order.
__global__ void bwd_dot_kernel(const bf16* __restrict__ o,
                               const bf16* __restrict__ dout,
                               float* __restrict__ dsum, int b, int s, int nh,
                               int dv, int lanes) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int sub = threadIdx.x & (lanes - 1);
  const bool live = row < (long)b * s * nh;
  float acc = 0.f;
  for (int c = sub * 8; live && c < dv; c += lanes * 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * dv + c);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + row * dv + c);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[k]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&dw[k]));
      acc += x.x * y.x + x.y * y.y;
    }
  }
  for (int off = lanes / 2; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && sub == 0) {
    const int h = (int)(row % nh);
    const long bs = row / nh;
    const int i = (int)(bs % s), bi = (int)(bs / s);
    dsum[((long)bi * nh + h) * s + i] = acc;
  }
}

// acc (64 x 64 fp32) = A B^T: A and B two 64-row tiles of kAtoms swizzle
// atoms, both K-major (4 k16 steps an atom; steps past the head dim
// multiply zero fill).
template <int kAtoms>
__device__ __forceinline__ void product_abt(float (&acc)[32], uint32_t a,
                                            uint32_t bt) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * kAtoms; ++ks) {
    const uint32_t off = (ks >> 2) * kAtomBytes + (ks & 3) * 32;
    wgmma_ss_m64n64k16(acc, desc_sw128(a + off, 16, 1024),
                       desc_sw128(bt + off, 16, 1024), ks > 0);
  }
}

// acc (64 x 64·kAtoms fp32) += A B: A the 64 x 64 fp32 accumulator `x`
// packed to bf16 (n8 groups 2kk, 2kk + 1 are k16 step kk), B a 64-row tile
// of kAtoms atoms read MN-major (step kk is its rows 16kk..16kk+15). The
// caller commits and waits.
template <int kAtoms>
__device__ __forceinline__ void product_ab(float (&acc)[32 * kAtoms],
                                           const float (&x)[32], uint32_t b) {
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<64 * kAtoms>(acc, pa[kk],
                          desc_sw128(b + kk * 2048, kAtomBytes, 1024));
}

// Store a warpgroup's 64 x 64·kAtoms accumulator, rows r0.. of head hd of
// batch row bi, columns < d: times `mul` as bf16 into out (n, len, heads,
// d), or, where `part` is not null, as fp32 into the partials (split sp,
// rows of width w, column offset c0).
template <int kAtoms>
__device__ __forceinline__ void store_acc(const float (&acc)[32 * kAtoms],
                                          bf16* __restrict__ out,
                                          float* __restrict__ part, int sp,
                                          int n, int bi, int r0, int hd,
                                          int len, int heads, int d, int w,
                                          int c0, float mul) {
  const int tid = threadIdx.x & 127;
  const int ra = r0 + (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int tig = tid & 3;
#pragma unroll
  for (int j = 0; j < 8 * kAtoms; ++j) {
    const int col = j * 8 + tig * 2;
    if (col >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row >= len) continue;
      const long at = ((long)bi * len + row) * heads + hd;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + (((long)sp * n * len * heads + at) *
                                               w + c0 + col)) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      else
        *reinterpret_cast<uint32_t*>(out + at * d + col) =
            pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// dK and dV of one (batch row, kv head, kv tile of kv_rows rows, head
// split). With splits == 1 they are stored as bf16 into dk, dv_out; else as
// fp32 into part (splits, b, t, kvh, dq + dv), dK unscaled.
template <int DQA, int DVA>
__global__ void __launch_bounds__(kKvThreads, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, bf16* __restrict__ dk,
                    bf16* __restrict__ dv_out, float* __restrict__ part,
                    int b, int s, int t, int nh, int kvh, int dq, int dv,
                    int causal, int splits, float scale) {
  constexpr int kStages = kv_stages(DQA, DVA);
  constexpr bool kSplitRows = split_rows(DQA, DVA);
  constexpr int kHalves = kv_rows(DQA, DVA) / kBlock;  // 64-row K/V tiles
  constexpr uint32_t kTileQ = DQA * kAtomBytes;   // one 64-row Q or K tile
  constexpr uint32_t kTileV = DVA * kAtomBytes;   // one 64-row V or dO tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;     // atoms are 1 KB aligned
  const uint32_t sV = sK + kHalves * kTileQ;
  const uint32_t sQ = sV + kHalves * kTileV;      // + stage * kTileQ
  const uint32_t sO = sQ + kStages * kTileQ;      // dO, + stage * kTileV
  const uint32_t sX = sO + kStages * kTileV;      // P^T exchange
  const uint32_t sStat = sX + (kSplitRows ? 0 : kXBytes);  // lse·log2e, D
  const uint32_t bars = sStat + kStages * 512;
  const uint32_t full = bars;                     // + 8 * stage
  const uint32_t empty = bars + 8 * kStages;
  const uint32_t kvbar = bars + 16 * kStages;
  float* xbuf = reinterpret_cast<float*>(smem_raw + (sX - raw));
  float* stat = reinterpret_cast<float*>(smem_raw + (sStat - raw));

  // kv tile slowest, from 0: under causal masking tile 0 sees every q tile
  const int per = b * kvh * splits;
  const int kt = blockIdx.x / per, rem = blockIdx.x % per;
  const int sp = rem % splits, kh = rem / splits % kvh;
  const int bi = rem / splits / kvh;
  const int k0 = kt * kHalves * kBlock, g = nh / kvh, hs = g / splits;
  const int n_qt = (s + kBlock - 1) / kBlock;
  const int qt0 = causal ? kt * kHalves : 0;      // q tiles that see the tile
  const int nq = n_qt > qt0 ? n_qt - qt0 : 0;
  const int items = hs * nq;                      // (head, q tile) pairs
  // the dQ grid may start on SMs this grid leaves free (it reads nothing
  // this grid writes)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 33);                // expect_tx + 32 lanes
      mbar_init(empty + 8 * i, 256);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: in warp 8 lane 0 issues the copies, every lane brings lse
    // and D; warps 9-11 only give their registers up
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kvbar, kHalves * (kTileQ + kTileV));
        for (int hf = 0; hf < kHalves; ++hf) {
          for (int a = 0; a < DQA; ++a)
            tma_load_4d(sK + hf * kTileQ + a * kAtomBytes, &tk, kvbar, a * 64,
                        kh, k0 + hf * kBlock, bi);
          for (int a = 0; a < DVA; ++a)
            tma_load_4d(sV + hf * kTileV + a * kAtomBytes, &tv, kvbar, a * 64,
                        kh, k0 + hf * kBlock, bi);
        }
      }
      for (int n = 0; n < items; ++n) {
        const int st = n % kStages;
        const int h = kh * g + sp * hs + n / nq;
        const int q0 = (qt0 + n % nq) * kBlock;
        const uint32_t fb = full + 8 * st;
        mbar_wait(empty + 8 * st, ((n / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(fb, kTileQ + kTileV);
          for (int a = 0; a < DQA; ++a)
            tma_load_4d(sQ + st * kTileQ + a * kAtomBytes, &tq, fb, a * 64, h,
                        q0, bi);
          for (int a = 0; a < DVA; ++a)
            tma_load_4d(sO + st * kTileV + a * kAtomBytes, &tdo, fb, a * 64,
                        h, q0, bi);
        }
        float* sl = stat + st * 128;
        for (int i = lane; i < kBlock; i += 32) {
          const bool ok = q0 + i < s;
          const long at = ((long)bi * nh + h) * s + q0 + i;
          sl[i] = ok ? lse[at] * kLog2e : 0.f;
          sl[kBlock + i] = ok ? dsum[at] : 0.f;
        }
        mbar_arrive(fb);
      }
    }
  } else {
    // consumers: rows kb.. of the tile, 64 a warpgroup (kSplitRows), or
    // warpgroup 0 dK and warpgroup 1 dV of all 64
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31, tig = lane & 3;
    const int kb = k0 + (kSplitRows ? wg * kBlock : 0);
    const int row_a = kb + (tid >> 5) * 16 + (lane >> 2);  // acc[4j + 0/1]
    const int row_b = row_a + 8;                            // acc[4j + 2/3]
    const float scale_log2 = scale * kLog2e;
    float* out_part = splits > 1 ? part : nullptr;
    mbar_wait(kvbar, 0);

    if constexpr (kSplitRows) {
      // dV += P^T dO and dK += dS^T Q for this warpgroup's 64 rows
      const uint32_t sKw = sK + wg * kTileQ, sVw = sV + wg * kTileV;
      float acc_k[32 * DQA], acc_v[32 * DVA];
#pragma unroll
      for (int i = 0; i < 32 * DQA; ++i) acc_k[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 32 * DVA; ++i) acc_v[i] = 0.f;
      for (int n = 0; n < items; ++n) {
        const int st = n % kStages;
        const int q0 = (qt0 + n % nq) * kBlock;
        mbar_wait(full + 8 * st, (n / kStages) & 1);
        if (causal && q0 + kBlock - 1 < kb) {     // every pair masked
          mbar_arrive(empty + 8 * st);
          continue;
        }
        float x[32], y[32];
        product_abt<DQA>(x, sKw, sQ + st * kTileQ);   // S^T
        product_abt<DVA>(y, sVw, sO + st * kTileV);   // dP^T
        wgmma_commit();
        wgmma_wait<0>();
        const float* l2 = stat + st * 128;
        const bool edge = (causal && kb + kBlock - 1 > q0) ||
                          q0 + kBlock > s || kb + kBlock > t;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + tig * 2 + (i & 1);   // q in the tile
          float p = exp2f(x[i] * scale_log2 - l2[col]);
          if (edge) {
            const int kr = (i & 2) ? row_b : row_a;
            if (q0 + col >= s || kr >= t || (causal && kr > q0 + col)) p = 0.f;
          }
          x[i] = p;
          y[i] = p * (y[i] - l2[kBlock + col]);
        }
        product_ab<DVA>(acc_v, x, sO + st * kTileV);
        product_ab<DQA>(acc_k, y, sQ + st * kTileQ);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(empty + 8 * st);              // Q, dO, lse, D read
      }
      store_acc<DQA>(acc_k, dk, out_part, sp, b, bi, kb, kh, t, kvh, dq,
                     dq + dv, 0, scale);
      store_acc<DVA>(acc_v, dv_out, out_part, sp, b, bi, kb, kh, t, kvh, dv,
                     dq + dv, dq, 1.f);
    } else if (threadIdx.x >= 128) {
      // dV += P^T dO; P^T to the dK warpgroup
      float acc[32 * DVA];
#pragma unroll
      for (int i = 0; i < 32 * DVA; ++i) acc[i] = 0.f;
      for (int n = 0; n < items; ++n) {
        const int st = n % kStages;
        const int q0 = (qt0 + n % nq) * kBlock;
        mbar_wait(full + 8 * st, (n / kStages) & 1);
        float x[32];
        product_abt<DQA>(x, sK, sQ + st * kTileQ);
        wgmma_commit();
        wgmma_wait<0>();
        const float* l2 = stat + st * 128;
        const bool edge = (causal && k0 + kBlock - 1 > q0) ||
                          q0 + kBlock > s || k0 + kBlock > t;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + tig * 2 + (i & 1);   // q in the tile
          float p = exp2f(x[i] * scale_log2 - l2[col]);
          if (edge) {
            const int kr = (i & 2) ? row_b : row_a;
            if (q0 + col >= s || kr >= t || (causal && kr > q0 + col)) p = 0.f;
          }
          x[i] = p;
        }
        named_sync(kXEmpty, 256);                   // the last P^T was read
#pragma unroll
        for (int i = 0; i < 32; ++i) xbuf[i * 128 + tid] = x[i];
        named_arrive(kXFull, 256);
        product_ab<DVA>(acc, x, sO + st * kTileV);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(empty + 8 * st);                // Q, dO, lse read
      }
      store_acc<DVA>(acc, dv_out, out_part, sp, b, bi, k0, kh,
                     t, kvh, dv, dq + dv, dq, 1.f);
    } else {
      // dK += dS^T Q, dS^T = P^T ∘ (V dO^T − D)
      float acc[32 * DQA];
#pragma unroll
      for (int i = 0; i < 32 * DQA; ++i) acc[i] = 0.f;
      if (items > 0) named_arrive(kXEmpty, 256);    // the exchange is free
      for (int n = 0; n < items; ++n) {
        const int st = n % kStages;
        mbar_wait(full + 8 * st, (n / kStages) & 1);
        float x[32];
        product_abt<DVA>(x, sV, sO + st * kTileV);
        wgmma_commit();
        wgmma_wait<0>();
        const float* dd = stat + st * 128 + kBlock;
        named_sync(kXFull, 256);                    // P^T of this tile written
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + tig * 2 + (i & 1);
          x[i] = xbuf[i * 128 + tid] * (x[i] - dd[col]);
        }
        if (n + 1 < items) named_arrive(kXEmpty, 256);
        product_ab<DQA>(acc, x, sQ + st * kTileQ);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(empty + 8 * st);                // Q, dO, D read
      }
      store_acc<DQA>(acc, dk, out_part, sp, b, bi, k0, kh, t,
                     kvh, dq, dq + dv, 0, scale);
    }
  }
}

// dk, dv from the head splits' partials (splits, rows, dq + dv), rows = b ·
// t · kvh: summed in split order, dK scaled, rounded to bf16; 4 columns a
// thread ((dq + dv) % 8 == 0, so a group never straddles dK and dV).
__global__ void bwd_sum_kernel(const float* __restrict__ part,
                               bf16* __restrict__ dk,
                               bf16* __restrict__ dv_out, long rows, int dq,
                               int dv, int splits, float scale) {
  const int w = dq + dv;
  const long n4 = rows * w / 4;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(part + 4 * i);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 x =
          *reinterpret_cast<const float4*>(part + sp * rows * w + 4 * i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const long row = 4 * i / w;
    const int c = (int)(4 * i - row * w);
    const float mul = c < dq ? scale : 1.f;
    bf16* out = c < dq ? dk + row * dq + c : dv_out + row * dv + (c - dq);
    uint2 v;
    v.x = pack_bf16(acc.x * mul, acc.y * mul);
    v.y = pack_bf16(acc.z * mul, acc.w * mul);
    *reinterpret_cast<uint2*>(out) = v;
  }
}

// dQ of one (batch row, head, 64-row q tile).
template <int DQA, int DVA>
__global__ void __launch_bounds__(kQThreads, q_min_blocks(DQA))
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, bf16* __restrict__ dq_out,
                  int b, int s, int t, int nh, int kvh, int dq, int dv,
                  int causal, float scale) {
  constexpr uint32_t kTileQ = DQA * kAtomBytes;
  constexpr uint32_t kTileV = DVA * kAtomBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sO = sQ + kTileQ;                // dO
  const uint32_t sK = sO + kTileV;                // + stage * kTileQ
  const uint32_t sV = sK + kQStages * kTileQ;     // + stage * kTileV
  const uint32_t bars = sV + kQStages * kTileV;
  const uint32_t full = bars;
  const uint32_t empty = bars + 8 * kQStages;
  const uint32_t qbar = bars + 16 * kQStages;

  // heaviest q tiles first (under causal the last ones see the most keys)
  const int rows = nh * b;
  const int n_qt = (s + kBlock - 1) / kBlock;
  const int qt = n_qt - 1 - (int)(blockIdx.x / rows);
  const int h = blockIdx.x % rows % nh, bi = blockIdx.x % rows / nh;
  const int kh = h / (nh / kvh);
  const int q0 = qt * kBlock;
  const int kend = causal ? min(t, q0 + kBlock) : t;
  const int n_kt = (kend + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(qbar, kTileQ + kTileV);
      for (int a = 0; a < DQA; ++a)
        tma_load_4d(sQ + a * kAtomBytes, &tq, qbar, a * 64, h, q0, bi);
      for (int a = 0; a < DVA; ++a)
        tma_load_4d(sO + a * kAtomBytes, &tdo, qbar, a * 64, h, q0, bi);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kQStages;
        mbar_wait(empty + 8 * st, ((kt / kQStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, kTileQ + kTileV);
        for (int a = 0; a < DQA; ++a)
          tma_load_4d(sK + st * kTileQ + a * kAtomBytes, &tk, full + 8 * st,
                      a * 64, kh, kt * kBlock, bi);
        for (int a = 0; a < DVA; ++a)
          tma_load_4d(sV + st * kTileV + a * kAtomBytes, &tv, full + 8 * st,
                      a * 64, kh, kt * kBlock, bi);
      }
    }
    return;
  }

  // consumers: the warpgroup's 64 q rows
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int row_a = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  const float scale_log2 = scale * kLog2e;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    const long at = ((long)bi * nh + h) * s + row;
    l2[r] = row < s ? lse[at] * kLog2e : 0.f;
    dd[r] = row < s ? dsum[at] : 0.f;
  }
  float acc[32 * DQA];
#pragma unroll
  for (int i = 0; i < 32 * DQA; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kQStages;
    const int k0 = kt * kBlock;
    mbar_wait(full + 8 * st, (kt / kQStages) & 1);
    const uint32_t kb = sK + st * kTileQ;
    float sc[32], dp[32];
    product_abt<DQA>(sc, sQ, kb);             // S = Q K^T
    product_abt<DVA>(dp, sO, sV + st * kTileV);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    const bool edge =
        (causal && k0 + kBlock - 1 > q0) || k0 + kBlock > t || q0 + kBlock > s;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(sc[i] * scale_log2 - l2[r]);
      if (edge) {
        const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
        const int row = r ? row_b : row_a;
        if (col >= t || row >= s || (causal && col > row)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dd[r]);
    }
    product_ab<DQA>(acc, dp, kb);                 // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(empty + 8 * st);                  // K and V of this stage read
  }
  store_acc<DQA>(acc, dq_out, nullptr, 0, b, bi, q0, h, s, nh, dq, dq, 0,
                 scale);
  // this grid ends after the dK/dV grid, so that work after it on the
  // stream (the partials' sum, the caller) sees dK and dV
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The launch of one backward: head splits, blocks and ring stages of each
// pass, dynamic shared memory, and the fp32 scratch (D, then the partials).
struct Plan {
  int splits, kv_blocks, q_blocks, kv_stages, q_stages, kv_smem, q_smem;
  long long part_floats, scratch_floats;
};

// The card's SM count, asked once per device.
cudaError_t sm_count(int* n) {
  static int sms[repro_dev::kMaxDevices] = {};
  int dev = 0;
  if (cudaError_t err = repro_dev::current(&dev)) return err;
  if (sms[dev] == 0)
    if (cudaError_t err = cudaDeviceGetAttribute(
            &sms[dev], cudaDevAttrMultiProcessorCount, dev))
      return err;
  *n = sms[dev];
  return cudaSuccess;
}

cudaError_t make_plan(int b, int s, int t, int nh, int kvh, int dq, int dv,
                      Plan* p) {
  if (b < 1 || s < 1 || t < 1 || kvh < 1 || nh < kvh || nh % kvh ||
      dq % 8 || dv % 8 || dv < 8 || dv > dq || dq > 256)
    return cudaErrorInvalidValue;
  int sms = 0;
  if (cudaError_t err = sm_count(&sms)) return err;
  const int dqa = (dq + 63) / 64, dva = (dv + 63) / 64, g = nh / kvh;
  const int rows = kv_rows(dqa, dva);
  const long long base = (long long)b * kvh * ((t + rows - 1) / rows);
  p->splits = g;
  for (int d = 1; d < g; ++d)
    if (g % d == 0 && base * d >= sms) {
      p->splits = d;
      break;
    }
  p->kv_blocks = (int)(base * p->splits);
  p->q_blocks = b * nh * ((s + kBlock - 1) / kBlock);
  p->kv_stages = kv_stages(dqa, dva);
  p->q_stages = kQStages;
  p->kv_smem = kv_smem(dqa, dva, p->kv_stages);
  p->q_smem = q_smem(dqa, dva);
  p->part_floats =
      p->splits > 1 ? (long long)p->splits * b * t * kvh * (dq + dv) : 0;
  // D first, rounded up to 64 floats so that the partials are aligned
  p->scratch_floats = ((long long)b * nh * s + 63) / 64 * 64 + p->part_floats;
  return cudaSuccess;
}

template <int DQA, int DVA>
int launch_da(const Plan& p, const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, const CUtensorMap& tdo, const bf16* o,
              const bf16* dout, const float* lse, float* scratch,
              bf16* dq_out, bf16* dk, bf16* dv_out, int b, int s, int t,
              int nh, int kvh, int dq, int dv, int causal, float scale,
              cudaStream_t stream) {
  // raise the opt-in limits once per instance and device
  static int granted_kv[repro_dev::kMaxDevices] = {};
  static int granted_q[repro_dev::kMaxDevices] = {};
  if (int err = repro_dev::grant_smem(bwd_dkdv_kernel<DQA, DVA>, p.kv_smem,
                                      granted_kv))
    return err;
  if (int err = repro_dev::grant_smem(bwd_dq_kernel<DQA, DVA>, p.q_smem,
                                      granted_q))
    return err;
  float* dsum = scratch;
  float* part = scratch + (p.scratch_floats - p.part_floats);
  int lanes = 1;                                  // a row's group of lanes
  while (lanes * 8 < dv) lanes *= 2;
  const long threads = (long)b * s * nh * lanes;
  bwd_dot_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      o, dout, dsum, b, s, nh, dv, lanes);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  bwd_dkdv_kernel<DQA, DVA>
      <<<(unsigned)p.kv_blocks, kKvThreads, p.kv_smem, stream>>>(
          tq, tk, tv, tdo, lse, dsum, dk, dv_out, part, b, s, t, nh, kvh, dq,
          dv, causal, p.splits, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  // dQ as a programmatic dependent of dK/dV: its blocks fill the SMs that
  // dK/dV blocks leave (under causal masking, most of the card in its tail)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.q_blocks);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = (size_t)p.q_smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, bwd_dq_kernel<DQA, DVA>, tq, tk, tv, tdo, lse,
          (const float*)dsum, dq_out, b, s, t, nh, kvh, dq, dv, causal,
          scale))
    return (int)err;
  if (p.splits > 1) {
    const long kv_rows = (long)b * t * kvh;
    const long n4 = kv_rows * (dq + dv) / 4;
    const long grid = (n4 + 255) / 256;
    bwd_sum_kernel<<<(unsigned)(grid < 4096 ? grid : 4096), 256, 0,
                     stream>>>(part, dk, dv_out, kv_rows, dq, dv, p.splits,
                               scale);
  }
  return (int)cudaGetLastError();
}

// The instance for (DQA, dva), every dva <= DQA.
template <int DQA, class... Args>
int launch_dq(int dva, Args... args) {
  auto go = [&](auto dva_c) {
    return launch_da<DQA, decltype(dva_c)::value>(args...);
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

// Dynamic shared memory of the larger of the two passes' blocks at
// query/key head dim dq and value head dim dv.
extern "C" int flash_attention_bwd_smem_bytes(int dq, int dv) {
  const int dqa = (dq + 63) / 64, dva = (dv + 63) / 64;
  const int kv = kv_smem(dqa, dva, kv_stages(dqa, dva));
  const int q = q_smem(dqa, dva);
  return kv > q ? kv : q;
}

// The launch flash_attention_bwd_bf16 makes at these shapes, into out[9]:
// head splits, dK/dV blocks, dQ blocks, dK/dV ring stages, dQ ring stages,
// dK/dV and dQ dynamic shared memory, partial bytes, and the fp32 scratch
// the caller allocates (D, then the partials). On the current device.
extern "C" int flash_attention_bwd_plan(int b, int s, int t, int nh, int kvh,
                                        int dq, int dv, long long* out) {
  Plan p;
  if (cudaError_t err = make_plan(b, s, t, nh, kvh, dq, dv, &p))
    return (int)err;
  const long long fields[] = {p.splits,    p.kv_blocks, p.q_blocks,
                              p.kv_stages, p.q_stages,  p.kv_smem,
                              p.q_smem,    4 * p.part_floats,
                              p.scratch_floats};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return 0;
}

// q (b, s, nh, dq), k (b, t, kvh, dq), v (b, t, kvh, dv), o and dout (b, s,
// nh, dv), all bf16; lse (b, nh, s) fp32, the forward's natural-log row
// logsumexp of the scaled scores; scratch fp32 of the plan's
// scratch_floats (flash_attention_bwd_plan); outputs dq (b, s, nh, dq), dk
// (b, t, kvh, dq), dv (b, t, kvh, dv) bf16. Contiguous, 16-byte aligned;
// dq % 8 == dv % 8 == 0, dv <= dq <= 256, nh % kvh == 0 (the Python wrapper
// checks). Three or four launches on `stream`: D, dK/dV, the partials' sum
// when the group is split, dQ. Returns the CUDA error of the launches (0 =
// cudaSuccess).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* scratch, void* dq_out,
                                        void* dk, void* dv_out, int b, int s,
                                        int t, int nh, int kvh, int dq,
                                        int dv, int causal, float scale,
                                        void* stream) {
  Plan p;
  if (cudaError_t err = make_plan(b, s, t, nh, kvh, dq, dv, &p))
    return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, b, s, nh, dq, kBlock) ||
      !encode(&tk, k, b, t, kvh, dq, kBlock) ||
      !encode(&tv, v, b, t, kvh, dv, kBlock) ||
      !encode(&tdo, dout, b, s, nh, dv, kBlock))
    return (int)cudaErrorInvalidValue;
  const int dva = (dv + 63) / 64;
  auto go = [&](auto dqa_c) {
    return launch_dq<decltype(dqa_c)::value>(
        dva, p, tq, tk, tv, tdo, (const bf16*)o, (const bf16*)dout, lse,
        scratch, (bf16*)dq_out, (bf16*)dk, (bf16*)dv_out, b, s, t, nh, kvh,
        dq, dv, causal, scale, (cudaStream_t)stream);
  };
  switch ((dq + 63) / 64) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 3: return go(std::integral_constant<int, 3>{});
    case 4: return go(std::integral_constant<int, 4>{});
  }
  return (int)cudaErrorInvalidValue;
}
