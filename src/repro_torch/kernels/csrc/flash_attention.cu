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
// the card's ~295 operations per byte, so it is bound by operations: the
// tensor cores have to be fed, and each kv tile's load has to hide behind
// the products on the tile before it.
//
// The design, per block (one warpgroup of consumers and one producer warp):
// - Both products are `wgmma.mma_async` (wgmma_bf16.cuh). S = Q K^T is
//   m64n64k16 with Q and K K-major in shared memory; P V is m64n{D}k16 with
//   D the value head dim rounded up to 64, P taken straight from the S
//   accumulator registers packed to bf16 pairs (no trip through shared
//   memory) and V read MN-major (the transpose flag). The 64 x D fp32
//   output accumulator lives in registers (128 a thread at dv = 256).
// - The query/key head dim dq and the value head dim dv may differ (MLA:
//   dq = qk_nope + qk_rope, dv = v_head_dim, e.g. 192 and 128): Q, K and
//   the depth of S = Q K^T are DQA 64-column atoms, V, the P·V width and
//   the output DVA atoms, each rounded up on its own. Only the pairs with
//   DVA <= DQA are built (the wrapper takes dv <= dq).
// - K and V arrive by TMA (one 4-d tensor map each, encoded on the host per
//   call and passed as __grid_constant__) into a ring of kStages stages in
//   128-byte-swizzle layout; one thread of the producer warp keeps the ring
//   full, `mbarrier`s report each stage full (TMA byte count) and empty (the
//   128 consumer threads), so the next tile's copy runs under this tile's
//   products. Rows past t and columns past d arrive as TMA's zero fill:
//   nothing outside the tensors is read, zero columns add exactly 0 to
//   Q K^T and are never stored. Any d % 8 == 0 up to 256 works: a row is
//   then d·2 bytes, a multiple of the 16 that TMA needs of every stride,
//   and the epilogue's bf16 pairs stop at column dv - 2.
// - Only the diagonal tile and the ragged last tile are masked. The block
//   order puts the q tiles with the most kv tiles first.
//
// Numerics: scores and softmax in fp32 like the reference, with the scale
// folded into log2(e) so the exponentials are exp2f; P is rounded to bf16
// for the P·V product (the reference keeps it fp32) while the row sums use
// the fp32 P; the denominator is floored at 1e-30. Masked keys take -1e30
// and so probability exactly 0. The kernel agrees with the reference to
// bf16 rounding, not bitwise.
//
// lse: when the caller passes a non-null fp32 (b, nh, s) buffer (entry
// flash_attention_lse_bf16, the forward of a training step), the epilogue
// also stores each row's natural-log m + log(l) of the scaled scores, the
// softmax statistic the backward kernel (flash_attention_bwd.cu) rebuilds
// P from. The kernel keeps m in log2 units and l as a sum of exp2f, so the
// store is (m + log2(l)) · ln 2. It adds a store and changes nothing else:
// the output is bit for bit that of a launch without lse.
//
// The paged variant (kPaged, entry paged_chunk_attention_bf16) is the
// chunked-prefill attention, which the JAX package runs as jnp on every
// backend (src/repro/kernels/ref.py, `paged_chunk_attention`): query j of
// row bi sits at position lengths[bi] + j and sees every pooled position up
// to it through the row's block table (dq == dv: the pools have one head
// dim). Only two things change, so the consumer code, and with it the
// accumulation order, is flash's:
// - the producer loads each 64-row kv tile as 64 / bt TMA boxes of one page
//   each (page id from block_tables, read by the producer thread), into the
//   same swizzle atoms; box i lands at i * bt * 128 bytes, a multiple of
//   the 128-byte swizzle's 1024-byte period for bt = 8..64, so the atom's
//   swizzle is that of one 64-row box;
// - the causal test and the walk's end carry the row's offset lengths[bi].
// Every output row depends only on its Q row, the kv tiles it walks and
// its mask, and both variants walk tiles at absolute multiples of 64 from
// position 0; a tile past a row's position is fully masked and leaves
// (m, l, acc) bit for bit as they were (alpha = exp2f(0) = 1, p = 0, V
// finite). So a chunk row equals the whole-prefill row at the same position
// on the same K/V, bit for bit. Keys past max_blocks * bt are masked like
// keys past t, read from the row's last table entry.
#include <cuda.h>

#include <type_traits>

#include "per_device.cuh"
#include "wgmma_bf16.cuh"

using namespace repro_wgmma;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 64;                      // q rows and kv rows a tile
constexpr int kStages = 2;                      // K/V ring depth
constexpr int kConsumers = 128;                 // one warpgroup
constexpr int kThreads = kConsumers + 32;       // + the producer warp
constexpr uint32_t kAtomBytes = kBlock * 64 * 2;  // 64 rows x 128 bytes
constexpr float kNegInf = -1e30f;                 // the reference's NEG_INF

// Bytes of dynamic shared memory for DQA query/key and DVA value swizzle
// atoms: Q, the K and V ring, 2 * kStages + 1 barriers, and 1 KB to align
// the tiles.
constexpr int smem_bytes(int dqa, int dva) {
  return 1024 + ((1 + kStages) * dqa + kStages * dva) * (int)kAtomBytes +
         8 * (2 * kStages + 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DQA / DVA = the query/key and the value head dims rounded up to 64, in
// 64-column swizzle atoms (1..4); dv is the output's head dim.
// kPaged (DQA == DVA): tk/tv map the pools (num_pages, bt, kvh, d), `tables`
// (b, t / bt) and `lengths` (b,) are read, t = max_blocks * bt and causal is
// 1; else tables, lengths and bt are unused. `lse` (b, nh, s) fp32 or null.
template <int DQA, int DVA, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ tables,
                     const int* __restrict__ lengths, int b, int s, int t,
                     int nh, int kvh, int dv, int causal, int bt,
                     float scale_log2) {
  static_assert(!kPaged || DQA == DVA, "the pools have one head dim");
  constexpr int kN = 64 * DVA;                    // P·V output width
  constexpr uint32_t kTileQ = DQA * kAtomBytes;   // one 64-row Q or K tile
  constexpr uint32_t kTileV = DVA * kAtomBytes;   // one 64-row V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // atoms are 1 KB aligned
  const uint32_t sK = sQ + kTileQ;                // + stage * kTileQ
  const uint32_t sV = sK + kStages * kTileQ;      // + stage * kTileV
  const uint32_t bars = sV + kStages * kTileV;
  const uint32_t full = bars;                     // + 8 * stage
  const uint32_t empty = bars + 8 * kStages;
  const uint32_t qbar = bars + 16 * kStages;

  // heaviest q tiles first: the slowest-varying part of the block index
  // walks the q tiles from the last (most kv tiles under causal) down
  const int rows = nh * b;
  const int n_qt = (s + kBlock - 1) / kBlock;
  const int qt = n_qt - 1 - (int)(blockIdx.x / rows);
  const int h = blockIdx.x % rows % nh, bi = blockIdx.x % rows / nh;
  const int kh = h / (nh / kvh);
  const int q0 = qt * kBlock;
  // logical position of query row 0: the row's cached length when paged
  const int qoff = kPaged ? lengths[bi] : 0;
  const int kend = causal ? min(t, qoff + q0 + kBlock) : t;
  const int n_kt = (kend + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every copy, the rest of the warp idles
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, kTileQ);
      for (int a = 0; a < DQA; ++a)
        tma_load_4d(sQ + a * kAtomBytes, &tq, qbar, a * 64, h, q0, bi);
      const int per = kPaged ? kBlock / bt : 0;     // pages a kv tile
      const int mb = kPaged ? t / bt : 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        const uint32_t ph = (kt / kStages) & 1;
        // the tile's page ids, read before the wait so that their latency
        // hides behind it; bt >= 8, so at most 8 (fixed indices: registers)
        int page[kBlock / 8];
#pragma unroll
        for (int i = 0; i < kBlock / 8; ++i)
          page[i] = kPaged && i < per
                        ? tables[(long)bi * mb + min(kt * per + i, mb - 1)]
                        : 0;
        mbar_wait(empty + 8 * st, ph ^ 1);          // stage free again
        mbar_expect_tx(full + 8 * st, kTileQ + kTileV);
        for (int a = 0; a < DQA; ++a) {
          const uint32_t ka = sK + st * kTileQ + a * kAtomBytes;
          const uint32_t va = sV + st * kTileV + a * kAtomBytes;
          if (kPaged) {
#pragma unroll
            for (int i = 0; i < kBlock / 8; ++i) {
              if (i >= per) break;
              tma_load_4d(ka + i * bt * 128, &tk, full + 8 * st, a * 64, kh,
                          0, page[i]);
              tma_load_4d(va + i * bt * 128, &tv, full + 8 * st, a * 64, kh,
                          0, page[i]);
            }
          } else {
            tma_load_4d(ka, &tk, full + 8 * st, a * 64, kh, kt * kBlock, bi);
            if (a < DVA)
              tma_load_4d(va, &tv, full + 8 * st, a * 64, kh, kt * kBlock,
                          bi);
          }
        }
      }
    }
    return;
  }

  // consumers: the warpgroup's 64 q rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_a = q0 + warp * 16 + gid;        // rows of acc[4j + 0/1]
  const int row_b = row_a + 8;                   // rows of acc[4j + 2/3]

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};           // log2 units
  float l_run[2] = {0.f, 0.f};                   // this thread's share

  mbar_wait(qbar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * kBlock;
    mbar_wait(full + 8 * st, (kt / kStages) & 1);
    const uint32_t kbase = sK + st * kTileQ, vbase = sV + st * kTileV;

    // S = Q K^T: 4 k16 steps per atom; steps past dq multiply zero fill
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * DQA; ++ks) {
      const uint32_t off = (ks >> 2) * kAtomBytes + (ks & 3) * 32;
      wgmma_ss_m64n64k16(sc, desc_sw128(sQ + off, 16, 1024),
                         desc_sw128(kbase + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // scale into log2 units, mask, online softmax; a row's 64 scores lie
    // on the 4 lanes of one quad
    const bool edge =
        (causal && k0 + kBlock - 1 > qoff + q0) || k0 + kBlock > t;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (col >= t || (causal && col > qoff + row)) x = kNegInf;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(sc[i] - m_run[(i >> 1) & 1]);
      sc[i] = p;
      rs[(i >> 1) & 1] += p;
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: n8 groups 2kk and 2kk + 1 of S are the A operand of k16
    // step kk; V's step kk is its rows 16kk..16kk+15 (two 1 KB row groups)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kN>(acc, pa[kk],
                   desc_sw128(vbase + kk * 2048, kAtomBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(empty + 8 * st);                 // K and V of this stage read
  }

  // finalize: full row sums, divide, store bf16 pairs of the dv real columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / fmaxf(l_run[0], 1e-30f),
                        1.f / fmaxf(l_run[1], 1e-30f)};
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      if (row < s)
        lse[((long)bi * nh + h) * s + row] =
            (m_run[r] + log2f(fmaxf(l_run[r], 1e-30f))) * 0.6931471805599453f;
    }
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (col >= dv) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      if (row < s)
        *reinterpret_cast<uint32_t*>(o + (((long)bi * s + row) * nh + h) * dv +
                                     col) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r],
                      acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int DQA, int DVA, bool kPaged>
int launch_da(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, void* o, float* lse, const int* tables,
              const int* lengths, int b, int s, int t, int nh, int kvh,
              int dv, int causal, int bt, float scale, cudaStream_t stream) {
  const int smem = smem_bytes(DQA, DVA);
  // raise the opt-in limit once per instance and device
  static int granted[repro_dev::kMaxDevices] = {};
  if (int err = repro_dev::grant_smem(flash_fwd_kernel<DQA, DVA, kPaged>,
                                      smem, granted))
    return err;
  const long blocks = (long)((s + kBlock - 1) / kBlock) * nh * b;
  flash_fwd_kernel<DQA, DVA, kPaged>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          tq, tk, tv, (bf16*)o, lse, tables, lengths, b, s, t, nh, kvh, dv,
          causal, bt, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// The instance for (DQA, dva): DVA == DQA for both variants, and for flash
// also every DVA < DQA.
template <bool kPaged, int DQA>
int launch_dq(int dva, const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, void* o, float* lse, const int* tables,
              const int* lengths, int b, int s, int t, int nh, int kvh,
              int dv, int causal, int bt, float scale, cudaStream_t stream) {
  auto go = [&](auto dva_c) {
    return launch_da<DQA, decltype(dva_c)::value, kPaged>(
        tq, tk, tv, o, lse, tables, lengths, b, s, t, nh, kvh, dv, causal, bt,
        scale, stream);
  };
  if (dva == DQA) return go(std::integral_constant<int, DQA>{});
  if constexpr (!kPaged) {
    if constexpr (DQA > 1)
      if (dva == 1) return go(std::integral_constant<int, 1>{});
    if constexpr (DQA > 2)
      if (dva == 2) return go(std::integral_constant<int, 2>{});
    if constexpr (DQA > 3)
      if (dva == 3) return go(std::integral_constant<int, 3>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kPaged>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, float* lse, const int* tables,
           const int* lengths, int b, int s, int t, int nh, int kvh, int dq,
           int dv, int causal, int bt, float scale, cudaStream_t stream) {
  const int dva = (dv + 63) / 64;
  switch ((dq + 63) / 64) {
    case 1:
      return launch_dq<kPaged, 1>(dva, tq, tk, tv, o, lse, tables, lengths,
                                  b, s, t, nh, kvh, dv, causal, bt, scale,
                                  stream);
    case 2:
      return launch_dq<kPaged, 2>(dva, tq, tk, tv, o, lse, tables, lengths,
                                  b, s, t, nh, kvh, dv, causal, bt, scale,
                                  stream);
    case 3:
      return launch_dq<kPaged, 3>(dva, tq, tk, tv, o, lse, tables, lengths,
                                  b, s, t, nh, kvh, dv, causal, bt, scale,
                                  stream);
    case 4:
      return launch_dq<kPaged, 4>(dva, tq, tk, tv, o, lse, tables, lengths,
                                  b, s, t, nh, kvh, dv, causal, bt, scale,
                                  stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of one block at query/key head dim dq and value
// head dim dv (Q, the K/V ring, the barriers and the alignment slack).
extern "C" int flash_attention_smem_bytes(int dq, int dv) {
  return smem_bytes((dq + 63) / 64, (dv + 63) / 64);
}

// q (b, s, nh, dq), k (b, t, kvh, dq), v (b, t, kvh, dv), o (b, s, nh, dv);
// all bf16, contiguous, 16-byte aligned. dq % 8 == dv % 8 == 0, dv <= dq <=
// 256, nh % kvh == 0 (the Python wrapper checks). `lse` is null or an fp32
// (b, nh, s) buffer that receives each row's natural-log logsumexp of the
// scaled scores. Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int flash_attention_lse_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int b, int s, int t, int nh, int kvh,
                                        int dq, int dv, int causal,
                                        float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, b, s, nh, dq, kBlock) ||
      !encode(&tk, k, b, t, kvh, dq, kBlock) ||
      !encode(&tv, v, b, t, kvh, dv, kBlock))
    return (int)cudaErrorInvalidValue;
  return launch<false>(tq, tk, tv, o, lse, nullptr, nullptr, b, s, t, nh,
                       kvh, dq, dv, causal, 0, scale, (cudaStream_t)stream);
}

// The serving entry: flash_attention_lse_bf16 without lse.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int t, int nh, int kvh, int dq, int dv,
                                    int causal, float scale, void* stream) {
  return flash_attention_lse_bf16(q, k, v, o, nullptr, b, s, t, nh, kvh, dq,
                                  dv, causal, scale, stream);
}

// Chunked-prefill attention over paged K/V: q (b, s, nh, d), pools k/v
// (num_pages, bt, kvh, d), tables (b, mb) int32 of valid page ids, lengths
// (b,) int32, o (b, s, nh, d); query j of row i sees pooled positions
// <= lengths[i] + j. bf16, contiguous, 16-byte aligned; d % 8 == 0,
// d <= 256, nh % kvh == 0, bt in {8, 16, 32, 64} (the Python wrapper
// checks). Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int paged_chunk_attention_bf16(const void* q, const void* k,
                                          const void* v, const int* tables,
                                          const int* lengths, void* o, int b,
                                          int s, int nh, int kvh, int d,
                                          int bt, int mb, int num_pages,
                                          float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, b, s, nh, d, kBlock) ||
      !encode(&tk, k, num_pages, bt, kvh, d, bt) ||
      !encode(&tv, v, num_pages, bt, kvh, d, bt))
    return (int)cudaErrorInvalidValue;
  return launch<true>(tq, tk, tv, o, nullptr, tables, lengths, b, s, mb * bt,
                      nh, kvh, d, d, 1, bt, scale, (cudaStream_t)stream);
}
