// The one-token decode body shared by the port's three decode-shaped
// attention kernels: paged decode, paged speculative verify
// (paged_attention.cu) and dense decode (decode_attention.cu).
//
// Split over the sequence. Each row's tokens are cut at fixed absolute
// positions: split i covers tokens [i·kSplit, min((i+1)·kSplit, len)). The
// grid holds one block per (row, kv head[, query tile], split) for every
// split the capacity allows (the host cannot read the lengths without a
// synchronise); a block whose first token lies at or past its longest row
// exits at once. A live block holds up to 16 query rows of one kv head
// (padded to the mma M), starts from (m = -inf, l = 0, acc = 0) and walks
// its split 64 tokens at a time: each token row's place in K/V (`kv_of`,
// for the paged kernels a block-table read, issued before the row's length
// arrives) is looked up once into shared memory, each chunk's 16-byte
// pieces are copied with cp.async (whole token rows per warp pass), two
// chunks in flight when a split has more than one, the S tile comes from
// `mma.sync.m16n8k16` on `ldmatrix` fragments, the online softmax runs with
// 8 threads per row, and P·V accumulates in registers. The block writes
// each valid row's fp32 (m, l, unnormalised acc) to scratch. A second
// kernel, launched from the same C entry point right behind on the same
// stream as a programmatic dependent (it starts while the split blocks
// finish and waits for their grid before reading), merges each output
// row's splits 0 .. ceil(len / kSplit) - 1 in that order:
//   M = max m_i,  o = sum acc_i·e^(m_i - M) / sum l_i·e^(m_i - M),
// with no atomics. A second kernel, not a last-block-merges counter:
// nothing persists between calls (no counters to zero or to lose to an
// aborted launch, no race between streams), and the order of the sum is
// fixed by construction. A length-0 row merges no split and gives zeros.
// Where the caller asks for it (dense decode's `lse`), the merge also
// writes each row's log-sum-exp of its scaled scores in fp32, M + log of
// the summed l, from the (m, l) pairs it holds already; -inf for a
// length-0 row. That is what a caller needs to merge the outputs of
// several calls over slices of one sequence.
//
// The kernels differ only in where token row p of K/V lives (`kv_of`),
// which output row each of the 16 mma rows holds (`row_of`) and how long
// that row is (`len_of`). Every query row goes through the same per-row
// arithmetic whatever the others are, and the split points and the merge
// order depend only on kSplit and the row's own length, which is what the
// bitwise contracts rest on:
//  * dense decode == paged decode on the same logical cache (same splits,
//    same chunks, same k-split, same shuffles, same merge);
//  * verify position j == paged decode at lengths + j + 1: within a split,
//    a chunk wholly past a row's length leaves its state exactly as it was
//    (m stays, alpha = 1, P = 0), and a masked position inside a live chunk
//    adds exactly 0·V whether its V row was loaded or zero-filled; a split
//    wholly past a row's length is neither written nor merged for it.
// Head dims: d % 8 == 0, d <= 256. Token rows move in 16-byte pieces (d / 8
// of them) and P·V in n8 output tiles, both in units of 8 columns; Q K^T
// steps 16 columns at a time, so at d % 16 == 8 its last step covers the
// 8 zeroed pad columns of each shared-memory row.
// Numerics: bf16 x bf16 scores accumulated in fp32, fp32 softmax, bf16
// probabilities into P·V with fp32 accumulation, fp32 merge, normalised at
// the end.
#pragma once

#include "mma_bf16.cuh"
#include "per_device.cuh"

// Tokens per split: 64 timed fastest of 64, 128 and 256 for paged decode at
// b = 8 on an H100 (tools/decode_split.py, which builds the others with
// -DDECODE_SPLIT=T). The wrappers' scratch sizing mirrors it
// (`_build.DECODE_SPLIT`) and checks it against `decode_split_tokens()`
// when a library loads.
#ifndef DECODE_SPLIT
#define DECODE_SPLIT 64
#endif

namespace repro_attn {

constexpr int kChunk = 64;  // tokens per loop step
constexpr int kSplit = DECODE_SPLIT;
static_assert(kSplit > 0 && kSplit % kChunk == 0,
              "DECODE_SPLIT must be a positive multiple of 64");
constexpr int kStages = kSplit > kChunk ? 2 : 1;  // K/V chunks in flight
constexpr int kRows = 16;   // query rows per block, padded to the mma M
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdP = kChunk + kPad;
constexpr int kMergeThreads = kMaxD / 4;  // four output columns each

inline int n_splits(int cap) { return cap > 0 ? (cap + kSplit - 1) / kSplit : 0; }

// Dynamic shared memory of one block at head dim d (Q rows, kStages K/V
// chunks, P, the split's token rows, scores, softmax state, row lengths).
inline int decode_smem_bytes(int d) {
  return (kRows + 2 * kStages * kChunk) * (d + kPad) * (int)sizeof(bf16) +
         kRows * kLdP * (int)sizeof(bf16) + kSplit * (int)sizeof(long long) +
         (kRows * kChunk + 3 * kRows) * (int)sizeof(float) +
         kRows * (int)sizeof(int);
}

// One split of up to 16 query rows of one kv head. q: query elements;
// row_of(i) is the output row of query row i (< n_valid): its d elements
// start at row_of(i)·d in q and out, and its partials of split `split` at
// index row_of(i)·nsplit + split of part_ml (m, l) and, times d, of
// part_acc. k, v: token rows of d elements; kv_of(p) is the row index of
// token p (< cap). len_of(i): row i attends to tokens < len_of(i) <=
// len_max <= cap. Rows n_valid..15 are padding and write nothing; so does a
// row whose length ends at or before the split's first token. kHalf:
// d % 16 == 8, whose Q K^T ends on a half step (each kernel has both
// builds and its C entry picks one, so d % 16 == 0 compiles without it).
template <bool kHalf, class RowOf, class LenOf, class KvOf>
__device__ __forceinline__ void decode_split_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int d, int n_valid, int split, int nsplit,
    int cap, int len_max, RowOf row_of, LenOf len_of, KvOf kv_of,
    float scale) {
  // the merge grid may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int s0 = split * kSplit;
  // where each token row of the split lives, looked up before the block
  // knows its length, so that the paged kernels' table reads overlap the
  // lengths read (-1: past cap)
  constexpr int kTok = (kSplit + kThreads - 1) / kThreads;
  long long tok[kTok];
#pragma unroll
  for (int u = 0; u < kTok; ++u) {
    const int t = threadIdx.x + u * kThreads, p = s0 + t;
    tok[u] = (t < kSplit && p < cap) ? (long long)kv_of(p) : -1;
  }
  if (s0 >= len_max) return;  // no row of the block reaches this split
  const int n_chunks = (min(s0 + kSplit, len_max) - s0 + kChunk - 1) / kChunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = d + kPad;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kRows * ld;                                // [kStages][64]
  bf16* sV = sK + kStages * kChunk * ld;                     // [kStages][64]
  bf16* sP = sV + kStages * kChunk * ld;                     // [16][kLdP]
  long long* sRow = reinterpret_cast<long long*>(sP + kRows * kLdP);
  float* sS = reinterpret_cast<float*>(sRow + kSplit);       // [16][64]
  float* sM = sS + kRows * kChunk;
  float* sL = sM + kRows;
  float* sA = sL + kRows;
  int* sLen = reinterpret_cast<int*>(sA + kRows);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int pieces = d / 8;  // 16-byte pieces of one row (<= 32)
  const int n_dt = d / 8;
  // k16 steps of Q K^T; at d % 16 == 8 (kHalf) the last one reads
  // columns d..d+7, the row pad (ld = d + kPad, kPad = 8), zeroed below in
  // Q and in every K stage so that they add exactly 0
  const int n_ks = kHalf ? d / 16 + 1 : d / 16;

  // the valid query rows; rows n_valid..15 are zero padding
  for (int i = tid; i < kRows * pieces; i += kThreads) {
    const int r = i / pieces, c = i - r * pieces;
    const bool ok = r < n_valid;
    cp_async16(sQ + r * ld + c * 8, ok ? q + (long)row_of(r) * d + c * 8 : q,
               ok ? 16 : 0);
  }
  cp_async_commit();
  // the token rows of the split (-1: past len_max, zero-filled)
#pragma unroll
  for (int u = 0; u < kTok; ++u) {
    const int t = tid + u * kThreads;
    if (t < kSplit) sRow[t] = s0 + t < len_max ? tok[u] : -1;
  }
  if (tid < kRows) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
    sLen[tid] = tid < n_valid ? len_of(tid) : 0;
  }
  if constexpr (kHalf) {
    // the pad columns of the Q rows and of each stage's K rows (which
    // follow Q contiguously); no copy writes them
    static_assert(kPad == 8, "the last k16 step reads 8 pad columns");
    for (int r = tid; r < kRows + kStages * kChunk; r += kThreads)
      *reinterpret_cast<uint4*>(sQ + r * ld + d) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // one chunk's K and V rows into stage `st`: each warp pass copies
  // `rpw` whole token rows, lanes on consecutive 16-byte pieces
  const int rpw = 32 / pieces;
  const int lr = lane / pieces, lc = lane - lr * pieces;
  auto load_chunk = [&](int ch, int st) {
    if (lr < rpw) {
      bf16* dK = sK + st * kChunk * ld;
      bf16* dV = sV + st * kChunk * ld;
      for (int r = warp * rpw + lr; r < kChunk; r += kWarps * rpw) {
        const long long row = sRow[ch * kChunk + r];
        const bool ok = row >= 0;
        const long off = ok ? row * d + lc * 8 : 0;
        cp_async16(dK + r * ld + lc * 8, k + off, ok ? 16 : 0);
        cp_async16(dV + r * ld + lc * 8, v + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  float acc[kMaxD / 32][4];  // n8 tiles j = warp + 4 * jj of the output
#pragma unroll
  for (int jj = 0; jj < kMaxD / 32; ++jj)
    acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch % kStages;
    const int c0 = s0 + ch * kChunk;
    if (ch > 0) __syncthreads();  // previous chunk fully consumed
    if (kStages > 1 && ch + 1 < n_chunks) {
      load_chunk(ch + 1, (ch + 1) % kStages);
      cp_async_wait<1>();  // Q and this chunk landed, the next in flight
    } else {
      if (kStages == 1 && ch > 0) load_chunk(ch, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + st * kChunk * ld;
    const bf16* cV = sV + st * kChunk * ld;

    // S = Q K^T for this warp's 16 tokens (2 n8 tiles); ldmatrix lane
    // addresses: A rows (lane & 7) + 8·((lane >> 3) & 1), k half lane >> 4;
    // B tokens (lane & 7) + 8·(lane >> 4), k half (lane >> 3) & 1
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* qa = sQ + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     (lane >> 4) * 8;
    const bf16* kb = cK + (warp * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kMaxD / 16; ++ks) {
      if (ks < n_ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, qa + ks * 16);
        ldsm_x4(b, kb + ks * 16);
        mma_bf16(sc[0], a, b);
        mma_bf16(sc[1], a, b + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = warp * 16 + nt * 8 + tig * 2 + (e & 1);
        const int row = gid + (e >> 1) * 8;
        sS[row * kChunk + col] =
            (c0 + col < sLen[row]) ? sc[nt][e] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax over the chunk: 8 threads per query row, 8 tokens each
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
        sP[row * kLdP + sub * 8 + i] = __float2bfloat16(row < n_valid ? p : 0.f);
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

    // O = O * alpha + P V over this warp's output tiles; one ldmatrix.trans
    // gives the V fragments of two k16 steps (lane t: token 32·kp + t)
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
    const bf16* pa = sP + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdP +
                     (lane >> 4) * 8;
#pragma unroll
    for (int kp = 0; kp < kChunk / 32; ++kp) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, pa + kp * 32);
      ldsm_x4(a1, pa + kp * 32 + 16);
#pragma unroll
      for (int jj = 0; jj < kMaxD / 32; ++jj) {
        const int j = warp + 4 * jj;
        if (j < n_dt) {
          uint32_t b[4];
          ldsm_x4_trans(b, cV + (kp * 32 + lane) * ld + j * 8);
          mma_bf16(acc[jj], a0, b);
          mma_bf16(acc[jj], a1, b + 2);
        }
      }
    }
  }

  // the split's partials of each valid row that reaches it
  const bool live_a = gid < n_valid && s0 < sLen[gid];
  const bool live_b = gid + 8 < n_valid && s0 < sLen[gid + 8];
  const long pa_row = live_a ? ((long)row_of(gid) * nsplit + split) * d : 0;
  const long pb_row = live_b ? ((long)row_of(gid + 8) * nsplit + split) * d : 0;
#pragma unroll
  for (int jj = 0; jj < kMaxD / 32; ++jj) {
    const int j = warp + 4 * jj;
    if (j < n_dt) {
      if (live_a)
        *reinterpret_cast<float2*>(part_acc + pa_row + j * 8 + tig * 2) =
            make_float2(acc[jj][0], acc[jj][1]);
      if (live_b)
        *reinterpret_cast<float2*>(part_acc + pb_row + j * 8 + tig * 2) =
            make_float2(acc[jj][2], acc[jj][3]);
    }
  }
  if (tid < n_valid && s0 < sLen[tid])
    part_ml[(long)row_of(tid) * nsplit + split] = make_float2(sM[tid], sL[tid]);
}

// The merge: one block per output row r = (bi·s + j)·nh + h of out
// (b, s, nh, d), four columns a thread. Its length is min(lengths[bi] +
// (verify ? j + 1 : 0), cap), as the split kernels count it; splits
// 0 .. ceil(len / kSplit) - 1 are summed in that order by every thread
// (their weights staged in shared memory, kMergeThreads splits at a time).
// Every live split's m is finite (its first token is unmasked), so m_i - M
// never meets -inf - (-inf), and the split holding M has l >= 1. With
// `lse` (one fp32 a row, or null) thread 0 writes M + log(l) there. Launched
// as a programmatic dependent of the split kernel: it may start early and
// waits for that grid before it reads anything.
__global__ void __launch_bounds__(kMergeThreads) decode_merge_kernel(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    const int* __restrict__ lengths, bf16* __restrict__ out,
    float* __restrict__ lse, int s, int nh, int d, int nsplit, int cap,
    int verify) {
  __shared__ float sW[kMergeThreads], sL[kMergeThreads];
  __shared__ float sMax[kMergeThreads / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long r = blockIdx.x;
  const int tid = threadIdx.x, c = tid * 4;
  const int bi = (int)(r / ((long)s * nh));
  const int j = (int)(r / nh) % s;
  const int len = min(max(lengths[bi] + (verify ? j + 1 : 0), 0), cap);
  const int n = (len + kSplit - 1) / kSplit;
  const float2* ml = part_ml + r * nsplit;
  const float* acc = part_acc + r * nsplit * d + c;
  float m = kNegInf;
  for (int i = tid; i < n; i += kMergeThreads) m = fmaxf(m, ml[i].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((tid & 31) == 0) sMax[tid >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) m = fmaxf(m, sMax[w]);
  float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f, l = 0.f;
  for (int i0 = 0; i0 < n; i0 += kMergeThreads) {
    __syncthreads();  // the previous tile's weights are consumed
    if (i0 + tid < n) {
      const float2 e = ml[i0 + tid];
      sW[tid] = expf(e.x - m);
      sL[tid] = e.y;
    }
    __syncthreads();
    const int cnt = min(kMergeThreads, n - i0);
    if (c < d) {
#pragma unroll 8
      for (int i = 0; i < cnt; ++i) {
        const float w = sW[i];
        const float4 a =
            *reinterpret_cast<const float4*>(acc + (long)(i0 + i) * d);
        l += sL[i] * w;
        o0 += a.x * w;
        o1 += a.y * w;
        o2 += a.z * w;
        o3 += a.w * w;
      }
    }
  }
  if (c < d) {
    const float inv = n > 0 ? 1.f / l : 0.f;
    *reinterpret_cast<uint2*>(out + r * d + c) = make_uint2(
        pack_f32(o0 * inv, o1 * inv), pack_f32(o2 * inv, o3 * inv));
  }
  // every thread summed l over the same splits in the same order
  if (lse != nullptr && tid == 0) lse[r] = n > 0 ? m + logf(l) : -INFINITY;
}

// Scratch layout of `rows` output rows at `nsplit` splits of head dim d:
// rows·nsplit·d fp32 accumulators, then rows·nsplit (m, l) pairs.
inline float2* part_ml_of(void* scratch, long rows, int nsplit, int d) {
  return reinterpret_cast<float2*>(static_cast<float*>(scratch) +
                                   rows * nsplit * d);
}

// Launch the merge of `rows` = b·s·nh output rows right behind the split
// kernel (programmatic stream serialisation), writing each row's lse too
// where `lse` is not null; returns the CUDA error.
inline int launch_merge(const float* part_acc, const float2* part_ml,
                        const int* lengths, bf16* out, long rows, int s,
                        int nh, int d, int nsplit, int cap, int verify,
                        cudaStream_t stream, float* lse = nullptr) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_merge_kernel, part_acc, part_ml,
                                 lengths, out, lse, s, nh, d, nsplit, cap,
                                 verify);
}

}  // namespace repro_attn

// The split width this library was built with (the wrappers check it
// against their scratch sizing).
extern "C" int decode_split_tokens() { return repro_attn::kSplit; }
