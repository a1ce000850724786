// The one-token decode body shared by the port's three decode-shaped
// attention kernels: paged decode, paged speculative verify
// (paged_attention.cu) and dense decode (decode_attention.cu).
//
// One thread block holds up to 16 query rows of one kv head (padded to the
// mma M) and walks K/V token rows 0 .. len_max - 1 64 at a time: every
// 16-byte load of a chunk is issued at once with cp.async, the S tile comes
// from `mma.sync.m16n8k16`, the online softmax runs with 8 threads per row,
// and P·V accumulates in registers. The kernels differ only in where token
// row p of K/V lives (`kv_of`), which query row each of the 16 mma rows
// holds (`row_of`) and how long that row is (`len_of`). Every query row
// goes through the same per-row arithmetic whatever the others are, which
// is what the bitwise contracts rest on:
//  * dense decode == paged decode on the same logical cache (same chunks,
//    same k-split, same shuffles);
//  * verify position j == paged decode at lengths + j + 1: a chunk wholly
//    past a row's length leaves its state exactly as it was (m stays,
//    alpha = 1, P = 0), and a masked position inside a live chunk adds
//    exactly 0·V whether its V row was loaded or zero-filled.
// Numerics: bf16 x bf16 scores accumulated in fp32, fp32 softmax, bf16
// probabilities into P·V with fp32 accumulation, normalised at the end.
#pragma once

#include "mma_bf16.cuh"

namespace repro_attn {

constexpr int kChunk = 64;  // tokens per loop step
constexpr int kRows = 16;   // query rows per block, padded to the mma M
constexpr int kWarps = 4;
constexpr int kLdP = kChunk + kPad;

// Dynamic shared memory of one block at head dim d (Q rows, K/V chunk, P,
// scores, softmax state, row lengths).
inline int decode_smem_bytes(int d) {
  return (kRows + 2 * kChunk) * (d + kPad) * (int)sizeof(bf16) +
         kRows * kLdP * (int)sizeof(bf16) +
         (kRows * kChunk + 3 * kRows) * (int)sizeof(float) +
         kRows * (int)sizeof(int);
}

// q, out: query and output elements; row_of(i) is the element offset of
// query row i (< n_valid) in both (dq == dv). k, v: token rows of d
// elements; kv_of(p) is the row index of token p (< len_max). len_of(i):
// row i attends to tokens < len_of(i) <= len_max. Rows n_valid..15 are
// padding and write nothing.
template <class RowOf, class LenOf, class KvOf>
__device__ __forceinline__ void decode_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int d, int n_valid,
    int len_max, RowOf row_of, LenOf len_of, KvOf kv_of, float scale) {
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
  int* sLen = reinterpret_cast<int*>(sA + kRows);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int chunks = d / 8;  // 16-byte pieces of one row
  const int n_dt = d / 8;
  const int n_ks = d / 16;

  // the valid query rows; rows n_valid..15 are zero padding
  for (int i = tid; i < kRows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r < n_valid;
    cp_async16(sQ + r * ld + c * 8, ok ? q + row_of(r) + c * 8 : q,
               ok ? 16 : 0);
  }
  cp_async_wait_all();
  if (tid < kRows) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
    sLen[tid] = tid < n_valid ? len_of(tid) : 0;
  }

  float acc[kMaxD / 32][4];  // n8 tiles j = warp + 4 * jj of the output
#pragma unroll
  for (int jj = 0; jj < kMaxD / 32; ++jj)
    acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;

  const int n_chunks = (len_max + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk;
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < kChunk * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i - r * chunks;
      const int p = c0 + r;
      const bool ok = p < len_max;
      const long row = ok ? kv_of(p) : 0;
      cp_async16(sK + r * ld + c * 8, k + row * d + c * 8, ok ? 16 : 0);
      cp_async16(sV + r * ld + c * 8, v + row * d + c * 8, ok ? 16 : 0);
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
#pragma unroll
  for (int jj = 0; jj < kMaxD / 32; ++jj) {
    const int j = warp + 4 * jj;
    if (j < n_dt) {
      if (gid < n_valid)
        *reinterpret_cast<uint32_t*>(out + row_of(gid) + j * 8 + tig * 2) =
            pack_f32(acc[jj][0] * inv_a, acc[jj][1] * inv_a);
      if (gid + 8 < n_valid)
        *reinterpret_cast<uint32_t*>(out + row_of(gid + 8) + j * 8 + tig * 2) =
            pack_f32(acc[jj][2] * inv_b, acc[jj][3] * inv_b);
    }
  }
}

// Raise a kernel's opt-in dynamic shared memory limit to `smem` bytes once
// per size; `granted` is the caller's static record. Returns the CUDA error.
template <class Kernel>
inline int grant_smem(Kernel kernel, int smem, int* granted) {
  if (smem <= *granted) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  *granted = smem;
  return 0;
}

}  // namespace repro_attn
