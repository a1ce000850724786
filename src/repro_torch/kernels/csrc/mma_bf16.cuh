// Device helpers of the decode-shaped attention kernels (decode_body.cuh):
// the bf16 `mma.sync.m16n8k16` tensor-core product (fp32 accumulation), its
// fragment loads (`ldmatrix`) and packs, and 16-byte `cp.async` copies into
// shared memory.
//
// Fragment layout of m16n8k16 (per lane; gid = lane / 4, tig = lane % 4;
// each 32-bit register holds two bf16 of adjacent k, low half first):
// A (16 x 16) a[0] row gid, k tig*2..+1; a[1] row gid+8, same k;
//             a[2] row gid, k tig*2+8..+9; a[3] row gid+8, same k;
// B (16 x 8)  b[0] column gid, k tig*2..+1; b[1] column gid, k tig*2+8..+9;
// C (16 x 8)  c[0..1] row gid, columns tig*2..+1; c[2..3] row gid+8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_attn {

constexpr int kMaxD = 256;        // largest head dim the kernels take
constexpr int kPad = 8;           // bf16 row pad: conflict-free fragment loads
constexpr float kNegInf = -1e30f; // the reference's NEG_INF

typedef __nv_bfloat16 bf16;

// c += a · b for one 16 x 8 x 16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory, one 32-bit register each:
// lane t gives the address of row t % 8 of matrix t / 8 (16 bytes, 16-byte
// aligned). Plain: register i of lane t holds row t / 4, elements
// (t % 4)·2..+1 of matrix i (an A or a k-contiguous B fragment). `_trans`:
// it holds element column t / 4, rows (t % 4)·2..+1 (a B fragment from a
// k-major, n-contiguous tile).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two fp32 values rounded to a bf16 pair, low half = lo.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Close the group of copies this thread has issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace repro_attn
