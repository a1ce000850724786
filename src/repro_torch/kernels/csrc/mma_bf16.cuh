// Device helpers shared by the port's attention kernels: the bf16
// `mma.sync.m16n8k16` tensor-core product (fp32 accumulation), its fragment
// loads and packs, and 16-byte `cp.async` copies into shared memory.
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

// Two adjacent bf16 values of one row.
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values of one column pair, low half = lower index.
__device__ __forceinline__ uint32_t pack_cols(const bf16* lo, const bf16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
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

// Commit the copies issued so far and wait for all of them (this thread's).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace repro_attn
