// IVF-PQ asymmetric-distance (ADC) scan, the RAG retrieval hot loop:
// out[n] = sum over m of lut[m, codes[n, m]], fp32. Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces: src/repro/kernels/pq_scan.py, `pq_scan` and its Pallas body
// `_pq_kernel`. The TPU kernel has no per-lane gather, so it expands each
// code against an iota over the codebook axis and reduces the one-hot
// product against the LUT. Hopper has the gather: each block holds the whole
// M·K fp32 LUT in shared memory, and a row costs M shared-memory reads, one
// per code. A code outside [0, K) adds exactly 0, as the one-hot compare
// gives, and is never used as an address.
//
// The contract is exact: each row is summed m = 0 … M-1, one fp32 add at a
// time from 0, by one thread. So the output equals, bit for bit, the plain
// in-order sum (`ref.pq_scan_in_order`), whatever the grid or the path.
//
// What bounds it on the H100 (tools/pq_scan_design.py, PERF.md). One
// query (250,000 rows x 16 uint8 codes, 4 MB) is a chain of latencies, not
// bytes: a ~2 us launch, the LUT's and the codes' round trips, then each
// SM's share of the gathers. The gathers are random over 32 banks: 32 lanes
// looking up one 256-entry LUT row take ~3.15 wavefronts, ~1.6 a row at
// M = 16, so each SM gathers its ~1,900 rows in ~1.7 us. A shard (2^28
// rows) is bound by how the grid streams the codes: these loads reach 0.83
// of HBM with the gathers and 0.89 without them.
//
// Design. A persistent grid of as many blocks as fit; the rows are cut into
// batches of kThreads x kR rows dealt to the blocks in turn (block b takes
// batches b, b + grid, …), so that the grid sweeps the codes front to back
// (a contiguous range per block held the shard under 0.6 of HBM).
// - The LUT arrives in one asynchronous bulk copy (`cp.async.bulk`, no
//   tensor map) on an mbarrier; threads wait on it only after their first
//   rows' loads are issued, so its round trip overlaps the codes'. (Plain
//   loads, or four bulk copies, were slower.) A LUT whose size is not a
//   multiple of 16 bytes, or that leaves no room for the barrier
//   (M·K·4 = 232,448), is filled with plain vector loads.
// - Rows of 1, 2 or 4 16-byte vectors, 16-byte aligned (uint8 at M = 16,
//   the IVF-PQ layout; int32 at M = 16): each thread loads kR rows a batch
//   (PQ_LOADS vectors, at least one row) and fetches its next batch while
//   it gathers this one. Any other row: one row at a time, by 16-byte
//   vectors when aligned, else code by code.
// A bulk-copy ring of code tiles behind full/empty mbarriers, one producer
// thread a block, was built and measured against this: one bulk-copy
// stream a block did not keep HBM busy (0.55-0.72 of it on the shard) and
// was slower at one query, so it was taken out.
// The C entry makes the launch plan (grid, vectors a row, LUT fill, shared
// memory) on each call, asking the occupancy once per device, kernel and
// shared-memory size; `pq_scan_plan` reports it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "wgmma_bf16.cuh"

// Knobs for the -D builds of tools/pq_scan_design.py; the shipped build
// takes these defaults.
#ifndef PQ_THREADS
#define PQ_THREADS 256  // threads a block
#endif
#ifndef PQ_LOADS
#define PQ_LOADS 1  // 16-byte row loads a thread a batch (one more batch in
#endif              // flight)
#ifndef PQ_NO_GATHER
#define PQ_NO_GATHER 0  // diagnostic: add the codes, read no LUT entry
#endif

namespace {

using repro_wgmma::mbar_expect_tx;
using repro_wgmma::mbar_fence_init;
using repro_wgmma::mbar_init;
using repro_wgmma::mbar_wait;
using repro_wgmma::smem_u32;

constexpr int kThreads = PQ_THREADS;
constexpr int kLoads = PQ_LOADS;
constexpr int kSmemLimit = 232448;  // one block's shared memory on an H100
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "PQ_THREADS");

// Rows a thread loads a batch at `v` 16-byte vectors a row (0: row by row).
__host__ __device__ constexpr int rows_a_thread(int v) {
  return v > 0 && kLoads / v > 1 ? kLoads / v : 1;
}

// One-dimensional bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename Code>
__device__ __forceinline__ float lookup(const float* s_row, Code code,
                                        int k) {
#if PQ_NO_GATHER
  return (float)code;
#else
  const int c = (int)code;
  return (unsigned)c < (unsigned)k ? s_row[c] : 0.f;
#endif
}

// acc plus the codes m0 … m0 + 16 / sizeof(Code) - 1 held in one 16-byte
// vector, in order.
template <typename Code>
__device__ __forceinline__ float add_vector(float acc, const float* s_lut,
                                            uint4 v, int m0, int k) {
  constexpr int kPer = 16 / sizeof(Code);
  union {
    uint4 v;
    Code c[kPer];
  } u;
  u.v = v;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    acc += lookup(s_lut + (m0 + j) * k, u.c[j], k);
  return acc;
}

// Shared memory: the LUT, then (bulk fill: the LUT is a multiple of 16
// bytes) its barrier.
// kV > 0: every row is exactly kV 16-byte vectors; kV == 0: any row.
template <typename Code, int kV>
__global__ void __launch_bounds__(kThreads)
    pq_scan_kernel(const Code* __restrict__ codes,
                   const float* __restrict__ lut, float* __restrict__ out,
                   long long n, int m, int k, int lut_bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  const int lut_floats = m * k;
  const uint32_t bar = smem_u32(smem + lut_floats * 4);
  if (lut_bulk) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)(lut_floats * 4);
      mbar_init(bar, 1);
      mbar_fence_init();
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(s_lut), lut, bytes, bar);
    }
  } else {  // a plain fill: 16-byte vectors, then the tail
    const int vecs = lut_floats / 4;
    for (int i = threadIdx.x; i < vecs; i += kThreads)
      reinterpret_cast<float4*>(s_lut)[i] =
          reinterpret_cast<const float4*>(lut)[i];
    for (int i = 4 * vecs + threadIdx.x; i < lut_floats; i += kThreads)
      s_lut[i] = lut[i];
  }
  __syncthreads();
  if constexpr (kV == 0) {
    if (lut_bulk) mbar_wait(bar, 0);
    const bool vec = (m * sizeof(Code)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(codes) % 16 == 0;
    constexpr int kPer = 16 / sizeof(Code);
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
         row < n; row += stride) {
      const Code* p = codes + row * m;
      float acc = 0.f;
      if (vec) {
        for (int c0 = 0; c0 < m; c0 += kPer)
          acc = add_vector<Code>(
              acc, s_lut, __ldg(reinterpret_cast<const uint4*>(p + c0)), c0,
              k);
      } else {
        for (int j = 0; j < m; ++j)
          acc += lookup(s_lut + j * k, __ldg(p + j), k);
      }
      out[row] = acc;
    }
  } else {
    constexpr int kR = rows_a_thread(kV);
    constexpr int kBatch = kThreads * kR;
    constexpr int kPer = 16 / sizeof(Code);
    // batches b, b + grid, … of this block b: the i-th starts at row
    // (i · grid + b) · kBatch
    const long long batches = (n + kBatch - 1) / kBatch;
    const int mine = (int)((batches - blockIdx.x + gridDim.x - 1) / gridDim.x);
    auto start = [&](int i) {
      return ((long long)i * gridDim.x + blockIdx.x) * kBatch;
    };
    uint4 cur[kR][kV], nxt[kR][kV];
    auto load = [&](uint4(&dst)[kR][kV], long long base) {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const long long row = base + j * kThreads + threadIdx.x;
        if (row < n) {
          const uint4* p = reinterpret_cast<const uint4*>(codes + row * m);
#pragma unroll
          for (int c = 0; c < kV; ++c) dst[j][c] = __ldg(p + c);
        }
      }
    };
    if (mine > 0) load(cur, start(0));
    if (lut_bulk) mbar_wait(bar, 0);
    for (int i = 0; i < mine; ++i) {
      const long long base = start(i);
      if (i + 1 < mine) load(nxt, start(i + 1));
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const long long row = base + j * kThreads + threadIdx.x;
        if (row < n) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < kV; ++c)
            acc = add_vector<Code>(acc, s_lut, cur[j][c], c * kPer, k);
          out[row] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < kR; ++j)
#pragma unroll
        for (int c = 0; c < kV; ++c) cur[j][c] = nxt[j][c];
    }
  }
}

// The kernel for `code_bytes` codes and `v` 16-byte vectors a row, opted in
// to the full shared memory at its first use on device `dev`; nullptr if
// there is none.
const void* kernel_for(int code_bytes, int v, int dev, cudaError_t* err) {
  static bool opted[repro_dev::kMaxDevices][2][5] = {};
  const void* kernel = nullptr;
  const int c = code_bytes == 4;
  if (code_bytes == 1 || code_bytes == 4) switch (v) {
      case 0: kernel = c ? (const void*)pq_scan_kernel<int32_t, 0>
                         : (const void*)pq_scan_kernel<uint8_t, 0>; break;
      case 1: kernel = c ? (const void*)pq_scan_kernel<int32_t, 1>
                         : (const void*)pq_scan_kernel<uint8_t, 1>; break;
      case 2: kernel = c ? (const void*)pq_scan_kernel<int32_t, 2>
                         : (const void*)pq_scan_kernel<uint8_t, 2>; break;
      case 4: kernel = c ? (const void*)pq_scan_kernel<int32_t, 4>
                         : (const void*)pq_scan_kernel<uint8_t, 4>; break;
    }
  *err = kernel ? cudaSuccess : cudaErrorInvalidValue;
  if (kernel && !opted[dev][c][v]) {
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemLimit);
    opted[dev][c][v] = *err == cudaSuccess;
  }
  return *err == cudaSuccess ? kernel : nullptr;
}

struct Plan {
  const void* kernel;
  int grid, threads;
  int v;         // 16-byte vectors a row (1, 2 or 4), or 0: row by row
  int lut_bulk;  // the LUT by one bulk copy, else a plain fill
  int smem;      // dynamic shared memory a block
  int batch;     // rows a batch, dealt to the blocks in turn
};

// The launch of one scan. Rows of 1, 2 or 4 aligned 16-byte vectors load as
// vectors, a batch ahead; any other row one at a time. The LUT comes by bulk
// copy when its size is a multiple of 16 bytes and its barrier fits beside
// it. The grid is as many blocks as fit, and no more than batches; the
// blocks that fit are asked once per device, kernel and shared-memory size.
cudaError_t make_plan(long long n, int m, int k, int code_bytes, bool aligned,
                      Plan* p) {
  constexpr int kDevs = repro_dev::kMaxDevices;
  static int sms[kDevs] = {};
  static int fit_smem[kDevs][2][5] = {}, fit[kDevs][2][5] = {};
  const int row = m * code_bytes, lut = m * k * 4;
  const int v = row / 16;
  p->v = aligned && row % 16 == 0 && (v == 1 || v == 2 || v == 4) ? v : 0;
  p->lut_bulk = lut % 16 == 0 && lut + 8 <= kSmemLimit;
  p->smem = p->lut_bulk ? lut + 8 : lut;
  p->threads = kThreads;
  p->batch = kThreads * rows_a_thread(p->v);
  if (n < 1 || m < 1 || k < 1 || p->smem > kSmemLimit)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = repro_dev::current(&dev);
  if (err) return err;
  p->kernel = kernel_for(code_bytes, p->v, dev, &err);
  if (!p->kernel) return err;
  if (sms[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  const int c = code_bytes == 4;
  if (fit_smem[dev][c][p->v] != p->smem) {
    int blocks = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, p->kernel, kThreads, p->smem)))
      return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    fit[dev][c][p->v] = blocks;
    fit_smem[dev][c][p->v] = p->smem;
  }
  const long long batches = (n + p->batch - 1) / p->batch;
  const long long most = (long long)sms[dev] * fit[dev][c][p->v];
  p->grid = (int)(batches < most ? batches : most);
  return cudaSuccess;
}

}  // namespace

// The plan pq_scan_f32 launches for these codes ((n, m) of code_bytes each,
// starting 16-byte aligned or not) and an (m, k) LUT, for logs and tests:
// out = {grid, threads, vectors a row, LUT by bulk copy, shared memory,
// rows a batch}.
extern "C" int pq_scan_plan(long long n, int m, int k, int code_bytes,
                            int aligned, int* out) {
  Plan p;
  if (cudaError_t err = make_plan(n, m, k, code_bytes, aligned, &p))
    return (int)err;
  const int fields[] = {p.grid, p.threads, p.v, p.lut_bulk, p.smem, p.batch};
  for (int i = 0; i < 6; ++i) out[i] = fields[i];
  return 0;
}

// codes (n, m) uint8 (code_bytes 1) or int32 (code_bytes 4), contiguous;
// lut (m, k) fp32, contiguous, 16-byte aligned; out (n,) fp32. n >= 1 and
// m·k·4 bytes within one block's shared memory (the Python wrapper checks).
// Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int pq_scan_f32(const void* codes, int code_bytes, const void* lut,
                           void* out, long long n, int m, int k,
                           void* stream) {
  if (reinterpret_cast<uintptr_t>(lut) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (cudaError_t err = make_plan(
          n, m, k, code_bytes, reinterpret_cast<uintptr_t>(codes) % 16 == 0,
          &p))
    return (int)err;
  int lut_bulk = p.lut_bulk;
  void* args[] = {&codes, &lut, &out, &n, &m, &k, &lut_bulk};
  return (int)cudaLaunchKernel(p.kernel, dim3(p.grid), dim3(kThreads), args,
                               p.smem, (cudaStream_t)stream);
}
