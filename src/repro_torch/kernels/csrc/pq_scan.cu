// IVF-PQ asymmetric-distance (ADC) scan, the RAG retrieval hot loop:
// out[n] = sum over m of lut[m, codes[n, m]], fp32. Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces: src/repro/kernels/pq_scan.py, `pq_scan` and its Pallas body
// `_pq_kernel`. The TPU kernel has no per-lane gather, so it expands each
// code against an iota over the codebook axis and reduces the one-hot
// product against the LUT (a masked sum of M·K products per row). Hopper
// has the gather that module's docstring names: every block copies the
// whole M·K fp32 LUT into shared memory once, and each row then costs M
// shared-memory reads, one per code. A code outside [0, K) adds exactly 0,
// as the one-hot compare gives, and is never used as an address.
//
// Design: a grid of a few blocks per SM (not one block per 256 rows, which
// at 250,000 rows would reload the 16 KB LUT ~980 times: 16 MB of L2 reads
// against 4 MB of codes), walking the rows with a grid-stride loop, one row
// per thread per iteration. A row whose bytes are a multiple of 16 (uint8
// at M = 16: one load) is read with 16-byte vector loads, neighbouring
// threads on neighbouring rows; any other M reads code by code. Each row
// sums m = 0 … M-1 in order in fp32. Row offsets are 64-bit: a shard of
// 2^28 rows × 16 uint8 codes is 2^32 bytes.
//
// What bounds it on the H100: bytes. Each code is read once (1 byte as
// uint8, 4 as int32) for one shared-memory read and one fp32 add, far below
// the card's ~20 operations per byte of HBM at fp32. But the shared-memory
// reads are random over 32 banks: a warp's 32 gathers into one LUT row hit
// about 3–4 wavefronts, and at uint8 (16 codes per 16-byte row) that is
// roughly what HBM can feed, 80–90% of it or less. So shared memory, not
// HBM, may set the pace of a large scan; spreading a LUT row over the banks
// (replicas, or a row per warp lane group) is a later redesign's concern.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;

template <typename Code>
__device__ __forceinline__ float lookup(const float* s_row, Code code,
                                        int k) {
  const int c = (int)code;
  return (unsigned)c < (unsigned)k ? s_row[c] : 0.f;
}

template <typename Code, bool kVec>
__global__ void __launch_bounds__(kThreads) pq_scan_kernel(
    const Code* __restrict__ codes, const float* __restrict__ lut,
    float* __restrict__ out, long long n, int m, int k) {
  extern __shared__ float s_lut[];
  for (int i = threadIdx.x; i < m * k; i += kThreads) s_lut[i] = lut[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
       row < n; row += stride) {
    const Code* p = codes + row * m;
    float acc = 0.f;
    if constexpr (kVec) {
      constexpr int kPer = 16 / sizeof(Code);  // codes per 16-byte load
      for (int c0 = 0; c0 < m; c0 += kPer) {
        union {
          uint4 v;
          Code c[kPer];
        } u;
        u.v = *reinterpret_cast<const uint4*>(p + c0);
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          acc += lookup(s_lut + (c0 + j) * k, u.c[j], k);
      }
    } else {
      for (int j = 0; j < m; ++j) acc += lookup(s_lut + j * k, p[j], k);
    }
    out[row] = acc;
  }
}

template <typename Code, bool kVec>
int grid_blocks(long long n, int m, int k, int* blocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
    if (cudaError_t err = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)err;
  }
  const int smem = m * k * (int)sizeof(float);
  static int granted = 0, per_sm = 0;  // opt-in limit and blocks per SM
  if (smem != granted) {               // at the last shared-memory size
    if (cudaError_t err = cudaFuncSetAttribute(
            pq_scan_kernel<Code, kVec>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return (int)err;
    int fit = 0;
    if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &fit, pq_scan_kernel<Code, kVec>, kThreads, smem))
      return (int)err;
    per_sm = fit < 1 ? 1 : (fit > kBlocksPerSm ? kBlocksPerSm : fit);
    granted = smem;
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm;
  *blocks = (int)(want < most ? want : most);
  return 0;
}

template <typename Code, bool kVec>
int launch(const void* codes, const void* lut, void* out, long long n, int m,
           int k, cudaStream_t stream) {
  int blocks = 0;
  if (int err = grid_blocks<Code, kVec>(n, m, k, &blocks)) return err;
  pq_scan_kernel<Code, kVec>
      <<<blocks, kThreads, m * k * (int)sizeof(float), stream>>>(
          (const Code*)codes, (const float*)lut, (float*)out, n, m, k);
  return (int)cudaGetLastError();
}

// Whole rows load as 16-byte vectors when a row is a multiple of 16 bytes
// and the codes start 16-byte aligned (then every row does).
bool vector_rows(const void* codes, int m, int code_bytes) {
  return (m * code_bytes) % 16 == 0 && (uintptr_t)codes % 16 == 0;
}

}  // namespace

// codes (n, m) uint8 (code_bytes 1) or int32 (code_bytes 4), contiguous;
// lut (m, k) fp32, contiguous; out (n,) fp32. n >= 1 and m·k·4 bytes within
// one block's shared memory (the Python wrapper checks). Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int pq_scan_f32(const void* codes, int code_bytes, const void* lut,
                           void* out, long long n, int m, int k,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = vector_rows(codes, m, code_bytes);
  if (code_bytes == 1)
    return vec ? launch<uint8_t, true>(codes, lut, out, n, m, k, s)
               : launch<uint8_t, false>(codes, lut, out, n, m, k, s);
  if (code_bytes == 4)
    return vec ? launch<int32_t, true>(codes, lut, out, n, m, k, s)
               : launch<int32_t, false>(codes, lut, out, n, m, k, s);
  return (int)cudaErrorInvalidValue;
}
