// One-time set-up of the C entries, kept per device. cudaFuncSetAttribute,
// cudaDeviceGetAttribute and the occupancy queries act on the runtime's
// current device only, so every entry keys what it has granted or asked by
// cudaGetDevice: the first launch on another card of the host opts in there
// before it runs. The Python wrappers make their tensors' device current
// around the call (torch.cuda.device), so the launch, the stream and this
// state agree. The grant runs at a kernel's first launch on a device, which
// the engines' warm-up makes before any CUDA-graph capture.
#pragma once

#include <cuda_runtime.h>

namespace repro_dev {

constexpr int kMaxDevices = 16;  // cards of one host this state covers

// The runtime's current device, an index into per-device state; an error
// past kMaxDevices.
inline cudaError_t current(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev >= 0 && *dev < kMaxDevices ? cudaSuccess
                                         : cudaErrorInvalidDevice;
}

// Raise `kernel`'s opt-in dynamic shared memory limit to `smem` bytes on the
// current device, once per device and size; `granted` is the caller's
// static record. Returns the CUDA error (0 = cudaSuccess).
template <class Kernel>
inline int grant_smem(Kernel kernel, int smem, int (&granted)[kMaxDevices]) {
  int dev = 0;
  if (const cudaError_t err = current(&dev)) return (int)err;
  if (smem <= granted[dev]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  granted[dev] = smem;
  return 0;
}

}  // namespace repro_dev
