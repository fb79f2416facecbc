// Helpers shared by the port's hand-written Hopper kernels.
//
// Each kernel source is built on its own into a shared library with a plain C
// interface (nvcc -> .so -> ctypes); every entry point takes the device index
// and the stream as arguments and returns the cudaError_t of its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace rt {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// N contiguous elements moved as one load/store (16 bytes for the vector paths)
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T e[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The dynamic-shared-memory opt-in of one kernel instantiation, recorded per
// device: the attribute belongs to a (function, device) pair, so a launch on
// a second card sets it there too.  Declare one `static SmemOptIn` beside
// each instantiation's launch and call ensure() after cudaSetDevice(device).
struct SmemOptIn {
  static constexpr int kMaxDevices = 64;
  std::atomic<int> bytes[kMaxDevices];  // the opt-in set on each device (0: none)

  template <typename Kernel>
  cudaError_t ensure(Kernel* kernel, int device, size_t need) {
    if (need <= 48 * 1024) return cudaSuccess;  // the default needs no opt-in
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (bytes[device].load(std::memory_order_acquire) >= static_cast<int>(need))
      return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(need));
    if (err == cudaSuccess) bytes[device].store(static_cast<int>(need), std::memory_order_release);
    return err;
  }
};

}  // namespace rt

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
