// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (_rmsnorm_kernel /
// fused_rmsnorm).  Per row: f32 mean of squares, x * rsqrt(var + eps) * w in
// f32, cast back to x's dtype.
//
// Bound: bytes.  Each element is read and written once and takes a handful of
// flops, so the kernel can at best stream at the card's memory rate.  Design:
// one 128-thread block per row, 16-byte vector loads (8 bf16 / 4 f32) when the
// row width and the pointers allow it, an f32 sum of squares reduced with warp
// shuffles, and a second pass over the row (served from L1/L2) for the scaled
// write.  A ragged row count needs no padding: the grid has one block per row.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ float block_sum(float v) {
  __shared__ float red[kThreads / 32];
  v = rt::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int d, float eps) {
  using V = rt::Vec<T, VEC>;
  const size_t row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  const V* wv = reinterpret_cast<const V*>(w);
  V* orow = reinterpret_cast<V*>(out + row * d);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const V v = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = rt::to_float(v.e[e]);
      ss = fmaf(f, f, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const V v = xr[i];
    const V g = wv[i];
    V o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.e[e] = rt::from_float<T>(rt::to_float(v.e[e]) * r * rt::to_float(g.e[e]));
    orow[i] = o;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int n_rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (d % kVec == 0 && rt::aligned16(x) && rt::aligned16(w) && rt::aligned16(out))
    rmsnorm_kernel<T, kVec><<<n_rows, kThreads, 0, stream>>>(xt, wt, ot, d, eps);
  else
    rmsnorm_kernel<T, 1><<<n_rows, kThreads, 0, stream>>>(xt, wt, ot, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int n_rows, int d,
                              float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, w, out, n_rows, d, eps, s);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, w, out, n_rows, d, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
