// RMSNorm backward for Hopper (sm_90a): dx and dw of out = x * rstd * w,
// rstd = rsqrt(mean(x^2) + eps), per row of d.
//
// A port-only kernel: the TPU side has no backward kernel (the JAX package
// differentiates its plain rmsnorm, src/repro/models/layers.py:26), but the
// port's model calls the forward kernel (csrc/rmsnorm.cu), so its gradient
// needs one too.  With x^ = x * rstd and gw = g * w:
//   dx = rstd * (gw - x^ * mean(gw * x^)),   dw = sum over rows of g * x^,
// all in f32, written in the input dtype.
//
// Bound: bytes (x and g read, dx written, a dozen flops an element).
// Design: rmsnorm_bwd_rows gives each tile of rows_per_tile rows one
// 128-thread block, which walks its rows one at a time as the forward walks
// one: a first pass takes sum(x^2) and sum(g * w * x) with one block
// reduction, a second (from L1/L2) writes dx and adds g * x^ into the
// block's f32 dw partial, kept in shared memory (d floats; each thread owns
// the same columns in every row, so no two threads touch one entry).  The
// partial goes to row tile t of an f32 scratch (n_tiles x d).  Then
// rmsnorm_bwd_colsum sums the scratch's column j over the tiles in order.
// No float atomics: two runs on one input give equal bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColThreads = 256;

// sums of a and b over the block; callable in a loop (ends with a barrier)
__device__ float2 block_sum2(float a, float b) {
  __shared__ float red[2][kThreads / 32];
  a = rt::warp_sum(a);
  b = rt::warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    t.x += red[0][i];
    t.y += red[1][i];
  }
  __syncthreads();  // red is free for the next call
  return t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
                     T* __restrict__ dx, float* __restrict__ partial, int n_rows, int d,
                     int rows_per_tile, float eps) {
  using V = rt::Vec<T, VEC>;
  extern __shared__ float acc[];  // d: this tile's sum of g * x^
  const int nvec = d / VEC;
  const V* wv = reinterpret_cast<const V*>(w);
  for (int i = threadIdx.x; i < nvec; i += kThreads)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i * VEC + e] = 0.f;

  const int row0 = blockIdx.x * rows_per_tile;
  const int row1 = min(n_rows, row0 + rows_per_tile);
  for (int row = row0; row < row1; ++row) {
    const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(row) * d);
    const V* gr = reinterpret_cast<const V*>(g + static_cast<size_t>(row) * d);
    V* dxr = reinterpret_cast<V*>(dx + static_cast<size_t>(row) * d);
    float ss = 0.f, gwx = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const V xv = xr[i], gv = gr[i], ww = wv[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = rt::to_float(xv.e[e]);
        ss = fmaf(xf, xf, ss);
        gwx = fmaf(rt::to_float(gv.e[e]) * rt::to_float(ww.e[e]), xf, gwx);
      }
    }
    const float2 sums = block_sum2(ss, gwx);
    const float rstd = rsqrtf(sums.x / static_cast<float>(d) + eps);
    const float mean_gwxh = sums.y * rstd / static_cast<float>(d);  // mean(gw * x^)
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const V xv = xr[i], gv = gr[i], ww = wv[i];
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = rt::to_float(xv.e[e]) * rstd;
        const float gf = rt::to_float(gv.e[e]);
        o.e[e] = rt::from_float<T>(rstd * (gf * rt::to_float(ww.e[e]) - xh * mean_gwxh));
        acc[i * VEC + e] = fmaf(gf, xh, acc[i * VEC + e]);
      }
      dxr[i] = o;
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[i * VEC + e] = acc[i * VEC + e];
}

template <typename T>
__global__ void __launch_bounds__(kColThreads)
    rmsnorm_bwd_colsum(const float* __restrict__ partial, T* __restrict__ dw, int n_tiles, int d) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[static_cast<size_t>(t) * d + j];
  dw[j] = rt::from_float<T>(s);
}

template <typename T, int VEC>
cudaError_t launch_rows(const void* x, const void* w, const void* g, void* dx, float* partial,
                        int n_rows, int d, int rows_per_tile, int n_tiles, float eps, int device,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  static rt::SmemOptIn optin;
  const cudaError_t err = optin.ensure(rmsnorm_bwd_rows<T, VEC>, device, smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_rows<T, VEC><<<n_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(dx), partial, n_rows, d, rows_per_tile, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* g, void* dx, void* dw,
                   float* partial, int n_rows, int d, int rows_per_tile, float eps, int device,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int n_tiles = n_rows == 0 ? 0 : (n_rows + rows_per_tile - 1) / rows_per_tile;
  if (n_tiles > 0) {
    const bool vec = d % kVec == 0 && rt::aligned16(x) && rt::aligned16(w) && rt::aligned16(g) &&
                     rt::aligned16(dx);
    const cudaError_t err =
        vec ? launch_rows<T, kVec>(x, w, g, dx, partial, n_rows, d, rows_per_tile, n_tiles, eps,
                                   device, stream)
            : launch_rows<T, 1>(x, w, g, dx, partial, n_rows, d, rows_per_tile, n_tiles, eps,
                                device, stream);
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_colsum<T><<<(d + kColThreads - 1) / kColThreads, kColThreads, 0, stream>>>(
      partial, static_cast<T*>(dw), n_tiles, d);
  return cudaGetLastError();
}

}  // namespace

// partial: an f32 scratch of ceil(n_rows / rows_per_tile) x d floats.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* g, void* dx,
                                  void* dw, void* partial, int n_rows, int d, int rows_per_tile,
                                  float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || rows_per_tile <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, w, g, dx, dw, p, n_rows, d, rows_per_tile, eps, device, s);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, w, g, dx, dw, p, n_rows, d, rows_per_tile, eps, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
