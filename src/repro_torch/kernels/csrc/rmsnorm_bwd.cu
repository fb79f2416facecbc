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
// Design: two launches, no float atomics, so two runs give equal bits.
// * rmsnorm_bwd_rows: a CTA per tile of rows_per_tile rows (the wrapper's
//   bwd_plan takes the tiling from the shape alone, at most 256 tiles).
//   Thread 0 streams the tile's rows of x and g, RPS rows a step (1, 2 or 4:
//   about 8 KB of x), into a ring of `stages` slots in shared memory
//   (cp.async.bulk on mbarriers), so x and g leave device memory once.  A
//   first pass over the slot takes each row's sum(x^2) and sum(g * w * x),
//   reduced over the CTA with one barrier a step, and keeps a thread's first
//   vectors of each row (and of w) in registers; the second writes dx in
//   16-byte vectors and adds g * x^ into the tile's f32 dw partial (d floats
//   of shared memory, each thread on its own columns, laid out so that a
//   warp's accesses hit 32 banks).  A slot is refilled at the next step's
//   barrier.  Rows that are not whole 16-byte vectors, or too wide for one
//   slot (f32 past d = 19,000), take the scalar path instead: x and g read
//   from global memory in both passes.  The partial goes to row t of an f32
//   scratch (n_tiles x d).
// * rmsnorm_bwd_colsum: 32 columns a CTA, its 16 warps each summing every
//   16th tile in order, then the 16 sums in order: d / 32 CTAs (128 at d =
//   4096), a few loads a thread.  Launched as a programmatic dependent of
//   the rows kernel, it waits on griddepcontrol for it, so no launch gap
//   stands between the two.
#include "hopper.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxRps = 4;  // rows a step at most
constexpr int kColWarps = 16;

// v[r] summed over the CTA for every r, with one barrier: red[parity]
// alternates between consecutive calls, so the next call never writes what
// this one reads
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*red)[kMaxThreads / 32][2 * kMaxRps],
                                          int parity) {
#pragma unroll
  for (int r = 0; r < N; ++r) v[r] = rt::warp_sum(v[r]);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < N; ++r) red[parity][threadIdx.x >> 5][r] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < N; ++r) v[r] = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i)
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] += red[parity][i][r];
}

// kBulk: rows through the shared ring (VEC = 16 bytes of T); else the scalar
// path (VEC = 1) from global memory.  RPS rows a step.
template <typename T, int VEC, bool kBulk, int RPS>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
                     T* __restrict__ dx, float* __restrict__ partial, int n_rows, int d,
                     int rows_per_tile, int stages, float eps) {
  constexpr int rps = RPS;
  // vectors of a row a thread keeps in registers between the passes: 4 rows
  // a step come with short rows (a vector a thread), and more would spill
  constexpr int KW = RPS == kMaxRps ? 1 : 2;
  using V = rt::Vec<T, VEC>;
  extern __shared__ float4 smem_v4[];
  // d: this tile's sum of g * x^, element e of vector i at acc[e * nvec + i]
  // (consecutive threads on consecutive banks)
  float* acc = reinterpret_cast<float*>(smem_v4);
  // slot s: the step's rps rows of x at 2 s rps d, of g at (2 s + 1) rps d
  T* slots = reinterpret_cast<T*>(acc + d);
  const size_t slot = static_cast<size_t>(rps) * d;  // elements of x (or g) a slot holds
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + 2 * stages * slot);
  __shared__ float red[2][kMaxThreads / 32][2 * kMaxRps];
  const int nvec = d / VEC;
  const int row0 = blockIdx.x * rows_per_tile;
  const int nr = min(n_rows - row0, rows_per_tile);
  const int n_steps = (nr + rps - 1) / rps;  // step j: rows row0 + j rps + [0, rps)
  const V* wv = reinterpret_cast<const V*>(w);

  // the column sum may be scheduled now: it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  for (int i = threadIdx.x; i < d; i += blockDim.x) acc[i] = 0.f;
  V wk[KW];  // w is the same in every row: the first KW vectors of it stay in registers
#pragma unroll
  for (int k = 0; k < KW; ++k)
    if (threadIdx.x + k * blockDim.x < nvec) wk[k] = wv[threadIdx.x + k * blockDim.x];
  auto issue = [&](int j) {  // thread 0: step j's rows of x and g into slot j % stages
    const int s = j % stages;
    const size_t off = static_cast<size_t>(row0 + j * rps) * d;
    const uint32_t bytes = static_cast<uint32_t>(min(rps, nr - j * rps) * d * sizeof(T));
    hp::mbar_expect_tx(&full[s], 2 * bytes);
    hp::bulk_load(slots + 2 * s * slot, x + off, bytes, &full[s]);
    hp::bulk_load(slots + (2 * s + 1) * slot, g + off, bytes, &full[s]);
  };
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) hp::mbar_init(&full[s], 1);
      hp::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int j = 0; j < stages && j < n_steps; ++j) issue(j);
  }

  for (int j = 0; j < n_steps; ++j) {
    const int rows = min(rps, nr - j * rps);
    const size_t off = static_cast<size_t>(row0 + j * rps) * d;
    const V* xs = reinterpret_cast<const V*>(x + off);  // row r at xs + r nvec
    const V* gs = reinterpret_cast<const V*>(g + off);
    if constexpr (kBulk) {
      const int s = j % stages;
      hp::mbar_wait(&full[s], (j / stages) & 1);
      xs = reinterpret_cast<const V*>(slots + 2 * s * slot);
      gs = reinterpret_cast<const V*>(slots + (2 * s + 1) * slot);
    }
    float sums[2 * RPS];  // sum(x^2) and sum(g * w * x) of each row
#pragma unroll
    for (int r = 0; r < 2 * RPS; ++r) sums[r] = 0.f;
    auto add = [&](const V& xv, const V& gv, const V& ww, int r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = rt::to_float(xv.e[e]);
        sums[2 * r] = fmaf(xf, xf, sums[2 * r]);
        sums[2 * r + 1] = fmaf(rt::to_float(gv.e[e]) * rt::to_float(ww.e[e]), xf, sums[2 * r + 1]);
      }
    };
    V xk[KW][RPS], gk[KW][RPS];  // the first KW vectors of each row stay in registers
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
#pragma unroll
      for (int r = 0; r < RPS; ++r)
        if (i < nvec && r < rows) {
          xk[k][r] = xs[r * nvec + i];
          gk[k][r] = gs[r * nvec + i];
          add(xk[k][r], gk[k][r], wk[k], r);
        }
    }
    for (int i = threadIdx.x + KW * blockDim.x; i < nvec; i += blockDim.x) {
      const V ww = wv[i];
#pragma unroll
      for (int r = 0; r < RPS; ++r)
        if (r < rows) add(xs[r * nvec + i], gs[r * nvec + i], ww, r);
    }
    block_sum(sums, red, j & 1);
    if constexpr (kBulk)  // every thread is past step j - 1: its slot takes a new step
      if (threadIdx.x == 0 && stages > 1 && j >= 1 && j - 1 + stages < n_steps)
        issue(j - 1 + stages);
    float rstd[RPS], mean_gwxh[RPS];  // mean(gw * x^)
#pragma unroll
    for (int r = 0; r < RPS; ++r) {
      rstd[r] = rsqrtf(sums[2 * r] / static_cast<float>(d) + eps);
      mean_gwxh[r] = sums[2 * r + 1] * rstd[r] / static_cast<float>(d);
    }
    V* dxs = reinterpret_cast<V*>(dx + off);
    auto put = [&](const V& xv, const V& gv, const V& ww, int r, int i) {  // dx, and g x^ into dw
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = rt::to_float(xv.e[e]) * rstd[r];
        const float gf = rt::to_float(gv.e[e]);
        o.e[e] = rt::from_float<T>(rstd[r] * (gf * rt::to_float(ww.e[e]) - xh * mean_gwxh[r]));
        acc[e * nvec + i] = fmaf(gf, xh, acc[e * nvec + i]);
      }
      dxs[r * nvec + i] = o;
    };
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
#pragma unroll
      for (int r = 0; r < RPS; ++r)
        if (i < nvec && r < rows) put(xk[k][r], gk[k][r], wk[k], r, i);
    }
    for (int i = threadIdx.x + KW * blockDim.x; i < nvec; i += blockDim.x) {
      const V ww = wv[i];
#pragma unroll
      for (int r = 0; r < RPS; ++r)
        if (r < rows) put(xs[r * nvec + i], gs[r * nvec + i], ww, r, i);
    }
    if constexpr (kBulk)
      if (stages == 1) {  // one slot: refill it once every thread has read it
        __syncthreads();
        if (threadIdx.x == 0 && j + 1 < n_steps) issue(j + 1);
      }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[i * VEC + e] = acc[e * nvec + i];
}

template <typename T>
__global__ void __launch_bounds__(kColWarps * 32)
    rmsnorm_bwd_colsum(const float* __restrict__ partial, T* __restrict__ dw, int n_tiles, int d) {
  __shared__ float red[kColWarps][32];
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the rows grid has ended and flushed
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d) {
#pragma unroll 16
    for (int t = warp; t < n_tiles; t += kColWarps) s += partial[static_cast<size_t>(t) * d + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kColWarps; ++i) t += red[i][lane];
    dw[col] = rt::from_float<T>(t);
  }
}

template <typename T, int VEC, bool kBulk, int RPS>
cudaError_t launch_rows(const void* x, const void* w, const void* g, void* dx, float* partial,
                        int n_rows, int d, int rows_per_tile, int n_tiles, int threads, int stages,
                        float eps, int device, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float) +
                      static_cast<size_t>(stages) * (2 * static_cast<size_t>(RPS) * d * sizeof(T) + 8);
  static rt::SmemOptIn optin;
  const cudaError_t err = optin.ensure(rmsnorm_bwd_rows<T, VEC, kBulk, RPS>, device, smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_rows<T, VEC, kBulk, RPS><<<n_tiles, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(dx), partial, n_rows, d, rows_per_tile, stages, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* g, void* dx, void* dw,
                   float* partial, int n_rows, int d, int rows_per_tile, int threads, int rps,
                   int stages, float eps, int device, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int n_tiles = n_rows == 0 ? 0 : (n_rows + rows_per_tile - 1) / rows_per_tile;
  if (n_tiles > 0) {
    const bool bulk = stages > 0;
    if (bulk && !(d % kVec == 0 && rt::aligned16(x) && rt::aligned16(w) && rt::aligned16(g) &&
                  rt::aligned16(dx)))
      return cudaErrorMisalignedAddress;
    if (!bulk && rps != 1) return cudaErrorInvalidValue;
    const cudaError_t err =
        !bulk      ? launch_rows<T, 1, false, 1>(x, w, g, dx, partial, n_rows, d, rows_per_tile,
                                                 n_tiles, threads, 0, eps, device, stream)
        : rps == 1 ? launch_rows<T, kVec, true, 1>(x, w, g, dx, partial, n_rows, d, rows_per_tile,
                                                   n_tiles, threads, stages, eps, device, stream)
        : rps == 2 ? launch_rows<T, kVec, true, 2>(x, w, g, dx, partial, n_rows, d, rows_per_tile,
                                                   n_tiles, threads, stages, eps, device, stream)
                   : launch_rows<T, kVec, true, 4>(x, w, g, dx, partial, n_rows, d, rows_per_tile,
                                                   n_tiles, threads, stages, eps, device, stream);
    if (err != cudaSuccess) return err;
  }
  // a programmatic dependent launch: its CTAs are placed while the rows
  // kernel runs and start summing the moment it ends
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + 31) / 32);
  cfg.blockDim = dim3(kColWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rmsnorm_bwd_colsum<T>, static_cast<const float*>(partial),
                            static_cast<T*>(dw), n_tiles, d);
}

}  // namespace

// The wrapper's bwd_plan gives rows_per_tile, threads (a multiple of 32, at
// most 512), rps (rows a step: 1, 2 or 4) and stages (slots of a step's rows in
// shared memory; 0 for the scalar path).
// partial: an f32 scratch of ceil(n_rows / rows_per_tile) x d floats.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* g, void* dx,
                                  void* dw, void* partial, int n_rows, int d, int rows_per_tile,
                                  int threads, int rps, int stages, float eps, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || rows_per_tile <= 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (rps != 1 && rps != 2 && rps != kMaxRps) || stages < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, w, g, dx, dw, p, n_rows, d, rows_per_tile, threads, rps, stages, eps,
                           device, s);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, w, g, dx, dw, p, n_rows, d, rows_per_tile, threads, rps,
                                   stages, eps, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
