// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (_rmsnorm_kernel /
// fused_rmsnorm).  Per row: f32 mean of squares, x * rsqrt(var + eps) * w in
// f32, cast back to x's dtype.
//
// Bound: bytes.  Each element is read and written once and takes a handful of
// flops, so the kernel can at best stream at the card's memory rate (N 512 x
// d 4096 bf16: 8.4 MB, 2.5 us at an H100 SXM's 3.35 TB/s); at d <= 2048 and
// N 512 the bound is under a microsecond, below what a launch costs.  Design
// (the plan, `rmsnorm.fwd_plan`, comes from the shape alone):
//
// * A row belongs to a team of W warps (the fewest, a power of two up to
//   16); each lane holds NV of the row's 16-byte vectors (8 bf16 / 4 f32;
//   NV a power of two up to 8; one element a lane on the scalar path for
//   rows that are not whole vectors or pointers not 16-byte aligned) in
//   registers, so x is read from memory once: its loads are all in flight
//   together, the sum of squares is taken from registers, and the scaled
//   row written from them.  bf16 stays packed in the registers, two values
//   a register, widened where it is used (by PTX the compiler cannot merge,
//   or it would hold x and w as f32 at twice the registers and half the
//   rows in flight).
// * w is read once a CTA, into registers, before the row loop.
// * x is loaded and the output stored with the streaming cache hint
//   (ld/st.global.cs): each is touched once.
// * Teams of one warp reduce by shuffles alone; wider teams add their warps'
//   sums through shared memory (double-buffered, one barrier a row step).
// * At most one wave of CTAs (of 128 threads, or one team wider than that)
//   strides over the rows; a ragged row count needs no padding.
// * Rows too wide for registers (more than 8 x 512 lanes: d > 32768 in
//   bf16, 16384 in f32, 4096 on the scalar path) take NV = 0: a 1024-thread
//   CTA a row that reads x twice (the second time from L2).
// * The launch is a programmatic dependent one: a CTA waits on
//   griddepcontrol (the previous kernel has ended and its writes are
//   visible) before it touches memory, so the launch and the CTAs' start
//   overlap the previous kernel's tail; it lets the next such launch start
//   at once.
// The summation order is fixed by the plan, so two runs give equal bits.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxTeamThreads = 512;  // a team holding its row in registers: <= 128 registers a thread
constexpr int kMaxNV = 8;

// A 16-byte vector in or out with the streaming hint (touched once); any
// other width plainly.
template <typename V>
__device__ __forceinline__ V load_once(const V* p) {
  if constexpr (sizeof(V) == 16) {
    const int4 r = __ldcs(reinterpret_cast<const int4*>(p));
    return *reinterpret_cast<const V*>(&r);
  } else {
    return *p;
  }
}

template <typename V>
__device__ __forceinline__ void store_once(V* p, const V& v) {
  if constexpr (sizeof(V) == 16)
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
  else
    *p = v;
}

// Element e of v as f32.  A 16-byte bf16 vector is read as its four 32-bit
// words and each half widened by a volatile PTX shift or mask, which the
// compiler cannot hoist or merge: x and w stay packed in the registers.
template <typename T, int VEC>
__device__ __forceinline__ float elem(const rt::Vec<T, VEC>& v, int e) {
  if constexpr (sizeof(T) == 2 && VEC == 8) {
    const uint32_t word = reinterpret_cast<const uint32_t*>(&v)[e / 2];
    uint32_t f;
    if (e % 2 == 0)
      asm volatile("shl.b32 %0, %1, 16;" : "=r"(f) : "r"(word));
    else
      asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(f) : "r"(word));
    return __uint_as_float(f);
  } else {
    return rt::to_float(v.e[e]);
  }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(NV > 0 ? kMaxTeamThreads : kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int n_rows, int d, int team_warps, float eps) {
  using V = rt::Vec<T, VEC>;
  __shared__ float red[2][kMaxThreads / 32];
  const int lanes = d / VEC;
  const int tt = team_warps * 32;  // a team's threads
  const int teams = blockDim.x / tt;
  const int team = threadIdx.x / tt, t = threadIdx.x % tt;
  const int warp = threadIdx.x / 32;
  const V* wv = reinterpret_cast<const V*>(w);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the previous kernel has ended and flushed
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  V wr[NV > 0 ? NV : 1];
#pragma unroll
  for (int u = 0; u < NV; ++u)
    if (t + u * tt < lanes) wr[u] = wv[t + u * tt];

  int parity = 0;
  // every team of the CTA takes the same number of steps (the barrier is the CTA's)
  for (long long base = static_cast<long long>(blockIdx.x) * teams; base < n_rows;
       base += static_cast<long long>(gridDim.x) * teams) {
    const long long row = base + team;
    const bool active = row < n_rows;
    const V* xr = reinterpret_cast<const V*>(x + (active ? row : 0) * static_cast<long long>(d));
    V* orow = reinterpret_cast<V*>(out + (active ? row : 0) * static_cast<long long>(d));

    V xv[NV > 0 ? NV : 1];
    float ss = 0.f;
    if constexpr (NV > 0) {
#pragma unroll
      for (int u = 0; u < NV; ++u)
        if (active && t + u * tt < lanes) xv[u] = load_once(xr + t + u * tt);
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (active && t + u * tt < lanes) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float f = elem(xv[u], e);
            ss = fmaf(f, f, ss);
          }
        }
      }
    } else {
      for (int i = t; active && i < lanes; i += tt) {
        const V v = xr[i];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = elem(v, e);
          ss = fmaf(f, f, ss);
        }
      }
    }
    ss = rt::warp_sum(ss);
    if (team_warps > 1) {  // uniform over the CTA
      if (threadIdx.x % 32 == 0) red[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < team_warps; ++i) ss += red[parity][team * team_warps + i];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (!active) continue;

    if constexpr (NV > 0) {
#pragma unroll
      for (int u = 0; u < NV; ++u)
        if (t + u * tt < lanes) {
          V o;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o.e[e] = rt::from_float<T>(elem(xv[u], e) * r * elem(wr[u], e));
          store_once(orow + t + u * tt, o);
        }
    } else {
      for (int i = t; i < lanes; i += tt) {
        const V v = xr[i];
        const V g = wv[i];
        V o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o.e[e] = rt::from_float<T>(elem(v, e) * r * elem(g, e));
        store_once(orow + i, o);
      }
    }
  }
}

// The instantiation for nv (0 or a power of two up to kMaxNV), launched as
// a programmatic dependent of the stream's previous kernel.
template <typename T, int VEC, int NV = kMaxNV>
cudaError_t launch_nv(int nv, const T* x, const T* w, T* out, int n_rows, int d, float eps,
                      int team_warps, int threads, int grid, cudaStream_t stream) {
  if (nv == NV) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, VEC, NV>, x, w, out, n_rows, d, team_warps,
                              eps);
  }
  if constexpr (NV > 0)
    return launch_nv<T, VEC, NV / 2>(nv, x, w, out, n_rows, d, eps, team_warps, threads, grid,
                                     stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int n_rows, int d, float eps,
                   int team_warps, int threads, int grid, int nv, int vector, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int lanes = vector ? d / kVec : d;
  if (team_warps < 1 || threads % (32 * team_warps) != 0 || grid < 1 || nv < 0 || nv > kMaxNV ||
      threads > (nv > 0 ? kMaxTeamThreads : kMaxThreads) ||
      (nv > 0 && lanes > nv * 32 * team_warps) || (nv == 0 && threads != 32 * team_warps))
    return cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (!vector)
    return launch_nv<T, 1>(nv, xt, wt, ot, n_rows, d, eps, team_warps, threads, grid, stream);
  if (d % kVec != 0 || !rt::aligned16(x) || !rt::aligned16(w) || !rt::aligned16(out))
    return cudaErrorMisalignedAddress;
  return launch_nv<T, kVec>(nv, xt, wt, ot, n_rows, d, eps, team_warps, threads, grid, stream);
}

}  // namespace

// The plan's arguments (rmsnorm.fwd_plan): team_warps warps a row, `threads`
// a CTA, `grid` CTAs striding over the rows, nv vectors a lane held in
// registers (0: the two-pass path), `vector` 16-byte vectors (else one
// element a lane).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int n_rows, int d,
                              float eps, int team_warps, int threads, int grid, int nv, int vector,
                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch<float>(x, w, out, n_rows, d, eps, team_warps, threads, grid, nv, vector, s);
    case rt::kBF16:
      return launch<__nv_bfloat16>(x, w, out, n_rows, d, eps, team_warps, threads, grid, nv,
                                   vector, s);
    default:
      return cudaErrorInvalidValue;
  }
}
