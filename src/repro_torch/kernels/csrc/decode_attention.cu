// Single-token GQA decode attention over a padded (B, KV, S, D) cache for
// Hopper (sm_90a), split along the sequence (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (_decode_kernel / decode_attention).  q (B, H, D), k/v (B, KV, S, D),
// lengths (B,) int32; positions >= lengths[b] are masked; the output is
// acc / max(l, 1e-30), so a row of length 0 gives 0.
//
// Bound: bytes.  Every valid cache row is read once per step and takes 2*D
// flops per query head.  The TPU grid (B, KV, S-blocks) walks S in order; on
// the H100 B*KV blocks alone (32 at the serving batch) would leave most of the
// 132 SMs idle, so the sequence is split across CTAs: one 128-thread CTA per
// (128-position chunk, KV head, sequence).  Chunks at or past lengths[b] exit
// at once.  In a CTA each thread scores one cache position for all n_rep query
// heads sharing the KV head (each K row read once, with 16-byte loads), the
// chunk's max and sum are block reductions, and the PV product runs with
// threads along D (coalesced V rows).  Each chunk writes a partial
// (max, sum, acc) in f32 to a scratch tensor the caller allocates; a second
// small kernel combines the chunks of each (sequence, head).
#include "common.cuh"

namespace {

constexpr int CH = 128;  // cache positions per chunk = threads per split CTA
constexpr int NW = CH / 32;

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(CH)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ lengths,
                        float* __restrict__ part_acc, float* __restrict__ part_ml, int KV, int S,
                        int n_split, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int G = CH / D;  // position groups in the PV product
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int s0 = split * CH;
  if (s0 >= len) return;  // the combine kernel reads only chunks below the length

  __shared__ float qs[NREP][D];
  __shared__ float ps[NREP][CH];
  __shared__ float accs[NREP][CH];
  __shared__ float red[NREP][NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (static_cast<size_t>(b) * KV + kvh) * NREP * D;  // heads kvh*NREP + r
  for (int i = tid; i < NREP * D; i += CH) qs[i / D][i % D] = rt::to_float(qb[i]) * scale_log2;
  __syncthreads();

  const size_t head = (static_cast<size_t>(b) * KV + kvh) * S * D;
  const int pos = s0 + tid;
  const bool valid = pos < len;
  float sc[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) sc[r] = 0.f;
  if (valid) {
    const rt::Vec<T, VEC>* krow =
        reinterpret_cast<const rt::Vec<T, VEC>*>(kc + head + static_cast<size_t>(pos) * D);
#pragma unroll 4
    for (int i = 0; i < D / VEC; ++i) {
      const rt::Vec<T, VEC> kv = krow[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float kf = rt::to_float(kv.e[e]);
#pragma unroll
        for (int r = 0; r < NREP; ++r) sc[r] = fmaf(qs[r][i * VEC + e], kf, sc[r]);
      }
    }
  }

  float mx[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    sc[r] = valid ? sc[r] : -INFINITY;
    const float w = rt::warp_max(sc[r]);
    if (lane == 0) red[r][warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    mx[r] = red[r][0];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx[r] = fmaxf(mx[r], red[r][w]);
  }
  __syncthreads();  // red is reused for the sums
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const float p = valid ? exp2f(sc[r] - mx[r]) : 0.f;  // mx is finite: s0 < len
    ps[r][tid] = p;
    const float w = rt::warp_sum(p);
    if (lane == 0) red[r][warp] = w;
  }
  __syncthreads();

  const int d = tid % D, g = tid / D;
  const int n_valid = min(CH, len - s0);
  const T* vrow = vc + head + static_cast<size_t>(s0) * D + d;
  float acc[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r] = 0.f;
  for (int c = g; c < n_valid; c += G) {
    const float vf = rt::to_float(vrow[static_cast<size_t>(c) * D]);
#pragma unroll
    for (int r = 0; r < NREP; ++r) acc[r] = fmaf(ps[r][c], vf, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r) accs[r][tid] = acc[r];
  __syncthreads();

  const size_t part = (static_cast<size_t>(b) * KV + kvh) * n_split + split;
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float a = accs[r][d];
#pragma unroll
      for (int j = 1; j < G; ++j) a += accs[r][j * D + d];
      part_acc[(part * NREP + r) * D + d] = a;
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) l += red[r][w];
      part_ml[(part * NREP + r) * 2 + 0] = mx[r];
      part_ml[(part * NREP + r) * 2 + 1] = l;
    }
  }
}

// One CTA of D threads per (KV head, sequence): merges the chunk partials of
// the NREP query heads of that KV head.
template <typename T, int D, int NREP>
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          const int* __restrict__ lengths, T* __restrict__ out, int KV, int S,
                          int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(max(lengths[b], 0), S);
  const int n_used = (len + CH - 1) / CH;
  const size_t part0 = (static_cast<size_t>(b) * KV + kvh) * n_split;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float m = -INFINITY;
    for (int s = 0; s < n_used; ++s) m = fmaxf(m, part_ml[((part0 + s) * NREP + r) * 2]);
    const float m_use = m == -INFINITY ? 0.f : m;
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const size_t p = (part0 + s) * NREP + r;
      const float w = exp2f(part_ml[p * 2] - m_use);
      l = fmaf(part_ml[p * 2 + 1], w, l);
      a = fmaf(part_acc[p * D + d], w, a);
    }
    const size_t h = static_cast<size_t>(kvh) * NREP + r;
    out[(static_cast<size_t>(b) * KV * NREP + h) * D + d] = rt::from_float<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D, int NREP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   float* part_acc, float* part_ml, int B, int KV, int S, float scale_log2,
                   cudaStream_t stream) {
  const int n_split = (S + CH - 1) / CH;
  decode_split_kernel<T, D, NREP><<<dim3(n_split, KV, B), CH, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_acc, part_ml, KV, S, n_split, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D, NREP><<<dim3(KV, B), D, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), KV, S, n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rep(int nrep, const void* q, const void* k, const void* v, const int* len,
                       void* out, float* pa, float* pm, int B, int KV, int S, float sl,
                       cudaStream_t s) {
  switch (nrep) {
    case 1:
      return launch<T, D, 1>(q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    case 2:
      return launch<T, D, 2>(q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    case 4:
      return launch<T, D, 4>(q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    case 8:
      return launch<T, D, 8>(q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, int nrep, const void* q, const void* k, const void* v,
                     const int* len, void* out, float* pa, float* pm, int B, int KV, int S,
                     float sl, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_rep<T, 16>(nrep, q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    case 32:
      return launch_rep<T, 32>(nrep, q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    case 64:
      return launch_rep<T, 64>(nrep, q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    case 128:
      return launch_rep<T, 128>(nrep, q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_chunk() { return CH; }

// part_acc: (B, KV, n_split, n_rep, D) f32 and part_ml: (B, KV, n_split, n_rep, 2)
// f32 scratch, n_split = ceil(S / decode_attention_chunk()).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* part_acc,
                                       void* part_ml, int B, int H, int KV, int S, int D,
                                       float softmax_scale, int dtype, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (KV == 0 || H % KV != 0 || S == 0) return cudaErrorInvalidValue;
  const float sl = softmax_scale * 1.4426950408889634f;
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch_d<float>(D, H / KV, q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    case rt::kBF16:
      return launch_d<__nv_bfloat16>(D, H / KV, q, k, v, len, out, pa, pm, B, KV, S, sl, s);
    default:
      return cudaErrorInvalidValue;
  }
}
