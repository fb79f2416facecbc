// Blocked exact attention (GQA, optional causal mask) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel
// / flash_attention).  q (B, Sq, H, D), k/v (B, Sk, KV, D); query head h reads
// KV head h / (H/KV); causal keeps q_pos >= k_pos with the diagonal at 0;
// output acc / max(l, 1e-30) with an online softmax in f32.
//
// Bound: operations at prefill lengths (about 4*D flops per query-key pair
// against 4*D bytes per row of q/k/v/o).  This first version does its products
// with plain f32 FMAs from shared memory (no mma/wgmma yet), which also keeps
// f32 inputs exact.  Design: one 128-thread CTA per (q-block of 64 rows, head,
// batch); the TPU's sequential kv grid axis becomes a loop over 32-row K/V
// tiles staged (as f32) in shared memory, which stops at the causal diagonal.
// Each thread owns 4 query rows x 4 key columns of the score tile and 4 rows x
// D/8 columns of the output; the 8 threads sharing a row reduce its max and
// sum with shuffles.  Ragged Sq/Sk are masked in place of the TPU's padding
// copies.  The softmax scale is folded into Q in the log2 domain (exp2f).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;  // query rows per CTA: 16 row groups x 4 rows
constexpr int BK = 32;  // keys per tile: 8 column lanes x 4 columns
constexpr int NJ = BK / 8;

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int Sq, int Sk, int H, int KV, float scale_log2,
                     int causal) {
  constexpr int DP = D + 1;    // padded smem row stride of Q and K (bank spread)
  constexpr int BKP = BK + 1;  // padded smem row stride of P
  constexpr int DC = D / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;           // BQ x DP
  float* Ks = Qs + BQ * DP;   // BK x DP
  float* Vs = Ks + BK * DP;   // BK x D
  float* Ps = Vs + BK * D;    // BQ x BKP

  const int qb = gridDim.x - 1 - blockIdx.x;  // long causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // column lane: key columns tx + 8j, output dims tx + 8c

  const size_t q_stride = static_cast<size_t>(H) * D;   // between seq positions
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* qbase = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kbase = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const T* vbase = v + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  T* obase = o + (static_cast<size_t>(b) * Sq * H + h) * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * DP + c] = s < Sq ? rt::to_float(qbase[s * q_stride + c]) * scale_log2 : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Q is staged)
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool ok = s < Sk;
      Ks[r * DP + c] = ok ? rt::to_float(kbase[s * kv_stride + c]) : 0.f;
      Vs[r * D + c] = ok ? rt::to_float(vbase[s * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool valid = kpos < Sk && (!causal || kpos <= qpos);
        sc[i][j] = valid ? sc[i][j] : -INFINITY;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing valid yet
      const float corr = exp2f(m[i] - m_use);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = exp2f(sc[i][j] - m_use);  // masked: exp2(-inf) = 0
        Ps[(ty * 4 + i) * BKP + tx + 8 * j] = p;
        rsum += p;
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * BKP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        obase[qpos * q_stride + tx + 8 * c] = rt::from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KV, float scale_log2, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static bool attr_set = false;  // one opt-in per instantiation, above the 48 KB default
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Sk, int H, int KV, float scale_log2, int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// softmax_scale is the plain scale (1/sqrt(D) by default); the kernel works in
// the log2 domain.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int H, int KV, int D,
                                      float softmax_scale, int causal, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  if (Sk == 0 || KV == 0 || H % KV != 0) return cudaErrorInvalidValue;
  const float scale_log2 = softmax_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch_d<float>(D, q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, s);
    case rt::kBF16:
      return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
