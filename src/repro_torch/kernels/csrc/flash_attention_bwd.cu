// Blocked exact attention, backward, for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(scale * Q K^T) V, GQA, causal or not.
//
// A port-only kernel: the TPU side has no backward kernel (the JAX package
// differentiates its plain chunked_attention, src/repro/models/layers.py:118),
// but the port's model calls the forward kernel (csrc/flash_attention.cu),
// so its gradient needs one too.  Layouts as the forward: q, o, do, dq
// (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D); query head h reads KV head
// h / (H / KV); causal keeps k_pos <= q_pos with the diagonal at 0.  With P
// = softmax(S), S = scale * Q K^T:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
//
// Bound on the H100: operations (2.5x the forward's, half of them masked
// when causal).  This first version is FlashAttention-2's two passes, simple
// and deterministic (no atomics), with f32 FMAs from shared memory and f32
// accumulation for f32 and bf16 inputs alike (bf16 is widened as it is
// staged):
//
// * flash_bwd_dq: one 128-thread CTA per (64-row q-block, head, sequence).
//   It stages Q and dO, takes delta from dO and O, walks the 32-row K tiles
//   once for the row max and sum (the forward keeps no log-sum-exp), then
//   again with V: S and dP from one loop over d, dS into shared memory, dQ
//   += dS K.  Each thread owns 4 rows x 4 key columns of the tiles and 4
//   rows x D/8 columns of dQ.  It writes dQ and each row's log2-domain
//   log-sum-exp and delta to an f32 scratch (B, H, Sq).
// * flash_bwd_dkv: one 128-thread CTA per (32-row k-block, KV head,
//   sequence).  It stages its K and V rows once and walks, for each of the
//   n_rep query heads of its KV head, the 64-row q-blocks that can see its
//   keys (from the diagonal on when causal): P^T and dS^T from one loop
//   over d, then dV += P^T dO and dK += dS^T Q.  Each thread owns 4 key
//   rows x 4 query columns of the tiles and 4 key rows x D/16 columns of dK
//   and dV, so the GQA sum over the group stays in registers.
//
// Shared memory: rows padded by one float (bank spread).  At D = 192 the dQ
// pass takes 153 KB and the dK/dV pass 162 KB (the per-device opt-in,
// rt::SmemOptIn); at D = 128 105 and 114 KB.  Head dims 16, 32, 64, 80, 96,
// 128 and 192 are instantiated; the wrapper zero-pads D = 24 to 32, as the
// forward's does.  The wgmma redesign is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;   // dQ pass: query rows per CTA
constexpr int BK = 32;   // dQ pass: key rows per K/V tile
constexpr int BKV = 32;  // dK/dV pass: key rows per CTA
constexpr int BQ2 = 64;  // dK/dV pass: query rows per Q/dO tile

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * BKV * (D + 1) + 2 * BQ2 * (D + 1) + 2 * BKV * (BQ2 + 1) + 2 * BQ2;
}

// rows [r0, r0 + rows) of a (S, heads, D) slab at `base` (stride `stride`
// between positions) into smem rows of DP floats; rows past S are zero
template <typename T, int D, int DP>
__device__ __forceinline__ void stage(float* dst, const T* base, size_t stride, int r0, int rows,
                                      int S) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, s = r0 + r;
    dst[r * DP + c] = s < S ? rt::to_float(base[s * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ delta_out, int Sq, int Sk,
                 int H, int KV, float scale, float scale_log2, int causal) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int DC = D / 8;   // dQ columns per thread
  constexpr int NJ = BK / 8;  // key columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* dOs = Qs + BQ * DP;   // BQ x DP
  float* Ks = dOs + BQ * DP;   // BK x DP
  float* Vs = Ks + BK * DP;    // BK x DP
  float* dSs = Vs + BK * DP;   // BQ x BKP

  const int qb = gridDim.x - 1 - blockIdx.x;  // long causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // key columns tx + 8j, dQ columns tx + 8c

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * KV + kvh) * D;

  stage<T, D, DP>(Qs, q + q_off, q_stride, q0, BQ, Sq);
  stage<T, D, DP>(dOs, dout + q_off, q_stride, q0, BQ, Sq);
  __syncthreads();

  // delta = rowsum(dO * O), each row's sum over the 8 lanes of its row group
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = q0 + r;
    float t = 0.f;
    if (s < Sq) {
      const T* orow = o + q_off + s * q_stride;
#pragma unroll
      for (int c = 0; c < DC; ++c) t = fmaf(dOs[r * DP + tx + 8 * c], rt::to_float(orow[tx + 8 * c]), t);
    }
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    t += __shfl_xor_sync(0xffffffffu, t, 4);
    delta[i] = t;
  }

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  auto scores = [&](float (&sc)[4][NJ]) {  // sc = (Q K^T) * scale_log2 of the staged tile
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
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[i][j] *= scale_log2;
  };
  auto valid = [&](int i, int j, int k0) {
    const int qpos = q0 + ty * 4 + i, kpos = k0 + tx + 8 * j;
    return kpos < Sk && (!causal || kpos <= qpos);
  };

  // 1. the row max and sum (log2 domain), online as in the forward
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, D, DP>(Ks, k + kv_off, kv_stride, k0, BK, Sk);
    __syncthreads();
    float sc[4][NJ];
    scores(sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        sc[i][j] = valid(i, j, k0) ? sc[i][j] : -INFINITY;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) rsum += exp2f(sc[i][j] - m_use);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * exp2f(m[i] - m_use) + rsum;
      m[i] = m_new;
    }
  }
  float lse[4];  // +inf for a row with no valid key: its P is 0
#pragma unroll
  for (int i = 0; i < 4; ++i) lse[i] = l[i] > 0.f ? m[i] + log2f(l[i]) : INFINITY;

  // 2. dS = P * (dP - delta) tile by tile, dQ += dS K
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    stage<T, D, DP>(Ks, k + kv_off, kv_stride, k0, BK, Sk);
    stage<T, D, DP>(Vs, v + kv_off, kv_stride, k0, BK, Sk);
    __syncthreads();
    float sc[4][NJ];
    scores(sc);
    float dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float gv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = dOs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = valid(i, j, k0) ? exp2f(sc[i][j] - lse[i]) : 0.f;
        dSs[(ty * 4 + i) * BKP + tx + 8 * j] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * BKP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * DP + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

  const size_t stat_off = (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos < Sq) {
      T* drow = dq + q_off + qpos * q_stride;
#pragma unroll
      for (int c = 0; c < DC; ++c) drow[tx + 8 * c] = rt::from_float<T>(acc[i][c] * scale);
      if (tx == 0) {
        lse_out[stat_off + qpos] = lse[i];
        delta_out[stat_off + qpos] = delta[i];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse_in,
                  const float* __restrict__ delta_in, T* __restrict__ dk, T* __restrict__ dv,
                  int Sq, int Sk, int H, int KV, float scale, float scale_log2, int causal) {
  constexpr int DP = D + 1;
  constexpr int BQP = BQ2 + 1;
  constexpr int DC = D / 16;   // dK/dV columns per thread
  constexpr int NJ = BQ2 / 16; // query columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;             // BKV x DP
  float* Vs = Ks + BKV * DP;    // BKV x DP
  float* Qs = Vs + BKV * DP;    // BQ2 x DP
  float* dOs = Qs + BQ2 * DP;   // BQ2 x DP
  float* Ps = dOs + BQ2 * DP;   // BKV x BQP
  float* dSs = Ps + BKV * BQP;  // BKV x BQP
  float* Ls = dSs + BKV * BQP;  // BQ2
  float* Ds = Ls + BQ2;         // BQ2

  const int k0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / KV;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // key rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // query columns tx + 16j, dK/dV columns tx + 16c

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * KV + kvh) * D;

  stage<T, D, DP>(Ks, k + kv_off, kv_stride, k0, BKV, Sk);
  stage<T, D, DP>(Vs, v + kv_off, kv_stride, k0, BKV, Sk);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int q_first = causal ? (k0 / BQ2) * BQ2 : 0;  // earlier q-blocks see none of these keys
  for (int r = 0; r < n_rep; ++r) {
    const int h = kvh * n_rep + r;
    const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t stat_off = (static_cast<size_t>(b) * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += BQ2) {
      __syncthreads();  // the previous tile's readers are done (and K, V are staged)
      stage<T, D, DP>(Qs, q + q_off, q_stride, q0, BQ2, Sq);
      stage<T, D, DP>(dOs, dout + q_off, q_stride, q0, BQ2, Sq);
      for (int i = tid; i < BQ2; i += kThreads) {
        const int s = q0 + i;
        Ls[i] = s < Sq ? lse_in[stat_off + s] : INFINITY;
        Ds[i] = s < Sq ? delta_in[stat_off + s] : 0.f;
      }
      __syncthreads();

      float st[4][NJ], dpt[4][NJ];  // S^T and dP^T: key rows x query columns
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[NJ], gv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * DP + d];
          vv[i] = Vs[(ty * 4 + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          gv[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int qc = tx + 16 * j, qpos = q0 + qc;
          const bool ok = kpos < Sk && qpos < Sq && (!causal || kpos <= qpos);
          const float p = ok ? exp2f(st[i][j] * scale_log2 - Ls[qc]) : 0.f;
          Ps[(ty * 4 + i) * BQP + qc] = p;
          dSs[(ty * 4 + i) * BQP + qc] = p * (dpt[i][j] - Ds[qc]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BQ2; ++qq) {
        float pv[4], sv[4], gv[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty * 4 + i) * BQP + qq];
          sv[i] = dSs[(ty * 4 + i) * BQP + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gv[c] = dOs[qq * DP + tx + 16 * c];
          qv[c] = Qs[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dva[i][c] = fmaf(pv[i], gv[c], dva[i][c]);
            dka[i][c] = fmaf(sv[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos < Sk) {
      const size_t row = kv_off + kpos * kv_stride;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[row + tx + 16 * c] = rt::from_float<T>(dka[i][c] * scale);
        dv[row + tx + 16 * c] = rt::from_float<T>(dva[i][c]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, float* lse, float* delta, int B, int Sq, int Sk,
                   int H, int KV, float scale, int causal, int device, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_floats<D>() * sizeof(float);
  constexpr size_t smem_dkv = dkv_smem_floats<D>() * sizeof(float);
  static rt::SmemOptIn optin_dq, optin_dkv;
  cudaError_t err = optin_dq.ensure(flash_bwd_dq<T, D>, device, smem_dq);
  if (err != cudaSuccess) return err;
  err = optin_dkv.ensure(flash_bwd_dkv<T, D>, device, smem_dkv);
  if (err != cudaSuccess) return err;
  const float sl = scale * 1.4426950408889634f;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq<T, D><<<dim3((Sq + BQ - 1) / BQ, H, B), kThreads, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse, delta, Sq, Sk, H, KV,
      scale, sl, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv<T, D><<<dim3((Sk + BKV - 1) / BKV, KV, B), kThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, scale,
      sl, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
                         int B, int Sq, int Sk, int H, int KV, float scale, int causal, int device,
                         cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return launch<float, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV, scale,
                              causal, device, s);
    case rt::kBF16:
      return launch<__nv_bfloat16, D>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                                      scale, causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// softmax_scale is the plain scale (1/sqrt(D) by default).  stats: an f32
// scratch of 2 x B x H x Sq floats (the log-sum-exp, then delta).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dv, void* stats, int B, int Sq, int Sk, int H,
                                          int KV, int D, float softmax_scale, int causal,
                                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (Sq == 0 || Sk == 0 || KV == 0 || H % KV != 0) return cudaErrorInvalidValue;
  float* lse = static_cast<float*>(stats);
  float* delta = lse + static_cast<size_t>(B) * H * Sq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 80:
      return launch_dtype<80>(dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 96:
      return launch_dtype<96>(dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                               softmax_scale, causal, device, s);
    case 192:
      return launch_dtype<192>(dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, KV,
                               softmax_scale, causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
