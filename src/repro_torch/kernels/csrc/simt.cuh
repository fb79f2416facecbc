// The register-tiled f32 FMA building blocks of the port's two f32
// attention kernels (flash_fwd_fma in flash_attention.cu, flash_bwd_fma in
// flash_attention_bwd.cu): cp.async copies of whole rows into shared rows
// padded by 4 floats, and products whose operands a thread reads as float4,
// each warp an 8 x 4 block of the product's thread grid, so that a warp's
// loads of one operand touch 8 rows (4 banks apart: no conflict) and of the
// other 4.  f32 must match the reference at 3e-5, which rules out TF32 and
// the tensor cores: these products run on the FMA units.
#pragma once

#include "hopper.cuh"

namespace {
namespace simt {

constexpr int kThreads = 256;  // every simt kernel's CTA

// 16 bytes from global into shared memory, asynchronously (cp.async.cg);
// zeros where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(hp::smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of a (S, stride) slab of D-float rows into shared rows
// LD floats apart, by all threads in 16-byte copies; rows past S are zeros.
template <int R, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, size_t stride, int r0,
                                          int S) {
  constexpr int CPR = D / 4;  // 16-byte copies per row
  for (int c = threadIdx.x; c < R * CPR; c += kThreads) {
    const int r = c / CPR, x = c % CPR;
    const bool in = r0 + r < S;
    cp_async16(dst + r * LD + 4 * x, src + (in ? static_cast<size_t>(r0 + r) * stride : 0) + 4 * x,
               in);
  }
}

// Zeros columns [D, DC) of `rows` shared rows LD floats apart (the products
// run DC wide; no copy writes there).
template <int D, int DC, int LD>
__device__ __forceinline__ void zero_pad(float* rows_base, int rows) {
  if constexpr (DC > D)
    for (int i = threadIdx.x; i < rows * (DC - D); i += kThreads)
      rows_base[(i / (DC - D)) * LD + D + i % (DC - D)] = 0.f;
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The place of thread t (of NT) in a product's RG x CG thread grid: each
// warp an 8 x 4 block of it, so that a warp's loads of A touch 8 rows and
// those of B 4 rows (or 4 consecutive float4 columns).
template <int RG, int CG, int NT>
__device__ __forceinline__ int2 grid_pos(int t) {
  static_assert(RG * CG == NT && RG % 8 == 0 && CG % 4 == 0, "8 x 4 warp blocks");
  const int w = t / 32, l = t % 32;
  return make_int2((w / (CG / 4)) * 8 + l / 4, (w % (CG / 4)) * 4 + l % 4);
}

// c[i][j] += sum_k A[(rg + RG i) LDA + k] B[(cg + CG j) LDB + k], k < K: both
// operands k-inner in shared memory, read as float4 along k (TM + TN 16-byte
// loads for 4 TM TN FMAs).  U: the k loop's unroll (1 leaves the registers
// of the next step's loads to a kernel that needs them).
template <int TM, int TN, int RG, int CG, int K, int LDA, int LDB, int U = 2>
__device__ __forceinline__ void mma_nt(float (&c)[TM][TN], const float* A, const float* B, int2 p) {
  const float* a0 = A + p.x * LDA;
  const float* b0 = B + p.y * LDB;
#pragma unroll U
  for (int k = 0; k < K; k += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + i * RG * LDA + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(b0 + j * CG * LDB + k);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
}

// c[i][4f + e] += sum_k A[(rg + RG i) LDA + k] B[k LDB + 4 (cg + CG f) + e],
// k < K: A k-inner (float4 along k), B k-outer (float4 along its columns).
// U as mma_nt's.
template <int TM, int TF, int RG, int CG, int K, int LDA, int LDB, int U = 2>
__device__ __forceinline__ void mma_nn(float (&c)[TM][4 * TF], const float* A, const float* B,
                                       int2 p) {
  const float* a0 = A + p.x * LDA;
  const float* b0 = B + 4 * p.y;
#pragma unroll U
  for (int k = 0; k < K; k += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + i * RG * LDA + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 b[TF];
#pragma unroll
      for (int f = 0; f < TF; ++f)
        b[f] = *reinterpret_cast<const float4*>(b0 + (k + e) * LDB + 4 * CG * f);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = lane4(a[i], e);
#pragma unroll
        for (int f = 0; f < TF; ++f) {
          c[i][4 * f + 0] = fmaf(av, b[f].x, c[i][4 * f + 0]);
          c[i][4 * f + 1] = fmaf(av, b[f].y, c[i][4 * f + 1]);
          c[i][4 * f + 2] = fmaf(av, b[f].z, c[i][4 * f + 2]);
          c[i][4 * f + 3] = fmaf(av, b[f].w, c[i][4 * f + 3]);
        }
      }
    }
  }
}

// A D-wide product (ROWS rows x DC columns as float4 columns) over NT
// threads: CG column groups of TF float4 columns, RG row groups of TM rows.
template <int DC, int NT, int ROWS = 64>
struct Wide {
  static constexpr int F = DC / 4;
  static constexpr int CG = F % 16 == 0 ? 16 : F % 8 == 0 ? 8 : 4;
  static constexpr int RG = NT / CG;
  static constexpr int TM = ROWS / RG, TF = F / CG;
  static_assert(F % CG == 0 && RG <= ROWS && ROWS % RG == 0, "D-wide product grid");
};

}  // namespace simt
}  // namespace
