// Blocked exact attention (GQA, optional causal mask) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel
// / flash_attention).  q (B, Sq, H, D), k/v (B, Sk, KV, D); query head h reads
// KV head h / (H/KV); causal keeps q_pos >= k_pos with the diagonal at 0;
// output acc / max(l, 1e-30) with an online softmax in f32.  The softmax
// scale is folded into the scores in the log2 domain (exp2f).
//
// Bound on the H100: operations at long prompts (4*D flops per query-key
// pair against 4*D bytes per row of q/k/v/o); at the serving prompt (S=512,
// D=128) the bytes and the flops are within 2x of each other (about 3 us
// each at an H100 SXM's published 3.35 TB/s and 989 TFLOP/s, 700 W).  Two
// kernels, chosen by dtype in flash_attention_launch:
//
// * bf16, the serving dtype: flash_fwd_sm90.  Both products run on the tensor
//   cores with wgmma.  One CTA of two consumer warpgroups per (head, 128-row
//   q-block, sequence); each warpgroup owns 64 query rows.  S = Q K^T is
//   m64n64k16 with both operands in shared memory; O += P V is m64nDk16 with
//   P converted to bf16 in registers (the A operand) and V read MN-major from
//   shared memory (the descriptor's transpose bit).  Thread 0 loads Q once
//   and K/V tiles of 64 rows by TMA into a 2-stage ring completing on
//   mbarriers, so tile j+1 arrives while tile j is computed.  Tiles are
//   swizzled (128/64/32-byte mode for D = 192|128|64 / 96|32 / 80|16); a row
//   wider than its swizzle span is several boxes: three 64-column boxes at
//   D = 192 (nemotron: QK^T is twelve k16 steps, PV m64n192k16 with 96
//   accumulators a thread; Q and the two rings fill 144 KB, and the O
//   staging takes the whole K ring), two at D = 128, three 32-column boxes
//   in 64-byte mode at D = 96 (MLA's qk dim),
//   since 192 bytes is no multiple of 128, and five 16-column boxes in
//   32-byte mode at D = 80 (zamba2), since 32 bytes is the widest span that
//   divides a 160-byte row.  The kv loop stops at the causal diagonal,
//   a warpgroup skips the tiles wholly above its own rows, and only tiles
//   that cross the diagonal or the Sk tail are masked (TMA zero-fills rows
//   past Sk, and a zero key scores 0, so k_pos >= Sk is masked explicitly).
//   q-blocks run heaviest first.  The output is staged through shared
//   memory and stored in 16-byte rows; the Sq tail is masked at the store.
//   P is rounded to bf16 before the PV product (the TPU kernel keeps it in
//   f32).
// * f32: flash_fwd_fma.  f32 inputs must match the reference at 3e-5, which
//   rules out TF32, so this kernel does both products with f32 FMAs from
//   shared memory: one 128-thread CTA per (64-row q-block, head, sequence), a
//   loop over 32-row K/V tiles; each thread owns 4 query rows x 4 key columns
//   of the score tile and 4 rows x D/8 columns of the output (24 at D = 192,
//   12 at D = 96, 10 at D = 80); at D = 192 the tiles take 107 KB of shared
//   memory.
//
// Both kernels can also write each row's log-sum-exp (the training path asks
// for it, serving never does): with `lse` non-null the epilogue stores
// m + log2(l) of the row's running max m and sum l, in the log2 domain of
// the scaled scores (+inf for a row with no valid key), into an f32 (B, H,
// ls) array, rows < Sq; the backward (flash_attention_bwd.cu) reads it
// instead of recomputing it.  With `lse` null nothing else changes.
//
// Head dims 16, 32, 64, 80, 96, 128 and 192 are instantiated; the wrapper
// zero-pads D = 24 to 32.
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace sm90 {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int BQ = 64 * kWarpgroups;  // query rows per CTA
constexpr int BK = 64;                // key rows per K/V tile
constexpr int kStages = 2;

// Shared-memory layout of one CTA at head dim D: [Q | K x kStages | V x
// kStages | barriers].  Each tile is NBOX boxes of (rows x SW bytes), as
// hp::RowBoxes<D> lays a row out.
template <int D>
struct Layout : hp::RowBoxes<D> {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(2 * 64 * D * 2 <= kStages * KV_BYTES, "the O staging reuses the K ring");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int ls, int Sq, int Sk, int H, int KV, float scale_log2,
                   int causal) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_k + kStages;

  const int h = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest causal q-blocks first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int wg_row0 = q0 + wg * 64;  // first query row of this warpgroup
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  const CUtensorMap* maps[2] = {&tk, &tv};
  auto load_kv = [=](int j) {  // thread 0: K and V tile j into stage j % kStages
    const int s = j % kStages;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint64_t* bar = m == 0 ? &bar_k[s] : &bar_v[s];
      uint8_t* dst = smem + (m == 0 ? L::K_OFF : L::V_OFF) + s * L::KV_BYTES;
      hp::mbar_expect_tx(bar, L::KV_BYTES);
#pragma unroll
      for (int x = 0; x < L::NBOX; ++x)
        hp::tma_load_4d(dst + x * BK * L::SW, maps[m], bar, x * L::BOX, kvh, j * BK, b);
    }
  };

  if (tid == 0) {
    hp::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&bar_k[s], 1);
      hp::mbar_init(&bar_v[s], 1);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
    for (int x = 0; x < L::NBOX; ++x)
      hp::tma_load_4d(smem + x * BQ * L::SW, &tq, bar_q, x * L::BOX, h, q0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }

  // Accumulator layout (m64nN, f32): this thread holds rows r and r + 8 of
  // its warpgroup's 64, r = warp*16 + lane/4, and in each 8-column block c
  // the columns 8c + 2*(lane%4) + {0, 1}: element [4c + 2i + j].
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int r_lo = warp * 16 + lane / 4;
  const int col2 = (lane % 4) * 2;

  const uint32_t q_base = hp::smem_u32(smem) + wg * 64 * L::SW;
  hp::mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = j * BK;
    if (!causal || k0 <= wg_row0 + 63) {  // warpgroup-uniform
      const uint32_t k_base = hp::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
      const uint32_t v_base = hp::smem_u32(smem + L::V_OFF + s * L::KV_BYTES);
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      hp::mbar_wait(&bar_k[s], parity);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 32 / L::SW), in = (kk * 32) % L::SW;
        const uint64_t da = hp::make_desc(q_base + off * BQ * L::SW + in, 16, 8 * L::SW, L::kSw);
        const uint64_t db = hp::make_desc(k_base + off * BK * L::SW + in, 16, 8 * L::SW, L::kSw);
        hp::wgmma_ss_m64n64k16(sc, da, db, kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait_all();
      hp::fence_regs(sc);

      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wg_row0 + r_lo + 8 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * c + 2 * i + e] * scale_log2;
            const int kpos = k0 + 8 * c + col2 + e;
            if (masked && (kpos >= Sk || (causal && kpos > qpos))) x = -INFINITY;
            sc[4 * c + 2 * i + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing valid yet
        const float corr = exp2f(m_run[i] - m_use);
        m_run[i] = m_new;
        float rsum = 0.f;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * c + 2 * i + e] - m_use);  // masked: 0
            sc[4 * c + 2 * i + e] = p;
            rsum += p;
          }
        l_run[i] = l_run[i] * corr + rsum;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          acc[4 * c + 2 * i] *= corr;
          acc[4 * c + 2 * i + 1] *= corr;
        }
      }

      uint32_t pa[BK / 16][4];  // P as the A operand, k-step t: keys 16t..16t+15
      hp::acc_to_a<BK>(pa, sc);
      hp::mbar_wait(&bar_v[s], parity);
      hp::wgmma_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        // V is MN-major: 16 key rows per k-step, 8-row groups sbo apart,
        // BOX-column boxes lbo apart.
        const uint64_t dv = hp::make_desc(v_base + t * 16 * L::SW, BK * L::SW, 8 * L::SW, L::kSw);
        hp::wgmma_rs_tb<D>(acc, pa[t], dv);
      }
      hp::wgmma_commit();
      hp::wgmma_wait_all();
      hp::fence_regs(acc);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && j + kStages < n_tiles) load_kv(j + kStages);
  }

  // Epilogue: full row sums across the quad, then O / max(l, 1e-30) in bf16
  // staged through the (now idle) K ring; the log-sum-exp if asked for.
  float l_row[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = l;
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  hp::store_rows<D>(acc, inv, smem + L::K_OFF + wg * 64 * D * 2,
                    o + static_cast<size_t>(b) * Sq * H * D + static_cast<size_t>(h) * D,
                    static_cast<size_t>(H) * D, wg_row0, Sq, 1 + wg);
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = wg_row0 + r_lo + 8 * i;
      if (qpos < Sq)
        lse[(static_cast<size_t>(b) * H + h) * ls + qpos] =
            l_row[i] > 0.f ? m_run[i] + log2f(l_row[i]) : INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int ls,
                   int B, int Sq, int Sk, int H, int KV, float scale_log2, int causal, int device,
                   cudaStream_t stream) {
  static rt::SmemOptIn optin;
  cudaError_t err = optin.ensure(flash_fwd_sm90<D>, device, Layout<D>::SMEM);
  if (err != cudaSuccess) return err;
  if (!rt::aligned16(q) || !rt::aligned16(k) || !rt::aligned16(v) || !rt::aligned16(o))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if ((err = hp::make_map<D>(&tq, q, B, Sq, H, BQ)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tk, k, B, Sk, KV, BK)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tv, v, B, Sk, KV, BK)) != cudaSuccess) return err;
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  flash_fwd_sm90<D><<<grid, kThreads, Layout<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, ls, Sq, Sk, H, KV, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// f32: FMAs from shared memory
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 128;
constexpr int BQ = 64;  // query rows per CTA: 16 row groups x 4 rows
constexpr int BK = 32;  // keys per tile: 8 column lanes x 4 columns
constexpr int NJ = BK / 8;

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int ls, int Sq, int Sk, int H, int KV, float scale_log2, int causal) {
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
  const float* qbase = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kbase = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const float* vbase = v + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  float* obase = o + (static_cast<size_t>(b) * Sq * H + h) * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * DP + c] = s < Sq ? qbase[s * q_stride + c] * scale_log2 : 0.f;
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
      Ks[r * DP + c] = ok ? kbase[s * kv_stride + c] : 0.f;
      Vs[r * D + c] = ok ? vbase[s * kv_stride + c] : 0.f;
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
      for (int c = 0; c < DC; ++c) obase[qpos * q_stride + tx + 8 * c] = acc[i][c] / denom;
      if (lse != nullptr && tx == 0)
        lse[(static_cast<size_t>(b) * H + h) * ls + qpos] = l[i] > 0.f ? m[i] + log2f(l[i]) : INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int ls,
                   int B, int Sq, int Sk, int H, int KV, float scale_log2, int causal, int device,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static rt::SmemOptIn optin;
  const cudaError_t err = optin.ensure(flash_fwd_fma<D>, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_fma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, ls, Sq, Sk, H, KV, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace simt

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                         float* lse, int ls, int B, int Sq, int Sk, int H, int KV, float sl,
                         int causal, int device, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return simt::launch<D>(q, k, v, o, lse, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    case rt::kBF16:
      return sm90::launch<D>(q, k, v, o, lse, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// softmax_scale is the plain scale (1/sqrt(D) by default); the kernels work in
// the log2 domain.  bf16 takes the wgmma kernel, f32 the FMA kernel.  lse:
// null, or an f32 (B, H, ls) array (ls >= Sq) for each row's log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int ls, int B, int Sq, int Sk, int H, int KV,
                                      int D, float softmax_scale, int causal, int dtype,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  if (Sk == 0 || KV == 0 || H % KV != 0 || (lse != nullptr && ls < Sq)) return cudaErrorInvalidValue;
  float* lf = static_cast<float*>(lse);
  const float sl = softmax_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 80:
      return launch_dtype<80>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 96:
      return launch_dtype<96>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 192:
      return launch_dtype<192>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
