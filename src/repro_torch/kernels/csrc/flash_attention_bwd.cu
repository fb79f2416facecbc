// Blocked exact attention, backward, for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(scale * Q K^T) V, GQA, causal or not.
//
// A port-only kernel: the TPU side has no backward kernel (the JAX package
// differentiates its plain chunked_attention, src/repro/models/layers.py:118),
// but the port's model calls the forward kernel (csrc/flash_attention.cu),
// so its gradient needs one too.  Layouts as the forward: q, o, do, dq
// (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D); query head h reads KV head
// h / (H / KV); causal keeps k_pos <= q_pos with the diagonal at 0.  With
// P = softmax(S), S = scale * Q K^T:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// P is rebuilt tile by tile as exp2(S * scale * log2(e) - lse) from the
// log-sum-exp that the forward kept (lse, f32 (B, H, ls), log2 domain).
//
// Bound on the H100: operations, 2.5x the forward's (5 products of 2 D per
// query-key pair), half of them masked when causal.  Three launches, no
// atomics anywhere, so two runs give the same bits (the train loop's resume
// is checked bit for bit):
//
// * flash_bwd_delta (both dtypes): delta = rowsum(dO * O) into an f32 (B, H,
//   ls) scratch, one warp per row; rows Sq..ls-1 get 0.
// * bf16, flash_bwd_dkv_sm90: one CTA of two consumer warpgroups per
//   (128-row key block, KV head, sequence), each warpgroup owning 64 key
//   rows.  Thread 0 loads the K and V block once and keeps a 2-stage TMA
//   ring of (Q tile, dO tile, lse slice, delta slice) on mbarriers over the
//   n_rep query heads of the group and the q-tiles that can see the keys
//   (from the diagonal on when causal).  Per tile: S^T = K Q^T and dP^T =
//   V dO^T (wgmma, both operands in shared memory), P^T = exp2(S^T sl -
//   lse), dS^T = P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q with
//   P^T and dS^T rounded to bf16 in registers as the A operand and the same
//   Q and dO tiles read MN-major (the descriptor's transpose bit), so the
//   GQA sum stays in registers in a fixed order.  dK takes the scale in the
//   epilogue; both are staged through the idle K and V blocks.  The
//   accumulators are 2 x D/2 f32 a thread, so at D = 192 the q-tile is 32
//   rows (S^T and dP^T m64n32, 16 f32 each) and at D <= 128 64 rows.
// * bf16, flash_bwd_dq_sm90: one CTA of two warpgroups per (128-row
//   q-block, head, sequence), heaviest causal blocks first: Q and dO staged
//   once, a 2-stage ring of 64-row K and V tiles; S = Q K^T, dP = dO V^T,
//   P and dS as above from each row's lse and delta, dQ += dS K (K read
//   MN-major); the kv loop stops at the causal diagonal.  At D <= 64 the
//   two warpgroups release ring stages on their own (an empty barrier per
//   stage) instead of meeting at a barrier per tile, so that one's softmax
//   runs under the other's products; at D >= 128 the barrier measured
//   faster.  dQ in its own pass (no atomics) costs 2 products more than the
//   bound's 5: 7 in all.
// Tiles are TMA boxes as hp::RowBoxes<D> lays a row out (the forward's
// swizzle modes); TMA zero-fills rows past Sq and Sk, and the tiles that
// cross the diagonal or a tail are masked explicitly.
//
// * f32: flash_bwd_dq_fma and flash_bwd_dkv_fma, f32 FMAs from shared memory
//   (f32 must hold 3e-5, which rules out TF32 and bf16 tensor cores).  The
//   dQ pass is one 128-thread CTA per (64-row q-block, head, sequence) over
//   32-row K/V tiles; the dK/dV pass one per (32-row k-block, KV head,
//   sequence) over the group's 64-row q-tiles; rows padded by one float
//   (bank spread); 153 and 162 KB of shared memory at D = 192.
//
// Head dims 16, 32, 64, 80, 96, 128 and 192 are instantiated; the wrapper
// zero-pads D = 24 to 32, as the forward's does.
#include <initializer_list>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), both dtypes
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                    int Sq, int H, int D, int ls, int n_rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;  // over (b, h, s < ls)
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int s = row % ls, bh = row / ls;
  float t = 0.f;
  if (s < Sq) {
    const size_t off = ((static_cast<size_t>(bh / H) * Sq + s) * H + bh % H) * D;
    for (int c = lane; c < D; c += 32) t = fmaf(rt::to_float(dout[off + c]), rt::to_float(o[off + c]), t);
  }
  t = rt::warp_sum(t);
  if (lane == 0) delta[row] = t;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace sm90 {

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kStages = 2;     // ring depth of both passes
constexpr int BKV = 128;       // dK/dV pass: key rows per CTA
constexpr int BQD = 128;       // dQ pass: query rows per CTA
constexpr int BK = 64;         // dQ pass: key rows per K/V tile

// dK/dV pass: [K | V | Q x kStages | dO x kStages | (lse, delta) x kStages |
// barriers].
template <int D>
struct DkvLayout : hp::RowBoxes<D> {
  static constexpr int BQ = D > 128 ? 32 : 64;  // query rows per ring tile
  static constexpr int KV_BYTES = BKV * D * 2;  // the K or the V block
  static constexpr int T_BYTES = BQ * D * 2;    // one Q or dO tile
  static constexpr int STAT_BYTES = 2 * BQ * 4;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + kStages * T_BYTES;
  static constexpr int STAT_OFF = DO_OFF + kStages * T_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + kStages * STAT_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + kStages) + 1024;  // + alignment slack
  static_assert(BKV % BQ == 0, "a causal key block starts a q-tile");
};

// dQ pass: [Q | dO | K x kStages | V x kStages | barriers].
template <int D>
struct DqLayout : hp::RowBoxes<D> {
  // At D <= 64 a tile's products are short and the warpgroups in step wait
  // on each other's softmax: each then releases a stage on its own (the
  // empty barriers) and thread 0 refills it once both have.  At D = 128 and
  // 192 the barrier per tile measured faster (PERF.md, the flash backward).
  static constexpr bool kDesync = D <= 64;
  static constexpr int Q_BYTES = BQD * D * 2;  // also dO
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse, const float* __restrict__ delta, int ls,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                       int Sk, int H, int KV, float scale, float scale_log2, int causal) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_t = bar_kv + 1;

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * BKV;  // the first key blocks see the most queries: they go first
  const int b = blockIdx.z;
  const int n_rep = H / KV;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int wg_k0 = k0 + wg * 64;  // first key row of this warpgroup
  const int qt0 = causal ? k0 / BQ : 0;  // earlier q-tiles see none of these keys
  const int nqt = max((Sq + BQ - 1) / BQ - qt0, 0);
  const int n_tiles = n_rep * nqt;  // (query head, q-tile) pairs, head-major

  const CUtensorMap* map_q = &tq;  // the kernel parameters themselves, not copies
  const CUtensorMap* map_do = &tdo;
  auto load_tile = [=](int j) {  // thread 0: Q, dO, lse and delta of tile j into stage j % kStages
    const int s = j % kStages;
    const int h = kvh * n_rep + j / nqt;
    const int q0 = (qt0 + j % nqt) * BQ;
    uint64_t* bar = &bar_t[s];
    hp::mbar_expect_tx(bar, 2 * L::T_BYTES + L::STAT_BYTES);
#pragma unroll
    for (int x = 0; x < L::NBOX; ++x) {
      hp::tma_load_4d(smem + L::Q_OFF + s * L::T_BYTES + x * BQ * L::SW, map_q, bar, x * L::BOX, h,
                      q0, b);
      hp::tma_load_4d(smem + L::DO_OFF + s * L::T_BYTES + x * BQ * L::SW, map_do, bar, x * L::BOX,
                      h, q0, b);
    }
    const size_t st = (static_cast<size_t>(b) * H + h) * ls + q0;  // q0 + BQ <= ls
    uint8_t* stat = smem + L::STAT_OFF + s * L::STAT_BYTES;
    hp::bulk_load(stat, lse + st, BQ * 4, bar);
    hp::bulk_load(stat + BQ * 4, delta + st, BQ * 4, bar);
  };

  if (tid == 0) {
    hp::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) hp::mbar_init(&bar_t[s], 1);
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
#pragma unroll
    for (int x = 0; x < L::NBOX; ++x) {
      hp::tma_load_4d(smem + L::K_OFF + x * BKV * L::SW, &tk, bar_kv, x * L::BOX, kvh, k0, b);
      hp::tma_load_4d(smem + L::V_OFF + x * BKV * L::SW, &tv, bar_kv, x * L::BOX, kvh, k0, b);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j);
  }

  // Accumulator layout (m64nN, f32): this thread holds rows r_lo and r_lo + 8
  // of its warpgroup's 64 key rows, and in each 8-column block c the
  // columns 8c + col2 + {0, 1}: element [4c + 2i + e].
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const int r_lo = warp * 16 + lane / 4;
  const int col2 = (lane % 4) * 2;
  // this warpgroup's 64 rows of each box of the K and V blocks
  const uint32_t k_base = hp::smem_u32(smem + L::K_OFF) + wg * 64 * L::SW;
  const uint32_t v_base = hp::smem_u32(smem + L::V_OFF) + wg * 64 * L::SW;
  hp::mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int q0 = (qt0 + j % nqt) * BQ;
    if (!causal || q0 + BQ - 1 >= wg_k0) {  // warpgroup-uniform: some query sees some key
      const uint32_t q_base = hp::smem_u32(smem + L::Q_OFF + s * L::T_BYTES);
      const uint32_t do_base = hp::smem_u32(smem + L::DO_OFF + s * L::T_BYTES);
      const float* Ls = reinterpret_cast<const float*>(smem + L::STAT_OFF + s * L::STAT_BYTES);
      const float* Ds = Ls + BQ;
      float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: 64 key rows x BQ query columns
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
      hp::mbar_wait(&bar_t[s], parity);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 32 / L::SW), in = (kk * 32) % L::SW;
        const uint64_t da = hp::make_desc(k_base + off * BKV * L::SW + in, 16, 8 * L::SW, L::kSw);
        const uint64_t db = hp::make_desc(q_base + off * BQ * L::SW + in, 16, 8 * L::SW, L::kSw);
        hp::wgmma_ss<BQ>(st, da, db, kk > 0);
      }
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 32 / L::SW), in = (kk * 32) % L::SW;
        const uint64_t da = hp::make_desc(v_base + off * BKV * L::SW + in, 16, 8 * L::SW, L::kSw);
        const uint64_t db = hp::make_desc(do_base + off * BQ * L::SW + in, 16, 8 * L::SW, L::kSw);
        hp::wgmma_ss<BQ>(dpt, da, db, kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // S^T is done, dP^T may still run
      hp::fence_regs(st);

      // P^T = exp2(S^T sl - lse), 0 where masked: the diagonal, the Sq tail
      // (its lse and delta slots are not the row's) and the Sk tail
      const bool masked = (causal && q0 < wg_k0 + 63) || q0 + BQ > Sq || wg_k0 + 64 > Sk;
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(Ls + 8 * c + col2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kpos = wg_k0 + r_lo + 8 * i;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qpos = q0 + 8 * c + col2 + e;
            float p = exp2f(st[4 * c + 2 * i + e] * scale_log2 - (e ? l2.y : l2.x));
            if (masked && (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos))) p = 0.f;
            st[4 * c + 2 * i + e] = p;
          }
        }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(dpt);
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * c + col2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * c + 2 * i + e;
            dpt[x] = st[x] * (dpt[x] - (e ? d2.y : d2.x));  // dS^T; 0 where P^T is
          }
      }

      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];  // k-step t: queries 16t..16t+15
      hp::acc_to_a<BQ>(pa, st);
      hp::acc_to_a<BQ>(dsa, dpt);
      hp::wgmma_fence();
#pragma unroll
      for (int t = 0; t < BQ / 16; ++t) {
        // dO and Q MN-major: 16 query rows per k-step, 8-row groups sbo
        // apart, BOX-column boxes lbo apart
        const uint64_t bdo = hp::make_desc(do_base + t * 16 * L::SW, BQ * L::SW, 8 * L::SW, L::kSw);
        hp::wgmma_rs_tb<D>(dva, pa[t], bdo);
      }
#pragma unroll
      for (int t = 0; t < BQ / 16; ++t) {
        const uint64_t bq = hp::make_desc(q_base + t * 16 * L::SW, BQ * L::SW, 8 * L::SW, L::kSw);
        hp::wgmma_rs_tb<D>(dka, dsa[t], bq);
      }
      hp::wgmma_commit();
      hp::wgmma_wait_all();
      hp::fence_regs(dva);
      hp::fence_regs(dka);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && j + kStages < n_tiles) load_tile(j + kStages);
  }

  // Epilogue: dK (times the scale) and dV in bf16 through the idle K and V
  // blocks; key rows past Sk are not written.
  __syncthreads();
  const float one[2] = {1.f, 1.f}, sc2[2] = {scale, scale};
  const size_t row_stride = static_cast<size_t>(KV) * D;
  const size_t base = static_cast<size_t>(b) * Sk * row_stride + static_cast<size_t>(kvh) * D;
  hp::store_rows<D>(dka, sc2, smem + L::K_OFF + wg * 64 * D * 2, dk + base, row_stride, wg_k0, Sk,
                    1 + wg);
  hp::store_rows<D>(dva, one, smem + L::V_OFF + wg * 64 * D * 2, dv + base, row_stride, wg_k0, Sk,
                    1 + wg);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta, int ls,
                      __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KV, float scale,
                      float scale_log2, int causal) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_k + kStages;
  uint64_t* empty = bar_v + kStages;

  const int h = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest causal q-blocks first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * BQD;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int wg_row0 = q0 + wg * 64;  // first query row of this warpgroup
  const int kv_end = causal ? min(Sk, q0 + BQD) : Sk;
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
      if constexpr (L::kDesync) hp::mbar_init(&empty[s], kThreads);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hp::mbar_expect_tx(bar_q, 2 * L::Q_BYTES);
#pragma unroll
    for (int x = 0; x < L::NBOX; ++x) {
      hp::tma_load_4d(smem + x * BQD * L::SW, &tq, bar_q, x * L::BOX, h, q0, b);
      hp::tma_load_4d(smem + L::DO_OFF + x * BQD * L::SW, &tdo, bar_q, x * L::BOX, h, q0, b);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }

  float acc[D / 2];  // dQ, accumulator layout as in the dK/dV pass
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int r_lo = warp * 16 + lane / 4;
  const int col2 = (lane % 4) * 2;
  float l_row[2], d_row[2];  // this thread's two rows' lse and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = wg_row0 + r_lo + 8 * i;
    const size_t st = (static_cast<size_t>(b) * H + h) * ls + qpos;
    l_row[i] = qpos < Sq ? lse[st] : 0.f;  // rows past Sq: zero Q and dO, never stored
    d_row[i] = qpos < Sq ? delta[st] : 0.f;
  }

  const uint32_t q_base = hp::smem_u32(smem) + wg * 64 * L::SW;
  const uint32_t do_base = hp::smem_u32(smem + L::DO_OFF) + wg * 64 * L::SW;
  hp::mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = j * BK;
    if (!causal || k0 <= wg_row0 + 63) {  // warpgroup-uniform
      const uint32_t k_base = hp::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
      const uint32_t v_base = hp::smem_u32(smem + L::V_OFF + s * L::KV_BYTES);
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      hp::mbar_wait(&bar_k[s], parity);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 32 / L::SW), in = (kk * 32) % L::SW;
        const uint64_t da = hp::make_desc(q_base + off * BQD * L::SW + in, 16, 8 * L::SW, L::kSw);
        const uint64_t db = hp::make_desc(k_base + off * BK * L::SW + in, 16, 8 * L::SW, L::kSw);
        hp::wgmma_ss_m64n64k16(sc, da, db, kk > 0);
      }
      hp::wgmma_commit();
      hp::mbar_wait(&bar_v[s], parity);  // V's load may land while S runs
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 32 / L::SW), in = (kk * 32) % L::SW;
        const uint64_t da = hp::make_desc(do_base + off * BQD * L::SW + in, 16, 8 * L::SW, L::kSw);
        const uint64_t db = hp::make_desc(v_base + off * BK * L::SW + in, 16, 8 * L::SW, L::kSw);
        hp::wgmma_ss_m64n64k16(dp, da, db, kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);

      // P = exp2(S sl - lse), 0 past Sk and above the diagonal
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wg_row0 + r_lo + 8 * i;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * c + col2 + e;
            float p = exp2f(sc[4 * c + 2 * i + e] * scale_log2 - l_row[i]);
            if (masked && (kpos >= Sk || (causal && kpos > qpos))) p = 0.f;
            sc[4 * c + 2 * i + e] = p;
          }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(dp);
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * c + 2 * i + e;
            dp[x] = sc[x] * (dp[x] - d_row[i]);  // dS
          }

      uint32_t dsa[BK / 16][4];  // dS as the A operand, k-step t: keys 16t..16t+15
      hp::acc_to_a<BK>(dsa, dp);
      hp::wgmma_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        // K MN-major, as the forward reads V
        const uint64_t bk = hp::make_desc(k_base + t * 16 * L::SW, BK * L::SW, 8 * L::SW, L::kSw);
        hp::wgmma_rs_tb<D>(acc, dsa[t], bk);
      }
      hp::wgmma_commit();
      hp::wgmma_wait_all();
      hp::fence_regs(acc);
    }
    // A warpgroup skips only the causal tail of the kv loop and waits on the
    // ring no more, so a skipped tile leaves no stale parity behind.
    if constexpr (L::kDesync) {
      hp::mbar_arrive(&empty[s]);
      if (tid == 0 && j + kStages < n_tiles) {
        hp::mbar_wait(&empty[s], parity);
        load_kv(j + kStages);
      }
      __syncwarp();
    } else {
      __syncthreads();  // both warpgroups are done with stage s
      if (tid == 0 && j + kStages < n_tiles) load_kv(j + kStages);
    }
  }

  // Epilogue: dQ times the scale in bf16 through the idle Q tile
  __syncthreads();
  const float sc2[2] = {scale, scale};
  hp::store_rows<D>(acc, sc2, smem + wg * 64 * D * 2,
                    dq + static_cast<size_t>(b) * Sq * H * D + static_cast<size_t>(h) * D,
                    static_cast<size_t>(H) * D, wg_row0, Sq, 1 + wg);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, int ls, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                   int H, int KV, float scale, int causal, int device, cudaStream_t stream) {
  static rt::SmemOptIn optin_dkv, optin_dq;
  cudaError_t err = optin_dkv.ensure(flash_bwd_dkv_sm90<D>, device, DkvLayout<D>::SMEM);
  if (err != cudaSuccess) return err;
  if ((err = optin_dq.ensure(flash_bwd_dq_sm90<D>, device, DqLayout<D>::SMEM)) != cudaSuccess)
    return err;
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq), static_cast<const void*>(dk),
                        static_cast<const void*>(dv), static_cast<const void*>(lse),
                        static_cast<const void*>(delta)})
    if (!rt::aligned16(p)) return cudaErrorMisalignedAddress;
  if (ls % BKV != 0) return cudaErrorInvalidValue;  // the ring's lse/delta slices stay in the row
  const float sl = scale * 1.4426950408889634f;
  CUtensorMap tq, tk, tv, tdo;
  // dK/dV pass: K, V in 128-row blocks; Q, dO in BQ-row tiles
  if ((err = hp::make_map<D>(&tq, q, B, Sq, H, DkvLayout<D>::BQ)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tdo, dout, B, Sq, H, DkvLayout<D>::BQ)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tk, k, B, Sk, KV, BKV)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tv, v, B, Sk, KV, BKV)) != cudaSuccess) return err;
  flash_bwd_dkv_sm90<D><<<dim3(KV, (Sk + BKV - 1) / BKV, B), kThreads, DkvLayout<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, ls, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, KV, scale, sl, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dQ pass: Q, dO in 128-row blocks; K, V in 64-row tiles
  if ((err = hp::make_map<D>(&tq, q, B, Sq, H, BQD)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tdo, dout, B, Sq, H, BQD)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tk, k, B, Sk, KV, BK)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tv, v, B, Sk, KV, BK)) != cudaSuccess) return err;
  flash_bwd_dq_sm90<D><<<dim3(H, (Sq + BQD - 1) / BQD, B), kThreads, DqLayout<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, ls, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, KV, scale, sl,
      causal);
  return cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// f32: FMAs from shared memory
// ---------------------------------------------------------------------------
namespace simt {

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
template <int D, int DP>
__device__ __forceinline__ void stage(float* dst, const float* base, size_t stride, int r0, int rows,
                                      int S) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, s = r0 + r;
    dst[r * DP + c] = s < S ? base[s * stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse_in, const float* __restrict__ delta_in, int ls,
                     float* __restrict__ dq, int Sq, int Sk, int H, int KV, float scale,
                     float scale_log2, int causal) {
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
  const size_t stat_off = (static_cast<size_t>(b) * H + h) * ls;

  stage<D, DP>(Qs, q + q_off, q_stride, q0, BQ, Sq);
  stage<D, DP>(dOs, dout + q_off, q_stride, q0, BQ, Sq);
  float lse[4], delta[4];  // +inf for a row past Sq or with no valid key: its P is 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    lse[i] = s < Sq ? lse_in[stat_off + s] : INFINITY;
    delta[i] = s < Sq ? delta_in[stat_off + s] : 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO are staged)
    stage<D, DP>(Ks, k + kv_off, kv_stride, k0, BK, Sk);
    stage<D, DP>(Vs, v + kv_off, kv_stride, k0, BK, Sk);
    __syncthreads();
    float sc[4][NJ], dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[NJ], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * DP + d];
        gv[i] = dOs[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        kv[j] = Ks[(tx + 8 * j) * DP + d];
        vv[j] = Vs[(tx + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        const float p = ok ? exp2f(sc[i][j] * scale_log2 - lse[i]) : 0.f;
        dSs[(ty * 4 + i) * BKP + tx + 8 * j] = p * (dp[i][j] - delta[i]);
      }
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos < Sq) {
      float* drow = dq + q_off + qpos * q_stride;
#pragma unroll
      for (int c = 0; c < DC; ++c) drow[tx + 8 * c] = acc[i][c] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse_in, const float* __restrict__ delta_in, int ls,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      float scale, float scale_log2, int causal) {
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

  stage<D, DP>(Ks, k + kv_off, kv_stride, k0, BKV, Sk);
  stage<D, DP>(Vs, v + kv_off, kv_stride, k0, BKV, Sk);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int q_first = causal ? (k0 / BQ2) * BQ2 : 0;  // earlier q-blocks see none of these keys
  for (int r = 0; r < n_rep; ++r) {
    const int h = kvh * n_rep + r;
    const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t stat_off = (static_cast<size_t>(b) * H + h) * ls;
    for (int q0 = q_first; q0 < Sq; q0 += BQ2) {
      __syncthreads();  // the previous tile's readers are done (and K, V are staged)
      stage<D, DP>(Qs, q + q_off, q_stride, q0, BQ2, Sq);
      stage<D, DP>(dOs, dout + q_off, q_stride, q0, BQ2, Sq);
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
        dk[row + tx + 16 * c] = dka[i][c] * scale;
        dv[row + tx + 16 * c] = dva[i][c];
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, int ls, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                   int H, int KV, float scale, int causal, int device, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_floats<D>() * sizeof(float);
  constexpr size_t smem_dkv = dkv_smem_floats<D>() * sizeof(float);
  static rt::SmemOptIn optin_dq, optin_dkv;
  cudaError_t err = optin_dq.ensure(flash_bwd_dq_fma<D>, device, smem_dq);
  if (err != cudaSuccess) return err;
  if ((err = optin_dkv.ensure(flash_bwd_dkv_fma<D>, device, smem_dkv)) != cudaSuccess) return err;
  const float sl = scale * 1.4426950408889634f;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  flash_bwd_dq_fma<D><<<dim3((Sq + BQ - 1) / BQ, H, B), kThreads, smem_dq, stream>>>(
      qf, kf, vf, dof, lse, delta, ls, static_cast<float*>(dq), Sq, Sk, H, KV, scale, sl, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkv_fma<D><<<dim3((Sk + BKV - 1) / BKV, KV, B), kThreads, smem_dkv, stream>>>(
      qf, kf, vf, dof, lse, delta, ls, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H,
      KV, scale, sl, causal);
  return cudaGetLastError();
}

}  // namespace simt

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, int ls, void* dq, void* dk,
                         void* dv, int B, int Sq, int Sk, int H, int KV, float scale, int causal,
                         int device, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return simt::launch<D>(q, k, v, dout, lse, delta, ls, dq, dk, dv, B, Sq, Sk, H, KV, scale,
                             causal, device, s);
    case rt::kBF16:
      return sm90::launch<D>(q, k, v, dout, lse, delta, ls, dq, dk, dv, B, Sq, Sk, H, KV, scale,
                             causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// softmax_scale is the plain scale (1/sqrt(D) by default).  lse: the
// forward's f32 (B, H, ls) log-sum-exp; delta: an f32 scratch of the same
// shape, which the first launch fills.  ls >= Sq, and for bf16 a multiple of
// 128 (the dK/dV pass reads lse and delta a whole q-tile at a time).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* delta, int ls,
                                          int B, int Sq, int Sk, int H, int KV, int D,
                                          float softmax_scale, int causal, int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (Sq == 0 || Sk == 0 || KV == 0 || H % KV != 0 || ls < Sq) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const int n_rows = B * H * ls;
  switch (dtype) {
    case rt::kF32:
      flash_bwd_delta<float><<<(n_rows + 7) / 8, 256, 0, s>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout), df, Sq, H, D, ls, n_rows);
      break;
    case rt::kBF16:
      flash_bwd_delta<__nv_bfloat16><<<(n_rows + 7) / 8, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), df, Sq, H,
          D, ls, n_rows);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  switch (D) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 80:
      return launch_dtype<80>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 96:
      return launch_dtype<96>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, device, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                               softmax_scale, causal, device, s);
    case 192:
      return launch_dtype<192>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                               softmax_scale, causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
