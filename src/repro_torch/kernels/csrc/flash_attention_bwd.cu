// Blocked exact attention, backward, for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(scale * Q K^T) V, GQA, causal or not.
//
// A port-only kernel: the TPU side has no backward kernel (the JAX package
// differentiates its plain chunked_attention, src/repro/models/layers.py:118),
// but the port's model calls the forward kernel (csrc/flash_attention.cu),
// so its gradient needs one too.  Layouts as the forward: q, o, do, dq
// (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D); query head h reads KV head
// h / (H / KV); causal keeps k_pos <= q_offset + q_pos, where q_offset >= 0
// is the global position of q's row 0 (0 for a whole sequence; a sequence
// shard's start beside the whole k and v, as the forward takes it).  Keys
// from q_offset + Sq on are seen by no query: their dK and dV are written as
// zeros.  With P = softmax(S), S = scale * Q K^T:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// P is rebuilt tile by tile as exp2(S * scale * log2(e) - lse) from the
// log-sum-exp that the forward kept (lse, f32 (B, H, ls), log2 domain).
//
// Bound on the H100: operations, 2.5x the forward's (5 products of 2 D per
// query-key pair), half of them masked when causal.  Three launches (two in
// f32), no atomics anywhere, so two runs give the same bits (the train loop's resume
// is checked bit for bit):
//
// * flash_bwd_delta (both dtypes): delta = rowsum(dO * O) into an f32 (B, H,
//   ls) scratch, one warp per row; rows Sq..ls-1 get 0.
// * bf16, flash_bwd_dkv_sm90: one CTA of two consumer warpgroups per
//   (128-row key block, KV head, sequence), each warpgroup owning 64 key
//   rows.  Thread 0 loads the K and V block once and keeps a 2-stage TMA
//   ring of (Q tile, dO tile, lse slice, delta slice) on mbarriers over the
//   n_rep query heads of the group and the q-tiles that can see the keys
//   (when causal, from the first whose last row reaches the block at the
//   offset on).  Per tile: S^T = K Q^T and dP^T =
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
// * f32, flash_bwd_fma: f32 FMAs only (f32 must hold 3e-5, which rules out
//   TF32 and the bf16 tensor cores), both passes as the CTAs of one launch
//   (256 threads), the heavier kind first so that a short grid such as
//   whisper's 160 dQ CTAs fills the card: dQ CTAs per (64-row q-block, head,
//   sequence) over K/V tiles and dK/dV CTAs per (64-key block, KV head,
//   sequence) over the group's Q/dO tiles, 64 rows each (128 at D <= 64, 32
//   for Q/dO at D = 192).  Warps 0-3 compute S (or S^T) while warps 4-7
//   compute dP (or dP^T) beside them; P and dS meet in shared memory; dQ
//   runs on all 8 warps, dK on warps 0-3 beside dV on warps 4-7.  Every
//   product is register-tiled (8 x 8 outputs a thread for dK and dV at D =
//   128, 4 x 8 for S, dP and dQ) from rows padded by 4 floats, read as
//   float4 with the reduction index innermost (S, dP) or outermost (dQ, dK,
//   dV), free of bank conflicts (the blocks in simt.cuh, shared with the
//   forward's flash_fwd_fma); D = 80 runs 96 wide on zero columns.  The
//   streamed tiles ride a cp.async ring, 2 stages where shared memory
//   allows; no float atomics.
//
// Head dims 16, 32, 64, 80, 96, 128 and 192 are instantiated; the wrapper
// zero-pads D = 24 to 32, as the forward's does.
#include <initializer_list>

#include "simt.cuh"

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
                       int Sk, int H, int KV, float scale, float scale_log2, int causal,
                       int q_offset) {
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
  // earlier q-tiles see none of these keys (the offset need not be a multiple of BQ)
  const int qt0 = causal && k0 > q_offset ? (k0 - q_offset) / BQ : 0;
  const int nqt = max((Sq + BQ - 1) / BQ - qt0, 0);
  // (query head, q-tile) pairs, head-major; none for keys past every query,
  // whose zero accumulators the epilogue still stores
  const int n_tiles = n_rep * nqt;

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
    if (!causal || q_offset + q0 + BQ - 1 >= wg_k0) {  // warpgroup-uniform: some query sees some key
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
      const bool masked = (causal && q_offset + q0 < wg_k0 + 63) || q0 + BQ > Sq || wg_k0 + 64 > Sk;
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
            if (masked && (qpos >= Sq || kpos >= Sk || (causal && kpos > q_offset + qpos))) p = 0.f;
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
                      float scale_log2, int causal, int q_offset) {
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
  const int wg_pos0 = q_offset + wg_row0;  // its global position, which the causal mask reads
  const int kv_end = causal ? min(Sk, q_offset + q0 + BQD) : Sk;
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
    if (!causal || k0 <= wg_pos0 + 63) {  // warpgroup-uniform
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
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_pos0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wg_pos0 + r_lo + 8 * i;  // global
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
                   int H, int KV, float scale, int causal, int q_offset, int device,
                   cudaStream_t stream) {
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
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, KV, scale, sl, causal, q_offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dQ pass: Q, dO in 128-row blocks; K, V in 64-row tiles
  if ((err = hp::make_map<D>(&tq, q, B, Sq, H, BQD)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tdo, dout, B, Sq, H, BQD)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tk, k, B, Sk, KV, BK)) != cudaSuccess) return err;
  if ((err = hp::make_map<D>(&tv, v, B, Sk, KV, BK)) != cudaSuccess) return err;
  flash_bwd_dq_sm90<D><<<dim3(H, (Sq + BQD - 1) / BQD, B), kThreads, DqLayout<D>::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, ls, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, KV, scale, sl,
      causal, q_offset);
  return cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// f32: register-tiled FMA products on a cp.async ring
// ---------------------------------------------------------------------------
namespace simt {

// Rows [row0, row0 + 64) of a D-wide product's accumulator (grid RG x CG, as
// mma_nn lays it out) times `mul` into a (rows, stride) f32 array; rows past
// `rows` and columns past D are not written.
template <int D, int TM, int TF, int RG, int CG>
__device__ __forceinline__ void store_acc(const float (&c)[TM][4 * TF], float mul, float* out,
                                          size_t stride, int row0, int rows, int2 p) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + p.x + RG * i;
    if (r >= rows) continue;
#pragma unroll
    for (int f = 0; f < TF; ++f) {
      const int col = 4 * (p.y + CG * f);
      if (col < D)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * stride + col) =
            make_float4(c[i][4 * f] * mul, c[i][4 * f + 1] * mul, c[i][4 * f + 2] * mul,
                        c[i][4 * f + 3] * mul);
    }
  }
}

// S and dP (dQ CTA), S^T and dP^T (dK/dV CTA): 64 rows x BC columns on 128
// threads (warps 0-3 one product, warps 4-7 the other), TM x TN a thread.
template <int BC>
struct SGrid {
  static constexpr int TM = BC == 128 ? 8 : 4;
  static constexpr int RG = 64 / TM, CG = 128 / RG, TN = BC / CG;
};

template <int D>
struct Fma {
  static constexpr int DC = D == 80 ? 96 : D;  // the products' width (D = 80 as 96, zeros)
  static constexpr int LD = DC + 4;            // shared row stride: rows 4 banks apart
  static constexpr int BQ = 64;                // dQ CTA: query rows
  static constexpr int BK = D <= 64 ? 128 : 64;  // dQ CTA: keys per K/V tile
  static constexpr int BKV = 64;               // dK/dV CTA: keys
  // dK/dV CTA: query rows per Q/dO tile
  static constexpr int BQ2 = D <= 64 ? 128 : D > 128 ? 32 : 64;
  static constexpr int LDS_ = BK + 4;          // P and dS rows (dQ CTA)
  static constexpr int LDP = BQ2 + 4;          // P^T and dS^T rows (dK/dV CTA)
  static constexpr int kBudget = 227 * 1024;
  static constexpr int dq_floats(int ns) { return 2 * BQ * LD + 2 * ns * BK * LD + BQ * LDS_; }
  static constexpr int dkv_floats(int ns) {
    return 2 * BKV * LD + 2 * ns * BQ2 * LD + 2 * BKV * LDP + 2 * ns * BQ2;
  }
  static constexpr int NS_DQ = dq_floats(2) * 4 <= kBudget ? 2 : 1;    // K/V ring depth
  static constexpr int NS_DKV = dkv_floats(2) * 4 <= kBudget ? 2 : 1;  // Q/dO ring depth
  static constexpr int SMEM =
      4 * (dq_floats(NS_DQ) > dkv_floats(NS_DKV) ? dq_floats(NS_DQ) : dkv_floats(NS_DKV));
  static_assert(dq_floats(1) * 4 <= kBudget && dkv_floats(1) * 4 <= kBudget, "shared memory");
  using Q = Wide<DC, kThreads>;      // dQ: all 256 threads
  using KV = Wide<DC, kThreads / 2>;  // dK (warps 0-3) and dV (warps 4-7) side by side
  using SQ = SGrid<BK>;               // S and dP
  using SKV = SGrid<BQ2>;             // S^T and dP^T
};

// One tile of a ring: the whole CTA waits for it.  Tile j is in slot j % NS;
// tile j + NS - 1 is loaded (`load`) once every thread is past tile j - 1.
template <int NS, typename Load>
__device__ __forceinline__ void ring_next(int j, Load load) {
  __syncthreads();  // every thread is past tile j - 1: its slot is free
  load(j + NS - 1);
  cp_async_commit();
  cp_async_wait<NS - 1>();
  __syncthreads();  // tile j is in
}

// dQ of one (64-row q-block, head, sequence): Q and dO staged once, K and V
// tiles of BK keys on a ring of NS_DQ stages; the causal kv loop stops at
// the diagonal.  Per tile: S = Q K^T on warps 0-3 and dP = dO V^T on warps
// 4-7 side by side, P into shared memory, dS = P (dP - delta) over it, then
// dQ += dS K on all warps.
template <int D>
__device__ __forceinline__ void dq_block(const float* q, const float* k, const float* v,
                                         const float* dout, const float* lse, const float* delta,
                                         int ls, float* dq, int B, int Sq, int Sk, int H, int KV,
                                         float scale, float scale_log2, int causal, int q_offset,
                                         int idx, float* smem) {
  using C = Fma<D>;
  using W = typename C::Q;
  using G = typename C::SQ;
  constexpr int LD = C::LD, BQ = C::BQ, BK = C::BK, NS = C::NS_DQ;
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;  // stage s: K at Ks + 2 s BK LD, V right after it
  float* Ps = Ks + 2 * NS * BK * LD;

  const int b = idx % B;
  idx /= B;
  const int h = idx % H;
  const int qb = (Sq + BQ - 1) / BQ - 1 - idx / H;  // long causal rows first
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const int kv_end = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  zero_pad<D, C::DC, LD>(Qs, 2 * BQ + 2 * NS * BK);  // Q, dO and the K, V stages
  load_rows<BQ, D, LD>(Qs, q + q_off, q_stride, q0, Sq);
  load_rows<BQ, D, LD>(dOs, dout + q_off, q_stride, q0, Sq);
  cp_async_commit();
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      float* st = Ks + 2 * (j % NS) * BK * LD;
      load_rows<BK, D, LD>(st, k + kv_off, kv_stride, j * BK, Sk);
      load_rows<BK, D, LD>(st + BK * LD, v + kv_off, kv_stride, j * BK, Sk);
    }
  };
  for (int t = 0; t + 1 < NS; ++t) {
    load_kv(t);
    cp_async_commit();
  }

  const bool s_warps = threadIdx.x < kThreads / 2;  // S (and P) here, dP (and dS) on the rest
  // S, dP: rows ps.x + RG i, keys ps.y + CG j
  const int2 ps = grid_pos<G::RG, G::CG, kThreads / 2>(threadIdx.x % (kThreads / 2));
  const int2 po = grid_pos<W::RG, W::CG, kThreads>(threadIdx.x);
  float stat[G::TM];  // S warps: each row's lse (+inf past Sq: P = 0); dP warps: its delta
  const size_t st = (static_cast<size_t>(b) * H + h) * ls;
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int qpos = q0 + ps.x + G::RG * i;
    stat[i] = qpos >= Sq ? (s_warps ? INFINITY : 0.f) : (s_warps ? lse : delta)[st + qpos];
  }
  float acc[W::TM][4 * W::TF];
#pragma unroll
  for (int i = 0; i < W::TM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * W::TF; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    ring_next<NS>(j, load_kv);
    const float* Kt = Ks + 2 * (j % NS) * BK * LD;
    float sp[G::TM][G::TN];  // S (warps 0-3) or dP (warps 4-7)
#pragma unroll
    for (int i = 0; i < G::TM; ++i)
#pragma unroll
      for (int c = 0; c < G::TN; ++c) sp[i][c] = 0.f;
    if (s_warps) {
      mma_nt<G::TM, G::TN, G::RG, G::CG, C::DC, LD, LD>(sp, Qs, Kt, ps);
      const int k0 = j * BK;
#pragma unroll
      for (int i = 0; i < G::TM; ++i) {
        const int qpos = q0 + ps.x + G::RG * i;
#pragma unroll
        for (int c = 0; c < G::TN; ++c) {
          const int kpos = k0 + ps.y + G::CG * c;
          const bool ok = kpos < Sk && (!causal || kpos <= q_offset + qpos);
          Ps[(ps.x + G::RG * i) * C::LDS_ + ps.y + G::CG * c] =
              ok ? exp2f(sp[i][c] * scale_log2 - stat[i]) : 0.f;
        }
      }
    } else {
      mma_nt<G::TM, G::TN, G::RG, G::CG, C::DC, LD, LD>(sp, dOs, Kt + BK * LD, ps);
    }
    __syncthreads();  // P is written
    if (!s_warps) {
#pragma unroll
      for (int i = 0; i < G::TM; ++i)
#pragma unroll
        for (int c = 0; c < G::TN; ++c) {
          float* x = Ps + (ps.x + G::RG * i) * C::LDS_ + ps.y + G::CG * c;
          *x = *x * (sp[i][c] - stat[i]);  // dS over P
        }
    }
    __syncthreads();  // dS is written
    mma_nn<W::TM, W::TF, W::RG, W::CG, BK, C::LDS_, LD>(acc, Ps, Kt, po);
  }
  cp_async_wait<0>();
  store_acc<D, W::TM, W::TF, W::RG, W::CG>(acc, scale, dq + q_off, q_stride, q0, Sq, po);
}

// dK and dV of one (64-key block, KV head, sequence): K and V staged once,
// the group's (query head, q-tile) pairs streamed head-major through a ring
// of NS_DKV stages of Q and dO with their lse and delta slices, from the
// causal diagonal on.  Per tile: S^T = K Q^T on warps 0-3 and dP^T = V dO^T
// on warps 4-7 side by side, P^T into shared memory, dS^T = P^T (dP^T -
// delta) beside it, then dK += dS^T Q on warps 0-3 and dV += P^T dO on
// warps 4-7 side by side; the GQA sum stays in registers in a fixed order.
template <int D>
__device__ __forceinline__ void dkv_block(const float* q, const float* k, const float* v,
                                          const float* dout, const float* lse, const float* delta,
                                          int ls, float* dk, float* dv, int B, int Sq, int Sk, int H,
                                          int KV, float scale, float scale_log2, int causal,
                                          int q_offset, int idx, float* smem) {
  using C = Fma<D>;
  using W = typename C::KV;
  using G = typename C::SKV;
  constexpr int LD = C::LD, BKV = C::BKV, BQ2 = C::BQ2, LDP = C::LDP, NS = C::NS_DKV;
  float* Ks = smem;
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;  // stage s: Q at Qs + 2 s BQ2 LD, dO right after it
  float* Ps = Qs + 2 * NS * BQ2 * LD;
  float* dSs = Ps + BKV * LDP;
  float* Ls = dSs + BKV * LDP;  // stage s: lse at Ls + 2 s BQ2, delta right after it

  const int b = idx % B;
  idx /= B;
  const int kvh = idx % KV;
  const int k0 = (idx / KV) * BKV;  // the first key blocks see the most queries
  const int n_rep = H / KV;
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  // earlier q-tiles see none of these keys; keys past every query get no
  // tile and store their zero accumulators
  const int qt0 = causal && k0 > q_offset ? (k0 - q_offset) / BQ2 : 0;
  const int nqt = max((Sq + BQ2 - 1) / BQ2 - qt0, 0);
  const int n_tiles = n_rep * nqt;

  zero_pad<D, C::DC, LD>(Ks, 2 * BKV + 2 * NS * BQ2);
  load_rows<BKV, D, LD>(Ks, k + kv_off, kv_stride, k0, Sk);
  load_rows<BKV, D, LD>(Vs, v + kv_off, kv_stride, k0, Sk);
  cp_async_commit();
  auto head = [&](int j) { return kvh * n_rep + j / nqt; };
  auto q_start = [&](int j) { return (qt0 + j % nqt) * BQ2; };
  auto load_q = [&](int j) {  // Q and dO of tile j with its lse and delta slices (q0 + BQ2 <= ls)
    if (j < n_tiles) {
      const int s = j % NS, q0 = q_start(j);
      const size_t q_off = (static_cast<size_t>(b) * Sq * H + head(j)) * D;
      load_rows<BQ2, D, LD>(Qs + 2 * s * BQ2 * LD, q + q_off, q_stride, q0, Sq);
      load_rows<BQ2, D, LD>(Qs + (2 * s + 1) * BQ2 * LD, dout + q_off, q_stride, q0, Sq);
      const size_t st = (static_cast<size_t>(b) * H + head(j)) * ls + q0;
      for (int c = threadIdx.x; c < BQ2 / 2; c += kThreads) {
        const int x = c % (BQ2 / 4);
        cp_async16(Ls + (2 * s + (c < BQ2 / 4 ? 0 : 1)) * BQ2 + 4 * x,
                   (c < BQ2 / 4 ? lse : delta) + st + 4 * x, true);
      }
    }
  };
  for (int t = 0; t + 1 < NS; ++t) {
    load_q(t);
    cp_async_commit();
  }

  const bool s_warps = threadIdx.x < kThreads / 2;  // S^T, P^T and dK here; dP^T, dS^T and dV on the rest
  const int half = threadIdx.x % (kThreads / 2);
  const int2 ps = grid_pos<G::RG, G::CG, kThreads / 2>(half);  // keys ps.x + RG i, queries ps.y + CG j
  const int2 po = grid_pos<W::RG, W::CG, kThreads / 2>(half);
  float acc[W::TM][4 * W::TF];  // dK (warps 0-3) or dV (warps 4-7)
#pragma unroll
  for (int i = 0; i < W::TM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * W::TF; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    ring_next<NS>(j, load_q);
    const int s = j % NS, q0 = q_start(j);
    const float* Qt = Qs + 2 * s * BQ2 * LD;
    const float* dOt = Qt + BQ2 * LD;
    const float* Lt = Ls + 2 * s * BQ2;
    const float* Dt = Lt + BQ2;
    float sp[G::TM][G::TN];  // S^T (warps 0-3) or dP^T (warps 4-7)
#pragma unroll
    for (int i = 0; i < G::TM; ++i)
#pragma unroll
      for (int c = 0; c < G::TN; ++c) sp[i][c] = 0.f;
    if (s_warps) {
      mma_nt<G::TM, G::TN, G::RG, G::CG, C::DC, LD, LD>(sp, Ks, Qt, ps);
#pragma unroll
      for (int i = 0; i < G::TM; ++i) {
        const int kpos = k0 + ps.x + G::RG * i;
#pragma unroll
        for (int c = 0; c < G::TN; ++c) {
          const int qc = ps.y + G::CG * c, qpos = q0 + qc;
          const bool ok = kpos < Sk && qpos < Sq && (!causal || kpos <= q_offset + qpos);
          Ps[(ps.x + G::RG * i) * LDP + qc] = ok ? exp2f(sp[i][c] * scale_log2 - Lt[qc]) : 0.f;
        }
      }
    } else {
      mma_nt<G::TM, G::TN, G::RG, G::CG, C::DC, LD, LD>(sp, Vs, dOt, ps);
    }
    __syncthreads();  // P^T is written
    if (!s_warps) {
#pragma unroll
      for (int i = 0; i < G::TM; ++i)
#pragma unroll
        for (int c = 0; c < G::TN; ++c) {
          const int at = (ps.x + G::RG * i) * LDP + ps.y + G::CG * c;
          dSs[at] = Ps[at] * (sp[i][c] - Dt[ps.y + G::CG * c]);
        }
    }
    __syncthreads();  // dS^T is written
    if (s_warps)
      mma_nn<W::TM, W::TF, W::RG, W::CG, BQ2, LDP, LD>(acc, dSs, Qt, po);
    else
      mma_nn<W::TM, W::TF, W::RG, W::CG, BQ2, LDP, LD>(acc, Ps, dOt, po);
  }
  cp_async_wait<0>();
  if (s_warps)
    store_acc<D, W::TM, W::TF, W::RG, W::CG>(acc, scale, dk + kv_off, kv_stride, k0, Sk, po);
  else
    store_acc<D, W::TM, W::TF, W::RG, W::CG>(acc, 1.f, dv + kv_off, kv_stride, k0, Sk, po);
}

// One launch holds both passes' CTAs, the heavier kind first (n_dq dQ CTAs
// and gridDim.x - n_dq dK/dV CTAs): whisper's cross-attention has 160 dQ
// CTAs, which on their own would leave a second wave on 132 SMs.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta, int ls,
                  float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int B,
                  int Sq, int Sk, int H, int KV, float scale, float scale_log2, int causal,
                  int q_offset, int n_dq, int dq_first) {
  extern __shared__ float4 smem_v4[];
  float* smem = reinterpret_cast<float*>(smem_v4);
  const int n_dkv = gridDim.x - n_dq;
  const int idx = blockIdx.x;
  if (dq_first ? idx < n_dq : idx >= n_dkv)
    dq_block<D>(q, k, v, dout, lse, delta, ls, dq, B, Sq, Sk, H, KV, scale, scale_log2, causal,
                q_offset, dq_first ? idx : idx - n_dkv, smem);
  else
    dkv_block<D>(q, k, v, dout, lse, delta, ls, dk, dv, B, Sq, Sk, H, KV, scale, scale_log2, causal,
                 q_offset, dq_first ? idx - n_dq : idx, smem);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, int ls, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                   int H, int KV, float scale, int causal, int q_offset, int device,
                   cudaStream_t stream) {
  using C = Fma<D>;
  static rt::SmemOptIn optin;
  cudaError_t err = optin.ensure(flash_bwd_fma<D>, device, C::SMEM);
  if (err != cudaSuccess) return err;
  for (const void* p : {q, k, v, dout, static_cast<const void*>(dq), static_cast<const void*>(dk),
                        static_cast<const void*>(dv), static_cast<const void*>(lse),
                        static_cast<const void*>(delta)})
    if (!rt::aligned16(p)) return cudaErrorMisalignedAddress;
  if (ls % C::BQ2 != 0) return cudaErrorInvalidValue;  // the ring's lse/delta slices stay in the row
  const long long n_dq = static_cast<long long>((Sq + C::BQ - 1) / C::BQ) * H * B;
  const long long n_dkv = static_cast<long long>((Sk + C::BKV - 1) / C::BKV) * KV * B;
  if (n_dq + n_dkv > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // the heavier CTA kind first: a dQ CTA does 3 products over its keys, a
  // dK/dV CTA 4 over the group's queries; a causal dQ CTA sees at most the
  // keys up to its last row's global position
  const long long seen = static_cast<long long>(q_offset) + Sq;
  const long long kv_max = causal && seen < Sk ? seen : Sk;
  const int dq_first = 3 * kv_max >= 4LL * (H / KV) * Sq;
  flash_bwd_fma<D><<<static_cast<unsigned>(n_dq + n_dkv), kThreads, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, ls, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), B, Sq, Sk, H, KV, scale,
      scale * 1.4426950408889634f, causal, q_offset, static_cast<int>(n_dq), dq_first);
  return cudaGetLastError();
}

}  // namespace simt

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, int ls, void* dq, void* dk,
                         void* dv, int B, int Sq, int Sk, int H, int KV, float scale, int causal,
                         int q_offset, int device, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return simt::launch<D>(q, k, v, dout, lse, delta, ls, dq, dk, dv, B, Sq, Sk, H, KV, scale,
                             causal, q_offset, device, s);
    case rt::kBF16:
      return sm90::launch<D>(q, k, v, dout, lse, delta, ls, dq, dk, dv, B, Sq, Sk, H, KV, scale,
                             causal, q_offset, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The dynamic shared memory of a CTA of the f32 kernel at head dim D (the
// build report logs it beside ptxas's registers), or -1.
extern "C" int flash_attention_bwd_f32_smem(int D) {
  switch (D) {
    case 16: return simt::Fma<16>::SMEM;
    case 32: return simt::Fma<32>::SMEM;
    case 64: return simt::Fma<64>::SMEM;
    case 80: return simt::Fma<80>::SMEM;
    case 96: return simt::Fma<96>::SMEM;
    case 128: return simt::Fma<128>::SMEM;
    case 192: return simt::Fma<192>::SMEM;
    default: return -1;
  }
}

// softmax_scale is the plain scale (1/sqrt(D) by default).  q_offset: the
// global position of q's row 0 (>= 0), which the causal mask reads; the
// forward's must be the same.  lse: the forward's f32 (B, H, ls)
// log-sum-exp; delta: an f32 scratch of the same shape, which the first
// launch fills.  ls >= Sq, and for bf16 a multiple of 128 (the dK/dV pass
// reads lse and delta a whole q-tile at a time).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* delta, int ls,
                                          int B, int Sq, int Sk, int H, int KV, int D,
                                          float softmax_scale, int causal, int q_offset, int dtype,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (Sq == 0 || Sk == 0 || KV == 0 || H % KV != 0 || ls < Sq || q_offset < 0)
    return cudaErrorInvalidValue;
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
                              softmax_scale, causal, q_offset, device, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, q_offset, device, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, q_offset, device, s);
    case 80:
      return launch_dtype<80>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, q_offset, device, s);
    case 96:
      return launch_dtype<96>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                              softmax_scale, causal, q_offset, device, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                               softmax_scale, causal, q_offset, device, s);
    case 192:
      return launch_dtype<192>(dtype, q, k, v, dout, lf, df, ls, dq, dk, dv, B, Sq, Sk, H, KV,
                               softmax_scale, causal, q_offset, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
