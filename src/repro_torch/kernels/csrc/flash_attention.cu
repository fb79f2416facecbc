// Blocked exact attention (GQA, optional causal mask) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel
// / flash_attention).  q (B, Sq, H, D), k/v (B, Sk, KV, D); query head h reads
// KV head h / (H/KV); causal keeps k_pos <= q_offset + q_pos, where
// q_offset >= 0 is the global position of q's row 0 (0 for a whole
// sequence; a sequence shard's start where q is one, as sequence-parallel
// prefill keeps it beside the whole k and v; a non-causal call ignores it);
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
//   divides a 160-byte row.  The kv loop stops at the causal diagonal
//   (key q_offset + q0 + BQ - 1 for the q-block at row q0),
//   a warpgroup skips the tiles wholly above its own rows, and only tiles
//   that cross the diagonal or the Sk tail are masked (TMA zero-fills rows
//   past Sk, and a zero key scores 0, so k_pos >= Sk is masked explicitly).
//   q-blocks run heaviest first (a q-block's cost grows with q_offset + q0,
//   so the order is the same for any offset).  The output is staged through shared
//   memory and stored in 16-byte rows; the Sq tail is masked at the store.
//   P is rounded to bf16 before the PV product (the TPU kernel keeps it in
//   f32).
// * f32: flash_fwd_fma.  f32 inputs must match the reference at 3e-5, which
//   rules out TF32 and the tensor cores, so both products are f32 FMAs: the
//   bound is the FMA units' 67 TFLOP/s (olmoe's causal 1 x 512 x 16 x 128:
//   16 us), and the products must be fed from registers, not from shared
//   memory at a load per FMA.  Design (simt.cuh's blocks, shared with the
//   f32 backward): 256 threads per (q-block, head, sequence), one launch
//   whose CTAs run the heaviest causal q-blocks first; the q-block is 64
//   rows, or 32 where 64 would give the card fewer CTAs than SMs
//   (flash_attention.fwd_plan, from the shape alone).  Q is staged once; K
//   and V tiles (64 keys, 32 at D = 192) ride a cp.async ring of 2-3
//   stages, a slot refilled as soon as every thread is past its tile, so
//   the next tiles arrive while this one is computed; two CTAs share an SM
//   at D <= 64, one at D >= 80.  S = Q K^T and O += P V are register-tiled (a
//   thread holds TM x TN scores and TM x 4 TF outputs) from float4 loads of
//   rows padded by 4 floats, each warp an 8 x 4 block of the thread grid:
//   the reduction index is innermost for S and outermost for PV, so no tile
//   is transposed and no load conflicts.  A row's max comes from its 16
//   column threads (shuffles over 4 lanes, then 4 warps through shared
//   memory); P goes to shared memory once a tile with each row's correction
//   of the running output; each row's sum stays split over the 16 threads
//   until the epilogue adds them in a fixed order.  Three barriers a tile,
//   no atomics: two runs give equal bits, whatever the q-block height.
//   D = 16 and 80 run 32 and 96 wide on zero columns.

// Both kernels can also write each row's log-sum-exp (the training path asks
// for it, serving never does): with `lse` non-null the epilogue stores
// m + log2(l) of the row's running max m and sum l, in the log2 domain of
// the scaled scores (+inf for a row with no valid key), into an f32 (B, H,
// ls) array, rows < Sq; the backward (flash_attention_bwd.cu) reads it
// instead of recomputing it.  With `lse` null nothing else changes.
//
// Head dims 16, 32, 64, 80, 96, 128 and 192 are instantiated; the wrapper
// zero-pads D = 24 to 32.
#include <initializer_list>

#include "simt.cuh"

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
                   int causal, int q_offset) {
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
  const int wg_pos0 = q_offset + wg_row0;  // its global position, which the causal mask reads
  const int kv_end = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
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
    if (!causal || k0 <= wg_pos0 + 63) {  // warpgroup-uniform
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

      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_pos0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wg_pos0 + r_lo + 8 * i;
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
                   int B, int Sq, int Sk, int H, int KV, float scale_log2, int causal, int q_offset,
                   int device, cudaStream_t stream) {
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, ls, Sq, Sk, H, KV, scale_log2, causal,
      q_offset);
  return cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// f32: register-tiled FMA products on a cp.async ring
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kSmemSM = 228 * 1024;  // an H100 SM's shared memory (1 KB of it reserved per CTA)

// The tiles of one CTA at head dim D and q-block height BQ (64 rows, or 32
// where 64 would give the card fewer CTAs than SMs: flash_attention.fwd_plan).
// Keys come in BK-row K/V tiles (64, or 32 at D = 192) on a ring of NS
// stages, as deep as leaves two CTAs an SM (1 KB each reserved), else as
// deep as fits one (D >= 80 holds one CTA an SM: 64-key tiles measured
// faster there than two CTAs on 32-key tiles).  The layout, in floats: [Q |
// K, V x NS | P | partial row maxima and sums | a value per row].  fwd_plan
// in flash_attention.py mirrors these numbers.
template <int D, int BQ>
struct Fwd {
  static constexpr int DC = D == 80 ? 96 : D == 16 ? 32 : D;  // the products' width (zero columns)
  static constexpr int LD = DC + 4;                            // shared row stride: rows 4 banks apart
  static constexpr int BK = DC <= 128 ? 64 : 32;               // keys per K/V tile
  static constexpr int LDP = BK + 4;                           // P's rows
  static constexpr int floats(int ns) { return BQ * LD + 2 * ns * BK * LD + BQ * LDP + 5 * BQ; }
  static constexpr bool two_an_sm(int ns) { return 2 * (4 * floats(ns) + 1024) <= kSmemSM; }
  static constexpr int NS =
      two_an_sm(3) ? 3 : two_an_sm(2) ? 2 : 4 * floats(3) <= 227 * 1024 ? 3 : 2;
  static constexpr int SMEM = 4 * floats(NS);
  static constexpr int kMinBlocks = two_an_sm(NS) ? 2 : 1;
  static_assert(SMEM <= 227 * 1024, "shared memory");
  // the k loops' unroll: 2, but 1 for S at D = 192 (measured faster there)
  static constexpr int U_S = D == 192 ? 1 : 2;
  // S = Q K^T: BQ x BK on all 256 threads, 16 x 16 of them, TM x TN a thread;
  // a row's 16 column threads are 4 lanes in each of 4 warps
  static constexpr int TM = BQ / 16, TN = BK / 16;
  using O = Wide<DC, kThreads, BQ>;  // O += P V: BQ x DC
};

// One (BQ-row q-block, head, sequence): Q staged once, K and V tiles on the
// ring, refilled as soon as every thread is past the tile that held the
// slot; the causal kv loop stops at the diagonal, and only the tiles that
// cross it or the Sk tail are masked.  Per tile: S = Q K^T, each row's max
// (4 lanes by shuffles, then 4 warps through shared memory), P = exp2(S sl -
// m) into shared memory with each row's correction of the running output,
// then O = O corr + P V.  Each row's sum stays split over its 16 column
// threads until the epilogue adds the 16 in a fixed order: no atomics, and
// the bits do not depend on BQ.  The CTAs run heaviest causal q-block first.
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, Fwd<D, BQ>::kMinBlocks)
    flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int ls, int B, int Sq, int Sk, int H, int KV, float scale_log2, int causal,
                  int q_offset) {
  using C = Fwd<D, BQ>;
  using W = typename C::O;
  constexpr int LD = C::LD, BK = C::BK, NS = C::NS, LDP = C::LDP, TM = C::TM, TN = C::TN;
  extern __shared__ float4 smem_v4[];
  float* Qs = reinterpret_cast<float*>(smem_v4);
  float* Ks = Qs + BQ * LD;  // stage s: K at Ks + 2 s BK LD, V right after it
  float* Ps = Ks + 2 * NS * BK * LD;
  float* red = Ps + BQ * LDP;  // BQ x 4: each row's partial maxima (then sums) by warp column
  float* rowv = red + 4 * BQ;  // BQ: each row's correction this tile (then its sum)

  int idx = blockIdx.x;
  const int b = idx % B;
  idx /= B;
  const int h = idx % H;
  const int qb = (Sq + BQ - 1) / BQ - 1 - idx / H;  // long causal rows first
  const int kvh = h / (H / KV);
  const int q0 = qb * BQ;
  const int pos0 = q_offset + q0;  // the global position of row q0, which the causal mask reads
  const size_t q_stride = static_cast<size_t>(H) * D, kv_stride = static_cast<size_t>(KV) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const int kv_end = causal ? min(Sk, pos0 + BQ) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  zero_pad<D, C::DC, LD>(Qs, BQ + 2 * NS * BK);  // Q and the K, V stages
  load_rows<BQ, D, LD>(Qs, q + q_off, q_stride, q0, Sq);
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      float* st = Ks + 2 * (j % NS) * BK * LD;
      load_rows<BK, D, LD>(st, k + kv_off, kv_stride, j * BK, Sk);
      load_rows<BK, D, LD>(st + BK * LD, v + kv_off, kv_stride, j * BK, Sk);
    }
  };
  load_kv(0);
  cp_async_commit();  // Q and tile 0
  for (int t = 1; t + 1 < NS; ++t) {
    load_kv(t);
    cp_async_commit();
  }

  // S: rows ps.x + 16 i, keys ps.y + 16 c; O: rows po.x + RG i
  const int2 ps = grid_pos<16, 16, kThreads>(threadIdx.x);
  const int2 po = grid_pos<W::RG, W::CG, kThreads>(threadIdx.x);
  const int wcol = (threadIdx.x / 32) % 4;  // this warp's column of the S grid
  const bool quad_head = threadIdx.x % 4 == 0;
  float m_run[TM], l_run[TM];  // each row's running max; this thread's share of its sum
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  float acc[W::TM][4 * W::TF];
#pragma unroll
  for (int i = 0; i < W::TM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * W::TF; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile j is in (and Q with tile 0)
    const float* Kt = Ks + 2 * (j % NS) * BK * LD;
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) s[i][c] = 0.f;
    mma_nt<TM, TN, 16, 16, C::DC, LD, LD, C::U_S>(s, Qs, Kt, ps);

    const int k0 = j * BK;
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > pos0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = pos0 + ps.x + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int kpos = k0 + ps.y + 16 * c;
        float x = s[i][c] * scale_log2;
        if (masked && (kpos >= Sk || (causal && kpos > qpos))) x = -INFINITY;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (quad_head) red[(ps.x + 16 * i) * 4 + wcol] = mx;
    }
    __syncthreads();  // the partial maxima are in; every thread is past tile j - 1
    load_kv(j + NS - 1);  // into tile j - 1's slot
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ps.x + 16 * i;
      const float4 r = *reinterpret_cast<const float4*>(red + row * 4);
      const float m_new = fmaxf(m_run[i], fmaxf(fmaxf(r.x, r.y), fmaxf(r.z, r.w)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing valid yet
      const float corr = exp2f(m_run[i] - m_use);
      m_run[i] = m_new;
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const float p = exp2f(s[i][c] - m_use);  // masked: exp2(-inf) = 0
        Ps[row * LDP + ps.y + 16 * c] = p;
        rsum += p;
      }
      l_run[i] = l_run[i] * corr + rsum;
      if (ps.y == 0) rowv[row] = corr;
    }
    __syncthreads();  // P and the corrections are in

#pragma unroll
    for (int i = 0; i < W::TM; ++i) {
      const float corr = rowv[po.x + W::RG * i];
#pragma unroll
      for (int c = 0; c < 4 * W::TF; ++c) acc[i][c] *= corr;
    }
    mma_nn<W::TM, W::TF, W::RG, W::CG, BK, LDP, LD>(acc, Ps, Kt + BK * LD, po);
  }
  cp_async_wait<0>();

  // Epilogue: each row's sum from its 16 column threads in a fixed order,
  // then O / max(l, 1e-30), and the log-sum-exp if asked for.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (quad_head) red[(ps.x + 16 * i) * 4 + wcol] = l;
  }
  __syncthreads();  // the partial sums are in; every thread is past the last P V
  if (ps.y == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ps.x + 16 * i, qpos = q0 + row;
      const float4 r = *reinterpret_cast<const float4*>(red + row * 4);
      const float l = (r.x + r.y) + (r.z + r.w);
      rowv[row] = fmaxf(l, 1e-30f);
      if (lse != nullptr && qpos < Sq)
        lse[(static_cast<size_t>(b) * H + h) * ls + qpos] = l > 0.f ? m_run[i] + log2f(l) : INFINITY;
    }
  }
  __syncthreads();
  float* obase = o + q_off;
#pragma unroll
  for (int i = 0; i < W::TM; ++i) {
    const int row = po.x + W::RG * i, qpos = q0 + row;
    if (qpos >= Sq) continue;
    const float denom = rowv[row];
#pragma unroll
    for (int f = 0; f < W::TF; ++f) {
      const int col = 4 * (po.y + W::CG * f);
      if (col < D)
        *reinterpret_cast<float4*>(obase + qpos * q_stride + col) =
            make_float4(acc[i][4 * f] / denom, acc[i][4 * f + 1] / denom,
                        acc[i][4 * f + 2] / denom, acc[i][4 * f + 3] / denom);
    }
  }
}

template <int D, int BQ>
cudaError_t launch_bq(const float* q, const float* k, const float* v, float* o, float* lse, int ls,
                      int B, int Sq, int Sk, int H, int KV, float scale_log2, int causal,
                      int q_offset, int device, cudaStream_t stream) {
  using C = Fwd<D, BQ>;
  static rt::SmemOptIn optin;
  const cudaError_t err = optin.ensure(flash_fwd_fma<D, BQ>, device, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>((Sq + BQ - 1) / BQ) * H * B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_fma<D, BQ><<<static_cast<unsigned>(ctas), kThreads, C::SMEM, stream>>>(
      q, k, v, o, lse, ls, B, Sq, Sk, H, KV, scale_log2, causal, q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int ls,
                   int B, int Sq, int Sk, int H, int KV, float scale_log2, int causal,
                   int q_offset, int block_q, int device, cudaStream_t stream) {
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (!rt::aligned16(p)) return cudaErrorMisalignedAddress;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  switch (block_q) {
    case 64:
      return launch_bq<D, 64>(qf, kf, vf, of, lse, ls, B, Sq, Sk, H, KV, scale_log2, causal,
                              q_offset, device, stream);
    case 32:
      return launch_bq<D, 32>(qf, kf, vf, of, lse, ls, B, Sq, Sk, H, KV, scale_log2, causal,
                              q_offset, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
int smem(int block_q) {
  return block_q == 64 ? Fwd<D, 64>::SMEM : block_q == 32 ? Fwd<D, 32>::SMEM : -1;
}

}  // namespace simt

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                         float* lse, int ls, int B, int Sq, int Sk, int H, int KV, float sl,
                         int causal, int qo, int block_q, int device, cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return simt::launch<D>(q, k, v, o, lse, ls, B, Sq, Sk, H, KV, sl, causal, qo, block_q, device,
                             s);
    case rt::kBF16:
      if (block_q != sm90::BQ) return cudaErrorInvalidValue;
      return sm90::launch<D>(q, k, v, o, lse, ls, B, Sq, Sk, H, KV, sl, causal, qo, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The dynamic shared memory of a CTA of the f32 kernel at head dim D and
// q-block height block_q (the build report logs it beside ptxas's registers
// and holds fwd_plan's figure to it), or -1.
extern "C" int flash_attention_f32_smem(int D, int block_q) {
  switch (D) {
    case 16: return simt::smem<16>(block_q);
    case 32: return simt::smem<32>(block_q);
    case 64: return simt::smem<64>(block_q);
    case 80: return simt::smem<80>(block_q);
    case 96: return simt::smem<96>(block_q);
    case 128: return simt::smem<128>(block_q);
    case 192: return simt::smem<192>(block_q);
    default: return -1;
  }
}

// softmax_scale is the plain scale (1/sqrt(D) by default); the kernels work in
// the log2 domain.  bf16 takes the wgmma kernel, f32 the FMA kernel.  lse:
// null, or an f32 (B, H, ls) array (ls >= Sq) for each row's log-sum-exp.
// block_q: the q-block height of flash_attention.fwd_plan (128 for bf16; 64
// or 32 for f32).  q_offset: the global position of q's row 0 (>= 0), which
// the causal mask reads.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int ls, int B, int Sq, int Sk, int H, int KV,
                                      int D, float softmax_scale, int causal, int q_offset,
                                      int dtype, int block_q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  if (Sk == 0 || KV == 0 || H % KV != 0 || (lse != nullptr && ls < Sq) || q_offset < 0)
    return cudaErrorInvalidValue;
  float* lf = static_cast<float*>(lse);
  const float sl = softmax_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, q_offset,
                              block_q, device, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, q_offset,
                              block_q, device, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, q_offset,
                              block_q, device, s);
    case 80:
      return launch_dtype<80>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, q_offset,
                              block_q, device, s);
    case 96:
      return launch_dtype<96>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, q_offset,
                              block_q, device, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, q_offset,
                              block_q, device, s);
    case 192:
      return launch_dtype<192>(dtype, q, k, v, o, lf, ls, B, Sq, Sk, H, KV, sl, causal, q_offset,
                              block_q, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
