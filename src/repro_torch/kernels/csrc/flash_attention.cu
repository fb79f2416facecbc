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
// kStages | barriers].  Each tile is NBOX boxes of (rows x SW bytes), one box
// per SW-byte column slice of the row, each swizzled by TMA in SW-byte mode.
// SW is the widest swizzle span that divides the row: a 192-byte row (D = 96)
// takes 64-byte mode, a 160-byte row (D = 80) 32-byte mode.  The wgmma descriptors' layout field follows SW, and a
// box's 8-row group is 8 * SW bytes, as the TMA swizzle lays it out.
template <int D>
struct Layout {
  static constexpr int SW = (D * 2) % 128 == 0 ? 128 : (D * 2) % 64 == 0 ? 64 : 32;  // bytes
  static_assert((D * 2) % SW == 0 && SW >= 32, "a row is whole swizzle spans");
  static constexpr int BOX = SW / 2;                     // bf16 columns per box
  static constexpr int NBOX = D / BOX;
  static constexpr hp::Swizzle kSw = SW == 128 ? hp::kSw128 : SW == 64 ? hp::kSw64 : hp::kSw32;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(2 * 64 * D * 2 <= kStages * KV_BYTES, "the O staging reuses the K ring");
};

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) hp::wgmma_rs_m64n16k16_tb(d, a, b);
  if constexpr (N == 32) hp::wgmma_rs_m64n32k16_tb(d, a, b);
  if constexpr (N == 64) hp::wgmma_rs_m64n64k16_tb(d, a, b);
  if constexpr (N == 80) hp::wgmma_rs_m64n80k16_tb(d, a, b);
  if constexpr (N == 96) hp::wgmma_rs_m64n96k16_tb(d, a, b);
  if constexpr (N == 128) hp::wgmma_rs_m64n128k16_tb(d, a, b);
  if constexpr (N == 192) hp::wgmma_rs_m64n192k16_tb(d, a, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int Sq,
                   int Sk, int H, int KV, float scale_log2, int causal) {
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

      // P as the A operand: k-step t covers keys 16t..16t+15, i.e. score
      // blocks 2t and 2t+1 of the accumulator layout.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        pa[t][0] = hp::pack_bf16(sc[8 * t + 0], sc[8 * t + 1]);
        pa[t][1] = hp::pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
        pa[t][2] = hp::pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
        pa[t][3] = hp::pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
      }
      hp::mbar_wait(&bar_v[s], parity);
      hp::wgmma_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        // V is MN-major: 16 key rows per k-step, 8-row groups sbo apart,
        // BOX-column boxes lbo apart.
        const uint64_t dv = hp::make_desc(v_base + t * 16 * L::SW, BK * L::SW, 8 * L::SW, L::kSw);
        wgmma_pv<D>(acc, pa[t], dv);
      }
      hp::wgmma_commit();
      hp::wgmma_wait_all();
      hp::fence_regs(acc);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && j + kStages < n_tiles) load_kv(j + kStages);
  }

  // Epilogue: full row sums across the quad, then O / max(l, 1e-30) in bf16
  // staged through the (now idle) K ring with 16-byte chunks XOR-swizzled by
  // row within aligned groups of a power-of-two size (4 of the 12 chunks of a
  // D = 96 row, 2 of the 10 of a D = 80 row), so that no chunk leaves its
  // row, and stored as 16-byte row pieces.
  constexpr int NCH = D / 8;  // 16-byte chunks per output row
  constexpr int SWZ = ((NCH & -NCH) < 8 ? (NCH & -NCH) : 8) - 1;
  uint8_t* stage = smem + L::K_OFF + wg * 64 * D * 2;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const uint32_t v =
          hp::pack_bf16(acc[4 * c + 2 * i] * inv[i], acc[4 * c + 2 * i + 1] * inv[i]);
      *reinterpret_cast<uint32_t*>(stage + r * D * 2 + ((c ^ (r & SWZ)) * 16) + col2 * 2) = v;
    }
  }
  hp::named_sync(1 + wg, 128);
  const size_t row_stride = static_cast<size_t>(H) * D;
  for (int idx = tid % 128; idx < 64 * NCH; idx += 128) {
    const int r = idx / NCH, c = idx % NCH;
    const int qpos = wg_row0 + r;
    if (qpos < Sq) {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + r * D * 2 + ((c ^ (r & SWZ)) * 16));
      *reinterpret_cast<uint4*>(o + (static_cast<size_t>(b) * Sq + qpos) * row_stride +
                                static_cast<size_t>(h) * D + c * 8) = v;
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (B, S, heads, D) bf16 tensor as the 4-D map {D, heads, S, B}; a box is
// {D-slice of SW bytes, 1 head, `rows` positions, 1 sequence}.  Rows past S
// are filled with zeros.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int rows) {
  using L = Layout<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::BOX), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = L::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : L::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KV, float scale_log2, int causal, int device, cudaStream_t stream) {
  static rt::SmemOptIn optin;
  cudaError_t err = optin.ensure(flash_fwd_sm90<D>, device, Layout<D>::SMEM);
  if (err != cudaSuccess) return err;
  if (!rt::aligned16(q) || !rt::aligned16(k) || !rt::aligned16(v) || !rt::aligned16(o))
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if ((err = make_map<D>(&tq, q, B, Sq, H, BQ)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tk, k, B, Sk, KV, BK)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tv, v, B, Sk, KV, BK)) != cudaSuccess) return err;
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  flash_fwd_sm90<D><<<grid, kThreads, Layout<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, scale_log2, causal);
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
                  const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
                  int KV, float scale_log2, int causal) {
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
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KV, float scale_log2, int causal, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static rt::SmemOptIn optin;
  const cudaError_t err = optin.ensure(flash_fwd_fma<D>, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_fma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, KV, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace simt

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                         int Sq, int Sk, int H, int KV, float sl, int causal, int device,
                         cudaStream_t s) {
  switch (dtype) {
    case rt::kF32:
      return simt::launch<D>(q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    case rt::kBF16:
      return sm90::launch<D>(q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// softmax_scale is the plain scale (1/sqrt(D) by default); the kernels work in
// the log2 domain.  bf16 takes the wgmma kernel, f32 the FMA kernel.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int H, int KV, int D,
                                      float softmax_scale, int causal, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  if (Sk == 0 || KV == 0 || H % KV != 0) return cudaErrorInvalidValue;
  const float sl = softmax_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 80:
      return launch_dtype<80>(dtype, q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 96:
      return launch_dtype<96>(dtype, q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    case 192:
      return launch_dtype<192>(dtype, q, k, v, o, B, Sq, Sk, H, KV, sl, causal, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
