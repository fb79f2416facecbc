// Single-token GQA decode attention over a padded (B, KV, S, D) cache for
// Hopper (sm_90a): one launch, a thread-block cluster per (sequence, KV head).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (_decode_kernel / decode_attention).  q (B, H, D), k/v (B, KV, S, D),
// lengths (B,) int32, clamped to [0, S]; positions >= the length are masked;
// the output is acc / max(l, 1e-30), so a row of length 0 gives 0.
//
// With `lse` non-null the merge also writes each head's log-sum-exp, f32
// (B, H): mu + log2(l) from the cluster's combined max mu and sum l, in the
// log2 domain of the scaled scores (as the flash kernels' lse), and -inf for
// a row of length 0.  That is the partial of a cache slice that flash-decoding
// over a sequence-sharded cache merges (kernels/ops.py, merge_partials): a
// slice holding no key of the row has weight exp2(-inf) = 0 there.  (The
// flash kernels write +inf for a row with no key, which their backward
// needs; here it would be an infinite weight.)  With `lse` null nothing
// else changes.
//
// The cache is of q's type, or int8 with f32 scales k_scale/v_scale (B, KV,
// S), one per token and KV head: the int8 branch of the JAX package's
// decode_attention_reference (src/repro/models/layers.py, jnp; its Pallas
// kernel takes no int8).  There K is cast to q's dtype (exact: every int8 is
// a bf16), q . k is summed in f32, times scale and k_scale, softmax'ed, and
// the probabilities times v_scale are cast to q's dtype before the PV
// product (f32 sums).  The bulk copies move the int8 rows (D bytes each).
// The scales, 4 bytes a row at offsets that are multiples of 16 only for
// some S, ride beside them in a ring of their own: every thread copies a few
// of a chunk's valid rows by 4-byte cp.async, issued with the chunk's bulk
// copies, so no load waits inside the chunk's passes.  Two routes:
//
// * bf16 q (decode_int8_mma_kernel): both products on the tensor cores,
//   mma.sync m16n8k16 bf16 x bf16 -> f32, each warp an independent split of
//   its 16-row tiles (tile c*16.. of a chunk to warp c % 4) with its own
//   online softmax, the 4 warps merged by their maxima at the end.
//   Scores as S^T = q K^T: M the CTA's query heads (8, the upper 8 rows of
//   the tile zero), N 8 cache rows, K the head dim in steps of 16.  The
//   contraction over D is permuted alike for q and K: D/16 steps in
//   segments of 4, 2, 1 steps, lane t of a quad holding 4w contiguous bytes
//   of a segment of w steps of one row (16-byte loads), and of each 4-byte
//   word bytes 0, 2 pair with contraction indices 2t, 2t+1 and bytes 1, 3
//   with 2t+8, 2t+9, so a word becomes its two bf16x2 operands by masks
//   alone (s8x2_to_bf16x2: 0x4300|m - 0x4300|s, exact; no I2F).  k_scale
//   and the softmax scale multiply the f32 accumulators (log2 domain);
//   rows at or past the length are -inf.  The accumulator fragment of the
//   two 8-row halves of a tile holds, for head g, rows 2t, 2t+1, 2t+8, 2t+9:
//   exactly the B fragment of PV^T = V^T P^T (M the head dim in 16-row
//   tiles, N the 8 heads, K the tile's 16 rows), so P stays in registers:
//   p * v_scale rounded to bf16 (the reference's rounding point; l sums p
//   unrounded and without v_scale, as before).  V^T's A fragment pairs two
//   rows at one column: lane g holds 2w contiguous bytes of a V segment of
//   w m-tiles (segments of 8, 4, 2, 1), m-tile m's output columns d and
//   d + 1 (its A rows g and g + 8) two neighbouring bytes, and a byte_perm
//   of the two rows' words brings a column's pair together before the same
//   mask conversion.  The row order is the cache's in both products.
// * f32 q (decode_attention_kernel): the CUDA-core loop below.  The
//   reference casts K to f32 there; neither bf16 nor TF32 operands would
//   hold its 3e-5.  k_scale multiplies each score after the dot (log2
//   domain); l sums exp2(s - m) without v_scale, and acc adds (p *
//   v_scale[row]) * v[row], which after the final acc / l is the
//   reference's order: normalise, then scale.  int8 becomes f32 by integer
//   ops and one exact add (int8x4_to_float), not by the quarter-rate I2F.
//   A lane takes 16 int8 values of a row where the CTA holds at most 4
//   heads (half the shuffles per row of 8-value vectors), and 8 above: 16
//   would put 8 heads' q and acc at 256 registers.
//
// Bound on the H100: bytes.  Every valid cache row is read once per step and
// takes 2*D flops per query head (about 2*n_rep flops per byte), so the
// design keeps as many cache bytes in flight as it can and does the
// arithmetic from shared memory (FMAs, or for the int8 cache under a bf16 q
// tensor-core tiles whose per-element cost is the int8 -> bf16 conversion:
// about 2 integer ops a byte where the FMA loop spent 2*n_rep + 2).  Both
// routes share the grid, the rings and the merge below.  The TPU grid walks S in order per
// (sequence, KV head); on the H100 that would be B*KV CTAs (32 at the serving
// batch) for 132 SMs, so the sequence is split across the CTAs of a cluster
// (flash-decoding) and merged inside the same launch:
//
// * Grid (cluster, KV, B) with a cluster of `cluster` CTAs along x (set at
//   launch; the wrapper's decode_plan picks it and the chunk rows).  Chunk c
//   (rows [c*CH, c*CH + CH) below the length) belongs to cluster rank
//   c % cluster; a CTA walks its chunks in a 2-stage ring (3 stages on the
//   tensor-core route, whose plan gives a short cache one chunk of about
//   256 rows a CTA and a long one the cluster size, 2 to 8, that fills the
//   card's waves best: 62 clusters of 8 fit an H100 at once, so granite's 64
//   clusters at 8 x 32k run as clusters of 7).
// * In the cache a chunk of one (sequence, KV head) is one contiguous block,
//   so thread 0 fetches a chunk's K and its V with one 1-D bulk copy each
//   (cp.async.bulk), completing on an mbarrier.  Only the valid rows are
//   copied (min(CH, len - s0) rows, from the device-side length), so the
//   kernel reads the bytes the bound counts.
// * (FMA loop) Scores: threads along D (16-byte loads, conflict-free), n_rep partial
//   dots per thread reduced across the row's lanes; each K row is read once
//   for the query heads of the CTA that share it.  Online softmax per head
//   by one warp (warp w takes heads w, w + 4, ...); PV with threads along D
//   over the chunk's rows.
// * (FMA loop) A row takes TD lanes of NV 16-byte vectors each (NV = 1, or 2 where one
//   vector a lane would need more than a warp: D = 192 in f32 is 48
//   vectors, so 24 lanes of two, the second 24 vectors further along the
//   row), and a warp 32 / TD whole rows.  Where TD does not divide 32 (D =
//   80: 10 or 20 lanes; D = 192: 24) a warp holds 3, 1 or 1 rows in its
//   first 30, 20 or 24 lanes and the rest idle.  Lane sums (a row's TD
//   lanes; the rows of one warp, TD lanes apart) go through group_sum: an
//   XOR butterfly over a power-of-two group at a power-of-two stride, else a
//   shift-down tree that stays inside the group.
// * A thread keeps its query and output slice of every head of the CTA in
//   registers (2 x heads x EL floats, 128 at most; the tensor-core route's
//   tiles are 8 heads wide), so a CTA takes at most 8 of
//   the n_rep heads of a KV head: at n_rep 12 (nemotron) the wrapper splits
//   them into 2 groups of 6, each its own cluster over the same cache rows
//   (grid y = KV x groups); the second group's reads of a chunk mostly hit
//   the L2 behind the first's.
// * Each CTA leaves its partial (m, l, acc[n_rep][D]) in its shared memory;
//   after cluster.sync() the CTAs merge the partials through distributed
//   shared memory, each rank a slice of the n_rep x D outputs, and write the
//   output.  A CTA with no chunk below the length still reaches both cluster
//   barriers, with an empty partial (m = -inf, l = 0).
#include <cooperative_groups.h>

#include <utility>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMmaStages = 3;  // the tensor-core route's ring: two chunks in flight behind one
constexpr int kMaxCluster = 8;  // the portable cluster size

}  // namespace

namespace rt {
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
}  // namespace rt

namespace {

// C: the cache's element type (q's, or int8_t with scales)
template <typename C, int D, int NREP>
struct Shape {
  static constexpr bool kQuant = sizeof(C) == 1;
  static constexpr int VB = kQuant && NREP > 4 ? 8 : 16;  // bytes per vector load of the cache
  static constexpr int VE = VB / sizeof(C);             // elements per vector load
  static constexpr int NV = (D / VE + 31) / 32;         // vectors per lane per row
  static constexpr int EL = NV * VE;                    // elements per lane per row
  static constexpr int TD = D / EL;                     // threads along one row (1..32)
  static constexpr int RPW = 32 / TD;                   // rows per warp per pass
  static constexpr int RP = kWarps * RPW;               // rows per CTA pass (and PV row groups)
  static constexpr int HPW = (NREP + kWarps - 1) / kWarps;  // softmax heads per warp
  static_assert(TD >= 1 && TD <= 32 && D % EL == 0, "unsupported head dim");
  static_assert(NREP <= 8, "at most 8 query heads per CTA (corr, m and l hold 8)");
  // the first column of this lane's vector j of a row
  __device__ static int col(int lane, int j) { return (j * TD + lane % TD) * VE; }

  // Dynamic shared memory for chunks of `ch` rows: [K ring | V ring | scores
  // (NREP x ch) | scale ring (kStages x [k_scale | v_scale] x ch, int8 only)
  // | corr (NREP) | partial m, l (NREP each) | partial acc (NREP x D) |
  // barriers].  The cross-warp reduction of
  // acc (kWarps x NREP x D f32) reuses the ring once the chunks are done.
  __host__ __device__ static size_t up16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }
  __host__ __device__ static size_t chunk_bytes(int ch) {
    return static_cast<size_t>(ch) * D * sizeof(C);
  }
  __host__ __device__ static size_t scores_off(int ch) {
    const size_t ring = 2 * kStages * chunk_bytes(ch), red = kWarps * NREP * D * 4;
    return ring > red ? ring : red;
  }
  __host__ __device__ static size_t scale_off(int ch) {
    return scores_off(ch) + static_cast<size_t>(NREP) * ch * 4;
  }
  __host__ __device__ static size_t corr_off(int ch) {
    return up16(scale_off(ch) + (kQuant ? static_cast<size_t>(kStages) * 2 * ch * 4 : 0));
  }
  // corr[8], then the partial's m[8] and l[8]
  __host__ __device__ static size_t part_off(int ch) { return corr_off(ch) + 8 * 4; }
  __host__ __device__ static size_t acc_off(int ch) { return part_off(ch) + 16 * 4; }
  __host__ __device__ static size_t bar_off(int ch) { return acc_off(ch) + NREP * D * 4; }
  __host__ __device__ static size_t smem(int ch) { return bar_off(ch) + 8 * 2 * kStages; }
};

// Sum of v over a group of N lanes STRIDE apart, this lane being member i
// (0 <= i < N for the group's lanes), exact at member 0.  Where N and STRIDE
// are powers of two the groups tile the warp and an XOR butterfly gives
// every member the sum (on the H100 the tree alone made bf16 decode at D =
// 128 slower).  Else a shift-down tree whose adds stay inside the group
// (an XOR by a STRIDE of 12 would leave it): offsets from the largest power
// of two below N down to 1; after offset o, member i < o holds the sum of
// members i, i + o, i + 2o, ...
template <int N, int STRIDE>
__device__ __forceinline__ float group_sum(float v, int i) {
  if constexpr ((N & (N - 1)) == 0 && (STRIDE & (STRIDE - 1)) == 0) {
#pragma unroll
    for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o * STRIDE);
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o >= N) continue;
      const float u = __shfl_down_sync(0xffffffffu, v, o * STRIDE);
      if (i + o < N) v += u;
    }
  }
  return v;
}

// T: q's and the output's type; C: the cache's (T, or int8_t with the f32
// scales ksc / vsc, (B, KV, S); nullptr otherwise)
// Four int8 values packed in w, as floats, exactly: with u = byte ^ 0x80 in
// [0, 255], the float of bit pattern 0x4B000000 | u is 2^23 + u, and
// (2^23 + u) - (2^23 + 128) is the byte's signed value.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | e)) - 8388736.0f;
}

// VE cache elements at p (one vector load) as floats
template <typename C, int VE>
__device__ __forceinline__ void load_vec(const C* p, float* f) {
  if constexpr (sizeof(C) == 1) {
    const rt::Vec<uint32_t, VE / 4> w = *reinterpret_cast<const rt::Vec<uint32_t, VE / 4>*>(p);
#pragma unroll
    for (int j = 0; j < VE / 4; ++j) int8x4_to_float(w.e[j], f + 4 * j);
  } else {
    const rt::Vec<C, VE> v = *reinterpret_cast<const rt::Vec<C, VE>*>(p);
#pragma unroll
    for (int e = 0; e < VE; ++e) f[e] = rt::to_float(v.e[e]);
  }
}

// 4 bytes global -> shared, asynchronously (cp.async: no 16-byte alignment)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(hp::smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The cluster's merge, once every CTA has left its partial in its shared
// memory (m and l of each of its `heads` heads, acc heads x D): after
// cluster.sync() rank c writes the outputs idx = c*kThreads + tid,
// c*kThreads + tid + cluster*kThreads, ...  Each reads the partials of its
// head from every rank through distributed shared memory, all loads issued
// before any is used (ranks past the cluster size repeat the last one and get
// weight 0).  o: the CTA's heads' outputs (heads x D); lse_h: their
// log-sum-exps, or null.
template <typename T, int D>
__device__ __forceinline__ void cluster_merge(cg::cluster_group& cluster, int heads, float* part_m,
                                              float* part_l, float* part_acc, T* o, float* lse_h) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  cluster.sync();  // every partial of the cluster is written
  for (int idx = rank * kThreads + static_cast<int>(threadIdx.x); idx < heads * D;
       idx += csize * kThreads) {
    const int r = idx / D;
    float pm[kMaxCluster], pl[kMaxCluster], pa[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      const int cc = min(c, csize - 1);
      pm[c] = cluster.map_shared_rank(part_m, cc)[r];
      pl[c] = cluster.map_shared_rank(part_l, cc)[r];
      pa[c] = cluster.map_shared_rank(part_acc, cc)[idx];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) mx = fmaxf(mx, pm[c]);
    const float mu = mx == -INFINITY ? 0.f : mx;  // every partial empty: length 0
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      const float w = c < csize ? exp2f(pm[c] - mu) : 0.f;
      l = fmaf(pl[c], w, l);
      a = fmaf(pa[c], w, a);
    }
    o[idx] = rt::from_float<T>(a / fmaxf(l, 1e-30f));
    if (lse_h != nullptr && idx % D == 0)  // one thread a head: its log-sum-exp
      lse_h[r] = l > 0.f ? mu + log2f(l) : -INFINITY;
  }
  cluster.sync();  // every CTA's shared memory stays alive until its peers have read it
}

template <typename T, typename C, int D, int NREP>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                            const C* __restrict__ vc, const float* __restrict__ ksc,
                            const float* __restrict__ vsc, const int* __restrict__ lengths,
                            T* __restrict__ out, float* __restrict__ lse, int KV, int groups,
                            int S, int CH, float scale_log2) {
  using SH = Shape<C, D, NREP>;
  constexpr int QV = 16 / sizeof(T);  // q elements per 16-byte load (SH::VE is a multiple)
  using QVec = rt::Vec<T, QV>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  // blockIdx.y: group g of KV head kvh's query heads, kvh * groups + g; its
  // NREP heads are kvh * groups * NREP + g * NREP + r = blockIdx.y * NREP + r
  const int hg = blockIdx.y, kvh = hg / groups, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) uint8_t smem[];
  C* kring = reinterpret_cast<C*>(smem);
  C* vring = kring + static_cast<size_t>(kStages) * CH * D;
  float* ps = reinterpret_cast<float*>(smem + SH::scores_off(CH));
  float* sc_ring = reinterpret_cast<float*>(smem + SH::scale_off(CH));  // int8 only
  float* corr_s = reinterpret_cast<float*>(smem + SH::corr_off(CH));
  float* part_m = reinterpret_cast<float*>(smem + SH::part_off(CH));
  float* part_l = part_m + 8;
  float* part_acc = reinterpret_cast<float*>(smem + SH::acc_off(CH));
  uint64_t* bar_k = reinterpret_cast<uint64_t*>(smem + SH::bar_off(CH));
  uint64_t* bar_v = bar_k + kStages;

  const int len = min(max(lengths[b], 0), S);
  const int n_chunks = (len + CH - 1) / CH;
  const int my_chunks = rank < n_chunks ? (n_chunks - rank + csize - 1) / csize : 0;
  const size_t head_s = (static_cast<size_t>(b) * KV + kvh) * S;  // this head's scale row
  const size_t head = head_s * D;

  auto issue = [=](int i) {  // thread 0: chunk i of this CTA into stage i % kStages
    const int s0 = (rank + i * csize) * CH;
    const uint32_t bytes = static_cast<uint32_t>(min(CH, len - s0)) * D * sizeof(C);
    const int st = i % kStages;
    hp::mbar_expect_tx(&bar_k[st], bytes);
    hp::bulk_load(kring + static_cast<size_t>(st) * CH * D, kc + head + static_cast<size_t>(s0) * D,
                  bytes, &bar_k[st]);
    hp::mbar_expect_tx(&bar_v[st], bytes);
    hp::bulk_load(vring + static_cast<size_t>(st) * CH * D, vc + head + static_cast<size_t>(s0) * D,
                  bytes, &bar_v[st]);
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      hp::mbar_init(&bar_k[st], 1);
      hp::mbar_init(&bar_v[st], 1);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  // every thread: chunk i's scales into scale stage i % kStages, one
  // cp.async group per chunk slot (empty past the last chunk)
  auto issue_scales = [&](int i) {
    if (i < my_chunks) {
      const int s0 = (rank + i * csize) * CH, n = min(CH, len - s0);
      float* dst = sc_ring + static_cast<size_t>(i % kStages) * 2 * CH;
      for (int r = tid; r < n; r += kThreads) {
        cp_async4(dst + r, ksc + head_s + s0 + r);
        cp_async4(dst + CH + r, vsc + head_s + s0 + r);
      }
    }
    cp_async_commit();
  };

  if (tid == 0)
    for (int i = 0; i < kStages && i < my_chunks; ++i) issue(i);
  if constexpr (SH::kQuant)
    for (int i = 0; i < kStages; ++i) issue_scales(i);

  // This thread's column slices of every row (NV vectors), and the CTA's
  // query heads (scaled into the log2 domain) at those columns.  Lanes past
  // the warp's last whole row (D = 80, 192) load no row.
  const bool row_lane = lane < SH::RPW * SH::TD;
  const int wrow = warp * SH::RPW + lane / SH::TD;  // this lane's row within a pass
  float qr[NREP][SH::EL];
  const T* qh = q + (static_cast<size_t>(b) * KV * groups + hg) * NREP * D;
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int j = 0; j < SH::NV; ++j)
#pragma unroll
      for (int u = 0; u < SH::VE; u += QV) {
        const QVec v = *reinterpret_cast<const QVec*>(qh + r * D + SH::col(lane, j) + u);
#pragma unroll
        for (int e = 0; e < QV; ++e)
          qr[r][j * SH::VE + u + e] = rt::to_float(v.e[e]) * scale_log2;
      }

  float m_own[SH::HPW], l_own[SH::HPW];  // heads warp + kWarps*t
#pragma unroll
  for (int t = 0; t < SH::HPW; ++t) {
    m_own[t] = -INFINITY;
    l_own[t] = 0.f;
  }
  float acc[NREP][SH::EL];
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int e = 0; e < SH::EL; ++e) acc[r][e] = 0.f;

  for (int i = 0; i < my_chunks; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int nv = min(CH, len - (rank + i * csize) * CH);
    const C* ks = kring + static_cast<size_t>(st) * CH * D;
    const C* vs = vring + static_cast<size_t>(st) * CH * D;
    const float* ksc_s = sc_ring + static_cast<size_t>(st) * 2 * CH;  // int8: this chunk's
    const float* vsc_s = ksc_s + CH;                                  // k_scale, v_scale
    if constexpr (SH::kQuant) {
      cp_async_wait<kStages - 1>();  // this thread's copies of chunk i's scales
      __syncthreads();               // and every other thread's
    }

    // scores of the chunk's rows for the n_rep heads
    hp::mbar_wait(&bar_k[st], parity);
    for (int base = 0; base < nv; base += SH::RP) {  // CTA-uniform trip count
      const int row = base + wrow;
      const bool ok = row_lane && row < nv;
      float dot[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) dot[r] = 0.f;
      if (ok) {
#pragma unroll
        for (int j = 0; j < SH::NV; ++j) {
          float kf[SH::VE];
          load_vec<C, SH::VE>(ks + row * D + SH::col(lane, j), kf);
#pragma unroll
          for (int e = 0; e < SH::VE; ++e) {
#pragma unroll
            for (int r = 0; r < NREP; ++r) dot[r] = fmaf(qr[r][j * SH::VE + e], kf[e], dot[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) dot[r] = group_sum<SH::TD, 1>(dot[r], lane % SH::TD);
      if (ok && lane % SH::TD == 0) {
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          if constexpr (SH::kQuant)
            ps[r * CH + row] = dot[r] * ksc_s[row];
          else
            ps[r * CH + row] = dot[r];
        }
      }
    }
    __syncthreads();

    // online softmax over the chunk: warp w updates heads w, w + kWarps, ...
#pragma unroll
    for (int t = 0; t < SH::HPW; ++t) {
      const int r = warp + kWarps * t;
      if (r < NREP) {
        float mx = -INFINITY;
        for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, ps[r * CH + j]);
        mx = rt::warp_max(mx);  // finite: nv >= 1
        const float m_new = fmaxf(m_own[t], mx);
        const float corr = exp2f(m_own[t] - m_new);
        float sum = 0.f;
        for (int j = lane; j < nv; j += 32) {
          const float p = exp2f(ps[r * CH + j] - m_new);
          sum += p;  // l sums the probabilities without v_scale
          if constexpr (SH::kQuant)
            ps[r * CH + j] = p * vsc_s[j];
          else
            ps[r * CH + j] = p;
        }
        sum = rt::warp_sum(sum);
        l_own[t] = l_own[t] * corr + sum;
        m_own[t] = m_new;
        if (lane == 0) corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V, threads along D over the chunk's rows
    hp::mbar_wait(&bar_v[st], parity);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float c = corr_s[r];
#pragma unroll
      for (int e = 0; e < SH::EL; ++e) acc[r][e] *= c;
    }
    for (int row = row_lane ? wrow : nv; row < nv; row += SH::RP) {
      float vf[SH::EL];
#pragma unroll
      for (int j = 0; j < SH::NV; ++j)
        load_vec<C, SH::VE>(vs + row * D + SH::col(lane, j), vf + j * SH::VE);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float p = ps[r * CH + row];
#pragma unroll
        for (int e = 0; e < SH::EL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
    __syncthreads();  // stage st and the scores are free again
    if (tid == 0 && i + kStages < my_chunks) issue(i + kStages);
    if constexpr (SH::kQuant) issue_scales(i + kStages);
  }

  // This CTA's partial: acc summed over the row groups (within a warp by
  // shuffles into the first row's lanes, across warps through the idle
  // ring), m and l per head.
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int e = 0; e < SH::EL; ++e) acc[r][e] = group_sum<SH::RPW, SH::TD>(acc[r][e], lane / SH::TD);
  float* red = reinterpret_cast<float*>(kring);  // kWarps x NREP x D, in the ring
  if (lane < SH::TD) {
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int j = 0; j < SH::NV; ++j)
#pragma unroll
        for (int e = 0; e < SH::VE; ++e)
          red[(warp * NREP + r) * D + SH::col(lane, j) + e] = acc[r][j * SH::VE + e];
  }
#pragma unroll
  for (int t = 0; t < SH::HPW; ++t) {
    const int r = warp + kWarps * t;
    if (r < NREP && lane == 0) {
      part_m[r] = m_own[t];
      part_l[r] = l_own[t];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < NREP * D; idx += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * NREP * D + idx];
    part_acc[idx] = a;
  }

  const size_t heads0 = (static_cast<size_t>(b) * KV * groups + hg) * NREP;  // the CTA's first head
  float* lse_h = lse == nullptr ? nullptr : lse + heads0;
  cluster_merge<T, D>(cluster, NREP, part_m, part_l, part_acc, out + heads0 * D, lse_h);
}

// --- the int8 cache under a bf16 q: both products on tensor cores ------------

// d += a b on one m16n8k16 tile: bf16 operands (a: 4 registers of a 16 x 16
// row-major tile, b: 2 of a 16 x 8 column-major one), f32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bytes 0 and 2 of z, signed, as a bf16x2 (byte 0 the low half), exactly:
// with m a byte's low 7 bits and s its sign bit, the bf16 0x4300 | m is 128 +
// m and 0x4300 | s is 128 or 256, so their difference is the byte's value.
// Two masks (LOP3) and one packed fma, no I2F.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t z) {
  const uint32_t a = (z & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (z & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(b), "r"(0xBF80BF80u), "r"(a));  // a - b
  return r;
}

// Two floats as a bf16x2, each rounded to nearest even (lo the low half)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Where a lane's bytes of a cache row sit in the two products (see the
// header).  The D/16 k-steps of the score product are cut into segments of
// 4, 2, 1 steps, lane t of a quad holding 4w contiguous bytes of a segment of
// w; the D/16 m-tiles of PV into segments of 8, 4, 2, 1, lane g holding 2w
// contiguous bytes of each row.
// Shared memory, for chunks of `ch` rows in `ring` stages (at most
// kMmaStages; fewer where a CTA has fewer chunks): [K ring | V ring | scale
// ring (ring x [k_scale | v_scale] x ch) | each warp's m and l (kWarps x 8
// each) | partial m, l (8 each) | partial acc (8 x D) | barriers]; the
// warps' acc (kWarps x 8 x D f32) reuses the ring once the chunks are done.
template <int D>
struct Mma {
  static constexpr int kM = D / 16;         // k-steps of the scores, m-tiles of PV
  static constexpr int kVW = (kM + 1) / 2;  // words of a lane's bytes of a V row
  static_assert(D % 16 == 0 && kM <= 16, "unsupported head dim");
  __host__ __device__ static constexpr int pow2_le(int n, int cap) {
    int w = cap;
    while (w > n) w /= 2;
    return w;
  }
  __host__ __device__ static constexpr int seg_first(int i, int cap) {  // of the segment holding i
    int f = 0;
    while (i >= f + pow2_le(kM - f, cap)) f += pow2_le(kM - f, cap);
    return f;
  }
  __host__ __device__ static constexpr int seg_width(int i, int cap) {
    return pow2_le(kM - seg_first(i, cap), cap);
  }
  // The column of the first of the 4 bytes lane t holds for k-step S is
  // k_col<S>() + k_lane<S>() * t: bytes 0 and 2 of them pair with the step's
  // contraction indices 2t, 2t + 1, bytes 1 and 3 with 2t + 8, 2t + 9 (q
  // permuted alike).  Template arguments, so that the segment loops run in
  // the compiler and not in the kernel.
  template <int S>
  __host__ __device__ static constexpr int k_col() {
    return 16 * seg_first(S, 4) + 4 * (S - seg_first(S, 4));
  }
  template <int S>
  __host__ __device__ static constexpr int k_lane() { return 4 * seg_width(S, 4); }
  // The output column of m-tile M's A row g, v_col<M>() + v_lane<M>() * g
  // (row g + 8: the next column); the lane's bytes of m-tile M are bytes 2
  // (M % 2), + 1 of its word M / 2.
  template <int M>
  __host__ __device__ static constexpr int v_col() {
    return 16 * seg_first(M, 8) + 2 * (M - seg_first(M, 8));
  }
  template <int M>
  __host__ __device__ static constexpr int v_lane() { return 2 * seg_width(M, 8); }
  __host__ __device__ static size_t scale_off(int ch, int ring) {
    const size_t rb = static_cast<size_t>(2 * ring) * ch * D, red = kWarps * 8 * D * 4;
    return rb > red ? rb : red;
  }
  __host__ __device__ static size_t wstat_off(int ch, int ring) {
    return scale_off(ch, ring) + static_cast<size_t>(ring) * 2 * ch * 4;
  }
  __host__ __device__ static size_t part_off(int ch, int ring) {
    return wstat_off(ch, ring) + 2 * kWarps * 8 * 4;
  }
  __host__ __device__ static size_t acc_off(int ch, int ring) {
    return part_off(ch, ring) + 16 * 4;
  }
  __host__ __device__ static size_t bar_off(int ch, int ring) {
    return acc_off(ch, ring) + 8 * D * 4;
  }
  __host__ __device__ static size_t smem(int ch, int ring) {
    return bar_off(ch, ring) + 8 * 2 * kMmaStages;
  }
};

// lane t's words of one K row, word S for k-step S (16-, 8- or 4-byte loads
// of each segment)
template <int D, int S>
__device__ __forceinline__ void load_k_seg(const int8_t* row, int t, uint32_t (&w)[D / 16]) {
  using L = Mma<D>;
  if constexpr (L::seg_first(S, 4) == S) {
    constexpr int W = L::seg_width(S, 4), C = L::template k_col<S>(), LN = L::template k_lane<S>();
    const int8_t* p = row + C + LN * t;
    if constexpr (W == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[S] = v.x, w[S + 1] = v.y, w[S + 2] = v.z, w[S + 3] = v.w;
    } else if constexpr (W == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[S] = v.x, w[S + 1] = v.y;
    } else {
      w[S] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
}
template <int D, int... S>
__device__ __forceinline__ void load_k_row(const int8_t* row, int t, uint32_t (&w)[D / 16],
                                           std::integer_sequence<int, S...>) {
  (load_k_seg<D, S>(row, t, w), ...);
}

// lane g's words of one V row: m-tile m's two bytes at bytes 2 (m % 2), + 1
// of word m / 2 (16-, 8-, 4- or 2-byte loads of each segment)
template <int D, int M>
__device__ __forceinline__ void load_v_seg(const int8_t* row, int g, uint32_t (&w)[Mma<D>::kVW]) {
  using L = Mma<D>;
  if constexpr (L::seg_first(M, 8) == M) {
    constexpr int W = L::seg_width(M, 8), i = M / 2, C = L::template v_col<M>();
    constexpr int LN = L::template v_lane<M>();
    const int8_t* p = row + C + LN * g;
    if constexpr (W == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
    } else if constexpr (W == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[i] = v.x, w[i + 1] = v.y;
    } else if constexpr (W == 2) {
      w[i] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[i] = *reinterpret_cast<const uint16_t*>(p);
    }
  }
}
template <int D, int... M>
__device__ __forceinline__ void load_v_row(const int8_t* row, int g, uint32_t (&w)[Mma<D>::kVW],
                                           std::integer_sequence<int, M...>) {
  (load_v_seg<D, M>(row, g, w), ...);
}

// q^T's A fragment of k-step S (row g: the CTA's head g): the bf16 at
// columns c, c + 2 and c + 1, c + 3 of q's row, c = k_col<S> + k_lane<S> * t,
// as K's bytes pair
template <int D, int S>
__device__ __forceinline__ void load_q_step(const __nv_bfloat16* qrow, int t,
                                            uint32_t (&qa)[D / 16][2]) {
  using L = Mma<D>;
  constexpr int C = L::template k_col<S>(), LN = L::template k_lane<S>();
  const uint2 v = *reinterpret_cast<const uint2*>(qrow + C + LN * t);
  qa[S][0] = __byte_perm(v.x, v.y, 0x5410);
  qa[S][1] = __byte_perm(v.x, v.y, 0x7632);
}
template <int D, int... S>
__device__ __forceinline__ void load_q(const __nv_bfloat16* qrow, int t, uint32_t (&qa)[D / 16][2],
                                       std::integer_sequence<int, S...>) {
  (load_q_step<D, S>(qrow, t, qa), ...);
}

// m-tile M of acc (PV^T: rows v_col<M> + v_lane<M> * g and the next, columns
// heads 2t, 2t + 1) into red, laid out [head][column] from this warp's head 2t
template <int D, int M>
__device__ __forceinline__ void store_acc_tile(float* red, int g, const float (&acc)[D / 16][4]) {
  using L = Mma<D>;
  float* r = red + L::template v_col<M>() + L::template v_lane<M>() * g;
  r[0] = acc[M][0];
  r[D] = acc[M][1];
  r[1] = acc[M][2];
  r[D + 1] = acc[M][3];
}
template <int D, int... M>
__device__ __forceinline__ void store_acc(float* red, int g, const float (&acc)[D / 16][4],
                                          std::integer_sequence<int, M...>) {
  (store_acc_tile<D, M>(red, g, acc), ...);
}

// byte_perm selector that puts byte b of x in byte 0 and byte b of y in byte
// 2 (bytes 1 and 3: don't care)
__host__ __device__ constexpr uint32_t pair_sel(int b) {
  return static_cast<uint32_t>(b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12));
}

// The int8 cache under a bf16 q (see the header): the grid, the rings and the
// merge of decode_attention_kernel; `heads` (<= 8) query heads per CTA.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 4 : 3)
    decode_int8_mma_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kc,
                           const int8_t* __restrict__ vc, const float* __restrict__ ksc,
                           const float* __restrict__ vsc, const int* __restrict__ lengths,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int KV,
                           int groups, int heads, int S, int CH, int ring, float scale_log2) {
  using L = Mma<D>;
  constexpr int kM = L::kM;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int hg = blockIdx.y, kvh = hg / groups, b = blockIdx.z;  // heads hg * heads + r
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' group and lane in it

  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* kring = reinterpret_cast<int8_t*>(smem);
  // stage st of chunk i is i % kMmaStages: below `ring`, as a CTA has at
  // most `ring` chunks where ring < kMmaStages
  int8_t* vring = kring + static_cast<size_t>(ring) * CH * D;
  float* sc_ring = reinterpret_cast<float*>(smem + L::scale_off(CH, ring));
  float* wstat = reinterpret_cast<float*>(smem + L::wstat_off(CH, ring));  // m, l [kWarps][8]
  float* part_m = reinterpret_cast<float*>(smem + L::part_off(CH, ring));
  float* part_l = part_m + 8;
  float* part_acc = reinterpret_cast<float*>(smem + L::acc_off(CH, ring));
  uint64_t* bar_k = reinterpret_cast<uint64_t*>(smem + L::bar_off(CH, ring));
  uint64_t* bar_v = bar_k + kMmaStages;

  const int len = min(max(lengths[b], 0), S);
  const int n_chunks = (len + CH - 1) / CH;
  const int my_chunks = rank < n_chunks ? (n_chunks - rank + csize - 1) / csize : 0;
  const size_t head_s = (static_cast<size_t>(b) * KV + kvh) * S;  // this head's scale row
  const size_t head = head_s * D;

  auto issue = [=](int i) {  // thread 0: chunk i of this CTA into stage i % kMmaStages
    const int s0 = (rank + i * csize) * CH;
    const uint32_t bytes = static_cast<uint32_t>(min(CH, len - s0)) * D;
    const int st = i % kMmaStages;
    hp::mbar_expect_tx(&bar_k[st], bytes);
    hp::bulk_load(kring + static_cast<size_t>(st) * CH * D, kc + head + static_cast<size_t>(s0) * D,
                  bytes, &bar_k[st]);
    hp::mbar_expect_tx(&bar_v[st], bytes);
    hp::bulk_load(vring + static_cast<size_t>(st) * CH * D, vc + head + static_cast<size_t>(s0) * D,
                  bytes, &bar_v[st]);
  };
  // every thread: chunk i's scales into scale stage i % kMmaStages, one
  // cp.async group per chunk slot (empty past the last chunk)
  auto issue_scales = [&](int i) {
    if (i < my_chunks) {
      const int s0 = (rank + i * csize) * CH, n = min(CH, len - s0);
      float* dst = sc_ring + static_cast<size_t>(i % kMmaStages) * 2 * CH;
      for (int r = tid; r < n; r += kThreads) {
        cp_async4(dst + r, ksc + head_s + s0 + r);
        cp_async4(dst + CH + r, vsc + head_s + s0 + r);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    for (int st = 0; st < kMmaStages; ++st) {
      hp::mbar_init(&bar_k[st], 1);
      hp::mbar_init(&bar_v[st], 1);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kMmaStages && i < my_chunks; ++i) issue(i);
  for (int i = 0; i < kMmaStages; ++i) issue_scales(i);

  // q^T's A fragments of the score product, its rows the CTA's heads (row g:
  // head g, 0 from `heads` on; rows 8-15 are 0)
  constexpr auto kSteps = std::make_integer_sequence<int, kM>{};
  uint32_t qa[kM][2];
  if (g < heads) {
    load_q<D>(q + ((static_cast<size_t>(b) * KV * groups + hg) * heads + g) * D, t, qa, kSteps);
  } else {
#pragma unroll
    for (int s = 0; s < kM; ++s) qa[s][0] = qa[s][1] = 0u;
  }

  // this warp's split: head g's running max (the same in the quad) and this
  // lane's share of its sum; acc = PV^T, m-tile m's rows v_col<m> + v_lane<m> *
  // g and the next, columns (heads) 2t and 2t + 1
  float m_run = -INFINITY, l_run = 0.f;
  float acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  cp_async_wait<kMmaStages - 1>();  // chunk 0's scales: this thread's copies
  __syncthreads();                  // and every other thread's
  for (int i = 0; i < my_chunks; ++i) {
    const int st = i % kMmaStages;
    const uint32_t parity = (i / kMmaStages) & 1;
    const int nv = min(CH, len - (rank + i * csize) * CH);
    const int8_t* ks = kring + static_cast<size_t>(st) * CH * D;
    const int8_t* vs = vring + static_cast<size_t>(st) * CH * D;
    const float* ksc_s = sc_ring + static_cast<size_t>(st) * 2 * CH;  // this chunk's k_scale,
    const float* vsc_s = ksc_s + CH;                                  // v_scale
    hp::mbar_wait(&bar_k[st], parity);
    hp::mbar_wait(&bar_v[st], parity);
    for (int r0 = warp * 16; r0 < nv; r0 += kWarps * 16) {  // this warp's 16-row tiles
      // S^T of rows r0 + 8j + n (n = 0..7): lane g holds K row r0 + 8j + g;
      // the two halves' chains of mma interleaved
      float sc[2][4];
      uint32_t kw[2][kM];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
        load_k_row<D>(ks + (r0 + 8 * j + g) * D, t, kw[j], kSteps);
      }
#pragma unroll
      for (int s = 0; s < kM; ++s)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma_16816(sc[j], qa[s][0], 0u, qa[s][1], 0u, s8x2_to_bf16x2(kw[j][s]),
                    s8x2_to_bf16x2(kw[j][s] >> 8));
      // head g's scores of rows r0 + 2t, + 1 (j = 0) and r0 + 8 + 2t, + 1
      // (j = 1): times k_scale and the softmax scale, -inf at or past nv
      const int ra = r0 + 2 * t, rb = ra + 8;
      const float2 ka = *reinterpret_cast<const float2*>(ksc_s + ra);
      const float2 kb = *reinterpret_cast<const float2*>(ksc_s + rb);
      const float2 va = *reinterpret_cast<const float2*>(vsc_s + ra);
      const float2 vb = *reinterpret_cast<const float2*>(vsc_s + rb);
      const bool ok[4] = {ra < nv, ra + 1 < nv, rb < nv, rb + 1 < nv};
      float sv[4] = {sc[0][0] * (ka.x * scale_log2), sc[0][1] * (ka.y * scale_log2),
                     sc[1][0] * (kb.x * scale_log2), sc[1][1] * (kb.y * scale_log2)};
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[e] = ok[e] ? sv[e] : -INFINITY;
        mx = fmaxf(mx, sv[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));  // finite: row r0 < nv
      const float m_new = fmaxf(m_run, mx);
      const float corr = exp2f(m_run - m_new);
      float p[4], sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sv[e] - m_new);
        sum += p[e];  // l sums the probabilities without v_scale
      }
      l_run = l_run * corr + sum;
      m_run = m_new;
      // P^T's B fragment: p * v_scale in bf16, 0 at or past nv (a stale scale
      // there may be anything)
      const float vsv[4] = {va.x, va.y, vb.x, vb.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ok[e] ? p[e] * vsv[e] : 0.f;
      const uint32_t pb0 = pack_bf16x2(p[0], p[1]), pb1 = pack_bf16x2(p[2], p[3]);
      // acc's columns are heads 2t, 2t + 1: their corrections from lanes 8t,
      // 8t + 4 (quads 2t, 2t + 1); skipped while no head's max moved
      if (__any_sync(0xffffffffu, corr != 1.f)) {
        const float c0 = __shfl_sync(0xffffffffu, corr, 8 * t);
        const float c1 = __shfl_sync(0xffffffffu, corr, 8 * t + 4);
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          acc[m][0] *= c0;
          acc[m][1] *= c1;
          acc[m][2] *= c0;
          acc[m][3] *= c1;
        }
      }
      // PV^T: V rows ra, ra + 1, rb, rb + 1 at lane g's columns
      uint32_t vw[4][L::kVW];
      load_v_row<D>(vs + ra * D, g, vw[0], kSteps);
      load_v_row<D>(vs + (ra + 1) * D, g, vw[1], kSteps);
      load_v_row<D>(vs + rb * D, g, vw[2], kSteps);
      load_v_row<D>(vs + (rb + 1) * D, g, vw[3], kSteps);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int w = m / 2, by = 2 * (m % 2);
        mma_16816(acc[m], s8x2_to_bf16x2(__byte_perm(vw[0][w], vw[1][w], pair_sel(by))),
                  s8x2_to_bf16x2(__byte_perm(vw[0][w], vw[1][w], pair_sel(by + 1))),
                  s8x2_to_bf16x2(__byte_perm(vw[2][w], vw[3][w], pair_sel(by))),
                  s8x2_to_bf16x2(__byte_perm(vw[2][w], vw[3][w], pair_sel(by + 1))), pb0, pb1);
      }
    }
    cp_async_wait<kMmaStages - 2>();  // chunk i + 1's scales (issued chunks ago)
    __syncthreads();  // stage st is free; chunk i + 1's scales are visible
    if (tid == 0 && i + kMmaStages < my_chunks) issue(i + kMmaStages);
    issue_scales(i + kMmaStages);
  }

  // This warp's partial into shared memory: m and l of head g (l summed over
  // the quad), acc into the idle ring as [warp][head][column]; then the
  // CTA's partial, the warps merged by their maxima.
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (t == 0) {
    wstat[warp * 8 + g] = m_run;
    wstat[(kWarps + warp) * 8 + g] = l_run;
  }
  float* red = reinterpret_cast<float*>(kring);  // kWarps x 8 x D, in the ring
  store_acc<D>(red + (warp * 8 + 2 * t) * D, g, acc, kSteps);
  __syncthreads();
  for (int idx = tid; idx < heads * D; idx += kThreads) {
    const int h = idx / D;
    float mw[kWarps], mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = wstat[w * 8 + h];
      mx = fmaxf(mx, mw[w]);
    }
    const float mu = mx == -INFINITY ? 0.f : mx;  // no warp of this CTA had a row
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(mw[w] - mu);
      a = fmaf(red[w * 8 * D + idx], e, a);
      l = fmaf(wstat[(kWarps + w) * 8 + h], e, l);
    }
    part_acc[idx] = a;
    if (idx % D == 0) {
      part_m[h] = mx;
      part_l[h] = l;
    }
  }

  const size_t heads0 = (static_cast<size_t>(b) * KV * groups + hg) * heads;  // CTA's first head
  cluster_merge<__nv_bfloat16, D>(cluster, heads, part_m, part_l, part_acc, out + heads0 * D,
                                  lse == nullptr ? nullptr : lse + heads0);
}

// The cache pointers and scales of one call: C is the cache's element type.
struct CacheArgs {
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
};

// One launch of `kernel` on the grid (cluster, KV * groups, B), in clusters of
// `cluster` CTAs along x, with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel* kernel, rt::SmemOptIn& optin, size_t smem, int B, int KV,
                            int groups, int cluster, int device, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = optin.ensure(kernel, device, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KV * groups, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename C, int D, int NREP>
cudaError_t launch(const void* q, CacheArgs c, const int* lengths, void* out, float* lse, int B,
                   int KV, int groups, int S, int cluster, int CH, float scale_log2, int device,
                   cudaStream_t stream) {
  static rt::SmemOptIn optin;
  return launch_clusters(decode_attention_kernel<T, C, D, NREP>, optin, Shape<C, D, NREP>::smem(CH),
                         B, KV, groups, cluster, device, stream, static_cast<const T*>(q),
                         static_cast<const C*>(c.k), static_cast<const C*>(c.v), c.k_scale,
                         c.v_scale, lengths, static_cast<T*>(out), lse, KV, groups, S, CH,
                         scale_log2);
}

// The shared-memory opt-in of decode_int8_mma_kernel<D>, one for its launches
// and its occupancy queries: a second record could lower the attribute
// below what the first believes is set.
template <int D>
rt::SmemOptIn& mma_optin() {
  static rt::SmemOptIn optin;
  return optin;
}

// the int8 cache under a bf16 q: heads (1..8) query heads per CTA
template <int D>
cudaError_t launch_mma(int heads, const void* q, CacheArgs c, const int* lengths, void* out,
                       float* lse, int B, int KV, int groups, int S, int cluster, int CH,
                       int ring, float scale_log2, int device, cudaStream_t stream) {
  if (heads < 1 || heads > 8 || CH % 16 != 0 || ring < 1 || ring > kMmaStages)
    return cudaErrorInvalidValue;
  return launch_clusters(decode_int8_mma_kernel<D>, mma_optin<D>(), Mma<D>::smem(CH, ring), B, KV,
                         groups, cluster, device, stream, static_cast<const __nv_bfloat16*>(q),
                         static_cast<const int8_t*>(c.k), static_cast<const int8_t*>(c.v),
                         c.k_scale, c.v_scale, lengths, static_cast<__nv_bfloat16*>(out), lse, KV,
                         groups, heads, S, CH, ring, scale_log2);
}

cudaError_t launch_mma_d(int D, int heads, const void* q, CacheArgs c, const int* len, void* out,
                         float* lse, int B, int KV, int g, int S, int cl, int ch, int ring,
                         float sl, int dev, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_mma<16>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, ring, sl, dev,
                             s);
    case 32:
      return launch_mma<32>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, ring, sl, dev,
                             s);
    case 64:
      return launch_mma<64>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, ring, sl, dev,
                             s);
    case 80:
      return launch_mma<80>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, ring, sl, dev,
                             s);
    case 128:
      return launch_mma<128>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, ring, sl, dev,
                             s);
    case 192:
      return launch_mma<192>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, ring, sl, dev,
                             s);
    default:
      return cudaErrorInvalidValue;
  }
}

// heads: query heads per CTA (n_rep / groups)
template <typename T, typename C, int D>
cudaError_t launch_rep(int heads, const void* q, CacheArgs c, const int* len, void* out, float* lse,
                       int B, int KV, int g, int S, int cl, int ch, float sl, int dev,
                       cudaStream_t s) {
  switch (heads) {
    case 1:
      return launch<T, C, D, 1>(q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 2:
      return launch<T, C, D, 2>(q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 3:
      return launch<T, C, D, 3>(q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 4:
      return launch<T, C, D, 4>(q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 6:
      return launch<T, C, D, 6>(q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 8:
      return launch<T, C, D, 8>(q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename C>
cudaError_t launch_d(int D, int heads, const void* q, CacheArgs c, const int* len, void* out,
                     float* lse, int B, int KV, int g, int S, int cl, int ch, float sl, int dev,
                     cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_rep<T, C, 16>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 32:
      return launch_rep<T, C, 32>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 64:
      return launch_rep<T, C, 64>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 80:
      return launch_rep<T, C, 80>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 128:
      return launch_rep<T, C, 128>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    case 192:
      return launch_rep<T, C, 192>(heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q's type T, and the cache's: T, or int8 (quant) with scales (under a bf16 q
// on the tensor cores)
template <typename T>
cudaError_t launch_t(bool quant, int D, int heads, const void* q, CacheArgs c, const int* len,
                     void* out, float* lse, int B, int KV, int g, int S, int cl, int ch, int ring,
                     float sl, int dev, cudaStream_t s) {
  if (quant) {
    if constexpr (sizeof(T) == 2)  // bf16 q: the tensor-core route
      return launch_mma_d(D, heads, q, c, len, out, lse, B, KV, g, S, cl, ch, ring, sl, dev, s);
    else
      return launch_d<T, int8_t>(D, heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
  }
  return launch_d<T, T>(D, heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
}

}  // namespace

// groups: CTA clusters per KV head, each over n_rep / groups of its query
// heads; cluster: CTAs per (sequence, KV head, group), 1..8; chunk: cache
// rows per bulk copy; ring: the stages of the tensor-core route's ring (1 to
// kMmaStages; the CUDA-core loop always has kStages).  All four come from the
// wrapper's decode_plan.  The caches must be 16-byte aligned.  quant: the
// caches are int8 and k_scale / v_scale their f32 (B, KV, S) scales (nullptr
// otherwise).  lse: null, or an f32 (B, H) array for each head's log-sum-exp
// (see the header).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* lengths, void* out, void* lse, int B, int H,
                                       int KV, int S, int D, int groups, int cluster, int chunk,
                                       int ring, float softmax_scale, int dtype, int quant,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (KV == 0 || groups < 1 || H % (KV * groups) != 0 || S == 0 || cluster < 1 ||
      cluster > kMaxCluster || chunk < 1)
    return cudaErrorInvalidValue;
  if (!rt::aligned16(k) || !rt::aligned16(v) || !rt::aligned16(q))
    return cudaErrorMisalignedAddress;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  const float sl = softmax_scale * 1.4426950408889634f;
  const int* len = static_cast<const int*>(lengths);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CacheArgs c{k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  const int heads = H / (KV * groups);
  switch (dtype) {
    case rt::kF32:
      return launch_t<float>(quant != 0, D, heads, q, c, len, out, lf, B, KV, groups, S,
                             cluster, chunk, ring, sl, device, s);
    case rt::kBF16:
      return launch_t<__nv_bfloat16>(quant != 0, D, heads, q, c, len, out, lf, B, KV, groups,
                                     S, cluster, chunk, ring, sl, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

namespace {

template <typename C, int D>
int fma_smem(int heads, int chunk) {
  switch (heads) {
    case 1: return static_cast<int>(Shape<C, D, 1>::smem(chunk));
    case 2: return static_cast<int>(Shape<C, D, 2>::smem(chunk));
    case 3: return static_cast<int>(Shape<C, D, 3>::smem(chunk));
    case 4: return static_cast<int>(Shape<C, D, 4>::smem(chunk));
    case 6: return static_cast<int>(Shape<C, D, 6>::smem(chunk));
    case 8: return static_cast<int>(Shape<C, D, 8>::smem(chunk));
    default: return -1;
  }
}

template <int D>
int route_smem(int heads, int dtype, int quant, int chunk, int ring) {
  if (dtype == rt::kBF16 && quant) return static_cast<int>(Mma<D>::smem(chunk, ring));
  if (quant) return fma_smem<int8_t, D>(heads, chunk);
  return dtype == rt::kF32 ? fma_smem<float, D>(heads, chunk)
                           : fma_smem<__nv_bfloat16, D>(heads, chunk);
}

}  // namespace

// A CTA's dynamic shared memory for q of `dtype`, the cache int8 (quant) or
// of q's dtype, `heads` query heads a CTA, chunks of `chunk` rows and `ring`
// stages (the tensor-core route's; the CUDA-core loop has kStages); -1 for a
// D or head count the kernel lacks.  The wrapper's plan counts the same
// (decode_attention.fma_smem and mma_smem).
extern "C" int decode_attention_smem(int D, int heads, int dtype, int quant, int chunk, int ring) {
  switch (D) {
    case 16: return route_smem<16>(heads, dtype, quant, chunk, ring);
    case 32: return route_smem<32>(heads, dtype, quant, chunk, ring);
    case 64: return route_smem<64>(heads, dtype, quant, chunk, ring);
    case 80: return route_smem<80>(heads, dtype, quant, chunk, ring);
    case 128: return route_smem<128>(heads, dtype, quant, chunk, ring);
    case 192: return route_smem<192>(heads, dtype, quant, chunk, ring);
    default: return -1;
  }
}

namespace {

// How many clusters of `cluster` CTAs of the tensor-core route at head dim D
// (chunks of `chunk` rows, `ring` stages) the device can hold at once
// (cudaOccupancyMaxActiveClusters); -1 on an error.
template <int D>
int mma_clusters(int chunk, int ring, int cluster, int device) {
  auto kernel = decode_int8_mma_kernel<D>;
  const size_t smem = Mma<D>::smem(chunk, ring);
  if (cudaSetDevice(device) != cudaSuccess ||
      mma_optin<D>().ensure(kernel, device, smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1024, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace

extern "C" int decode_int8_mma_clusters(int D, int chunk, int ring, int cluster, int device) {
  switch (D) {
    case 16: return mma_clusters<16>(chunk, ring, cluster, device);
    case 32: return mma_clusters<32>(chunk, ring, cluster, device);
    case 64: return mma_clusters<64>(chunk, ring, cluster, device);
    case 80: return mma_clusters<80>(chunk, ring, cluster, device);
    case 128: return mma_clusters<128>(chunk, ring, cluster, device);
    case 192: return mma_clusters<192>(chunk, ring, cluster, device);
    default: return -1;
  }
}
