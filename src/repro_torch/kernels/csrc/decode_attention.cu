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
// kernel takes no int8).  There the scores are scale * (q . k) * k_scale,
// softmax'ed, and the probabilities times v_scale weight the int8 V rows.
// Here k_scale multiplies each score after the dot (in the log2 domain);
// the running denominator l sums exp2(s - m) without v_scale, and acc adds
// (p * v_scale[row]) * v[row], which after the final acc / l is the
// reference's order: normalise, then scale.  The bulk copies move the int8
// rows (D bytes each).  The scales, 4 bytes a row at offsets that are
// multiples of 16 only for some S, ride beside them in a ring of their own:
// every thread copies a few of a chunk's valid rows by 4-byte cp.async,
// issued with the chunk's bulk copies, so no load waits inside the chunk's
// passes (a global load there left each pass waiting on device memory).
// int8 becomes f32 by integer ops and one exact add (int8x4_to_float), not
// by the quarter-rate I2F.  A lane takes 16 int8 values of a row where the
// CTA holds at most 4 heads (half the shuffles per row of 8-value vectors),
// and 8 above: 16 would put 8 heads' q and acc at 256 registers.
//
// Bound on the H100: bytes.  Every valid cache row is read once per step and
// takes 2*D flops per query head (about 2*n_rep flops per byte), so the
// design keeps as many cache bytes in flight as it can and does the
// arithmetic with FMAs from shared memory.  The TPU grid walks S in order per
// (sequence, KV head); on the H100 that would be B*KV CTAs (32 at the serving
// batch) for 132 SMs, so the sequence is split across the CTAs of a cluster
// (flash-decoding) and merged inside the same launch:
//
// * Grid (cluster, KV, B) with a cluster of `cluster` CTAs along x (set at
//   launch; the wrapper's decode_plan picks it and the chunk rows).  Chunk c
//   (rows [c*CH, c*CH + CH) below the length) belongs to cluster rank
//   c % cluster; a CTA walks its chunks in a 2-stage ring.
// * In the cache a chunk of one (sequence, KV head) is one contiguous block,
//   so thread 0 fetches a chunk's K and its V with one 1-D bulk copy each
//   (cp.async.bulk), completing on an mbarrier.  Only the valid rows are
//   copied (min(CH, len - s0) rows, from the device-side length), so the
//   kernel reads the bytes the bound counts.
// * Scores: threads along D (16-byte loads, conflict-free), n_rep partial
//   dots per thread reduced across the row's lanes; each K row is read once
//   for the query heads of the CTA that share it.  Online softmax per head
//   by one warp (warp w takes heads w, w + 4, ...); PV with threads along D
//   over the chunk's rows.
// * A row takes TD lanes of NV 16-byte vectors each (NV = 1, or 2 where one
//   vector a lane would need more than a warp: D = 192 in f32 is 48
//   vectors, so 24 lanes of two, the second 24 vectors further along the
//   row), and a warp 32 / TD whole rows.  Where TD does not divide 32 (D =
//   80: 10 or 20 lanes; D = 192: 24) a warp holds 3, 1 or 1 rows in its
//   first 30, 20 or 24 lanes and the rest idle.  Lane sums (a row's TD
//   lanes; the rows of one warp, TD lanes apart) go through group_sum: an
//   XOR butterfly over a power-of-two group at a power-of-two stride, else a
//   shift-down tree that stays inside the group.
// * A thread keeps its query and output slice of every head of the CTA in
//   registers (2 x heads x EL floats, 128 at most), so a CTA takes at most 8 of
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

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
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

  cluster.sync();  // every partial of the cluster is written
  // The merge is spread over the cluster: rank c writes the outputs idx =
  // c*kThreads + tid, c*kThreads + tid + cluster*kThreads, ...  Each reads
  // the partials of its head from every rank through distributed shared
  // memory, all loads issued before any is used (ranks past the cluster
  // size repeat the last one and get weight 0).
  T* o = out + (static_cast<size_t>(b) * KV * groups + hg) * NREP * D;  // heads hg*NREP + r
  for (int idx = rank * kThreads + tid; idx < NREP * D; idx += csize * kThreads) {
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
    if (lse != nullptr && idx % D == 0)  // one thread a head: its log-sum-exp
      lse[(static_cast<size_t>(b) * KV * groups + hg) * NREP + r] =
          l > 0.f ? mu + log2f(l) : -INFINITY;
  }
  cluster.sync();  // every CTA's shared memory stays alive until its peers have read it
}

// The cache pointers and scales of one call: C is the cache's element type.
struct CacheArgs {
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
};

template <typename T, typename C, int D, int NREP>
cudaError_t launch(const void* q, CacheArgs c, const int* lengths, void* out, float* lse, int B,
                   int KV, int groups, int S, int cluster, int CH, float scale_log2, int device,
                   cudaStream_t stream) {
  using SH = Shape<C, D, NREP>;
  auto kernel = decode_attention_kernel<T, C, D, NREP>;
  const size_t smem = SH::smem(CH);
  static rt::SmemOptIn optin;
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const C*>(c.k),
                           static_cast<const C*>(c.v), c.k_scale, c.v_scale, lengths,
                           static_cast<T*>(out), lse, KV, groups, S, CH, scale_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// q's type T, and the cache's: T, or int8 (quant) with scales
template <typename T>
cudaError_t launch_t(bool quant, int D, int heads, const void* q, CacheArgs c, const int* len,
                     void* out, float* lse, int B, int KV, int g, int S, int cl, int ch, float sl,
                     int dev, cudaStream_t s) {
  if (quant)
    return launch_d<T, int8_t>(D, heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
  return launch_d<T, T>(D, heads, q, c, len, out, lse, B, KV, g, S, cl, ch, sl, dev, s);
}

}  // namespace

// groups: CTA clusters per KV head, each over n_rep / groups of its query
// heads; cluster: CTAs per (sequence, KV head, group), 1..8; chunk: cache
// rows per bulk copy.  All three come from the wrapper's decode_plan.  The
// caches must be 16-byte aligned.  quant: the caches are int8 and k_scale /
// v_scale their f32 (B, KV, S) scales (nullptr otherwise).  lse: null, or an
// f32 (B, H) array for each head's log-sum-exp (see the header).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* lengths, void* out, void* lse, int B, int H,
                                       int KV,
                                       int S, int D, int groups, int cluster, int chunk,
                                       float softmax_scale, int dtype, int quant, int device,
                                       void* stream) {
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
                             cluster, chunk, sl, device, s);
    case rt::kBF16:
      return launch_t<__nv_bfloat16>(quant != 0, D, heads, q, c, len, out, lf, B, KV, groups,
                                     S, cluster, chunk, sl, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
