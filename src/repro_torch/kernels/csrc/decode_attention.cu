// Single-token GQA decode attention over a padded (B, KV, S, D) cache for
// Hopper (sm_90a): one launch, a thread-block cluster per (sequence, KV head).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (_decode_kernel / decode_attention).  q (B, H, D), k/v (B, KV, S, D),
// lengths (B,) int32, clamped to [0, S]; positions >= the length are masked;
// the output is acc / max(l, 1e-30), so a row of length 0 gives 0.
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
//   XOR butterfly over a power-of-two group, else a shift-down tree that
//   stays inside the group.
// * A thread keeps its query and output slice of every head of the CTA in
//   registers (2 x heads x 8 floats at most), so a CTA takes at most 8 of
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

template <typename T, int D, int NREP>
struct Shape {
  static constexpr int VE = 16 / sizeof(T);             // elements per 16-byte load
  static constexpr int NV = (D / VE + 31) / 32;         // 16-byte vectors per lane per row
  static constexpr int EL = NV * VE;                    // elements per lane per row
  static constexpr int TD = D / EL;                     // threads along one row (2..32)
  static constexpr int RPW = 32 / TD;                   // rows per warp per pass
  static constexpr int RP = kWarps * RPW;               // rows per CTA pass (and PV row groups)
  static constexpr int HPW = (NREP + kWarps - 1) / kWarps;  // softmax heads per warp
  static_assert(TD >= 2 && TD <= 32 && D % EL == 0, "unsupported head dim");
  static_assert(NREP <= 8, "at most 8 query heads per CTA (corr, m and l hold 8)");
  // the first column of this lane's vector j of a row
  __device__ static int col(int lane, int j) { return (j * TD + lane % TD) * VE; }

  // Dynamic shared memory for chunks of `ch` rows: [K ring | V ring | scores
  // (NREP x ch) | corr (NREP) | partial m, l (NREP each) | partial acc (NREP
  // x D) | barriers].  The cross-warp reduction of acc (kWarps x NREP x D
  // f32) reuses the ring once the chunks are done.
  __host__ __device__ static size_t up16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }
  __host__ __device__ static size_t chunk_bytes(int ch) {
    return static_cast<size_t>(ch) * D * sizeof(T);
  }
  __host__ __device__ static size_t scores_off(int ch) {
    const size_t ring = 2 * kStages * chunk_bytes(ch), red = kWarps * NREP * D * 4;
    return ring > red ? ring : red;
  }
  __host__ __device__ static size_t corr_off(int ch) {
    return up16(scores_off(ch) + static_cast<size_t>(NREP) * ch * 4);
  }
  // corr[8], then the partial's m[8] and l[8]
  __host__ __device__ static size_t part_off(int ch) { return corr_off(ch) + 8 * 4; }
  __host__ __device__ static size_t acc_off(int ch) { return part_off(ch) + 16 * 4; }
  __host__ __device__ static size_t bar_off(int ch) { return acc_off(ch) + NREP * D * 4; }
  __host__ __device__ static size_t smem(int ch) { return bar_off(ch) + 8 * 2 * kStages; }
};

// Sum of v over a group of N lanes STRIDE apart, this lane being member i
// (0 <= i < N for the group's lanes), exact at member 0.  Where N is a power
// of two the groups tile the warp and an XOR butterfly gives every member
// the sum (on the H100 the tree alone made bf16 decode at D = 128 slower).
// Else a shift-down tree whose adds stay inside the group: offsets from the
// largest power of two below N down to 1; after offset o, member i < o holds
// the sum of members i, i + o, i + 2o, ...
template <int N, int STRIDE>
__device__ __forceinline__ float group_sum(float v, int i) {
  if constexpr ((N & (N - 1)) == 0) {
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

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                            const T* __restrict__ vc, const int* __restrict__ lengths,
                            T* __restrict__ out, int KV, int groups, int S, int CH,
                            float scale_log2) {
  using SH = Shape<T, D, NREP>;
  using Vec = rt::Vec<T, SH::VE>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  // blockIdx.y: group g of KV head kvh's query heads, kvh * groups + g; its
  // NREP heads are kvh * groups * NREP + g * NREP + r = blockIdx.y * NREP + r
  const int hg = blockIdx.y, kvh = hg / groups, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) uint8_t smem[];
  T* kring = reinterpret_cast<T*>(smem);
  T* vring = kring + static_cast<size_t>(kStages) * CH * D;
  float* ps = reinterpret_cast<float*>(smem + SH::scores_off(CH));
  float* corr_s = reinterpret_cast<float*>(smem + SH::corr_off(CH));
  float* part_m = reinterpret_cast<float*>(smem + SH::part_off(CH));
  float* part_l = part_m + 8;
  float* part_acc = reinterpret_cast<float*>(smem + SH::acc_off(CH));
  uint64_t* bar_k = reinterpret_cast<uint64_t*>(smem + SH::bar_off(CH));
  uint64_t* bar_v = bar_k + kStages;

  const int len = min(max(lengths[b], 0), S);
  const int n_chunks = (len + CH - 1) / CH;
  const int my_chunks = rank < n_chunks ? (n_chunks - rank + csize - 1) / csize : 0;
  const size_t head = (static_cast<size_t>(b) * KV + kvh) * S * D;

  auto issue = [=](int i) {  // thread 0: chunk i of this CTA into stage i % kStages
    const int s0 = (rank + i * csize) * CH;
    const uint32_t bytes = static_cast<uint32_t>(min(CH, len - s0)) * D * sizeof(T);
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
  if (tid == 0)
    for (int i = 0; i < kStages && i < my_chunks; ++i) issue(i);

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
    for (int j = 0; j < SH::NV; ++j) {
      const Vec v = *reinterpret_cast<const Vec*>(qh + r * D + SH::col(lane, j));
#pragma unroll
      for (int e = 0; e < SH::VE; ++e) qr[r][j * SH::VE + e] = rt::to_float(v.e[e]) * scale_log2;
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
    const T* ks = kring + static_cast<size_t>(st) * CH * D;
    const T* vs = vring + static_cast<size_t>(st) * CH * D;

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
          const Vec kv = *reinterpret_cast<const Vec*>(ks + row * D + SH::col(lane, j));
#pragma unroll
          for (int e = 0; e < SH::VE; ++e) {
            const float kf = rt::to_float(kv.e[e]);
#pragma unroll
            for (int r = 0; r < NREP; ++r) dot[r] = fmaf(qr[r][j * SH::VE + e], kf, dot[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) dot[r] = group_sum<SH::TD, 1>(dot[r], lane % SH::TD);
      if (ok && lane % SH::TD == 0) {
#pragma unroll
        for (int r = 0; r < NREP; ++r) ps[r * CH + row] = dot[r];
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
          ps[r * CH + j] = p;
          sum += p;
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
      for (int j = 0; j < SH::NV; ++j) {
        const Vec vv = *reinterpret_cast<const Vec*>(vs + row * D + SH::col(lane, j));
#pragma unroll
        for (int e = 0; e < SH::VE; ++e) vf[j * SH::VE + e] = rt::to_float(vv.e[e]);
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float p = ps[r * CH + row];
#pragma unroll
        for (int e = 0; e < SH::EL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
    __syncthreads();  // stage st and the scores are free again
    if (tid == 0 && i + kStages < my_chunks) issue(i + kStages);
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
  }
  cluster.sync();  // every CTA's shared memory stays alive until its peers have read it
}

template <typename T, int D, int NREP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   int B, int KV, int groups, int S, int cluster, int CH, float scale_log2,
                   int device, cudaStream_t stream) {
  using SH = Shape<T, D, NREP>;
  auto kernel = decode_attention_kernel<T, D, NREP>;
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), lengths, static_cast<T*>(out), KV, groups,
                           S, CH, scale_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// heads: query heads per CTA (n_rep / groups)
template <typename T, int D>
cudaError_t launch_rep(int heads, const void* q, const void* k, const void* v, const int* len,
                       void* out, int B, int KV, int g, int S, int cl, int ch, float sl, int dev,
                       cudaStream_t s) {
  switch (heads) {
    case 1:
      return launch<T, D, 1>(q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 2:
      return launch<T, D, 2>(q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 3:
      return launch<T, D, 3>(q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 4:
      return launch<T, D, 4>(q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 6:
      return launch<T, D, 6>(q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 8:
      return launch<T, D, 8>(q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(int D, int heads, const void* q, const void* k, const void* v,
                     const int* len, void* out, int B, int KV, int g, int S, int cl, int ch,
                     float sl, int dev, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_rep<T, 16>(heads, q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 32:
      return launch_rep<T, 32>(heads, q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 64:
      return launch_rep<T, 64>(heads, q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 80:
      return launch_rep<T, 80>(heads, q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 128:
      return launch_rep<T, 128>(heads, q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    case 192:
      return launch_rep<T, 192>(heads, q, k, v, len, out, B, KV, g, S, cl, ch, sl, dev, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// groups: CTA clusters per KV head, each over n_rep / groups of its query
// heads; cluster: CTAs per (sequence, KV head, group), 1..8; chunk: cache
// rows per bulk copy.  All three come from the wrapper's decode_plan.  The
// caches must be 16-byte aligned.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int H, int KV,
                                       int S, int D, int groups, int cluster, int chunk,
                                       float softmax_scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  if (KV == 0 || groups < 1 || H % (KV * groups) != 0 || S == 0 || cluster < 1 ||
      cluster > kMaxCluster || chunk < 1)
    return cudaErrorInvalidValue;
  if (!rt::aligned16(k) || !rt::aligned16(v) || !rt::aligned16(q))
    return cudaErrorMisalignedAddress;
  const float sl = softmax_scale * 1.4426950408889634f;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return launch_d<float>(D, H / (KV * groups), q, k, v, len, out, B, KV, groups, S, cluster,
                             chunk, sl, device, s);
    case rt::kBF16:
      return launch_d<__nv_bfloat16>(D, H / (KV * groups), q, k, v, len, out, B, KV, groups, S,
                                     cluster, chunk, sl, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
