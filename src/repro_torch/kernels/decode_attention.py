"""Single-token GQA decode attention on the card (wrapper of
``csrc/decode_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``_decode_kernel`` / ``decode_attention``).  Bound on the H100: bytes (each
valid cache row is read once per step).  One launch per call: a thread-block
cluster of CTAs per (sequence, KV head) splits the sequence into chunks
(flash-decoding), each chunk's valid K and V rows arrive by one bulk copy
each into a shared-memory ring of 2 stages (3 on the int8 cache's
tensor-core route), the n_rep query heads that share a KV
head share every cache read, and the cluster's CTAs merge their partial
(max, sum, acc) through distributed shared memory, each a slice of the
output.  No scratch tensor and no second kernel.  :func:`decode_plan` sizes
the cluster and the chunks, and splits an n_rep above 8 (nemotron's 12, or
32 query heads over one KV head) into equal groups of heads, each its own
cluster over the same cache rows.  Head dims 16, 32, 64, 80 (zamba2's
shared block, a row of 10 or 20 lanes that leaves the rest of the warp
idle), 128 and 192 (nemotron: a row of 24 lanes, each of one 16-byte vector
in bf16 and two in f32); an n_rep whose groups hold 1, 2, 3, 4, 6 or 8
heads (``N_REPS``); any other D or n_rep raises.

The cache is of q's dtype, or int8 with f32 ``k_scale``/``v_scale`` (B, KV,
S) (``kvcache.init_kv_cache(quant=True)``): the int8 branch of the JAX
package's ``decode_attention_reference`` (jnp; its Pallas kernel takes no
int8), for a bf16 or f32 q at every D and n_rep above.  The bulk copies move
the int8 rows; the valid rows' scales ride beside them in a ring of their
own, by 4-byte asynchronous copies.  Bound: bytes, the valid int8 K and V
rows plus 8 bytes of scales a row, q and the output.  Under a bf16 q both
products run on the tensor cores (``mma.sync`` m16n8k16, bf16 operands, f32
sums), as the reference's arithmetic allows: K cast to bf16 exactly, q . k
summed in f32 and scaled by k_scale there, p * v_scale rounded to bf16 (the
reference's rounding point) before PV.  Scores as S^T = q K^T (the 8 head
columns of a CTA in the tile's rows), whose accumulators are PV^T's B
operand as they stand; the contraction over D is permuted alike for q and K
so that a lane's 16-byte loads feed whole operands, and PV's head-dim
columns so that a lane holds two neighbouring bytes of each 16-column tile.
Each warp keeps its own online softmax over its 16-row tiles; the warps
merge by their maxima before the cluster does.  On this route a short
cache (up to 2,048 rows) takes one chunk of about 256 rows a CTA; a long
one takes chunks of 64 rows or more (a tile for each warp) in a 3-stage
ring sized so that 4 CTAs share an SM, and the cluster size (2 to 8) whose
waves the card fills best, from the clusters it holds at once
(``cudaOccupancyMaxActiveClusters``; ``decode_plan``).
Under an f32 q the CUDA-core loop stays: the reference casts K to f32
there, and neither bf16 nor TF32 operands would hold its 3e-5.

``return_lse=True`` also returns each head's log-sum-exp, (B, H) f32 in the
log2 domain of the scaled scores (as flash's ``return_lse``), from the
kernel's own merge: the partial that flash-decoding over a sequence-sharded
cache merges (``ops.merge_partials``).  A row of length 0 gives out 0 and
lse ``-inf``, weight 0 in that merge; the flash kernels' ``+inf`` for a row
with no key serves their backward and is not this convention.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Callable
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 128, 192)
GROUP_HEADS = (1, 2, 3, 4, 6, 8)  # the kernel's instantiations: query heads a CTA serves
MAX_HEADS_PER_CTA = 8  # query heads whose q and output slices a thread keeps in registers

launches = 0  # kernel launches since the last reset (see ops.reset_launch_counts)
lse_launches = 0  # those of them that also wrote the log-sum-exp

N_SM = 132  # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8  # the portable thread-block cluster size
RING_BYTES = 64 * 1024  # shared memory of the 2-stage ring: 2 x (a K and a V chunk)
STAGES, MMA_STAGES, WARPS = 2, 3, 4  # ring stages (CUDA-core loop, tensor-core route), warps a CTA
MMA_MIN_CHUNK = 64  # one 16-row tile for each of the CTA's 4 warps
MMA_SHORT_ROWS = 256  # a short cache's rows a CTA, in one chunk
MMA_CTAS_PER_SM = {16: 4, 32: 4, 64: 4, 80: 4, 128: 4, 192: 3}  # the tensor-core route's registers allow
SMEM_PER_BLOCK = 232_448  # the dynamic shared memory a block may use on an H100
SMEM_PER_SM = 233_472  # an SM's shared memory, 1 KB of it reserved for each resident block


@dataclass(frozen=True)
class DecodePlan:
    """How the kernel splits one call: the n_rep query heads of a KV head in
    ``groups`` groups, a cluster of ``cluster`` CTAs per (sequence, KV head,
    group), the grid ``(cluster, KV * groups, B)``, chunks of ``chunk``
    cache rows, and at most ``chunks_per_cta`` chunks per CTA.  Chunk ``c``
    (rows ``[c*chunk, (c+1)*chunk)``) belongs to cluster rank ``c %
    cluster``, as the kernel walks it, in every group's cluster.  ``ring``:
    the stages of the ring of chunks, ``smem`` a CTA's dynamic shared memory
    in bytes, as the kernel lays them out."""

    groups: int
    cluster: int
    chunk: int
    chunks_per_cta: int
    grid: tuple[int, int, int]
    ring: int
    smem: int

    def rows_of(self, rank: int, length: int) -> list[int]:
        """The cache rows below ``length`` that cluster rank ``rank`` reads."""
        rows: list[int] = []
        for c in range(rank, -(-length // self.chunk), self.cluster):
            rows.extend(range(c * self.chunk, min((c + 1) * self.chunk, length)))
        return rows


def head_groups(n_rep: int) -> int:
    """The fewest groups that split n_rep into equal groups of at most
    ``MAX_HEADS_PER_CTA`` heads (12 -> 2 groups of 6)."""
    g = -(-n_rep // MAX_HEADS_PER_CTA)
    while n_rep % g:
        g += 1
    return g


# the n_rep (up to 128) whose equal groups are an instantiation
N_REPS = tuple(n for n in range(1, 129) if n // head_groups(n) in GROUP_HEADS)


def fma_smem(d: int, heads: int, elem_bytes: int, quant: bool, chunk: int) -> int:
    """Dynamic shared memory of the CUDA-core loop (``Shape::smem`` in the
    source): the ring (or the warps' acc after it), the scores, the int8
    scale ring, corr, the partial's m, l and acc, the barriers."""
    ring, red = 2 * STAGES * chunk * d * elem_bytes, WARPS * heads * d * 4
    scales = max(ring, red) + heads * chunk * 4 + (STAGES * 2 * chunk * 4 if quant else 0)
    return -(-scales // 16) * 16 + 8 * 4 + 16 * 4 + heads * d * 4 + 8 * 2 * STAGES


def mma_smem(d: int, chunk: int, ring: int) -> int:
    """Dynamic shared memory of the tensor-core route (``Mma::smem`` in the
    source) with ``ring`` stages: the int8 ring (or the warps' acc, 8 heads
    wide, after it), the scale ring, each warp's m and l, the partial's m, l
    and acc, the barriers."""
    ring_b, red = 2 * ring * chunk * d, WARPS * 8 * d * 4
    return (max(ring_b, red) + ring * 2 * chunk * 4 + 2 * WARPS * 8 * 4 + 16 * 4 + 8 * d * 4
            + 8 * 2 * MMA_STAGES)


def decode_plan(b: int, kv: int, s: int, d: int, elem_bytes: int, n_rep: int = 1, *,
                mma: bool = False,
                clusters_fit: Callable[[int, int, int, int], int] | None = None) -> DecodePlan:
    """Head groups, cluster size and chunk rows for a (B, KV, S, D) cache of
    ``elem_bytes`` elements (the cache's: 1 for int8) read by n_rep query
    heads per KV head; ``mma``: the int8 cache under a bf16 q (the
    tensor-core route), whose cluster size follows ``clusters_fit(d, chunk,
    ring, cluster)``, the clusters a card holds at once (on a card
    ``clusters_fit_on(device)``; without one, every SM full).

    The CUDA-core loop's cluster grows (up to 8) until the B*KV*groups
    clusters give at least two CTAs per SM.  Its chunk is the rows one CTA
    would own with one chunk each, rounded up to 16 and capped at the
    largest power of two of rows for which the 2-stage ring of K and V
    chunks fits ``RING_BYTES`` (64 rows at D = 80 and 32 at D = 192 in bf16,
    16 at D = 192 in f32): at the serving shape (B=4, KV=8, S=1024, D=128,
    bf16) that is clusters of 8 and chunks of 64 rows (16 KB per copy), two
    per CTA.  The cluster never exceeds the number of chunks.

    The tensor-core route splits a short cache (at most 8 x
    ``MMA_SHORT_ROWS`` rows) into one chunk of about 256 rows a CTA: such a
    call is held by latency, and on an H100 one wave of few CTAs beats more,
    smaller ones (zamba2's 4 x 32/32 x 552: clusters of 3, 0.01253 ms,
    against 7, 0.01648, whose 128 clusters take two waves).  A long cache
    gets chunks of 64 rows or more (the largest power of two whose 3-stage
    ring leaves room for 4 CTAs an SM, 3 at D = 192), and of clusters of 2
    to 8 CTAs the one whose size times the use of its waves (the clusters
    over the waves' room) is largest: at 8 x 32/8 x 32k x 128, where an
    H100 holds 62 clusters of 8 at once, 64 clusters of 7 (69 fit) in one
    wave rather than 62 + 2 in two (0.213 against 0.246 ms).
    """
    groups = head_groups(n_rep)
    heads, clusters = n_rep // groups, b * kv * groups
    if not mma:
        cluster = 1
        while cluster < MAX_CLUSTER and clusters * cluster < 2 * N_SM:
            cluster *= 2
        per_cta = -(-s // cluster)
        fit = RING_BYTES // (4 * d * elem_bytes)
        chunk = min(max(16, 1 << (fit.bit_length() - 1)), 16 * -(-per_cta // 16))
        n_chunks = -(-s // chunk)
        cluster = min(cluster, n_chunks)
        return DecodePlan(groups, cluster, chunk, -(-n_chunks // cluster), (cluster, kv * groups, b),
                          STAGES, fma_smem(d, heads, elem_bytes, elem_bytes == 1, chunk))
    if s <= MMA_SHORT_ROWS * MAX_CLUSTER:  # a short cache: one chunk of about 256 rows a CTA
        cluster = -(-s // MMA_SHORT_ROWS)
        chunk = 16 * -(-(-(-s // cluster)) // 16)
        cluster = min(cluster, -(-s // chunk))
        return DecodePlan(groups, cluster, chunk, 1, (cluster, kv * groups, b), 1,
                          mma_smem(d, chunk, 1))
    # a long cache: chunks of at least 64 rows, the largest power of two whose
    # ring of MMA_STAGES leaves room for as many CTAs an SM as the registers allow
    chunk, budget = MMA_MIN_CHUNK, SMEM_PER_SM // MMA_CTAS_PER_SM[d] - 1024
    while mma_smem(d, 2 * chunk, MMA_STAGES) <= budget:
        chunk *= 2
    n_chunks = -(-s // chunk)
    if clusters_fit is None:
        def clusters_fit(d, chunk, ring, cluster):  # every SM holds as many CTAs as fit
            per_sm = min(SMEM_PER_SM // (mma_smem(d, chunk, ring) + 1024), MMA_CTAS_PER_SM[d])
            return per_sm * N_SM // cluster
    best = None
    for cluster in range(MAX_CLUSTER, 1, -1):
        per = -(-n_chunks // cluster)
        ring = min(MMA_STAGES, per)
        cap = clusters_fit(d, chunk, ring, cluster)
        if cap < 1:
            continue
        score = cluster * clusters / (-(-clusters // cap) * cap)  # cluster size x wave use
        if best is None or score > best[0]:
            best = (score, cluster, per, ring)
    if best is None:
        raise ValueError(f"decode kernel: no cluster of the tensor-core route fits the card at D = {d}")
    _, cluster, per, ring = best
    return DecodePlan(groups, cluster, chunk, per, (cluster, kv * groups, b), ring,
                      mma_smem(d, chunk, ring))


_fits: dict[int, Callable[[int, int, int, int], int]] = {}


def clusters_fit_on(device: int) -> Callable[[int, int, int, int], int]:
    """(d, chunk, ring, cluster) -> how many clusters of the tensor-core
    route ``device`` holds at once (``cudaOccupancyMaxActiveClusters``),
    asked once per distinct argument."""
    if device not in _fits:
        fn = _build.function("decode_attention", "decode_int8_mma_clusters", [ctypes.c_int] * 5)
        _fits[device] = functools.lru_cache(maxsize=None)(
            lambda d, chunk, ring, cluster: fn(d, chunk, ring, cluster, device))
    return _fits[device]


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KV, S, D)
    v_cache: torch.Tensor,  # (B, KV, S, D)
    lengths: torch.Tensor,  # (B,) int32
    *,
    softmax_scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # (B, KV, S) f32, with an int8 cache
    v_scale: torch.Tensor | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Attention out (B, H, D); with ``return_lse`` also (out, lse)."""
    global launches, lse_launches
    dev = q.device
    quant = k_cache.dtype == torch.int8
    scales = (k_scale, v_scale) if quant else ()
    if dev.type != "cuda" or any(t.device != dev for t in (k_cache, v_cache, lengths, *scales)):
        raise ValueError("decode kernel needs q, caches, scales and lengths on one CUDA device")
    if q.dtype not in _build.DTYPES or v_cache.dtype != k_cache.dtype or not (
            k_cache.dtype == q.dtype or quant):
        raise TypeError(f"decode kernel takes an f32 or bf16 q and caches of its dtype or int8, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("decode kernel: an int8 cache needs k_scale and v_scale, another none")
    if quant and any(t.dtype != torch.float32 or t.shape != k_cache.shape[:3]
                     or not t.is_contiguous() for t in scales):
        raise ValueError("decode kernel needs contiguous f32 scales (B, KV, S) of the int8 cache")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode kernel needs int32 lengths, got {lengths.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode kernel needs q (B,H,D), caches (B,KV,S,D), got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, h, d = q.shape
    _, kv, s, _ = k_cache.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or lengths.shape != (b,) or kv == 0
            or h % kv or h // kv not in N_REPS or d not in HEAD_DIMS or s == 0):
        raise ValueError(f"decode kernel: unsupported shapes q {tuple(q.shape)}, cache {tuple(k_cache.shape)} (D in {HEAD_DIMS}, H/KV in groups of {GROUP_HEADS})")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("decode kernel needs contiguous q, caches and lengths")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode kernel needs 16-byte aligned q and caches (bulk copies)")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    mma = quant and q.dtype == torch.bfloat16
    plan = decode_plan(b, kv, s, d, k_cache.element_size(), h // kv, mma=mma,
                       clusters_fit=clusters_fit_on(dev.index) if mma else None)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, dtype=torch.float32, device=dev) if return_lse else None
    fn = _build.function(
        "decode_attention",
        "decode_attention_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        lengths.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
        b, h, kv, s, d, plan.groups, plan.cluster, plan.chunk, plan.ring, scale,
        _build.DTYPES[q.dtype],
        int(quant), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("decode_attention", err)
    launches += 1
    if return_lse:
        lse_launches += 1
        return out, lse
    return out
