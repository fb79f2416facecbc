"""Single-token GQA decode attention on the card (wrapper of
``csrc/decode_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``_decode_kernel`` / ``decode_attention``).  Bound on the H100: bytes (each
valid cache row is read once per step).  One launch per call: a thread-block
cluster of CTAs per (sequence, KV head) splits the sequence into chunks
(flash-decoding), each chunk's valid K and V rows arrive by one bulk copy
each into a 2-stage shared-memory ring, the n_rep query heads that share a KV
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
the int8 rows and the plan sizes the chunks by their 1-byte elements; the
valid rows' scales ride beside them in a ring of their own, by 4-byte
asynchronous copies.  Bound: bytes, the valid int8 K and V rows plus 8
bytes of scales a row, q and the output.

``return_lse=True`` also returns each head's log-sum-exp, (B, H) f32 in the
log2 domain of the scaled scores (as flash's ``return_lse``), from the
kernel's own merge: the partial that flash-decoding over a sequence-sharded
cache merges (``ops.merge_partials``).  A row of length 0 gives out 0 and
lse ``-inf``, weight 0 in that merge; the flash kernels' ``+inf`` for a row
with no key serves their backward and is not this convention.
"""

from __future__ import annotations

import ctypes
import math
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


@dataclass(frozen=True)
class DecodePlan:
    """How the kernel splits one call: the n_rep query heads of a KV head in
    ``groups`` groups, a cluster of ``cluster`` CTAs per (sequence, KV head,
    group), the grid ``(cluster, KV * groups, B)``, chunks of ``chunk``
    cache rows, and at most ``chunks_per_cta`` chunks per CTA.  Chunk ``c``
    (rows ``[c*chunk, (c+1)*chunk)``) belongs to cluster rank ``c %
    cluster``, as the kernel walks it, in every group's cluster."""

    groups: int
    cluster: int
    chunk: int
    chunks_per_cta: int
    grid: tuple[int, int, int]

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


def decode_plan(b: int, kv: int, s: int, d: int, elem_bytes: int, n_rep: int = 1) -> DecodePlan:
    """Head groups, cluster size and chunk rows for a (B, KV, S, D) cache of
    ``elem_bytes`` elements (the cache's: 1 for int8) read by n_rep query
    heads per KV head.

    The cluster grows (up to 8) until the B*KV*groups clusters give at least
    two CTAs per SM.  A chunk is the rows one CTA would own with one chunk each,
    rounded up to 16 and capped at the largest power of two of rows for which
    the 2-stage ring of K and V chunks fits ``RING_BYTES`` (64 rows at D = 80
    and 32 at D = 192 in bf16, 16 at D = 192 in f32): at the serving shape (B=4, KV=8, S=1024, D=128,
    bf16) that is clusters of 8 and chunks of 64 rows (16 KB per copy), two
    per CTA.  The cluster never exceeds the number of chunks."""
    groups = head_groups(n_rep)
    cluster = 1
    while cluster < MAX_CLUSTER and b * kv * groups * cluster < 2 * N_SM:
        cluster *= 2
    per_cta = -(-s // cluster)
    fit = RING_BYTES // (4 * d * elem_bytes)
    chunk = min(max(16, 1 << (fit.bit_length() - 1)), 16 * -(-per_cta // 16))
    n_chunks = -(-s // chunk)
    cluster = min(cluster, n_chunks)
    return DecodePlan(groups, cluster, chunk, -(-n_chunks // cluster), (cluster, kv * groups, b))


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
    plan = decode_plan(b, kv, s, d, k_cache.element_size(), h // kv)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, dtype=torch.float32, device=dev) if return_lse else None
    fn = _build.function(
        "decode_attention",
        "decode_attention_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        lengths.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
        b, h, kv, s, d, plan.groups, plan.cluster, plan.chunk, scale, _build.DTYPES[q.dtype],
        int(quant), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("decode_attention", err)
    launches += 1
    if return_lse:
        lse_launches += 1
        return out, lse
    return out
