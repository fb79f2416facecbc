"""Parameter multicast data plane over ``torch.distributed`` (paper §5.1):
the port of ``repro.core.collectives``.

The paper's chain multicast is point-to-point NCCL send/recv.  A serial
forwarding chain is pipelined: the source injects parameter block ``b`` at
step ``b``, and at every step each rank forwards the block it holds to its
chain successor, so after ``n_blocks + n_ranks - 2`` steps every rank holds
every block: the Fig. 13(a) argument (total time ~ |M|/B, independent of the
number of receivers).  Each step is one batch of ``isend``/``irecv`` to the
neighbours (``dist.batch_isend_irecv``).

Fig. 14's parallel sharded transfer: each of the ``g`` devices of a source
scale-up domain ships a distinct 1/g shard to its peer in the target domain
(one point-to-point send each, the links used in parallel), and the target
domain all-gathers the shards over its scale-up links.

The functions take a process group and work on whatever device its backend
serves (gloo: CPU tensors; NCCL: CUDA tensors on each rank's current
device).  They pick no device.  ``pipelined_chain_steps`` and
``chain_broadcast_seconds`` are the data-plane model's arithmetic.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Pipelined chain broadcast (serial forwarding multicast, Fig. 13a)
# ---------------------------------------------------------------------------


def _global(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def chain_broadcast_blocks(
    blocks: torch.Tensor,  # (n_blocks, block_elems); read on the chain's source only
    group: dist.ProcessGroup | None = None,
    src: int = 0,
) -> torch.Tensor:
    """Pipelined broadcast of ``blocks`` along the chain of group ranks
    ``src, src + 1, ..., n - 1`` (the planner emits device orders; callers
    renumber).  At step ``s`` chain position ``p`` holds block ``s - p`` and
    sends it to ``p + 1`` while it receives block ``s - p + 1`` from ``p - 1``.
    Returns every block on every chain rank; a rank before ``src`` is not on
    the chain and gets its own ``blocks`` back."""
    rank, n_ranks = dist.get_rank(group), dist.get_world_size(group)
    n_blocks = blocks.shape[0]
    pos = rank - src
    # every rank of the group, on the chain or not: NCCL wants all of them in
    # the first collective call
    dist.barrier(group=group)
    if pos < 0:
        return blocks
    out = blocks.clone() if pos == 0 else torch.zeros_like(blocks)
    last = n_ranks - 1 - src
    for s in range(n_blocks + n_ranks - src - 2):
        ops = []
        b_send, b_recv = s - pos, s - pos + 1
        if pos < last and 0 <= b_send < n_blocks:
            ops.append(dist.P2POp(dist.isend, out[b_send], _global(group, rank + 1), group))
        if pos > 0 and 0 <= b_recv < n_blocks:
            ops.append(dist.P2POp(dist.irecv, out[b_recv], _global(group, rank - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return out


def chain_broadcast(
    params_flat: torch.Tensor,  # (total_elems,); read on group rank 0 only
    group: dist.ProcessGroup | None = None,
    n_blocks: int = 16,
) -> torch.Tensor:
    """Broadcast a flat parameter vector from group rank 0 to every rank of
    ``group`` through the pipelined chain: padded with zeros to a multiple
    of ``n_blocks``, split into blocks and sliced back."""
    total = params_flat.shape[0]
    pad = (-total) % n_blocks
    blocks = F.pad(params_flat, (0, pad)).reshape(n_blocks, (total + pad) // n_blocks)
    return chain_broadcast_blocks(blocks, group).reshape(-1)[:total]


# ---------------------------------------------------------------------------
# Parallel sharded transfer (Fig. 14): shard sends + all-gather over scale-up
# ---------------------------------------------------------------------------


def scaleup_groups(layout: list[list[int]]) -> list[dist.ProcessGroup]:
    """One process group per scale-up domain: ``layout[c]`` lists the global
    ranks of chain position ``c``'s domain.  Every rank must call this, with
    the same layout (``dist.new_group`` is collective)."""
    return [dist.new_group(ranks) for ranks in layout]


def sharded_group_transfer(
    shard: torch.Tensor,  # this rank's 1/g shard of the block (source domain)
    layout: list[list[int]],  # layout[c][u]: global rank at chain position c, scale-up index u
    groups: list[dist.ProcessGroup],  # scaleup_groups(layout)
    src: int = 0,
    dst: int = 1,
) -> torch.Tensor:
    """Each rank of domain ``src`` sends its shard to the rank of domain
    ``dst`` with the same scale-up index (one send each, in parallel), then
    every domain all-gathers over its scale-up group, shards concatenated in
    scale-up order.  Returns the full block on every rank of domain ``dst``;
    elsewhere what its domain gathered (zeros for ranks that received
    nothing), which callers mask by rank."""
    me = dist.get_rank()
    c, u = next((c, row.index(me)) for c, row in enumerate(layout) if me in row)
    moved = torch.zeros_like(shard)
    ops = []
    if c == src:
        ops.append(dist.P2POp(dist.isend, shard.contiguous(), layout[dst][u]))
    if c == dst:
        ops.append(dist.P2POp(dist.irecv, moved, layout[src][u]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    parts = [torch.empty_like(moved) for _ in layout[c]]
    dist.all_gather(parts, moved, group=groups[c])
    return torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# Analytic timing (the simulator's data-plane model)
# ---------------------------------------------------------------------------


def pipelined_chain_steps(n_blocks: int, n_ranks: int) -> int:
    """Hop-times of the pipelined broadcast (against n_blocks * (R - 1)
    unpipelined)."""
    return n_blocks + max(n_ranks - 1, 1) - 1


def chain_broadcast_seconds(
    model_bytes: int, bottleneck_bytes_per_s: float, n_blocks: int, n_ranks: int
) -> float:
    block_t = model_bytes / n_blocks / bottleneck_bytes_per_s
    return block_t * pipelined_chain_steps(n_blocks, n_ranks)
