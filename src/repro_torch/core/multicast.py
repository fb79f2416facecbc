"""Online interference-free multicast scale-plan generation (paper §5.1,
Algorithm 11, Figs. 12-14).

Key ideas implemented here:

  * **Serial forwarding chains** ``S -> T1 -> ... -> Tn``: pipelined
    layer-by-layer forwarding makes total transfer time ``|M| / B``
    *independent of the number of receivers* (Fig. 13a) — this is why the
    data plane needs no per-host caching.
  * **Scale-up grouping**: devices in one NVLink/ICI domain collapse into a
    single chain *node*; intra-node distribution is near-free.
  * **Interference-freedom via full-duplex links** (Fig. 7c/d): a device
    whose egress already carries serving traffic (a prefill instance
    streaming KVCache out) is pruned from the source set; reading from a
    *decode* instance instead puts the parameter flow on the opposite link
    direction.
  * **Multi-chain** (Fig. 12): one chain per leaf when every leaf has both
    sources and targets — avoids slow inter-leaf hops and lets more chain
    tails live-scale without interference.
  * **Fastest-first node order** (Fig. 13b): targets with higher aggregate
    bandwidth go earlier in the chain so serving throughput rises sooner.
  * **Parallel sharded transfer** (Fig. 14): when consecutive chain nodes
    have ``g`` devices each holding/awaiting the full parameters, each source
    device ships ``1/g`` of the bytes and the target scale-up domain
    AllGathers — a ``g x`` speedup.
  * **Latency-aware ranking** (post-Fig. 13a realism): when the caller
    passes the data plane's latency view (``net=`` a ``FlowSim`` or
    ``NetworkModel``), chain cost is no longer bandwidth-only — hop ``k``
    of a pipelined chain cannot deliver byte 0 before ``k`` store-and-
    forward stages have elapsed, so a target's projected arrival is
    ``max over chain prefix j of (cum_latency_j + |M|/BW_j)``.  Source
    selection, fastest-first target ordering and multi-chain splitting all
    re-rank on that cost, so deep serial chains lose to wider/shallower
    plans when switching delay dominates and the analytic
    ``transfer_seconds`` matches the FlowSim-realized completion.  A
    zero-latency network plans bit-for-bit like the bandwidth-only
    planner (golden-trace pinned).

The planner is greedy and runs in ``O(S log S + T log T)`` bandwidth-only
and ``O(S * T)`` latency-aware — the paper's answer to NP-hard optimal
multicast on heterogeneous networks.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterable, Protocol, Sequence

from repro_torch.core.topology import (
    NVLINK_GBPS,
    Device,
    Role,
    Topology,
    gbps_to_bytes_per_s,
)


class LatencyView(Protocol):
    """What the planner needs from the data plane: per-hop first-byte
    latency.  Both ``repro.net.FlowSim`` and ``repro.net.NetworkModel``
    satisfy it; tests may pass any duck-typed stand-in."""

    def hop_latency(self, src: int, dst: int) -> float: ...  # pragma: no cover


# ---------------------------------------------------------------------------
# Plan data structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Node:
    """One chain node = all devices of a scale-up domain participating."""

    device_ids: tuple[int, ...]
    scaleup: int
    leaf: int
    agg_bw_gbps: float  # sum of members' scale-out link bandwidth
    is_source: bool = False
    is_host: bool = False

    @property
    def size(self) -> int:
        return len(self.device_ids)


@dataclasses.dataclass(frozen=True)
class Edge:
    src: Node
    dst: Node
    bw_gbps: float  # effective bandwidth of this hop (after Fig.14 sharding)
    sharded_ways: int  # Fig. 14 parallelism factor
    intra_scaleup: bool = False  # NVLink/ICI hop — uses no scale-out link
    latency_s: float = 0.0  # first-byte (link + switch) latency of this hop,
    #   as the data plane charges it (0.0 when planned bandwidth-only)


@dataclasses.dataclass
class Chain:
    nodes: list[Node]  # nodes[0] is the source
    edges: list[Edge]

    @property
    def targets(self) -> list[Node]:
        return self.nodes[1:]

    @property
    def is_degenerate(self) -> bool:
        """A source-only chain (no edges) moves no bytes: it has no
        bottleneck to rank on and zero transfer time.  Callers ranking or
        dividing by chain speed must branch on this explicitly — a
        degenerate chain covers no target and must not win any ranking."""
        return not self.edges

    @property
    def bottleneck_gbps(self) -> float:
        """Slowest hop of the chain.  ``inf`` for a degenerate (edge-less)
        chain by convention — check :attr:`is_degenerate` before using this
        in a ranking or as a divisor."""
        if self.is_degenerate:
            return math.inf
        return min(e.bw_gbps for e in self.edges)

    @property
    def latency_seconds(self) -> float:
        """Total store-and-forward first-byte latency along the chain."""
        return sum(e.latency_s for e in self.edges)

    def transfer_seconds(self, model_bytes: int) -> float:
        """Pipelined chain completion under the latency model: hop ``k``'s
        last byte lands at ``cum_latency_k + |M| / BW_k`` (its first byte
        waits for every upstream store-and-forward stage), so the chain
        completes at the max over hops.  At zero latency this reduces to
        the Fig. 13a ``|M| / bottleneck_BW`` exactly — independent of chain
        length; with uniform hop bandwidth it is the closed form
        ``|M|/bottleneck_BW + sum(per-hop latency)``.  Degenerate (edge-
        less) chains explicitly take zero time — they move no bytes."""
        if self.is_degenerate:
            return 0.0
        done, cum_lat = 0.0, 0.0
        for e in self.edges:
            cum_lat += e.latency_s
            done = max(done, cum_lat + model_bytes / gbps_to_bytes_per_s(e.bw_gbps))
        return done

    @property
    def tail(self) -> Node:
        return self.nodes[-1]


@dataclasses.dataclass
class MulticastPlan:
    chains: list[Chain]
    covered: list[int]  # target device ids covered, in arrival order
    gen_seconds: float  # plan-generation wall time (paper: < 40 ms)
    pruned_sources: list[int]  # sources dropped by interference pruning

    def transfer_seconds(self, model_bytes: int) -> float:
        return max((c.transfer_seconds(model_bytes) for c in self.chains), default=0.0)

    @property
    def live_scale_nodes(self) -> list[Node]:
        """Chain tails: their egress carries no forwarding traffic, so they
        can join live scaling without interference (Fig. 12)."""
        return [c.tail for c in self.chains if c.edges]

    def all_edges(self) -> list[Edge]:
        return [e for c in self.chains for e in c.edges]


# ---------------------------------------------------------------------------
# Algorithm 11
# ---------------------------------------------------------------------------


def _group_nodes(
    topo: Topology, ids: Sequence[int], *, is_source: bool
) -> list[Node]:
    """Group device ids by scale-up domain into chain nodes."""
    groups: dict[int, list[int]] = {}
    for i in ids:
        groups.setdefault(topo.scaleup_of(i), []).append(i)
    nodes = []
    for su, members in groups.items():
        d0 = topo.device(members[0])
        nodes.append(
            Node(
                device_ids=tuple(sorted(members)),
                scaleup=su,
                leaf=d0.leaf,
                agg_bw_gbps=sum(topo.bw(i) for i in members),
                is_source=is_source,
                is_host=d0.is_host,
            )
        )
    return nodes


def _prune_sources(topo: Topology, src_ids: Sequence[int]) -> tuple[list[int], list[int]]:
    """Line 1 ``prune()``: drop sources whose *egress* direction already
    carries serving traffic (Fig. 7b interference).  Decode instances keep —
    their egress is free (KVCache flows in); prefill instances drop."""
    kept, pruned = [], []
    for i in src_ids:
        if topo.device(i).egress_busy:
            pruned.append(i)
        else:
            kept.append(i)
    return kept, pruned


def _hop_stats(
    net: LatencyView | None, src: Node, dst: Node
) -> tuple[float, float, int, bool]:
    """(latency_s, effective_bw_gbps, sharded_ways, intra_scaleup) of the
    hop ``src -> dst`` — the same Fig. 14 arithmetic the selection loop
    applies, plus the data plane's per-hop latency (max across the sharded
    sibling pairs, exactly as ``MulticastExecution`` charges it)."""
    ways = min(src.size, dst.size)
    intra = src.scaleup == dst.scaleup and not src.is_host
    if intra:
        eff_bw = NVLINK_GBPS * ways
    else:
        eff_bw = min(src.agg_bw_gbps / src.size, dst.agg_bw_gbps / dst.size) * ways
    lat = 0.0
    if net is not None:
        lat = max(
            (
                net.hop_latency(s, d)
                for s, d in zip(src.device_ids[:ways], dst.device_ids[:ways])
            ),
            default=0.0,
        )
    return lat, eff_bw, ways, intra


def plan_multicast(
    topo: Topology,
    src_ids: Sequence[int],
    tgt_ids: Sequence[int],
    n: int,
    *,
    allow_interference: bool = False,
    net: LatencyView | None = None,
    model_bytes: int | None = None,
) -> MulticastPlan:
    """Generate the scale plan: load parameters from ``src_ids`` onto ``n``
    devices drawn from ``tgt_ids`` (Algorithm 11).

    ``allow_interference=True`` disables Line-1 pruning — the ablation
    baseline showing 1.5x slower scaling / 50% worse tail TBT (Fig. 8).

    ``net`` is the data plane's latency view (a ``repro.net.FlowSim`` or
    ``NetworkModel``; anything with ``hop_latency(src, dst)``).  When it
    carries any latency, source selection and target ordering rank on
    projected arrival time — ``max over chain prefix of (cumulative hop
    latency + |M|/hop_BW)`` — instead of bandwidth alone; pass
    ``model_bytes`` so the bandwidth term is weighed correctly (omitting it
    makes the ranking latency-dominated).  A zero-latency ``net`` (or
    ``net=None``) reproduces the bandwidth-only plan bit-for-bit.
    """
    t0 = time.perf_counter()
    lat_aware = net is not None and getattr(net, "has_latency", True)
    mbytes = float(model_bytes) if model_bytes else 0.0

    # Line 1: prune + group sources by leaf, fastest leaf first
    if allow_interference:
        kept_src, pruned = list(src_ids), []
    else:
        kept_src, pruned = _prune_sources(topo, src_ids)
        if not kept_src:
            # all in-GPU sources interfere -> seed the chain from the O(1)
            # host-cached copy instead (the paper's fallback; PCIe egress of
            # a host carries no serving traffic)
            hosts = [d.id for d in topo.devices if d.is_host]
            if hosts:
                kept_src = hosts[:1]
            elif src_ids:  # degraded cluster with no host tier: last resort
                kept_src, pruned = list(src_ids), []

    src_nodes = _group_nodes(topo, kept_src, is_source=True)
    by_leaf: dict[int, list[Node]] = {}
    for nd in src_nodes:
        by_leaf.setdefault(nd.leaf, []).append(nd)
    leaf_order = sorted(
        by_leaf, key=lambda lf: -sum(nd.agg_bw_gbps for nd in by_leaf[lf])
    )
    src_queue: list[Node] = []
    for lf in leaf_order:
        src_queue.extend(sorted(by_leaf[lf], key=lambda nd: -nd.agg_bw_gbps))

    # Line 2-3: group targets by scale-up domain, order groups (a) by the
    # leaf order of the sources (intra-leaf chains first) then (b) by
    # decreasing aggregate bandwidth (Fig. 13b fastest-first) — or, when
    # latency-aware, by the projected first-hop arrival from the initial
    # source set, so a high-bandwidth target behind a slow link no longer
    # jumps the queue.
    tgt_nodes = _group_nodes(topo, list(tgt_ids), is_source=False)
    src_leaf_rank = {lf: r for r, lf in enumerate(leaf_order)}
    if lat_aware and src_queue:
        init_srcs = list(src_queue)

        def _tgt_eta(nd: Node) -> float:
            best = math.inf
            for s in init_srcs:
                lat, eff_bw, _, _ = _hop_stats(net, s, nd)
                best = min(best, lat + mbytes / gbps_to_bytes_per_s(eff_bw))
            return best

        tgt_nodes.sort(
            key=lambda nd: (
                src_leaf_rank.get(nd.leaf, 1 << 30),
                _tgt_eta(nd),
                -nd.agg_bw_gbps,
            )
        )
    else:
        tgt_nodes.sort(
            key=lambda nd: (src_leaf_rank.get(nd.leaf, 1 << 30), -nd.agg_bw_gbps)
        )

    # Lines 4-10: pop target groups; prefer same-leaf sources with enough
    # aggregate bandwidth (or, latency-aware, whichever source yields the
    # earliest projected arrival — which is what splits deep chains into
    # wider plans when switching delay dominates); freshly scaled targets
    # become sources (chains).
    chains: list[Chain] = []
    chain_of: dict[int, Chain] = {}  # scaleup id of last node -> its chain
    covered: list[int] = []
    m = 0
    # latency-aware chain state, keyed by id() of the live queue-node object
    # (nodes stay referenced by the queue/chains, so ids are stable):
    # cumulative store-and-forward latency at the node, and the node's own
    # projected arrival (original sources: 0.0 — they hold the parameters)
    cum_lat: dict[int, float] = {}
    arrive: dict[int, float] = {}

    for g_tgt in tgt_nodes:
        if m >= n:
            break
        take = g_tgt
        if m + g_tgt.size > n:
            keep = n - m
            take = dataclasses.replace(
                g_tgt,
                device_ids=g_tgt.device_ids[:keep],
                agg_bw_gbps=sum(topo.bw(i) for i in g_tgt.device_ids[:keep]),
            )

        pick: Node | None = None
        if lat_aware:
            if not src_queue:
                break  # no sources at all — caller must register a host copy

            def _cost(s: Node) -> tuple[float, float]:
                lat, eff_bw, _, _ = _hop_stats(net, s, take)
                cum = cum_lat.get(id(s), 0.0) + lat
                eta = max(
                    arrive.get(id(s), 0.0),
                    cum + mbytes / gbps_to_bytes_per_s(eff_bw),
                )
                return (eta, -s.agg_bw_gbps)

            pick = min(src_queue, key=_cost)
        else:
            # Scale-up shortcut: a source inside the *same* NVLink/ICI
            # domain covers the target at scale-up speed (near-free — §5.1)
            same_su = [
                s for s in src_queue if s.scaleup == take.scaleup and not s.is_host
            ]
            # Line 6-7: source selection — same leaf first
            same_leaf = [s for s in src_queue if s.leaf == take.leaf]
            if same_su:
                pick = max(same_su, key=lambda s: s.agg_bw_gbps)
            elif same_leaf and sum(s.agg_bw_gbps for s in same_leaf) >= take.agg_bw_gbps:
                pick = max(same_leaf, key=lambda s: s.agg_bw_gbps)
            elif src_queue:
                pick = max(src_queue, key=lambda s: s.agg_bw_gbps)
            if pick is None:
                break  # no sources at all — caller must register a host copy

        # Fig. 14: parallel sharded transfer when both endpoints have g
        # devices with (to-be-)duplicated parameters
        hop_lat, eff_bw, ways, intra_scaleup = _hop_stats(
            net if lat_aware else None, pick, take
        )
        edge = Edge(src=pick, dst=take, bw_gbps=eff_bw, sharded_ways=ways,
                    intra_scaleup=intra_scaleup, latency_s=hop_lat)

        # the picked node's scale-out egress now carries this chain's
        # forwarding traffic — it must not head a second chain (full-duplex
        # rule: one egress flow per link).  Intra-scale-up hops don't use
        # the scale-out link, so the source stays available.
        if not intra_scaleup:
            src_queue = [s for s in src_queue if s is not pick]

        if pick.scaleup in chain_of and not pick.is_source:
            ch = chain_of.pop(pick.scaleup)
            ch.nodes.append(take)
            ch.edges.append(edge)
        else:
            ch = Chain(nodes=[pick, take], edges=[edge])
            chains.append(ch)
            if pick.scaleup in chain_of:
                chain_of.pop(pick.scaleup, None)
        chain_of[take.scaleup] = ch

        # Line 10: the freshly scaled group becomes a source for what follows
        fresh = dataclasses.replace(take, is_source=False)
        src_queue.insert(0, fresh)
        if lat_aware:
            cum_lat[id(fresh)] = cum_lat.get(id(pick), 0.0) + hop_lat
            arrive[id(fresh)] = max(
                arrive.get(id(pick), 0.0),
                cum_lat[id(fresh)] + mbytes / gbps_to_bytes_per_s(eff_bw),
            )
        covered.extend(take.device_ids)
        m += take.size

    return MulticastPlan(
        chains=chains,
        covered=covered,
        gen_seconds=time.perf_counter() - t0,
        pruned_sources=pruned,
    )


# ---------------------------------------------------------------------------
# Validation (used by property tests and the simulator's safety checks)
# ---------------------------------------------------------------------------


def validate_plan(topo: Topology, plan: MulticastPlan) -> list[str]:
    """Returns a list of violations (empty = plan is sound)."""
    errors: list[str] = []

    # every covered target appears exactly once
    if len(set(plan.covered)) != len(plan.covered):
        errors.append("target covered more than once")

    # per-device flow direction accounting: egress used by at most one
    # multicast flow AND not by serving traffic (full-duplex rule)
    egress_used: dict[int, int] = {}
    ingress_used: dict[int, int] = {}
    for e in plan.all_edges():
        if e.intra_scaleup:
            continue  # NVLink/ICI hop — no scale-out link involved
        # a sharded edge can never span more device pairs than its smaller
        # endpoint: a larger sharded_ways would silently truncate in the
        # slices below and under-count link usage, so flag AND clamp it
        # (the accounting stays sound on whatever pairs actually transfer)
        ways = min(len(e.src.device_ids), len(e.dst.device_ids))
        if e.sharded_ways > ways:
            errors.append(
                f"edge {e.src.device_ids}->{e.dst.device_ids}: sharded_ways "
                f"{e.sharded_ways} exceeds endpoint size {ways}"
            )
        else:
            ways = e.sharded_ways
        for i in e.src.device_ids[:ways]:
            egress_used[i] = egress_used.get(i, 0) + 1
        for i in e.dst.device_ids[:ways]:
            ingress_used[i] = ingress_used.get(i, 0) + 1

    for i, cnt in egress_used.items():
        if cnt > 1:
            errors.append(f"device {i}: {cnt} same-direction egress flows")
        d = topo.device(i)
        if d.egress_busy:
            errors.append(f"device {i}: multicast egress collides with serving egress")
    for i, cnt in ingress_used.items():
        if cnt > 1:
            errors.append(f"device {i}: {cnt} same-direction ingress flows")
        d = topo.device(i)
        if d.ingress_busy and not d.is_host:
            errors.append(f"device {i}: multicast ingress collides with serving ingress")
    return errors


def chain_time_model(
    model_bytes: int,
    chain_bw_gbps: float,
    n_targets: int,
    *,
    pipelined: bool = True,
    total_latency_s: float = 0.0,
) -> float:
    """Fig. 13a analytic model with the latency term: pipelined chain time
    is ~|M|/B + the chain's total store-and-forward first-byte latency
    (``Chain.latency_seconds``), regardless of n; unpipelined
    (store-and-forward of the whole model) is n*|M|/B + the same latency.
    ``total_latency_s=0`` is the original pure-bandwidth model."""
    base = model_bytes / gbps_to_bytes_per_s(chain_bw_gbps)
    return (base if pipelined else base * max(n_targets, 1)) + total_latency_s
