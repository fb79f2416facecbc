"""Flow-level *execution* of an Algorithm-11 multicast plan.

Planning stays greedy (``repro.core.multicast.plan_multicast``); this module
turns the resulting chains into typed flows on the shared :class:`FlowSim`,
so *realized* transfer times reflect whatever serving / migration / cold-
start traffic is live — instead of the plan's dedicated-link estimate.

Each chain edge becomes ``sharded_ways`` parallel ``MULTICAST_HOP`` flows of
``|M| / ways`` bytes (the Fig. 14 parallel sharded transfer), plus the
intra-scale-up ``ALLGATHER`` flows that re-assemble the full copy on the
receiving domain.  Pipelined forwarding (Fig. 13a) is approximated at flow
granularity: every hop streams concurrently, and a node is *ready* when its
incoming hop has finished AND its upstream node is ready — under dedicated
links every hop runs at the bottleneck rate and the whole chain completes
in ``|M| / B`` like the analytic model; under contention the max over the
chain prefix is exact for a stable bottleneck.

Failure handling: if any hop's link fails without a surviving route, the
whole execution aborts (remaining hops are withdrawn) and ``on_abort``
fires — the caller (ClusterRuntime / Simulator) re-plans from surviving
sources.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.core.multicast import MulticastPlan, Node
from repro_torch.net.flows import Flow, FlowKind
from repro_torch.net.flowsim import FlowSim


@dataclasses.dataclass
class _EdgeState:
    chain_idx: int
    edge_idx: int
    flows: list[Flow]
    pending: int
    done_at: float | None = None


class MulticastExecution:
    """One plan's in-flight transfer: flows + per-node readiness tracking."""

    def __init__(
        self,
        plan: MulticastPlan,
        model_bytes: int,
        *,
        on_node_ready: Callable[[Node, float], None] | None = None,
        on_done: Callable[["MulticastExecution", float], None] | None = None,
        on_abort: Callable[["MulticastExecution", float], None] | None = None,
        tracer=None,
        parent_span=None,
    ):
        self.plan = plan
        self.model_bytes = model_bytes
        self.on_node_ready = on_node_ready
        self.on_done = on_done
        self.on_abort = on_abort
        # duck-typed (repro.obs.Tracer-shaped) to keep repro.net free of an
        # obs import; None / disabled tracers cost one attribute check
        self.tracer = tracer if tracer is not None and tracer.enabled else None
        self.parent_span = parent_span
        self.sim: FlowSim | None = None
        self.flows: list[Flow] = []
        self.edges: list[_EdgeState] = []
        self._edge_of: dict[int, _EdgeState] = {}  # id(flow) -> edge state
        self.node_ready_at: dict[Node, float] = {}
        self.done_at: float | None = None
        self.aborted = False
        self._build()

    def _build(self) -> None:
        for ci, chain in enumerate(self.plan.chains):
            for ei, edge in enumerate(chain.edges):
                ways = max(1, edge.sharded_ways)
                pairs = list(
                    zip(edge.src.device_ids[:ways], edge.dst.device_ids[:ways])
                )
                hop_bytes = self.model_bytes / len(pairs)
                flows = [
                    Flow(
                        FlowKind.MULTICAST_HOP,
                        s,
                        d,
                        hop_bytes,
                        on_complete=self._flow_done,
                        on_abort=self._flow_aborted,
                        tag=f"chain{ci}.hop{ei}",
                        chain=ci,
                        hop=ei,
                    )
                    for s, d in pairs
                ]
                if len(pairs) > 1 or edge.dst.size > len(pairs):
                    # Fig. 14: every receiving device AllGathers the shards
                    # it did not receive over the scale-up fabric (members
                    # beyond the sharded pairs pull the full copy there)
                    anchor = edge.dst.device_ids[0]
                    other = (
                        edge.dst.device_ids[1] if edge.dst.size > 1 else anchor
                    )
                    for j, d in enumerate(edge.dst.device_ids):
                        frac = (
                            (len(pairs) - 1) / len(pairs) if j < len(pairs) else 1.0
                        )
                        if frac <= 0.0:
                            continue
                        flows.append(
                            Flow(
                                FlowKind.ALLGATHER,
                                anchor if d != anchor else other,
                                d,
                                self.model_bytes * frac,
                                on_complete=self._flow_done,
                                on_abort=self._flow_aborted,
                                tag=f"chain{ci}.allgather{ei}",
                                chain=ci,
                                hop=ei,
                            )
                        )
                st = _EdgeState(ci, ei, flows, pending=len(flows))
                self.edges.append(st)
                for f in flows:
                    self._edge_of[id(f)] = st
                self.flows.extend(flows)

    # -- lifecycle -----------------------------------------------------------
    def start(self, sim: FlowSim, now: float | None = None) -> "MulticastExecution":
        self.sim = sim
        if now is not None:
            sim.advance_to(now)
        # source nodes are ready by definition
        for chain in self.plan.chains:
            if chain.nodes:
                self.node_ready_at[chain.nodes[0]] = sim.now
        if not self.flows:
            self.done_at = sim.now
            if self.on_done:
                self.on_done(self, sim.now)
            return self
        self._charge_chain_latency(sim)
        sim.start_many(self.flows)
        return self

    def _charge_chain_latency(self, sim: FlowSim) -> None:
        """Under the latency model, hop ``k`` of a pipelined forwarding
        chain cannot deliver its first byte before the store-and-forward
        latencies of hops ``0..k-1`` have elapsed — charge each hop the
        cumulative latency of its upstream edges as ``extra_latency_s``.
        Parallel sharded sibling flows of one edge are shards of the SAME
        store-and-forward stage, so downstream hops pay the slowest
        sibling (``max``), and each hop budgets ``FlowSim.hop_latency`` —
        the worst latency across live spine planes, since routing picks
        planes by load, not latency: the per-flow charge (its actual
        routed path + this prefix) can never exceed what downstream hops
        budgeted for it, which is what keeps hop-k first bytes causally
        behind hop-(k-1) under heterogeneous per-plane profiles.  This is
        the same per-hop value the latency-aware planner sums, so analytic
        ``MulticastPlan.transfer_seconds`` matches realized completion on
        uncontended networks.  Zero-latency networks leave every flow
        untouched."""
        by_chain: dict[int, list[_EdgeState]] = {}
        for st in self.edges:
            by_chain.setdefault(st.chain_idx, []).append(st)
        for states in by_chain.values():
            prefix = 0.0
            for st in sorted(states, key=lambda s: s.edge_idx):
                edge_lat = 0.0
                for f in st.flows:
                    f.extra_latency_s = prefix
                    if f.kind is FlowKind.MULTICAST_HOP:
                        edge_lat = max(edge_lat, sim.hop_latency(f.src, f.dst))
                prefix += edge_lat

    def cancel(self, sim: FlowSim | None = None, now: float | None = None) -> None:
        """Withdraw all outstanding hops without firing abort callbacks
        (the consumer was drained on purpose)."""
        sim = sim or self.sim
        if sim is None:
            return
        self.aborted = True
        for f in self.flows:
            if not f.done and not f.aborted:
                sim.remove(f, now, abort=False)

    # -- flow callbacks ------------------------------------------------------
    def _flow_done(self, flow: Flow, t: float) -> None:
        st = self._edge_of[id(flow)]
        st.pending -= 1
        if st.pending == 0:
            st.done_at = t
            self._propagate(t)

    def _flow_aborted(self, flow: Flow, t: float) -> None:
        if self.aborted:
            return
        self.aborted = True
        for f in self.flows:
            if f is not flow and not f.done and not f.aborted and self.sim:
                self.sim.remove(f, abort=False)
        if self.on_abort:
            self.on_abort(self, t)

    def _propagate(self, t: float) -> None:
        """Walk each chain in order: a node is ready when its incoming edge
        finished and its predecessor is ready (flow-granular pipelining)."""
        by_chain: dict[int, list[_EdgeState]] = {}
        for st in self.edges:
            by_chain.setdefault(st.chain_idx, []).append(st)
        all_done = True
        for ci, chain in enumerate(self.plan.chains):
            prev_ready = self.node_ready_at.get(chain.nodes[0], None)
            for st in sorted(by_chain.get(ci, []), key=lambda s: s.edge_idx):
                node = chain.edges[st.edge_idx].dst
                if st.done_at is None or prev_ready is None:
                    all_done = False
                    break
                ready = max(st.done_at, prev_ready)
                if node not in self.node_ready_at:
                    self.node_ready_at[node] = ready
                    if self.tracer is not None:
                        self.tracer.instant(
                            "layer_arrival", max(ready, t), cat="scale",
                            parent=self.parent_span, chain=ci,
                            devices=list(node.device_ids))
                    if self.on_node_ready:
                        self.on_node_ready(node, max(ready, t))
                prev_ready = self.node_ready_at[node]
        if all_done and self.done_at is None and not self.aborted:
            self.done_at = max(self.node_ready_at.values(), default=t)
            if self.on_done:
                self.on_done(self, t)

    # -- queries -------------------------------------------------------------
    def flows_into(self, dev: int) -> list[Flow]:
        """The parameter hops landing on ``dev`` (AllGather excluded) —
        drives flow-backed :class:`LiveSession` progress."""
        return [
            f for f in self.flows if f.dst == dev and f.kind is FlowKind.MULTICAST_HOP
        ]

    def bytes_into(self, dev: int) -> float:
        return sum(f.transferred for f in self.flows_into(dev))

    @property
    def done(self) -> bool:
        return self.done_at is not None
