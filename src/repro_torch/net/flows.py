"""Typed flows riding the shared flow-level network simulator.

Every byte BLITZSCALE moves over the compute network is one of a small set
of flow types; unifying them in one simulator is what lets a cold start, a
live scale-up and a KV-cache drain contend on the same leaf uplink — the
interference Algorithm 11 is designed to dodge:

  * ``MULTICAST_HOP`` — one hop of a serial forwarding chain (§5.1);
  * ``ALLGATHER``     — the intra-scale-up AllGather completing a Fig. 14
                        parallel sharded transfer;
  * ``KV_MIGRATION``  — frozen KV pages prefill->decode (§2.1, §5.4);
  * ``COLD_START``    — unicast parameter load from the O(1) host copy (or
                        an interference-ignorant GPU copy — the "+Network"
                        ablation baseline);
  * ``SERVING``       — live KVCache serving traffic that scaling flows
                        must not collide with.  Request-granular since the
                        latency-model PR: one finite flow per finished
                        prefill, sized at the request's ACTUAL KV volume
                        (``prompt_tokens x kv_bytes_per_token``).  A size of
                        ``math.inf`` still denotes the legacy persistent
                        background stream (it never completes, it only takes
                        its max-min share) — the PR-3 configuration the
                        golden-trace regression test pins.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable

from repro_torch.net.links import Link


class FlowKind(enum.Enum):
    MULTICAST_HOP = "multicast_hop"
    ALLGATHER = "allgather"
    KV_MIGRATION = "kv_migration"
    COLD_START = "cold_start"
    SERVING = "serving"


@dataclasses.dataclass(eq=False)
class Flow:
    """One src->dst transfer; rate is assigned by the simulator's max-min
    fair sharing and changes whenever the set of competing flows does."""

    kind: FlowKind
    src: int
    dst: int
    size: float  # bytes; math.inf = persistent background flow
    payload: Any = None
    on_complete: Callable[["Flow", float], None] | None = None
    on_abort: Callable[["Flow", float], None] | None = None
    tag: str = ""
    # extra first-byte latency charged on top of the routed path's own
    # propagation + switching terms — multicast executions use it to give
    # chain hop k the cumulative latency of its upstream hops (a pipelined
    # forwarding chain cannot deliver byte 0 at depth k before k store-and-
    # forward stages have elapsed)
    extra_latency_s: float = 0.0
    # causal position inside a multicast execution (chain index / edge depth);
    # None for every non-multicast flow.  Purely observational: the tracer
    # bridge stamps these onto hop spans so a critical-path analyzer can
    # reconstruct the forwarding DAG without tree-parenting overlapping
    # pipelined hops under each other.
    chain: int | None = None
    hop: int | None = None

    # -- simulator-managed state --------------------------------------------
    remaining: float = dataclasses.field(init=False)
    transferred: float = 0.0
    rate: float = 0.0  # bytes/s under the current max-min allocation
    started_at: float | None = None
    finished_at: float | None = None
    aborted: bool = False
    # first-byte setup: while ``active_at`` is in the future the flow is
    # propagating (rate 0, contends with nobody); None = active immediately
    # (the zero-latency configuration never sets it, keeping that code path
    # bit-for-bit identical to the pure bandwidth model)
    active_at: float | None = None
    path: list[Link] = dataclasses.field(default_factory=list, repr=False)
    # admission order on the simulator (ties in the event calendar break on
    # it, and every introspection API sorts by it so results keep the
    # engine's start order regardless of index layout); -1 = never admitted
    seq: int = dataclasses.field(init=False, default=-1, repr=False)
    # calendar generation: bumped whenever the flow's projected event time
    # goes stale (rate change, reroute, removal) — heap entries carrying an
    # older generation are discarded lazily on pop
    cal_gen: int = dataclasses.field(init=False, default=0, repr=False)

    def __post_init__(self):
        self.remaining = float(self.size)

    @property
    def background(self) -> bool:
        return not math.isfinite(self.size)

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    def eta(self, now: float) -> float:
        """Finish time under the CURRENT rate (changes on any flow event)."""
        if self.done:
            return self.finished_at
        if self.rate <= 0.0 or self.background:
            return math.inf
        return now + self.remaining / self.rate
