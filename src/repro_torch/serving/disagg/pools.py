"""Phase-tagged engine pools for PD-disaggregated serving.

A :class:`PooledEngine` wraps one :class:`InstanceEngine` with its cluster
identity: the device it occupies, its phase (prefill or decode), and its
lifecycle state.  The pool supports the two §5.4 transitions that make
decode scaling cheap:

  * **mutation** — a prefill instance becomes a decode instance in place:
    the parameters are already resident, so the transition moves *zero*
    parameter bytes and only flips the device role (egress-busy →
    ingress-busy);
  * **draining** — scale-down marks an instance draining; it finishes its
    in-flight work, accepts nothing new, and frees its device when idle.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core import topology as topo_mod
from repro_torch.core.live_scaling import LiveSession
from repro_torch.serving.disagg.kv_migration import MigrationPayload
from repro_torch.serving.engine import InstanceEngine

PREFILL = "prefill"
DECODE = "decode"

ACTIVE = "active"
LOADING = "loading"  # live-scaling: parameters still streaming in
DRAINING = "draining"  # scale-down: finish in-flight work, then retire

_PHASE_ROLE = {PREFILL: topo_mod.Role.PREFILL, DECODE: topo_mod.Role.DECODE}


@dataclasses.dataclass
class PooledEngine:
    engine: InstanceEngine
    device_id: int
    phase: str  # PREFILL | DECODE
    state: str = ACTIVE
    session: LiveSession | None = None  # live-scaling progress while LOADING
    pending: deque = dataclasses.field(default_factory=deque)  # migrated payloads awaiting slots
    inflight: int = 0  # KV migrations on the wire toward this engine

    def load(self) -> int:
        """Dispatch-ordering load: queued + active + migrating-in work
        (both landed payloads and flows still on the wire — otherwise every
        migration started within one transfer window piles onto the same
        'least loaded' decode engine)."""
        e = self.engine
        return len(e.queue) + len(e.active) + len(self.pending) + self.inflight

    def idle(self) -> bool:
        return (
            not self.engine.queue
            and not self.engine.active
            and not self.pending
            and self.inflight == 0
        )

    def serving(self) -> bool:
        return self.state == ACTIVE and self.engine.can_serve_alone()


class EnginePool:
    """Both phase pools plus the topology role bookkeeping."""

    def __init__(self, topo: topo_mod.Topology):
        self.topo = topo
        self.engines: dict[str, list[PooledEngine]] = {PREFILL: [], DECODE: []}

    # -- queries ------------------------------------------------------------
    def all(self) -> list[PooledEngine]:
        return self.engines[PREFILL] + self.engines[DECODE]

    def phase(self, phase: str) -> list[PooledEngine]:
        return self.engines[phase]

    def serving(self, phase: str) -> list[PooledEngine]:
        """Engines that may take new work (ACTIVE implies not draining)."""
        return [pe for pe in self.engines[phase] if pe.serving()]

    def migration_targets(self) -> list[PooledEngine]:
        """Decode engines KV pages may be routed to: serving ones, plus
        LOADING ones (a directly live-scaled decode instance receives
        migrations *while* parameters stream in — the §5.4 incast scenario
        the mutation policy exists to avoid; payloads landing on a loading
        engine wait in ``pending`` until it can serve)."""
        return [
            pe
            for pe in self.engines[DECODE]
            if pe.state != DRAINING and (pe.serving() or pe.state == LOADING)
        ]

    def n_provisioned(self, phase: str) -> int:
        """Instances counted against the autoscaler target (incl. loading)."""
        return sum(1 for pe in self.engines[phase] if pe.state != DRAINING)

    # -- lifecycle ----------------------------------------------------------
    def add(self, pe: PooledEngine) -> PooledEngine:
        self.engines[pe.phase].append(pe)
        if pe.state == ACTIVE:
            self.topo.device(pe.device_id).role = _PHASE_ROLE[pe.phase]
        return pe

    def activate(self, pe: PooledEngine) -> None:
        """A LOADING engine finished live-scaling: it now serves alone."""
        pe.state = ACTIVE
        pe.session = None
        self.topo.device(pe.device_id).role = _PHASE_ROLE[pe.phase]

    def mutate_to_decode(self, pe: PooledEngine) -> PooledEngine:
        """§5.4: flip a prefill instance into a decode instance in place.

        Parameters are already resident — zero bytes move; only the device's
        busy link direction changes (prefill egress → decode ingress)."""
        assert pe.phase == PREFILL and pe.state == ACTIVE
        self.engines[PREFILL].remove(pe)
        pe.phase = DECODE
        self.engines[DECODE].append(pe)
        self.topo.device(pe.device_id).role = topo_mod.Role.DECODE
        return pe

    def drain(self, pe: PooledEngine) -> None:
        pe.state = DRAINING

    def retire_idle(self) -> list[PooledEngine]:
        """Remove draining engines that finished their work; free devices.
        ``idle()`` counts in-flight migrations (``inflight``), so an engine
        never retires while KV pages are still on the wire toward it."""
        retired = []
        for phase in (PREFILL, DECODE):
            for pe in list(self.engines[phase]):
                if pe.state == DRAINING and pe.idle():
                    self.engines[phase].remove(pe)
                    dev = self.topo.device(pe.device_id)
                    dev.role = topo_mod.Role.FREE
                    dev.model = None
                    retired.append(pe)
        return retired
