"""FlowSim event-subscription API + serializable flow-event log.

The flow simulator used to talk to its consumers only through per-flow
callbacks (``on_complete`` / ``on_abort``) — enough for the party that
*started* a flow, but invisible to everyone else.  The control planes need
more: the FleetScheduler wants to know about a leaf failure the instant it
happens (not one tick later, when the victim runtime has drained its
half-loaded engine), and the regression harness wants the full event
stream of a seeded run to diff against a golden file.

``FlowSim.subscribe`` delivers every :class:`NetEvent` to every subscriber,
in simulation order:

  * ``FLOW_STARTED`` / ``FLOW_COMPLETED`` / ``FLOW_ABORTED`` — one per flow
    lifecycle edge (per-flow callbacks fire first, then subscribers see the
    settled world); ``FLOW_REROUTED`` when a failure moved a live flow onto
    a surviving spine plane instead of aborting it;
  * ``LINK_DEGRADED`` / ``LINK_FAILED`` / ``LINK_RECOVERED`` and
    ``DEVICE_FAILED`` / ``DEVICE_RECOVERED`` / ``LEAF_FAILED`` — scenario
    mutations.  Failure events are emitted AFTER the evicted flows' aborts
    have settled, so a subscriber reacting to ``LEAF_FAILED`` observes a
    consistent post-failure network (re-routes applied, doomed flows gone).

:class:`FlowEventLog` is the canonical subscriber for the golden-trace
regression tests: it renders each event as one deterministic text line
(``repr`` floats — shortest round-trip representation, so a golden diff is
bit-for-bit on event times).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.net.flows import Flow
    from repro_torch.net.links import LinkKey

FLOW_STARTED = "flow_started"
FLOW_COMPLETED = "flow_completed"
FLOW_ABORTED = "flow_aborted"
#: a link/device/leaf failure moved a still-live flow onto a surviving
#: spine plane instead of aborting it; emitted after the failure's aborts
#: settle and BEFORE the failure event itself, so incident bundles show
#: the reroute inside the failure window
FLOW_REROUTED = "flow_rerouted"
LINK_DEGRADED = "link_degraded"
LINK_FAILED = "link_failed"
LINK_RECOVERED = "link_recovered"
DEVICE_FAILED = "device_failed"
DEVICE_RECOVERED = "device_recovered"
LEAF_FAILED = "leaf_failed"

#: the event kinds a placement control plane should re-plan on
FAILURE_KINDS = frozenset({LINK_FAILED, DEVICE_FAILED, LEAF_FAILED})


@dataclasses.dataclass(frozen=True)
class NetEvent:
    """One observable network event, stamped with simulation time."""

    kind: str
    t: float
    flow: "Flow | None" = None
    link_key: "LinkKey | None" = None
    device: int | None = None
    leaf: int | None = None

    def render(self) -> str:
        """One deterministic text line (golden-trace serialization)."""
        parts = [repr(float(self.t)), self.kind]
        if self.flow is not None:
            f = self.flow
            parts.append(
                f"{f.kind.value}[{f.tag or '-'}] {f.src}->{f.dst} "
                f"{repr(float(f.size))}"
            )
        if self.link_key is not None:
            parts.append("link=" + ":".join(str(x) for x in self.link_key))
        if self.device is not None:
            parts.append(f"dev={self.device}")
        if self.leaf is not None:
            parts.append(f"leaf={self.leaf}")
        return " ".join(parts)


class FlowEventLog:
    """Subscriber that accumulates rendered event lines.

    Usage::

        log = FlowEventLog()
        sim.subscribe(log)
        ...  # run the scenario
        assert log.lines() == golden_file_lines

    ``maxlen`` turns the log into a bounded ring buffer: only the newest
    ``maxlen`` events are retained and ``dropped`` counts evictions — the
    always-on production shape (keep the recent window, never grow without
    bound).  The default (``maxlen=None``) keeps everything, which is what
    the golden-trace tests rely on.
    """

    def __init__(self, maxlen: int | None = None):
        from collections import deque

        self.events: "deque[NetEvent]" = deque(maxlen=maxlen)
        self.maxlen = maxlen
        self.dropped = 0

    def __call__(self, ev: NetEvent) -> None:
        if self.maxlen is not None and len(self.events) == self.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def lines(self) -> list[str]:
        return [ev.render() for ev in self.events]

    def dump(self) -> str:
        return "\n".join(self.lines()) + "\n"

    def count(self, kind: str) -> int:
        return sum(1 for ev in self.events if ev.kind == kind)

    def iter_kinds(self, *kinds: str):
        """Iterate retained events whose kind is in ``kinds`` (e.g.
        ``log.iter_kinds(*FAILURE_KINDS)`` for the replan-worthy subset)."""
        want = frozenset(kinds)
        return (ev for ev in self.events if ev.kind in want)

    @property
    def oldest_t(self) -> float | None:
        """Timestamp of the oldest RETAINED event (None when empty) — a
        window reader compares it against its window start to detect that
        eviction already ate into the window."""
        return self.events[0].t if self.events else None

    def since(self, t: float) -> list[NetEvent]:
        """Retained events at/after ``t`` (the flight-recorder window)."""
        return [ev for ev in self.events if ev.t >= t]

    def truncated_since(self, t: float) -> bool:
        """True when events at/after ``t`` are KNOWN to have been evicted:
        the ring has dropped events and the oldest retained one is already
        inside the window (or nothing survives at all)."""
        if self.dropped == 0:
            return False
        return self.oldest_t is None or self.oldest_t > t
