"""The engine's step log: one record a decode step, always on.

``InstanceEngine.step`` stamps each phase of a step with :func:`now`, the
host's ``time.perf_counter`` clock, and appends one :class:`StepRecord` to
:data:`STEP_LOG`, the process-wide log, so that what an engine wrote
outlives the engine:

  * ``t_begin`` at the step's entry, ``t_launch`` once ``_admit`` has run,
    ``t_launched`` once the decode step is launched, ``t_synced`` once the
    host holds the new tokens (``tolist``), ``t_end`` after the per-slot
    bookkeeping.  The phases' self times are ``admit`` = ``t_launch -
    t_begin``, ``launch`` = ``t_launched - t_launch``, ``wait`` =
    ``t_synced - t_launched`` and ``bookkeep`` = ``t_end - t_synced``;
    together they make up the step, ``t_end - t_begin``;
  * ``live``, the slots the step decoded;
  * ``device_ms``, the device's time for the captured step's replay, from
    two CUDA events recorded on the replay's stream just before and just
    after it, read once the host holds the tokens; ``None`` where no graph
    was replayed (the CPU, an eager engine).  No host time stands in for it.

A step that finds no live slot writes nothing.  A profiler's timeline maps
the stamps through one pair of readings taken together, ``perf_counter``
and the trace's clock.  The log is a ring: it keeps the last ``maxlen``
records and counts those it dropped.  Host code: the engine passes floats.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

__all__ = ["StepRecord", "StepLog", "STEP_LOG", "now"]

PHASES = ("admit", "launch", "wait", "bookkeep")


def now() -> float:
    """The step log's clock, ``time.perf_counter`` seconds."""
    return time.perf_counter()  # simcheck: disable=determinism -- metadata, never replayed


class StepRecord(NamedTuple):
    t_begin: float  # perf_counter seconds
    t_launch: float
    t_launched: float
    t_synced: float
    t_end: float
    live: int
    device_ms: float | None


class StepLog:
    """A bounded ring of :class:`StepRecord`, oldest first."""

    def __init__(self, maxlen: int = 8192):
        self._ring: deque[StepRecord] = deque(maxlen=maxlen)
        self.evicted = 0

    def add(self, rec: StepRecord) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.evicted += 1
        self._ring.append(rec)

    def records(self) -> list[StepRecord]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.evicted = 0

    def totals(self) -> dict:
        """Over the records held: steps, live-slot tokens, the device seconds
        of the steps that have them (``None`` where none has) and the
        seconds of each phase and of the whole step."""
        recs = self._ring
        device = [r.device_ms for r in recs if r.device_ms is not None]
        out = {"steps": len(recs), "tokens": sum(r.live for r in recs),
               "device_s": sum(device) / 1e3 if device else None}
        for i, name in enumerate(PHASES):  # between the record's stamps i and i + 1
            out[f"{name}_s"] = sum(r[i + 1] - r[i] for r in recs)
        out["step_s"] = sum(r.t_end - r.t_begin for r in recs)
        return out


#: the process-wide log every engine writes into
STEP_LOG = StepLog()
