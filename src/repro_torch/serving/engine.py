"""Per-instance serving engine of the port: continuous batching, with the
decode step captured once as a CUDA graph.

The same public API as ``repro.serving.engine.InstanceEngine``.  A fixed
number of decode slots; finished sequences free their slot at once and queued
requests are admitted at the next step boundary.  Every decode step runs all
slots, appends to the caches of live slots only, and keeps the last token of
the others.  One host read per step (``tolist``) collects the new tokens.
``loaded_layers`` tracks live-scaling progress (``can_serve_alone``).

The engine runs on the device its parameters are on.  On CUDA it captures
its decode step (``TF.decode_step`` over its own ``last_tokens``,
``slot_live`` and cache tree) once, at its first admission, as one
``torch.cuda.CUDAGraph``, and each step replays it: the counterpart of the
JAX engine's decode step lowered once per (arch, n_slots) on first use, so
that a scaled instance pays no per-launch host cost, and an engine that
only prefills (a disaggregated prefill pool's) never captures.  The graph reads and writes fixed
storage, so every buffer it touches keeps its storage for the engine's
life: admission copies into the slots, the step updates in place, and no
path may swap the engine's parameter tensors.  On the CPU the same step
runs eagerly.  Prefill runs eagerly on both.

Every step that decodes writes one record to the process-wide step log
(``obs.steplog.STEP_LOG``): its phases on the host clock and, where it
replayed the graph, the replay's device time from two CUDA events recorded
on the stream around it (outside the graph, read once ``tolist`` has
returned: no synchronisation of their own).
"""

from __future__ import annotations

import dataclasses
import gc
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.obs.steplog import STEP_LOG, StepRecord, now


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    done: bool = False


class InstanceEngine:
    """Continuous-batching engine around the port's model."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        n_slots: int = 8,
        max_seq: int = 512,
    ):
        self.cfg = cfg = cfg.replace(uniform_decode=False)
        self.params = params
        self.device = params["final_norm"].device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.queue: deque[ServeRequest] = deque()
        self.active: dict[int, ServeRequest] = {}  # slot -> request
        self.free_slots = list(range(n_slots))[::-1]
        self.caches = TF.init_caches(cfg, n_slots, max_seq, device=self.device)
        self.last_tokens = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self.slot_live = torch.zeros((n_slots,), dtype=torch.bool, device=self.device)
        self.loaded_layers = cfg.n_layers  # < n_layers while live-scaling
        self.steps = 0
        self._graph: torch.cuda.CUDAGraph | None = None
        self._graph_launches: dict[str, int] = {}  # kernel launches of one replay
        self._replay_events: tuple[torch.cuda.Event, torch.cuda.Event] | None = None
        self._capture_pending = self.device.type == "cuda"  # at the first admission

    # -- the decode step ---------------------------------------------------------
    def _decode_all(self) -> None:
        """Decode every slot in place: live slots' caches and states advance
        and ``last_tokens`` takes their new tokens; free slots keep theirs.
        This is the captured region: nothing in it reads the host or keeps
        a tensor it allocated."""
        nxt, _ = TF.decode_step(self.cfg, self.params, self.last_tokens, self.caches,
                                self.slot_live)
        self.last_tokens.copy_(torch.where(self.slot_live, nxt, self.last_tokens))

    def _capture(self) -> None:
        """Warm up ``_decode_all`` on a side stream, then capture it as one
        CUDA graph.  This runs once, before the first admission's splice,
        while every slot is free: the warm-up runs on the real buffers, and
        the only writes a step makes for a free slot (an MoE model's K/V
        entry, and its scales in an int8 cache, at the slot's length:
        ``attention.gqa_decode``) land in a slot row that ``_splice_slot``
        overwrites whole when it admits a request.  Neither the warm-up's
        launches nor the capture count as launches; each replay adds the
        captured step's."""
        assert not bool(self.slot_live.any()), "the decode step is captured while every slot is free"
        self._capture_pending = False
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with ops.uncounted(), torch.cuda.stream(side):
                self._decode_all()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a collection during the capture could free the graph of an
            # engine dropped in a reference cycle, and destroying a graph
            # while a stream captures invalidates the capture: garbage waits
            # until the capture ends
            collecting = gc.isenabled()
            gc.disable()
            try:
                with ops.uncounted() as per_step, torch.cuda.graph(graph):
                    self._decode_all()
            finally:
                if collecting:
                    gc.enable()
        self._graph, self._graph_launches = graph, per_step
        self._replay_events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))

    def _decode(self) -> None:
        """One decode step: a replay of the captured graph on CUDA (its
        launches added to the kernels' counters; a step always follows an
        admission, which captured it), ``_decode_all`` on the CPU or where
        ``_capture_pending`` was cleared to keep an engine eager.  The
        replay lies between ``_replay_events`` on the stream it runs on."""
        if self._graph is None:
            self._decode_all()
            return
        stream = torch.cuda.current_stream(self.device)
        start, end = self._replay_events
        start.record(stream)
        self._graph.replay()
        end.record(stream)
        ops.add_launch_counts(self._graph_launches)

    # -- live scaling hooks -----------------------------------------------------
    def set_loaded_layers(self, k: int) -> None:
        self.loaded_layers = min(k, self.cfg.n_layers)

    def can_serve_alone(self) -> bool:
        return self.loaded_layers >= self.cfg.n_layers

    # -- public API --------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self.queue.append(req)

    def _splice_slot(self, slot: int, one: Any, first_token: int) -> None:
        """Copy a 1-slot prefill cache and its first token into ``slot`` in
        place.  Local admission and migrated-KV admission share it.  Every
        leaf of the cache tree (the layers' caches or SSM states and an int8
        cache's scales, the hybrid's shared-block caches) whose axis 1 is
        the slot axis takes the request's row, the reference engine's rule."""

        def splice(old, new):
            if isinstance(old, dict):
                for name in old:
                    splice(old[name], new[name])
            elif old.dim() >= 2 and old.shape[1] == self.n_slots:
                old[:, slot].copy_(new[:, 0])

        if self._capture_pending:
            self._capture()
        splice(self.caches, one)
        self.last_tokens[slot] = int(first_token)
        self.slot_live[slot] = True

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            slot = self.free_slots.pop()
            req.slot = slot
            nxt, one = self.prefill_only(req)
            self._splice_slot(slot, one, nxt)
            self.active[slot] = req

    # -- disaggregated-serving entry points --------------------------------------
    def prefill_only(self, req: ServeRequest) -> tuple[int, Any]:
        """Run the prefill phase only: returns (first_token, 1-slot cache)."""
        tokens = torch.as_tensor(req.prompt[None].astype(np.int32), device=self.device)
        one = TF.init_caches(self.cfg, 1, self.max_seq, device=self.device)
        nxt, one = TF.prefill(self.cfg, self.params, tokens, one)
        first = int(nxt[0])
        req.out_tokens.append(first)
        return first, one

    def admit_prefilled(self, req: ServeRequest, first_token: int, one: Any) -> bool:
        """Admit a request whose prefill ran elsewhere.  False when no decode
        slot is free (the caller keeps the payload queued)."""
        if not self.free_slots:
            return False
        slot = self.free_slots.pop()
        req.slot = slot
        self._splice_slot(slot, one, first_token)
        self.active[slot] = req
        return True

    def kv_used_frac(self) -> float:
        """Fraction of KV capacity held by live sequences (autoscaler signal)."""
        used = sum(len(r.prompt) + len(r.out_tokens) for r in self.active.values())
        return used / float(self.n_slots * self.max_seq)

    def step(self) -> list[ServeRequest]:
        """One continuous-batching iteration; returns finished requests.  A
        step that decodes writes its record to ``STEP_LOG``."""
        t_begin = now()
        self._admit()
        finished: list[ServeRequest] = []
        if not self.active:
            return finished
        live = len(self.active)
        t_launch = now()
        self._decode()
        t_launched = now()
        self.steps += 1
        tokens = self.last_tokens.tolist()
        t_synced = now()
        device_ms = (self._replay_events[0].elapsed_time(self._replay_events[1])
                     if self._graph is not None else None)
        for slot, req in list(self.active.items()):
            req.out_tokens.append(tokens[slot])
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                self.active.pop(slot)
                self.free_slots.append(slot)
                self.slot_live[slot] = False
        STEP_LOG.add(StepRecord(t_begin, t_launch, t_launched, t_synced, now(),
                                live, device_ms))
        return finished

    def run_until_done(self, max_steps: int = 10_000) -> list[ServeRequest]:
        out: list[ServeRequest] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not self.queue:
                break
        return out
