"""Per-instance serving engine of the port: continuous batching, eager.

The same public API as ``repro.serving.engine.InstanceEngine``.  A fixed
number of decode slots; finished sequences free their slot at once and queued
requests are admitted at the next step boundary.  Every decode step runs all
slots, appends to the caches of live slots only, and keeps the last token of
the others.  One host read per step (``tolist``) collects the new tokens.
``loaded_layers`` tracks live-scaling progress (``can_serve_alone``).

The engine runs on the device its parameters are on.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


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
        leaf of the cache tree (the layers' caches or SSM states, the
        hybrid's shared-block caches) whose axis 1 is the slot axis takes
        the request's row, the reference engine's rule."""

        def splice(old, new):
            if isinstance(old, dict):
                for name in old:
                    splice(old[name], new[name])
            elif old.dim() >= 2 and old.shape[1] == self.n_slots:
                old[:, slot].copy_(new[:, 0])

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
        """One continuous-batching iteration; returns finished requests."""
        self._admit()
        finished: list[ServeRequest] = []
        if not self.active:
            return finished
        nxt, self.caches = TF.decode_step(
            self.cfg, self.params, self.last_tokens, self.caches, self.slot_live
        )
        self.last_tokens = torch.where(self.slot_live, nxt, self.last_tokens)
        self.steps += 1
        tokens = self.last_tokens.tolist()
        for slot, req in list(self.active.items()):
            req.out_tokens.append(tokens[slot])
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                self.active.pop(slot)
                self.free_slots.append(slot)
                self.slot_live[slot] = False
        return finished

    def run_until_done(self, max_steps: int = 10_000) -> list[ServeRequest]:
        out: list[ServeRequest] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not self.queue:
                break
        return out
