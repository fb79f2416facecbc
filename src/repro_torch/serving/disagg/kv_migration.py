"""KV-cache migration channel: prefill→decode page transfer (paper §2.1, §5.4).

A finished prefill freezes the request's KV pages (the 1-slot cache dict
the engine produced) and ships them to a decode instance over the scale-out
network as a :class:`repro.net.Flow` of kind ``KV_MIGRATION`` — page-
granular like :class:`repro.models.kvcache.PagedKVCache` blocks.

The channel is a thin adapter over the shared flow-level simulator
(:class:`repro.net.FlowSim`); the per-ingress fair-share incast model that
used to live here is deleted.  The *incast* effect that motivates §5.4's
mutation policy now emerges from max-min sharing: a decode instance that is
simultaneously a live-scaling target has the parameter multicast hop and
every migration headed to it contending on the same ingress link — which is
exactly why BlitzScale mutates an already-parameterised prefill instance
into a decode instance instead of live-scaling decode directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import topology as topo_mod
from repro_torch.net import Flow, FlowKind, FlowSim
from repro_torch.serving.engine import ServeRequest

DEFAULT_PAGE_TOKENS = 16  # tokens per migrated KV page (block granularity)


def _tensors(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def payload_bytes(cache_one: Any, prompt_len: int, max_seq: int) -> int:
    """Bytes of KV state a request of ``prompt_len`` tokens actually owns.

    The 1-slot cache dict is allocated at ``max_seq``; only the prompt
    prefix carries information, so the migrated volume is the prompt-length
    fraction of the tensors' bytes.  The port's 1-slot cache holds the same
    leaves as the JAX one (``k``, ``v`` and int32 ``lengths``), so the count
    equals the JAX package's for the same config."""
    total = sum(t.numel() * t.element_size() for t in _tensors(cache_one))
    return max(1, int(total * prompt_len / max(max_seq, 1)))


@dataclasses.dataclass
class MigrationPayload:
    """One request's frozen KV pages in flight prefill→decode."""

    rid: int
    request: ServeRequest
    first_token: int
    cache_one: Any  # 1-slot cache dict from InstanceEngine.prefill_only
    prompt_len: int
    total_bytes: int
    n_pages: int
    src_dev: int
    dst_dev: int
    # snapshot of the emitted tokens at freeze time — an independent COPY,
    # so the resume-side gap check can detect the live request being decoded,
    # truncated, or replayed while its KV pages were in flight
    tokens_at_freeze: list[int] = dataclasses.field(default_factory=list)
    # realized transfer timestamps (latency + contention included) — small
    # KV payloads are latency-dominated under the per-hop latency model,
    # and this is where that shows up per request
    sent_at: float | None = None
    landed_at: float | None = None

    @property
    def transfer_seconds(self) -> float | None:
        if self.sent_at is None or self.landed_at is None:
            return None
        return self.landed_at - self.sent_at


def make_payload(
    req: ServeRequest,
    first_token: int,
    cache_one: Any,
    *,
    max_seq: int,
    src_dev: int,
    dst_dev: int,
    page_tokens: int = DEFAULT_PAGE_TOKENS,
) -> MigrationPayload:
    prompt_len = int(len(req.prompt))
    nbytes = payload_bytes(cache_one, prompt_len, max_seq)
    n_pages = -(-prompt_len // page_tokens)  # ceil
    return MigrationPayload(
        rid=req.rid,
        request=req,
        first_token=first_token,
        cache_one=cache_one,
        prompt_len=prompt_len,
        total_bytes=nbytes,
        n_pages=n_pages,
        src_dev=src_dev,
        dst_dev=dst_dev,
        tokens_at_freeze=list(req.out_tokens),
    )


class KVMigrationChannel:
    """KV-page flows on the shared flow-level network simulator.

    ``start`` launches one ``KV_MIGRATION`` flow per frozen request;
    ``poll(now)`` advances the underlying :class:`FlowSim` to ``now`` and
    returns payloads whose flows finished arriving.  Bandwidth sharing —
    including incast with live-scaling parameter streams, multicast chains
    and co-tenant traffic — is entirely the simulator's max-min allocation;
    a standalone channel builds its own FlowSim, a ClusterRuntime passes
    the runtime-wide (or, under MaaS, fleet-wide) one."""

    def __init__(self, topo: topo_mod.Topology | None = None, *,
                 net: FlowSim | None = None, tracer=None):
        if net is None:
            if topo is None:
                raise ValueError("KVMigrationChannel needs a topology or a FlowSim")
            net = FlowSim(topo)
        self.net = net
        # duck-typed (repro.obs.Tracer-shaped); None / disabled -> no spans
        self.tracer = tracer if tracer is not None and tracer.enabled else None
        self._spans: dict[int, object] = {}  # rid -> open migration span
        self._arrived: list[MigrationPayload] = []
        self._failed: list[MigrationPayload] = []
        self.transfer_log: list[float] = []  # realized seconds per landing

    @property
    def flows(self) -> list[Flow]:
        """In-flight KV migration flows (on the shared simulator)."""
        return [f for f in self.net.flows if f.kind is FlowKind.KV_MIGRATION]

    def inflight_to(self, dev: int) -> int:
        # indexed on the simulator (dst table) — no scan over the fleet's
        # whole flow population just to admit one migration
        return len(self.net.flows_into(dev, (FlowKind.KV_MIGRATION,)))

    # -- transfer lifecycle -------------------------------------------------
    def start(self, payload: MigrationPayload, now: float) -> None:
        self.net.advance_to(now)
        payload.sent_at = self.net.now  # before start: an instant (same-
        payload.landed_at = None  # device) landing fires _landed inside it
        if self.tracer is not None:
            self._spans[payload.rid] = self.tracer.begin(
                "kv_migration", self.net.now, cat="migration",
                track="migration", rid=payload.rid, src=payload.src_dev,
                dst=payload.dst_dev, bytes=payload.total_bytes)
        self.net.start(
            Flow(
                FlowKind.KV_MIGRATION,
                payload.src_dev,
                payload.dst_dev,
                float(payload.total_bytes),
                payload=payload,
                on_complete=self._landed,
                on_abort=self._aborted,
                tag=f"kv:{payload.rid}",
            )
        )

    def _landed(self, flow: Flow, t: float) -> None:
        flow.payload.landed_at = t
        self.transfer_log.append(t - flow.payload.sent_at)
        if self.tracer is not None:
            self.tracer.end(self._spans.pop(flow.payload.rid, None), t)
        self._arrived.append(flow.payload)

    def _aborted(self, flow: Flow, t: float) -> None:
        # a link/NIC failure killed the transfer: the frozen pages are
        # still resident on the prefill side, so the caller re-targets
        # (take_failed) instead of losing the request
        if self.tracer is not None:
            self.tracer.end(self._spans.pop(flow.payload.rid, None), t,
                            aborted=True)
        self._failed.append(flow.payload)

    def poll(self, now: float) -> list[MigrationPayload]:
        """Advance the network to ``now``; return payloads that arrived."""
        self.net.advance_to(now)
        done, self._arrived = self._arrived, []
        return done

    def take_failed(self) -> list[MigrationPayload]:
        """Payloads whose flows were aborted by a failure — the runtime
        re-targets them onto a surviving decode instance."""
        out, self._failed = self._failed, []
        return out
