"""Live autoscaling of the port: the cooperative execution protocol (paper §4,
§5.2), as in ``repro.core.live_scaling``.

While a scaling instance (the *target*) is still receiving parameters, it
runs the first ``k`` loaded layers of every request and forwards the
activation to the overloaded *source*, which runs layers ``k..L``.
``cooperative_forward`` computes that split; its contract is that it equals
the monolithic forward for every ``k``.  ``Phase`` and ``LiveSession`` are
the host-side state machine of one (source, target) pair.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

from repro_torch.core.zigzag import live_throughput_multiplier
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


class Phase(enum.Enum):
    REDIRECT = "redirect"
    COOPERATIVE = "cooperative"
    REBALANCED = "rebalanced"


@dataclasses.dataclass
class LiveSession:
    """Host-side state machine coordinating one (source, target) pair.

    Progress is constant-rate (``link_bytes_per_s``) or, when
    ``progress_bytes`` is set, the bytes actually delivered so far."""

    n_layers: int
    layer_bytes: int
    link_bytes_per_s: float
    started_at: float
    phase: Phase = Phase.REDIRECT
    progress_bytes: Callable[[], float] | None = None

    def layers_loaded(self, now: float) -> int:
        if self.progress_bytes is not None:
            if self.layer_bytes <= 0:
                return self.n_layers
            return min(self.n_layers, int(self.progress_bytes() / self.layer_bytes))
        if self.link_bytes_per_s <= 0:
            return self.n_layers
        dt = max(0.0, now - self.started_at)
        return min(self.n_layers, int(dt * self.link_bytes_per_s / self.layer_bytes))

    def throughput_multiplier(self, now: float) -> float:
        k = self.layers_loaded(now)
        if k >= self.n_layers:
            self.phase = Phase.REBALANCED
            return 2.0
        if k >= 1 and self.phase is Phase.REDIRECT:
            self.phase = Phase.COOPERATIVE
        return live_throughput_multiplier(k, self.n_layers)

    def done_at(self) -> float:
        return self.started_at + self.n_layers * self.layer_bytes / self.link_bytes_per_s


def cooperative_forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S)
    k: int,  # layers loaded on the target
    frames: torch.Tensor | None = None,  # (B, Sf, d): a vlm's patch frames
) -> torch.Tensor:
    """Target runs layers [0, k), source runs [k, L); returns logits (B, S, V).

    A vlm's frames enter through the embedding.  An enc-dec model's decoder
    layers run here without cross-attention (``forward_layers_range``), as in
    the reference."""
    positions = TF._positions(tokens)
    x = TF._embed(cfg, params, tokens, frames)
    shared = params.get("shared")  # the hybrid's shared block runs on both sides
    # ---- target side: layers [0, k)
    x = TF.forward_layers_range(cfg, params["layers"], x, 0, k, positions, shared)
    # (activation crosses the network here)
    # ---- source side: layers [k, L)
    x = TF.forward_layers_range(cfg, params["layers"], x, k, cfg.n_layers, positions, shared)
    x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)


def select_live_pairs(
    plan,  # MulticastPlan
    overloaded: list[int],  # device ids of overloaded instances
    *,
    slo_requires_live: bool = True,
) -> list[tuple[int, int]]:
    """§5.2 'Selecting instances for live scaling': pair each overloaded
    instance with a chain-tail node (slowest link, free egress — Fig. 12).
    Returns (source_device, target_device) pairs."""
    if not slo_requires_live:
        return []
    tails = [n.device_ids[0] for n in plan.live_scale_nodes]
    return list(zip(overloaded, tails))
