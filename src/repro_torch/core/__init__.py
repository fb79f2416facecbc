"""Core of the PyTorch port: the paper's contribution as host modules and
torch data-plane pieces, under the JAX package's names.

  topology        — scale-up/scale-out cluster model (Fig. 10)
  parameter_pool  — global O(1)-cached parameter manager (§5.3)
  multicast       — Algorithm 11 interference-free multi-chain planner (§5.1)
  zigzag          — live-scaling pipeline ILP + ILP-free scheduler (§5.2)
  live_scaling    — cooperative execution protocol + the split forward
  autoscaler      — load monitor + bound policy + decode pre-scaling (§5.3-4)
  collectives     — chain broadcast over torch.distributed
  simulator       — discrete-event MAAS evaluation harness (Fig. 3 method),
                    in modelled seconds on the paper's A800 cluster
"""

from repro_torch.core.autoscaler import Autoscaler, PolicyConfig
from repro_torch.core.live_scaling import LiveSession, cooperative_forward
from repro_torch.core.multicast import MulticastPlan, plan_multicast, validate_plan
from repro_torch.core.parameter_pool import ParameterPool
from repro_torch.core.topology import Role, Topology, make_cluster
from repro_torch.core.zigzag import (
    simulate_best_effort,
    simulate_zigzag,
    solve_pipeline_ilp,
)

__all__ = [
    "Autoscaler",
    "PolicyConfig",
    "LiveSession",
    "cooperative_forward",
    "MulticastPlan",
    "plan_multicast",
    "validate_plan",
    "ParameterPool",
    "Role",
    "Topology",
    "make_cluster",
    "simulate_best_effort",
    "simulate_zigzag",
    "solve_pipeline_ilp",
]
