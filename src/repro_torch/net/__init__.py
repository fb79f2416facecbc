"""Unified flow-level network data plane.

Everything BLITZSCALE moves over the compute network — multicast chain
hops, KV-cache migrations, cold-start unicasts, sharded AllGathers and
background serving streams — rides one congestion-aware flow simulator
with progressive max-min fair sharing over the ``core.topology`` graph,
advanced event-by-event.  See ``flowsim.FlowSim`` for the engine and
``multicast_exec.MulticastExecution`` for plan execution timing.
"""

from repro_torch.net.events import (
    DEVICE_FAILED,
    DEVICE_RECOVERED,
    FAILURE_KINDS,
    FLOW_ABORTED,
    FLOW_COMPLETED,
    FLOW_REROUTED,
    FLOW_STARTED,
    LEAF_FAILED,
    LINK_DEGRADED,
    LINK_FAILED,
    LINK_RECOVERED,
    FlowEventLog,
    NetEvent,
)
from repro_torch.net.flows import Flow, FlowKind
from repro_torch.net.flowsim import FlowSim, flow_done_eps, maxmin_rates
from repro_torch.net.links import (
    DEV_IN,
    DEV_OUT,
    LEAF_DOWN,
    LEAF_UP,
    SCALEUP,
    Link,
    LinkProfile,
    NetworkModel,
)
from repro_torch.net.multicast_exec import MulticastExecution

__all__ = [
    "Flow",
    "FlowKind",
    "FlowSim",
    "FlowEventLog",
    "NetEvent",
    "maxmin_rates",
    "flow_done_eps",
    "MulticastExecution",
    "Link",
    "LinkProfile",
    "NetworkModel",
    "DEV_IN",
    "DEV_OUT",
    "LEAF_UP",
    "LEAF_DOWN",
    "SCALEUP",
    "FLOW_STARTED",
    "FLOW_COMPLETED",
    "FLOW_ABORTED",
    "FLOW_REROUTED",
    "LINK_DEGRADED",
    "LINK_FAILED",
    "LINK_RECOVERED",
    "DEVICE_FAILED",
    "DEVICE_RECOVERED",
    "LEAF_FAILED",
    "FAILURE_KINDS",
]
