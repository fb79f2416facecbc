"""Cluster/network model used by the multicast planner (paper Fig. 10).

The paper models a scale-up + scale-out hybrid network:

  * devices inside a *scale-up group* (NVLink domain on GPU; an ICI-connected
    pod slice on TPU) have ultra-high bandwidth (1.6-3.6 Tbps) — intra-group
    transfers are treated as near-free and groups are collapsed into single
    logical nodes by the planner;
  * devices attach to a *leaf switch* with per-device bandwidth ``BW_i``;
    devices under one leaf have full-mesh min(BW_i, BW_j) connectivity;
  * leaves connect via a spine whose bandwidth is <= intra-leaf (we do not
    model the spine explicitly — ECMP/VLT assumption, §5.1);
  * every link is FULL-DUPLEX: flows in opposite directions on the same link
    do not contend (Fig. 7c) — the cornerstone of interference-free planning.

Device roles track what serving traffic currently occupies each direction of
a device's link so the planner can prune interfering sources/targets.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Iterable, Sequence


class Role(enum.Enum):
    """What an accelerator is currently doing — determines which direction of
    its network link carries serving traffic (PD-disaggregated LLMs move
    KVCache prefill->decode, §2.1)."""

    FREE = "free"
    PREFILL = "prefill"  # egress busy (sends KVCache to decode instances)
    DECODE = "decode"  # ingress busy (receives KVCache)
    COLOCATED = "colocated"  # both directions carry some serving traffic
    HOST_CACHE = "host_cache"  # CPU host holding the O(1) cached copy


@dataclasses.dataclass
class Device:
    """One accelerator (or a CPU host acting as a parameter source)."""

    id: int
    host: int
    leaf: int
    scaleup: int  # scale-up (NVLink/ICI) domain id
    bw_gbps: float  # scale-out link bandwidth
    role: Role = Role.FREE
    model: str | None = None  # model currently deployed (None = spare)
    is_host: bool = False  # CPU host memory source (PCIe-attached)

    @property
    def egress_busy(self) -> bool:
        return self.role in (Role.PREFILL, Role.COLOCATED)

    @property
    def ingress_busy(self) -> bool:
        return self.role in (Role.DECODE, Role.COLOCATED)


@dataclasses.dataclass
class Topology:
    devices: list[Device]

    def __post_init__(self):
        self._by_id = {d.id: d for d in self.devices}

    def device(self, i: int) -> Device:
        return self._by_id[i]

    def leaf_of(self, i: int) -> int:
        return self._by_id[i].leaf

    def scaleup_of(self, i: int) -> int:
        return self._by_id[i].scaleup

    def bw(self, i: int) -> float:
        return self._by_id[i].bw_gbps

    # ------------------------------------------------------------------
    def spares(self) -> list[Device]:
        return [d for d in self.devices if d.role is Role.FREE and not d.is_host]

    def sources_for(self, model: str) -> list[Device]:
        """All devices holding `model` parameters (GPU instances + hosts)."""
        return [d for d in self.devices if d.model == model]

    def scaleup_groups(self, ids: Iterable[int]) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for i in ids:
            out.setdefault(self.scaleup_of(i), []).append(i)
        return out

    def link_bw(self, i: int, j: int) -> float:
        """Effective scale-out bandwidth between two devices (full-mesh
        min() within a leaf; the spine is not modelled — §5.1)."""
        return min(self.bw(i), self.bw(j))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def make_cluster(
    n_hosts: int,
    devs_per_host: int = 8,
    *,
    hosts_per_leaf: int = 2,
    bw_gbps: float = 200.0,
    scaleup_per_host: bool = True,
    start_id: int = 0,
) -> Topology:
    """A leaf-spine GPU/TPU cluster: each host is one scale-up domain (the
    paper's cluster A: 4x8 A800 + NVLink; our TPU mapping: one ICI slice)."""
    devices: list[Device] = []
    i = start_id
    for h in range(n_hosts):
        leaf = h // hosts_per_leaf
        for _ in range(devs_per_host):
            devices.append(
                Device(
                    id=i,
                    host=h,
                    leaf=leaf,
                    scaleup=h if scaleup_per_host else 0,
                    bw_gbps=bw_gbps,
                )
            )
            i += 1
    return Topology(devices)


def add_host_sources(
    topo: Topology, *, pcie_gbps: float = 256.0, per_host: bool = True
) -> Topology:
    """Append one CPU-host pseudo-device per host: the O(1) cached copy can
    be broadcast from there when no GPU instance holds the model."""
    max_id = max(d.id for d in topo.devices) + 1
    hosts = sorted({d.host for d in topo.devices})
    extra = []
    for k, h in enumerate(hosts):
        leaf = next(d.leaf for d in topo.devices if d.host == h)
        extra.append(
            Device(
                id=max_id + k,
                host=h,
                leaf=leaf,
                scaleup=-1 - h,  # hosts are not in any accelerator scale-up domain
                bw_gbps=pcie_gbps,
                role=Role.HOST_CACHE,
                is_host=True,
            )
        )
    return Topology(topo.devices + extra)


# ---------------------------------------------------------------------------
# Reference hardware constants (paper Table 1/2 + TPU v5e targets)
# ---------------------------------------------------------------------------

# paper Table 1 (cluster A / B)
RDMA_GBPS = 100.0
PCIE_HOST_GPU_GBPS = 128.0
SSD_GBPS = 10.0
NVLINK_GBPS = 1600.0

# TPU v5e single-chip targets (roofline constants, §Roofline)
TPU_BF16_TFLOPS = 197.0
TPU_HBM_GBPS_BYTES = 819.0e9  # bytes/s
TPU_ICI_GBPS_BYTES = 50.0e9  # bytes/s per link


def gbps_to_bytes_per_s(gbps: float) -> float:
    return gbps * 1e9 / 8.0
