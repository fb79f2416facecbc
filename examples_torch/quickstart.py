"""Quickstart: the BlitzScale mechanism in ~60 lines, on the port.

1. build a cluster topology + the O(1) global parameter pool,
2. generate an interference-free multicast plan (Algorithm 11),
3. see why the serial chain makes scale time independent of receiver count,
4. watch live (ZigZag) scaling beat best-effort on the paper's Fig.15 example.

    python examples_torch/quickstart.py

Host arithmetic only (no tensor): it prints what ``examples/quickstart.py``
prints, apart from the two wall-clock figures.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

from repro_torch.core import multicast as mc
from repro_torch.core import topology as tp
from repro_torch.core.parameter_pool import ParameterPool
from repro_torch.core.zigzag import simulate_best_effort, simulate_zigzag, solve_pipeline_ilp


def main(argv: list[str] | None = None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    # -- 1. a 4-host x 8-GPU cluster with NVLink scale-up + 100G RDMA -------
    topo = tp.add_host_sources(tp.make_cluster(n_hosts=4, devs_per_host=8))
    pool = ParameterPool(topo)
    model, size = "llama3-8b", 16_000_000_000
    pool.register(model, size)  # exactly ONE host-DRAM copy cluster-wide

    # one serving instance is already deployed (a decode instance: egress free)
    pool.deploy(model, [0])
    topo.device(0).role = tp.Role.DECODE

    # -- 2. a burst arrives: scale 6 new instances --------------------------
    gpu_srcs, host_copy = pool.sources(model)
    spares = [d.id for d in topo.spares()]
    plan = mc.plan_multicast(topo, gpu_srcs, spares, n=6)
    assert mc.validate_plan(topo, plan) == [], "interference-free by construction"
    print(f"plan: {len(plan.chains)} chain(s) in {plan.gen_seconds*1e3:.2f} ms")
    for i, ch in enumerate(plan.chains):
        path = " -> ".join(str(n.device_ids) for n in ch.nodes)
        print(f"  chain {i}: {path}  bottleneck {ch.bottleneck_gbps:.0f} Gbps")

    # -- 3. chain time is independent of the receiver count -----------------
    t = plan.transfer_seconds(size)
    print(f"scale 6 instances over the compute network: {t*1e3:.0f} ms "
          f"(1 instance would take {mc.chain_time_model(size, 100.0, 1)*1e3:.0f} ms — same!)")
    print(f"SSD at 10 Gbps would take {size / (10e9/8):.1f} s")

    # -- 4. live ZigZag scaling (paper Fig.15: 7 requests, 7 layers, Time_l=6)
    be = simulate_best_effort(7, 7, 6.0)
    zz = simulate_zigzag(7, 7, 6.0)
    ilp = solve_pipeline_ilp(7, 7, 6.0)
    print("\nlive scaling (7 layers, load=6x exec):")
    print(f"  best-effort avg latency {be.avg_latency:.1f}, makespan {be.makespan:.0f}")
    print(f"  ZigZag      avg latency {zz.avg_latency:.1f}, makespan {zz.makespan:.0f}")
    print(f"  exact ILP   avg latency {ilp.avg_latency:.1f} (solved in {ilp.solve_ms:.1f} ms)")


if __name__ == "__main__":
    main()
