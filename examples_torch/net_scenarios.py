"""Walkthrough of the flow-level network data plane (`repro_torch.net`).

Five short acts on one 2-leaf cluster:

  1. a multicast scale-up executes as flows and matches the plan's
     dedicated-link estimate;
  2. a KV-cache drain into the same targets slows it — the §5.4 incast
     emerging from max-min sharing, not from a hand-written model;
  3. a degraded downlink stretches everything (scenario knob);
  4. a device failure aborts the parameter stream mid-transfer and the
     abort callback re-plans from the surviving sources;
  5. on a 2-plane spine, a failed uplink plane re-routes flows instead.

    python examples_torch/net_scenarios.py

Host arithmetic only (no tensor): it prints what
``examples/net_scenarios.py`` prints.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

from repro_torch.core import multicast as mc
from repro_torch.core import topology as tp
from repro_torch.net import LEAF_DOWN, LEAF_UP, Flow, FlowKind, FlowSim, MulticastExecution

MODEL_BYTES = int(16e9)  # 8B model in bf16
KV_BYTES = int(2e9)


def build():
    topo = tp.add_host_sources(tp.make_cluster(4, 4, bw_gbps=100.0))
    for i in (0, 1):  # decode instances in leaf 0 hold the model (egress free)
        topo.device(i).model = "m"
        topo.device(i).role = tp.Role.DECODE
    tgts = [d.id for d in topo.spares() if d.leaf == 1][:4]
    return topo, [0, 1], tgts


def act(title):
    print(f"\n=== {title}")


def main(argv: list[str] | None = None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    act("1. dedicated links: flows reproduce the analytic chain time")
    topo, srcs, tgts = build()
    plan = mc.plan_multicast(topo, srcs, tgts, len(tgts))
    sim = FlowSim(topo)
    ex = MulticastExecution(plan, MODEL_BYTES)
    ex.start(sim, 0.0)
    sim.advance_to(1e6)
    print(f"   plan estimate {plan.transfer_seconds(MODEL_BYTES):.2f}s, "
          f"realized {ex.done_at:.2f}s over {len(ex.flows)} flows")

    act("2. + KV drain into the same targets: incast emerges")
    topo, srcs, tgts = build()
    plan = mc.plan_multicast(topo, srcs, tgts, len(tgts))
    sim = FlowSim(topo)
    ex = MulticastExecution(plan, MODEL_BYTES)
    ex.start(sim, 0.0)
    kv = [sim.start(Flow(FlowKind.KV_MIGRATION, 2 + k, tgts[k % len(tgts)],
                         float(KV_BYTES)), 0.0) for k in range(4)]
    sim.advance_to(1e6)
    print(f"   scale-up now {ex.done_at:.2f}s; last KV page lands at "
          f"{max(f.finished_at for f in kv):.2f}s")

    act("3. degraded downlink (x0.1): both consumers stretch")
    topo, srcs, tgts = build()
    plan = mc.plan_multicast(topo, srcs, tgts, len(tgts))
    sim = FlowSim(topo)
    sim.degrade_link((LEAF_DOWN, 1, 0), 0.1)
    ex = MulticastExecution(plan, MODEL_BYTES)
    ex.start(sim, 0.0)
    sim.advance_to(1e6)
    print(f"   scale-up {ex.done_at:.2f}s on the degraded path")

    act("4. device failure mid-transfer: abort callback -> re-plan")
    topo, srcs, tgts = build()
    plan = mc.plan_multicast(topo, srcs, tgts, len(tgts))
    sim = FlowSim(topo)
    events = []
    ex = MulticastExecution(plan, MODEL_BYTES,
                            on_abort=lambda e, t: events.append(t))
    ex.start(sim, 0.0)
    sim.fail_device(tgts[0], 0.2)
    print(f"   aborted at t={events[0]:.2f}s; surviving spares: "
          f"{[d.id for d in topo.spares() if sim.device_ok(d.id)][:6]}...")
    replan_tgts = [i for i in tgts if sim.device_ok(i)]
    plan2 = mc.plan_multicast(topo, srcs, replan_tgts, len(replan_tgts))
    ex2 = MulticastExecution(plan2, MODEL_BYTES)
    ex2.start(sim, 0.2)
    sim.advance_to(1e6)
    print(f"   re-planned onto {len(replan_tgts)} healthy targets, "
          f"done at t={ex2.done_at:.2f}s")

    act("5. dual-plane spine: a failed uplink plane re-routes")
    topo, srcs, tgts = build()
    sim = FlowSim(topo, spine_planes=2)
    f = sim.start(Flow(FlowKind.COLD_START, srcs[0], tgts[0], float(MODEL_BYTES)), 0.0)
    plane = next(l.key for l in f.path if l.key[0] == LEAF_UP)
    aborted = sim.fail_link(plane, 0.3)
    assert aborted == [] and not f.aborted
    sim.advance_to(1e6)
    print(f"   plane {plane} failed at 0.3s; flow re-routed and finished at "
          f"{f.finished_at:.2f}s (no abort)")

    print("\nall five scenarios behaved as modelled")


if __name__ == "__main__":
    main()
