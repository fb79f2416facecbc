"""Serverless multi-model MaaS demo on the port: scale-to-zero + multicast
cold start.

Three models share one 8-device fleet under the MaaS control plane
(repro_torch.serving.maas).  The script walks the serverless lifecycle the
paper builds toward (§1):

  phase 1 — a burst hits the hot model; the fleet grants it the free
            devices and its runtime live-scales (§5.4 policy inside);
  phase 2 — the cold models sit idle past the timeout: they drain, free
            every accelerator, and park at *zero* — the shared
            ParameterPool holds exactly one host-DRAM copy each (O(1));
  phase 3 — a late request arrives for a parked model: the fleet grants
            seats and the model cold-starts by re-multicasting parameters
            from its O(1) host copy, then serves.

A virtual clock drives the fleet so the run is deterministic.  Every
modelled device computes on the one torch device:

    python examples_torch/serve_maas.py               # cuda
    python examples_torch/serve_maas.py --device cpu
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import topology as tp
from repro_torch.core.autoscaler import PolicyConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serving.maas import FleetPolicy, FleetScheduler, ZERO

ARCHS = ["granite-8b", "qwen1.5-4b", "minicpm3-4b"]
PROMPT, GEN = 16, 6
TICK = 0.01


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; it raises without CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)

    topo = tp.add_host_sources(tp.make_cluster(2, 4, bw_gbps=100.0))
    fleet = FleetScheduler(topo, policy=FleetPolicy(idle_to_zero_s=0.5), verbose=True)

    cfgs = {}
    rng = np.random.default_rng(0)
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch, reduced=True)
        cfgs[cfg.name] = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        fleet.add_model(
            cfg,
            TF.init_params(cfg, gen, device=dev),
            n_prefill=1,
            n_decode=1,
            n_slots=2,
            max_seq=PROMPT + GEN + 8,
            model_bytes=int(200e6),  # ~16 ms modelled multicast on 100 Gbps
            prefill_capacity_tps=400.0,
            decode_capacity_tps=60.0,
            policy=PolicyConfig(max_instances=3, kv_upper=0.5, scale_down_timeout_s=0.4),
        )
    hot, _, cold = list(cfgs)

    def submit(model: str, now: float) -> None:
        prompt = rng.integers(0, cfgs[model].vocab_size, size=PROMPT).astype(np.int32)
        fleet.submit(model, prompt, GEN, now)

    def run_until_idle(t: float) -> float:
        while fleet.n_outstanding:
            t += TICK
            fleet.tick(t)
            assert fleet.param_pool.invariant_ok()
        return t

    print(f"== phase 1: burst of 8 requests on the hot model ({hot})")
    t = 0.0
    for _ in range(8):
        submit(hot, t)
    t = run_until_idle(t)
    print(f"   done at t={t:.2f}s, hot model holds "
          f"{fleet.tenants[hot].runtime.n_engines} engines\n")

    print("== phase 2: everyone idle -> fleet drains all models to zero")
    while not all(x.state == ZERO for x in fleet.tenants.values()):
        t += TICK
        fleet.tick(t)
        assert fleet.param_pool.invariant_ok()
    free = len(topo.spares())
    cache = {h: f"{b/1e6:.0f}MB" for h, b in fleet.param_pool.host_cache_bytes().items()}
    print(f"   at t={t:.2f}s all {len(ARCHS)} models are at zero; "
          f"{free}/8 accelerators free; host cache per host: {cache}\n")

    print(f"== phase 3: late request for a parked model ({cold}) -> cold start")
    submit(cold, t)
    t_cold = t
    t = run_until_idle(t)
    tc = fleet.tenants[cold]
    rep = tc.runtime.router.slo_report()
    print(
        f"   served at t={t:.2f}s: cold-start TTFT {rep.mean_ttft*1e3:.0f}ms "
        f"(submitted t={t_cold:.2f}s), multicast source: "
        f"{'O(1) host copy' if tc.runtime.stats.cold_starts_from_host else 'GPU copy'}\n"
    )

    s = fleet.stats
    print(
        f"fleet totals: {s.grants} grants, {s.cold_starts} cold starts, "
        f"{s.scale_to_zero_events} scale-to-zero events, "
        f"{s.gpu_seconds:.2f} GPU-seconds occupied"
    )
    assert s.cold_starts >= 1 and s.scale_to_zero_events >= len(ARCHS)


if __name__ == "__main__":
    main()
