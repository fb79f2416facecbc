"""PD-disaggregated serving demo on the port, on a real-trace burst (paper
§5.4).

A BurstGPT-shaped arrival burst (repro_torch.serving.traces) hits a
disaggregated cluster of prefill + decode engine pools.  Watch the §5.4
policy work:

  * finished prefills freeze their KV pages and migrate them to a decode
    instance over the modelled compute network;
  * the burst trips the autoscaler: decode capacity is raised by *mutating*
    a prefill instance in place (parameters already resident — zero bytes
    move, no incast with the KVCache migration traffic) while a replacement
    prefill live-scales on a spare device;
  * when the burst passes, the scale-down timeout drains the extra
    instances and frees their devices.

    python examples_torch/serve_disagg.py               # cuda
    python examples_torch/serve_disagg.py --device cpu

Every modelled device computes on the one torch device.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import topology as tp
from repro_torch.core.autoscaler import PolicyConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serving import traces
from repro_torch.serving.disagg import ClusterRuntime

ARCH = "granite-8b"
PROMPT, GEN = 24, 8
TRACE_SECONDS = 12.0  # burstgpt's first burst, compressed


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; it raises without CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_config(ARCH, reduced=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = TF.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(0)

    # arrival *times* from the BurstGPT shape; token lengths kept tiny so
    # the demo runs in seconds on CPU
    tr = traces.burstgpt(duration=60.0, base_rate=0.4, burst_every=60.0, seed=0)
    arrivals = sorted(t * TRACE_SECONDS / 60.0 for t, _, _ in tr)[:32]

    topo = tp.add_host_sources(tp.make_cluster(2, 4, bw_gbps=100.0))
    rt = ClusterRuntime(
        cfg,
        params,
        topo=topo,
        policy=PolicyConfig(max_instances=4, kv_upper=0.5, scale_down_timeout_s=0.5),
        n_prefill=2,
        n_decode=1,
        n_slots=4,
        max_seq=PROMPT + GEN + 8,
        model_bytes=get_config(ARCH).approx_params() * 2,
        prefill_capacity_tps=2000.0,
        decode_capacity_tps=200.0,
        verbose=True,
    )

    t0 = time.perf_counter()
    clock = lambda: time.perf_counter() - t0
    pending = list(arrivals)
    for _ in range(100_000):
        if not pending and rt.n_outstanding == 0:
            break
        now = clock()
        while pending and pending[0] <= now:
            pending.pop(0)
            prompt = rng.integers(0, cfg.vocab_size, size=PROMPT).astype(np.int32)
            rt.submit(prompt, GEN, now)
        rt.tick(now)
    else:
        raise RuntimeError(f"tick budget exhausted with {rt.n_outstanding} outstanding")

    rep = rt.router.slo_report()
    handoffs, gapped = rt.router.handoff_report()
    s = rt.stats
    print(
        f"\nserved {rep.n} requests in {clock():.2f}s  "
        f"mean_ttft {rep.mean_ttft*1e3:.0f}ms attainment {rep.attainment:.0%}"
    )
    print(
        f"migrations {s.migrations}  mutations {s.mutations} "
        f"(param bytes moved: {s.mutation_param_bytes})  "
        f"replacement live-scales {s.live_scaled_prefill}  "
        f"scale-downs {s.scale_downs}  handoffs {handoffs} gapped {gapped}"
    )


if __name__ == "__main__":
    main()
