"""Serving driver of the port: BlitzScale autoscaling end to end on the port's
engines (the copy of ``repro.launch.serve``).

A trace of requests hits one engine; the load monitor detects the burst; the
scale planner builds a multicast chain plan; a second engine "loads"
parameter blocks layer by layer at the plan's modelled bandwidth; live
cooperative execution serves requests across the pair while loading; the
pair rebalances once loading completes:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --requests 24

With ``--disagg`` the same burst runs on the PD-disaggregated runtime
(:mod:`repro_torch.serving.disagg`): prefill and decode engine pools,
per-request KV-cache migration between them, decode pre-scaling and
prefill->decode instance mutation per the paper's §5.4 policy:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --disagg --requests 24

With ``--maas`` the fleet serves several models on one shared topology: the
MaaS control plane (:mod:`repro_torch.serving.maas`) arbitrates free devices
between per-model runtimes by SLO pressure x queue depth, parks idle models
at zero accelerators (only the O(1) host copy survives) and cold-starts them
back via multicast when requests arrive:

  PYTHONPATH=src python -m repro_torch.launch.serve --maas \
      --models granite-8b,qwen1.5-4b,minicpm3-4b --requests 24

Every instance of the modelled cluster (``make_cluster(2, 4)``, 8 devices)
computes on the one device ``--device`` names (default ``cuda``; it raises
without CUDA, and ``--device cpu`` runs on the CPU).  The network between
the instances is the flow-level model (:mod:`repro_torch.net`), as in the JAX
package; no bytes cross a real link.  All engines of one model share one
parameter dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import multicast as mc
from repro_torch.core import topology as topo_mod
from repro_torch.core.live_scaling import LiveSession
from repro_torch.core.parameter_pool import ParameterPool
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serving.engine import InstanceEngine, ServeRequest
from repro_torch.serving.router import Router


def _model(args, cfg, params):
    """The CLI's reduced config and seeded weights, unless the caller passes
    its own (``chip_smoke.py`` passes full granite-8b)."""
    if cfg is None:
        cfg = get_config(args.arch, reduced=True)
    if params is None:
        params = TF.init_params(cfg, args.seed, device=resolve_device(args.device))
    return cfg, params


def run_disagg(args, cfg=None, params=None):
    """PD-disaggregated serving: prefill pool -> KV migration -> decode pool,
    autoscaled with decode pre-scaling + prefill->decode mutation (§5.4).
    Returns the runtime after every request finished; raises SystemExit when
    a request was dropped or token-gapped."""
    from repro_torch.core.autoscaler import PolicyConfig
    from repro_torch.serving.disagg import ClusterRuntime

    cfg, params = _model(args, cfg, params)
    # network model (live-scale + KV-migration volumes) uses the FULL
    # architecture footprint; compute may run a reduced config
    model_bytes = get_config(args.arch).approx_params() * 2
    rng = np.random.default_rng(args.seed)
    max_seq = args.prompt_len + args.gen_len + 8

    topo = topo_mod.add_host_sources(topo_mod.make_cluster(2, 4, bw_gbps=100.0))
    policy = PolicyConfig(max_instances=4, kv_upper=0.5, scale_down_timeout_s=0.5)
    rt = ClusterRuntime(
        cfg,
        params,
        topo=topo,
        policy=policy,
        n_prefill=args.n_prefill,
        n_decode=args.n_decode,
        n_slots=args.n_slots,
        max_seq=max_seq,
        model_bytes=model_bytes,
        prefill_capacity_tps=2000.0,
        decode_capacity_tps=200.0,
        verbose=True,
    )

    t0 = time.perf_counter()
    clock = lambda: time.perf_counter() - t0
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        rt.submit(prompt, args.gen_len, clock())
    print(f"[monitor] burst of {args.requests} requests hit the prefill pool")
    completed_all = rt.run_until_done(clock)

    rep = rt.router.slo_report()
    handoffs, gapped = rt.router.handoff_report()
    s = rt.stats
    print(
        f"[disagg] served {rep.n} requests in {clock():.2f}s  "
        f"mean_ttft {rep.mean_ttft*1e3:.0f}ms p99_ttft {rep.p99_ttft*1e3:.0f}ms "
        f"mean_tbt {rep.mean_tbt*1e3:.1f}ms attainment {rep.attainment:.0%}"
    )
    print(
        f"[disagg] {s.migrations} KV migrations ({s.migrated_bytes/1e6:.1f} MB modelled), "
        f"{s.mutations} prefill->decode mutation(s) ({s.mutation_param_bytes} param bytes), "
        f"{s.live_scaled_prefill} replacement prefill + {s.direct_decode_scales} "
        f"direct decode live-scale(s) ({s.live_scale_param_bytes/1e9:.1f} GB "
        f"modelled param traffic), {s.prescaled_decodes} decode instance(s) pre-scaled"
    )
    # outstanding counts requests lost anywhere post-submit (including ones
    # that prefilled but never finished decode — invisible to rep.n)
    dropped = rt.n_outstanding + gapped
    print(
        f"[disagg] handoffs completed {handoffs}/{s.migrations}, "
        f"dropped or token-gapped requests: {dropped}"
    )
    if not completed_all or dropped != 0:
        raise SystemExit(f"FAIL: {dropped} request(s) dropped or token-gapped")
    return rt


def run_maas(args, cfgs: dict | None = None, params: dict | None = None):
    """Serverless multi-model MaaS: N models on one shared topology, devices
    arbitrated by the fleet scheduler, idle models scaled to zero and
    cold-started back via multicast from the O(1) host copy.

    ``cfgs`` and ``params`` map an arch id of ``--models`` to the config and
    parameter dict to serve it with (``chip_smoke.py`` passes full-width
    models); the others get the reduced config and weights seeded with
    ``--seed`` + their index.  Returns the fleet after every request
    finished; raises SystemExit when a request was dropped or token-gapped,
    or the parameter pool lost its invariant."""
    from repro_torch.core.autoscaler import PolicyConfig
    from repro_torch.serving import traces
    from repro_torch.serving.maas import ZERO, FleetPolicy, FleetScheduler

    archs = [m.strip() for m in args.models.split(",") if m.strip()]
    if len(archs) < 2:
        raise SystemExit("--maas needs at least two models (--models a,b,...)")
    max_seq = args.prompt_len + args.gen_len + 8
    cfgs, params = dict(cfgs or {}), dict(params or {})

    topo = topo_mod.add_host_sources(topo_mod.make_cluster(2, 4, bw_gbps=100.0))
    fleet = FleetScheduler(
        topo, policy=FleetPolicy(idle_to_zero_s=1.5), verbose=True
    )
    by_name = {}
    for i, arch in enumerate(archs):
        cfg = cfgs.get(arch) or get_config(arch, reduced=True)
        p = params.get(arch)
        if p is None:
            p = TF.init_params(cfg, args.seed + i, device=resolve_device(args.device))
        by_name[cfg.name] = cfg
        fleet.add_model(
            cfg,
            p,
            n_prefill=1,
            n_decode=1,
            n_slots=args.n_slots,
            max_seq=max_seq,
            model_bytes=get_config(arch).approx_params() * 2,
            prefill_capacity_tps=2000.0,
            decode_capacity_tps=200.0,
            policy=PolicyConfig(max_instances=3, kv_upper=0.5, scale_down_timeout_s=0.5),
        )

    # Zipf-skewed, burst-staggered arrivals compressed to a few wall seconds;
    # the cold tail should spend part of the run parked at zero devices
    mix = traces.multi_model_mix(
        list(by_name), duration=60.0, total_rate=1.0, seed=args.seed
    )
    # subsample evenly across the horizon (keeping late arrivals preserves
    # the scale-to-zero -> cold-start cycle) and compress to ~10 wall seconds
    step = max(1, len(mix) // args.requests)
    scale = 10.0 / 60.0
    arrivals = [(t * scale, m) for t, m, _, _ in mix[::step][: args.requests]]

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    clock = lambda: time.perf_counter() - t0  # noqa: E731
    pending = sorted(arrivals)
    for _ in range(200_000):
        if not pending and fleet.n_outstanding == 0:
            break
        now = clock()
        while pending and pending[0][0] <= now:
            _, model = pending.pop(0)
            prompt = rng.integers(0, by_name[model].vocab_size, size=args.prompt_len)
            fleet.submit(model, prompt.astype(np.int32), args.gen_len, now)
        fleet.tick(now)
        if not fleet.param_pool.invariant_ok():
            raise SystemExit(f"FAIL: parameter pool invariant broken at t={now:.3f}s")
    else:
        raise SystemExit(f"FAIL: tick budget exhausted, {fleet.n_outstanding} outstanding")

    dropped = 0
    print()
    for name, t in fleet.tenants.items():
        rep = t.runtime.router.slo_report()
        _, gapped = t.runtime.router.handoff_report()
        dropped += t.runtime.n_outstanding + gapped
        print(
            f"[maas] {name}: {rep.n} served  mean_ttft {rep.mean_ttft*1e3:.0f}ms "
            f"attainment {rep.attainment:.0%}  cold_starts {t.runtime.stats.cold_starts} "
            f"scaled_to_zero {t.stats.scaled_to_zero} "
            f"gpu_seconds {t.stats.gpu_seconds:.2f} "
            f"{'(at zero now)' if t.state == ZERO else ''}"
        )
    s = fleet.stats
    print(
        f"[maas] fleet: {s.grants} grants, {s.cold_starts} cold starts, "
        f"{s.scale_to_zero_events} scale-to-zero, {s.preemptions} preemptions, "
        f"{s.gpu_seconds:.2f} GPU-seconds occupied"
    )
    if dropped:
        raise SystemExit(f"FAIL: {dropped} request(s) dropped or token-gapped")
    return fleet


def run_colocated(args, cfg=None, params=None) -> dict:
    """One engine takes the burst; a second live-scales in beside it and the
    pair rebalances once it holds every layer.  Returns the router, both
    engines, the live session, the multicast plan, the finished requests
    and the loop's steps."""
    cfg, params = _model(args, cfg, params)
    rng = np.random.default_rng(args.seed)
    max_seq = args.prompt_len + args.gen_len + 8

    # --- cluster state: topology + O(1) parameter pool --------------------
    topo = topo_mod.make_cluster(2, 4, bw_gbps=100.0)
    topo = topo_mod.add_host_sources(topo)
    pool = ParameterPool(topo)
    model_bytes = cfg.approx_params() * 2
    pool.register(cfg.name, model_bytes)
    pool.deploy(cfg.name, [0])
    topo.device(0).role = topo_mod.Role.COLOCATED

    # --- engine 0 serves; burst arrives ------------------------------------
    eng0 = InstanceEngine(cfg, params, n_slots=args.n_slots, max_seq=max_seq)
    router = Router()
    t0 = time.perf_counter()
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        rid = router.submit(args.prompt_len, args.gen_len, time.perf_counter() - t0)
        eng0.submit(ServeRequest(rid, prompt, args.gen_len))

    # --- load monitor trips -> plan a scale-out ----------------------------
    queue_depth = len(eng0.queue)
    print(f"[monitor] queue depth {queue_depth} > slots {args.n_slots} -> scale")
    gpu_srcs, host = pool.sources(cfg.name)
    spare = [d.id for d in topo.spares()][:1]
    plan = mc.plan_multicast(topo, gpu_srcs or [topo.devices[-1].id], spare, 1)
    errs = mc.validate_plan(topo, plan)
    if errs:
        raise RuntimeError(f"invalid multicast plan: {errs}")
    t_load = plan.transfer_seconds(model_bytes)
    print(
        f"[planner] {len(plan.chains)} chain(s), modelled transfer "
        f"{t_load*1e3:.0f} ms for {model_bytes/1e6:.0f} MB "
        f"(gen {plan.gen_seconds*1e3:.2f} ms)"
    )

    # --- live scaling: engine 1 starts with 0 layers, gains them over time -
    eng1 = InstanceEngine(cfg, params, n_slots=args.n_slots, max_seq=max_seq)
    eng1.set_loaded_layers(0)
    session = LiveSession(
        n_layers=cfg.n_layers,
        layer_bytes=model_bytes // max(cfg.n_layers, 1),
        link_bytes_per_s=model_bytes / max(t_load, 1e-6),
        started_at=time.perf_counter(),
    )

    done = 0
    steps = 0
    finished: list[ServeRequest] = []
    while done < args.requests and steps < 10_000:
        steps += 1
        now = time.perf_counter()
        k = session.layers_loaded(now)
        eng1.set_loaded_layers(k)
        mult = session.throughput_multiplier(now)
        # cooperative phase: redirect half the queue once eng1 can serve alone
        if eng1.can_serve_alone() and eng0.queue:
            while len(eng0.queue) > len(eng1.queue):
                eng1.submit(eng0.queue.pop())
        for eng in (eng0, eng1) if eng1.can_serve_alone() else (eng0,):
            for r in eng.step():
                done += 1
                finished.append(r)
                router.note_first_token(r.rid, now - t0)
                router.note_done(r.rid)
        if steps % 20 == 0:
            print(
                f"[live] step {steps} loaded {k}/{cfg.n_layers} layers "
                f"boost x{mult:.2f} done {done}/{args.requests} phase={session.phase.value}"
            )

    rep = router.slo_report()
    print(
        f"served {rep.n} requests in {time.perf_counter()-t0:.2f}s  "
        f"mean_ttft {rep.mean_ttft*1e3:.0f}ms attainment {rep.attainment:.0%}"
    )
    return {"router": router, "engines": (eng0, eng1), "session": session,
            "finished": finished, "steps": steps, "plan": plan}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device every engine computes on (cuda raises without CUDA)")
    ap.add_argument("--disagg", action="store_true",
                    help="run the PD-disaggregated runtime (prefill/decode pools)")
    ap.add_argument("--n-prefill", type=int, default=2)
    ap.add_argument("--n-decode", type=int, default=1)
    ap.add_argument("--maas", action="store_true",
                    help="serve several models on one fleet (MaaS control plane)")
    ap.add_argument("--models", default="granite-8b,qwen1.5-4b,minicpm3-4b",
                    help="comma-separated arch ids for --maas")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.maas:
        run_maas(args)
        return
    if args.disagg:
        run_disagg(args)
        return
    run_colocated(args)


if __name__ == "__main__":
    main()
