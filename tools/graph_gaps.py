#!/usr/bin/env python3
"""Where a captured decode step's device time goes, read with no profiler
attached, and how far the profiler's kernel records can be trusted to say it.

    python3 tools/graph_gaps.py --workload granite-8b.long32k --seed 7 [--json FILE]

From the root of a checkout, on one CUDA card.  One process a reading,
because the profiler stays attached (CUPTI) once it has started and every
later graph launch pays for it.  In this order:

1. calibration, clean: a captured graph of ``KERNELS`` kernels on every SM,
   each spinning ``SPIN_NS`` on ``%globaltimer`` and keeping the first and
   the last reading of all its blocks (its own clock), replayed between two
   CUDA events ``REPLAYS`` times;
2. decode, clean: the cell's engine, set up as the benchmark's replay driver
   sets it up, runs ``STEPS`` decode steps; the engine's step log
   (``repro_torch.obs.steplog``) gives each step's ``device_ms`` (CUDA events
   around the replay) and cycle (one ``t_launch`` to the next);
3. profiled: ``torch.profiler`` over ``PROFILED_STEPS`` decode steps, each
   under its own annotation, and over the calibration's replays;
4. attached: the profiler stopped, ``STEPS`` decode steps and the
   calibration's replays again.

The estimate of the decode graph's idle time between kernels is the clean
``device_ms`` less the merged kernel records of a profiled step (one that
holds a record of ``decode_int8_mma_kernel`` a layer).  It is too low by what
the profiler adds to each kernel record.  The calibration bounds that: under
the profiler, a spinning kernel's record against its own clock, and its own
clock and gaps clean against profiled.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "decode_int8_mma_kernel"
SPIN = "stamp_spin"
CALIB = 100_000  # the calibration's annotations are numbered from here, the steps' from 0
STEPS, PROFILED_STEPS = 300, 40  # decode steps clean and attached; profiled
KERNELS, SPIN_NS, REPLAYS = 2048, 2000, 20  # the calibration graph, replayed REPLAYS times
INT64_MAX = 2**63 - 1

SPIN_SRC = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ long long gtimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// every block spins spin_ns on the global timer; the kernel's first and last
// readings over all blocks land in stamps[2 i] and stamps[2 i + 1]
__global__ void stamp_spin(long long* stamps, int i, long long spin_ns) {
    long long t0 = gtimer(), t = t0;
    while (t - t0 < spin_ns) t = gtimer();
    if (threadIdx.x == 0) {
        atomicMin(stamps + 2 * i, t0);
        atomicMax(stamps + 2 * i + 1, t);
    }
}

extern "C" int stamp_spin_launch(void* stamps, int i, long long spin_ns, int blocks,
                                 void* stream) {
    stamp_spin<<<blocks, 32, 0, (cudaStream_t)stream>>>((long long*)stamps, i, spin_ns);
    return (int)cudaGetLastError();
}
"""


# -- what the readings give (host arithmetic, tested on the CPU) ------------------


def merged_ns(recs) -> int:
    """Summed length of the union of (start, end, ...) records."""
    total, end = 0, None
    for s, e, *_ in sorted(recs):
        lo = s if end is None else max(s, end)
        total += max(0, e - lo)
        end = e if end is None else max(end, e)
    return total


def mean(xs) -> float | None:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def steps_of(recs) -> dict:
    """Means over the step log's records (``StepRecord``s in order): ms of
    device time, of the cycle (one ``t_launch`` to the next record's), of
    the launch call and of the host's wait; the idle share of the cycles."""
    dev = [r.device_ms for r in recs]
    cyc = [(b.t_launch - a.t_launch) * 1e3 for a, b in zip(recs, recs[1:])]
    busy = sum(dev[:len(cyc)])
    return {"n": len(recs), "device_ms": mean(dev), "cycle_ms": mean(cyc),
            "launch_ms": mean((r.t_launched - r.t_launch) * 1e3 for r in recs),
            "wait_ms": mean((r.t_synced - r.t_launched) * 1e3 for r in recs),
            "idle_pct": 100 * (1 - busy / sum(cyc)) if cyc else None}


def profiled_steps(device, annotations, n_layers: int) -> list[dict]:
    """Each annotated step that holds one int8 decode record a layer (a step
    short of one lost a record to the profiler): the count and the merged ms
    of its records, less the copy of its tokens to the host, which follows
    the replay's end event.  ``device``: (start_ns, end_ns, name) sorted by
    start; ``annotations``: (start_ns, end_ns) of each step."""
    out = []
    for s0, s1 in annotations:
        recs = [d for d in device if s0 <= d[0] <= s1 and not d[2].startswith("Memcpy DtoH")]
        if sum(KERNEL in d[2] for d in recs) == n_layers:
            out.append({"records": len(recs), "merged_ms": merged_ns(recs) / 1e6})
    return out


def quantiles(xs) -> dict:
    q = statistics.quantiles(xs, n=20) if len(xs) > 1 else [xs[0]] * 19
    return {"mean": mean(xs), "p5": q[0], "p50": q[9], "p95": q[18]}


def calibration(events_ms, stamps, records=None) -> dict:
    """A calibration phase: ``events_ms`` each replay's event time,
    ``stamps`` each replay's (first, last) readings a kernel in ns and, where
    profiled, ``records`` each replay's kernel records (start_ns, end_ns) in
    launch order.  In us: each kernel's own span (last reading less first),
    the gap between one kernel's last reading and the next one's first, and
    the replay's event time not covered by own spans, per kernel; profiled,
    each record's length less its kernel's own span (what the record adds),
    the gap between records, and the replay's event time not covered by
    merged records, per kernel."""
    own = [(e - s) / 1e3 for rep in stamps for s, e in rep]
    gaps = [(b[0] - a[1]) / 1e3 for rep in stamps for a, b in zip(rep, rep[1:])]
    n = len(stamps[0])
    uncovered = [(t * 1e6 - sum(e - s for s, e in rep)) / 1e3 / n
                 for t, rep in zip(events_ms, stamps)]
    out = {"replays": len(stamps), "kernels": n, "event_ms": mean(events_ms),
           "own_us": quantiles(own), "own_gap_us": quantiles(gaps),
           "not_own_us_per_kernel": mean(uncovered),
           "stamp_grain_ns": grain(stamps)}
    if records is not None:
        added = [(r[1] - r[0] - (e - s)) / 1e3 for reps, rep in zip(records, stamps)
                 for r, (s, e) in zip(reps, rep)]
        rgaps = [(b[0] - a[1]) / 1e3 for reps in records for a, b in zip(reps, reps[1:])]
        out.update(record_less_own_us=quantiles(added), record_gap_us=quantiles(rgaps),
                   not_recorded_us_per_kernel=mean(
                       (t * 1e6 - merged_ns(reps)) / 1e3 / n for t, reps in zip(events_ms, records)))
    return out


def grain(stamps) -> int:
    """The greatest common divisor of the steps between a replay's readings:
    the timer's resolution, or a multiple of it."""
    g = 0
    for rep in stamps:
        vals = sorted(t for pair in rep for t in pair)
        for a, b in zip(vals, vals[1:]):
            g = math.gcd(g, b - a)
    return g


def bound(clean: dict, profiled: dict, calib: dict) -> dict:
    """The decode graph's idle time between kernels, in ms: the estimate
    (clean ``device_ms`` less a profiled step's merged records) and its
    upper end, the estimate plus what the profiler may add to each of the
    step's records, read off the calibration (its 95th percentile of record
    less own span a kernel, where that is positive)."""
    est = clean["device_ms"] - profiled["merged_ms"]
    add = max(0.0, calib["record_less_own_us"]["p95"]) / 1e3 * profiled["records"]
    return {"estimate_ms": est, "upper_ms": est + add, "records": profiled["records"],
            "per_boundary_us": est * 1e3 / profiled["records"]}


# -- on the card --------------------------------------------------------------------


def spin_launcher():
    """The calibration kernel's launch entry, built with nvcc into
    ``build/graph_gaps/``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out = ROOT / "build" / "graph_gaps"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "stamp_spin.cu", out / "libstamp_spin.so"
    src.write_text(SPIN_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).stamp_spin_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Calibration:
    def __init__(self, kernels: int, spin_ns: int):
        import torch

        launch = spin_launcher()
        blocks = torch.cuda.get_device_properties(0).multi_processor_count
        self.stamps = torch.zeros((kernels, 2), dtype=torch.int64, device="cuda")
        self.reset()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            stream = torch.cuda.current_stream().cuda_stream
            for i in range(kernels):
                err = launch(self.stamps.data_ptr(), i, spin_ns, blocks, stream)
                if err:
                    raise RuntimeError(f"stamp_spin launch failed: CUDA error {err}")
        self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def reset(self):
        self.stamps[:, 0].fill_(INT64_MAX)
        self.stamps[:, 1].zero_()

    def replay(self, n: int, annotate=None) -> tuple[list, list]:
        """``n`` replays, each under ``annotate(k)`` where given: their event
        ms and stamps."""
        import torch

        ms, stamps = [], []
        for k in range(n):
            self.reset()
            with annotate(k) if annotate else contextlib.nullcontext():
                self.events[0].record()
                self.graph.replay()
                self.events[1].record()
                torch.cuda.synchronize()
            ms.append(self.events[0].elapsed_time(self.events[1]))
            stamps.append([tuple(p) for p in self.stamps.tolist()])
        return ms, stamps


def engine(workload: str, seed: int):
    """The cell's engine with its sessions admitted, as
    ``blitzbench/drivers/replay.py`` sets it up; and its spec."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from blitzbench import generate, harness
    from blitzbench import weights as W
    from blitzbench.drivers.replay import context_kv
    from blitzbench.reference.model import Spec
    from repro_torch.models import kvcache
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import InstanceEngine, ServeRequest

    cell = harness.load_cell(workload)
    conf, mix = cell.config, cell.traffic
    cfg = W.port_config(conf, kv_quant=mix["kv_cache"] == "int8")
    weights = W.make_weights(conf, seed, "cuda")
    lengths, firsts = generate.sessions(mix, seed, conf["vocab_size"])
    max_seq = mix["max_seq"]
    eng = InstanceEngine(cfg, weights, n_slots=mix["sessions"], max_seq=max_seq)
    for s, (n, first) in enumerate(zip(lengths.tolist(), firsts.tolist())):
        one = TF.init_caches(cfg, 1, max_seq, device="cuda")
        for i in range(cfg.n_layers):
            k, v = context_kv(conf, mix, seed, i, s, n, "cuda")
            kvcache.write_prompt_kv(TF.layer_slice(one["layers"], i), k, v,
                                    torch.tensor([n], dtype=torch.int32, device="cuda"))
        eng.admit_prefilled(ServeRequest(s, np.zeros(n, np.int32), max_seq - n - 8,
                                         out_tokens=[first]), first, one)
        del one, k, v
    return eng, Spec.from_config(conf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--json")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from blitzbench.trace import summarize
    from repro_torch.obs.steplog import STEP_LOG

    calib = Calibration(KERNELS, SPIN_NS)
    calib.replay(3)
    c_ms, c_stamps = calib.replay(REPLAYS)
    eng, spec = engine(args.workload, args.seed)
    for _ in range(5):  # the first replays
        eng.step()

    def run_steps(n, annotate=False):
        STEP_LOG.clear()
        for k in range(n):
            if annotate:
                with record_function(f"bench.decode#{k}"):
                    eng.step()
            else:
                eng.step()
        return STEP_LOG.records()

    clean = steps_of(run_steps(STEPS))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0_ns = time.time_ns()
    run_steps(10)  # the profiler's first ~50 ms, while its clock settles
    traced = steps_of(run_steps(PROFILED_STEPS, annotate=True))
    p_ms, p_stamps = calib.replay(REPLAYS, annotate=lambda k: record_function(
        f"bench.calib#{CALIB + k}"))
    torch.cuda.synchronize()
    t1_ns = time.time_ns()
    prof.stop()
    summary = summarize(prof, t0_ns, t1_ns)  # drops the annotations' device-side ranges
    a_ms, a_stamps = calib.replay(REPLAYS)
    attached = steps_of(run_steps(STEPS))

    ann = summary.annotations
    steps = profiled_steps(summary.device, [ann[k][1:] for k in range(PROFILED_STEPS)
                                            if k in ann], spec.n_layers)
    spins = [[(s, e) for s, e, name in summary.device
              if SPIN in name and ann[CALIB + k][1] <= s <= ann[CALIB + k][2]]
             if CALIB + k in ann else [] for k in range(REPLAYS)]
    whole = [k for k, r in enumerate(spins) if len(r) == KERNELS]
    profiled = {"n": len(steps), "records": mean(s["records"] for s in steps),
                "merged_ms": mean(s["merged_ms"] for s in steps)}
    cal = {"clean": calibration(c_ms, c_stamps),
           "profiled": calibration([p_ms[k] for k in whole], [p_stamps[k] for k in whole],
                                   [spins[k] for k in whole]) if whole else None,
           "attached": calibration(a_ms, a_stamps)}
    if whole:  # the estimate made on the calibration's graph, a kernel
        cal["estimate_us_per_kernel"] = (mean(c_ms) * 1e3 - mean(
            merged_ns(spins[k]) for k in whole) / 1e3) / KERNELS
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "clean": clean, "profiled": {**traced, **profiled}, "attached": attached,
           "calibration": cal,
           "gap": bound(clean, profiled, cal["profiled"]) if steps and whole else None}
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
