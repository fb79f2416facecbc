"""One cell of ``BENCHMARK.json``: the files its names lead to, and the result
line a run prints.

A cell's configuration is the file its ``configs`` entry names; its traffic
mix is ``traffic/<traffic>.json``, whose ``driver`` names the module under
``drivers/`` that runs it; what belongs to the cell alone (its rate, the
limits of its comparison, its profiled slice) is ``cells/<workload>.json``;
each per-layer metric is read by ``metrics/<metric>.py``.  A later cell, mix
or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

from blitzbench.weights import load_config

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "blitzbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list


def make_cell(name: str, config_file: Path, traffic: str, chips: int = 1,
              end_to_end: list = (), per_layer: list = ()) -> Cell:
    """A cell from its files: the configuration, ``traffic/<traffic>.json``
    and ``cells/<name>.json``."""
    return Cell(
        name=name, chips=chips, config=load_config(config_file),
        traffic=json.loads((HERE / "traffic" / f"{traffic}.json").read_text()),
        settings=json.loads((HERE / "cells" / f"{name}.json").read_text()),
        end_to_end=list(end_to_end), per_layer=list(per_layer),
    )


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def applies(m: dict) -> bool:
        return name in m.get("workloads", [name])

    return make_cell(name, ROOT / conf["file"], w["traffic"], w["chips"],
                     [m for m in bench["end_to_end"] if applies(m)],
                     [m for m in bench["per_layer"] if applies(m)])


def driver(cell: Cell):
    return importlib.import_module(f"blitzbench.drivers.{cell.traffic['driver']}")


def percentile(values, q: float) -> float:
    """Nearest rank: the smallest value with at least q% of the values at or
    below it (missing answers enter as +inf)."""
    v = sorted(values)
    if not v:
        return math.inf
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"blitzbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(cell: Cell, record) -> dict:
    """Each of the cell's per-layer metrics that its reader finds something
    to read for."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def result_line(cell: Cell, outcome, trace: bool) -> dict:
    """The last line of standard output."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    metrics = (per_layer(cell, outcome.record) if trace else
               {k: {"value": v, "unit": units[k]} for k, v in outcome.metrics.items() if k in units})
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    line = {"correct": all(v <= lim for v, lim in outcome.checks.values()),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": outcome.device}
    if trace and outcome.record.trace is not None:
        from blitzbench.trace import breakdown

        line["breakdown"] = breakdown(outcome.record.trace)
    line["checks"] = checks
    return line


def finite(x):
    """Non-finite floats (a tail with missing answers) as null, so that the
    line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


def emit(line: dict) -> None:
    """The numbers compared, with their limits, as the last lines of
    standard error; the result as the last line of standard output."""
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(finite(line)), flush=True)


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read: the spans of the window (traced runs
    only) and the profiled slice's summary."""

    cell: Cell
    spec: object  # reference.model.Spec of the cell's configuration
    spans: list
    slice_host: tuple | None  # perf_counter bounds of the profiled slice
    trace: object | None  # trace.TraceSummary

    def __post_init__(self):
        self.by_idx = {s.idx: s for s in self.spans}

    def annotated(self, name: str) -> list:
        """(span, start_ns, end_ns) of each call of ``name`` in the profiled
        slice."""
        if self.trace is None:
            return []
        return [(self.by_idx[i], s, e) for i, (k, s, e) in sorted(self.trace.annotations.items())
                if k == name and i in self.by_idx]

    def spans_of(self, name: str) -> list:
        """Spans of ``name`` that do not overlap the profiled slice, whose
        host times the profiler inflates."""
        lo, hi = self.slice_host or (None, None)
        return [s for s in self.spans if s.name == name
                and (lo is None or s.t1 < lo or (hi is not None and s.t0 > hi))]


@dataclasses.dataclass
class Outcome:
    metrics: dict  # end-to-end metric -> value
    attempted: int
    failed: int
    checks: dict  # name -> (value, limit), in the order printed
    device: dict
    record: RunRecord
    reading: dict | None = None  # check's numbers of the served tokens
    control: dict | None = None  # control name -> the same numbers, where asked for
