"""Dry-run of the port on the production meshes (``repro.launch.dryrun``):
every assigned (arch x input shape) cell's step, run once over fake tensors
on a fake process group of 256 (single pod, (16, 16)) or 512 (multi-pod,
(2, 16, 16)) ranks inside this one process, seen from rank 0.  Nothing is
allocated and no data moves; every op DTensor dispatches is counted on the
rank's own blocks.

The model runs on the plain path (``ops.use_impl("ref")``), as the
reference's dry-run lowers the jnp oracles: the hand-written kernels cannot
run on fake tensors.  Per cell one JSON file under ``--out``:

  * argument bytes per device, from the blocks' shapes: parameters, Adam
    moments, batch, caches (``param_bytes_per_dev``, ``opt_bytes_per_dev``,
    ``batch_bytes_per_dev``, ``cache_bytes_per_dev``);
  * ``temp_bytes_per_dev``: the peak of the bytes of the tensors the step
    makes on this rank and holds at once (torch's ``MemTracker`` counts the
    global DTensor sizes under fake tensors, so the port counts storages
    itself);
  * ``dot_flops_per_dev``: ``torch.utils.flop_counter``'s formulas on the
    local products, counted below DTensor (at the DTensor level the count is
    the global product's);
  * ``hbm_bytes_per_dev``: the unfused eager traffic, the sum over the local
    ops (views excluded) of their input and output bytes; not XLA's fused
    count, which the reference reports under the same name;
  * ``collective_bytes_per_dev`` and ``coll_by_op`` / ``coll_count``: the
    operand bytes of the collectives DTensor issues, by op;
  * the three roofline terms against the H100 SXM data sheet (bf16 dense
    989 TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s each way), the bottleneck,
    ``model_flops_global`` and ``useful_flop_frac``, and whether the
    argument and temporary bytes fit in 80 GB;
  * ``ok``, or ``error`` and the traceback's tail: a cell that fails is
    recorded, not hidden.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                   # all cells, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import build_cell, bytes_per_device, materialize
from repro_torch.training.optimizer import adamw_update, tree_leaves

# H100 SXM data sheet, per device
PEAK_FLOPS = 989e12  # bf16 dense
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way
DEVICE_BYTES = 80e9

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "benchmarks", "results", "dryrun_torch")


def model_flops(arch: str, shape: str) -> float:
    """MODEL_FLOPS: 6 N D for training, 2 N_active D for inference (global)."""
    cfg = get_config(arch)
    sp = SHAPES[shape]
    n_active = cfg.approx_active_params()
    if sp.kind == "train":
        return 6.0 * n_active * sp.seq_len * sp.global_batch
    if sp.kind == "prefill":
        return 2.0 * n_active * sp.seq_len * sp.global_batch
    return 2.0 * n_active * sp.global_batch


def _in_propagation() -> bool:
    """Whether the current op runs inside DTensor's sharding propagation
    (its output-metadata inference runs each new op signature once on
    global shapes; its cost model computes shard offsets): no device runs
    it."""
    f = sys._getframe(2)
    while f is not None:
        if "propagate" in f.f_code.co_name:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def _propagation_unfaked():
    """DTensor's index arithmetic with the fake mode lifted: its sharding
    propagation (whose cost model computes strided shards' offsets) and a
    strided shard's size and offsets are computed with small index tensors
    and read back, which a fake tensor cannot do.  The metadata inference
    inside propagation makes a fake mode of its own."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def unfaked(fn):
        def call(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)

        return call

    patched = [(ShardingPropagator, "propagate_op_sharding_non_cached")]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in vars(strided):
        patched.append((strided, "local_shard_size_and_offset"))
    saved = [(cls, name, vars(cls)[name]) for cls, name in patched]
    for cls, name, attr in saved:
        fn = attr.__func__ if isinstance(attr, (staticmethod, classmethod)) else attr
        wrapped = unfaked(fn)
        setattr(cls, name, type(attr)(wrapped) if isinstance(attr, (staticmethod, classmethod))
                else wrapped)
    try:
        yield
    finally:
        for cls, name, attr in saved:
            setattr(cls, name, attr)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


class DeviceCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ops one rank runs: a DTensor op is passed on (DTensor
    dispatches it and its local ops come back here), a local op is counted.

    ``flops`` (the flop counter's formulas), ``hbm_bytes`` (inputs and
    outputs of each op that is not a view; collectives apart), the
    collectives' operand bytes and counts by op, and ``peak_bytes``: the
    most bytes of storages made inside the block alive at once."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes: dict[str, float] = collections.defaultdict(float)
        self.coll_count: dict[str, int] = collections.defaultdict(int)
        self.live = 0
        self.peak_bytes = 0
        self._refs: dict[int, list] = {}  # storage key -> [nbytes, live tensors]

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        rec = self._refs.get(key)
        if rec is None:
            rec = self._refs[key] = [st.nbytes(), 0]
            self.live += rec[0]
            self.peak_bytes = max(self.peak_bytes, self.live)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        rec = self._refs.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live -= rec[0]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        nbytes = sum(t.numel() * t.element_size() for t in ins)
        if func.namespace == "_c10d_functional":
            if func.__name__.split(".")[0] != "wait_tensor":
                name = func.__name__.split(".")[0]
                self.coll_bytes[name] += nbytes
                self.coll_count[name] += 1
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs, out_val=out)
        returns = func._schema.returns
        view = bool(returns) and returns[0].alias_info is not None and \
            not returns[0].alias_info.is_write
        if not view:
            self.hbm_bytes += nbytes + sum(t.numel() * t.element_size() for t in outs)
        in_ids = {id(t) for t in ins}
        for t in outs:
            if id(t) not in in_ids:
                self._track(t)
        return out


def _count(art, mesh, *, grad: bool, call=None) -> dict:
    """The counts of one call of ``art.fn`` (or of ``call(*args)``) on fake
    DTensor arguments, on the plain path."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    counter = DeviceCounter()
    with FakeTensorMode(allow_non_fake_inputs=True), _propagation_unfaked():
        args = materialize(art, mesh)
        with torch.enable_grad() if grad else torch.no_grad(), ops.use_impl("ref"), counter:
            out = (call or art.fn)(*args)
        del out, args
    return {"flops": counter.flops, "hbm_bytes": counter.hbm_bytes,
            "coll_bytes": dict(counter.coll_bytes), "coll_count": dict(counter.coll_count),
            "peak_bytes": counter.peak_bytes}


def _train_counts(arch: str, shape: str, mesh, rec: dict) -> dict:
    """A train step's counts from one microbatch: the step of ``n``
    microbatches repeats the same forward and backward ``n`` times on
    batches of the same shape and updates once, so the step on one
    microbatch's batch (B / n rows) is counted, its AdamW update (counted
    apart) taken out, the rest taken ``n`` times and the update added once.
    The peak adds the f32 gradient accumulators the real step holds.  Left
    out: the step's gather of the token batch before it slices the
    microbatches (int32 ids, a few MB)."""
    cfg = get_config(arch)
    sp = SHAPES[shape]
    n = max(cfg.microbatches, 1)
    rules = steps_mod.make_rules(cfg, mesh)
    one = steps_mod.build_train_artifacts(
        cfg.replace(microbatches=1), dataclasses.replace(sp, global_batch=sp.global_batch // n),
        rules)
    step = _count(one, mesh, grad=True)
    opt_cfg = steps_mod.opt_config_for(cfg)

    def update(params, opt_state, batch):
        from torch.distributed.tensor.experimental import implicit_replication

        grads = sh.map_template(torch.zeros_like, params)
        with sh.use_sharding_rules(rules), implicit_replication():
            return adamw_update(params, grads, opt_state, opt_cfg)

    upd = _count(one, mesh, grad=False, call=update)
    out = {"peak_bytes": step["peak_bytes"], "coll_bytes": {}, "coll_count": {}}
    for key in ("flops", "hbm_bytes"):
        out[key] = n * (step[key] - upd[key]) + upd[key]
    for key in ("coll_bytes", "coll_count"):
        for op in set(step[key]) | set(upd[key]):
            a, b = step[key].get(op, 0), upd[key].get(op, 0)
            out[key][op] = n * (a - b) + b
    if n > 1:  # the f32 copies of the gradients that are not f32
        for t, spec in zip(tree_leaves(one.args[0]), tree_leaves(one.in_specs[0])):
            if t.dtype != torch.float32:
                wide = torch.empty(t.shape, dtype=torch.float32, device="meta")
                out["peak_bytes"] += bytes_per_device(wide, spec, mesh)
    rec["microbatches"] = n
    rec["counted_as"] = f"one microbatch of {sp.global_batch // n} rows x {n}, the update once"
    return out


def _sum_bytes(art, mesh, which: tuple[int, ...]) -> int:
    return sum(bytes_per_device(art.args[i], art.in_specs[i], mesh) for i in which)


def run_cell(arch: str, shape: str, multi_pod: bool, outdir: str, *, force: bool = False) -> dict:
    """One cell on the production mesh; call inside ``fake_process_group``
    of the mesh's world size."""
    mesh_name = "multi" if multi_pod else "single"
    path = os.path.join(outdir, f"{arch}__{shape}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name}
    t0 = time.perf_counter()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mesh = make_production_mesh(multi_pod=multi_pod)
        rec["chips"] = mesh.size()
        art = build_cell(arch, shape, mesh)
        kind = SHAPES[shape].kind
        rec["param_bytes_per_dev"] = _sum_bytes(art, mesh, (0,))
        if kind == "train":
            rec["opt_bytes_per_dev"] = _sum_bytes(art, mesh, (1,))
            rec["batch_bytes_per_dev"] = _sum_bytes(art, mesh, (2,))
        else:
            last = len(art.args) - 1
            rec["cache_bytes_per_dev"] = _sum_bytes(art, mesh, (last,))
            rec["batch_bytes_per_dev"] = _sum_bytes(art, mesh, tuple(range(1, last)))
        rec["argument_bytes_per_dev"] = _sum_bytes(art, mesh, tuple(range(len(art.args))))
        if kind == "train":
            counts = _train_counts(arch, shape, mesh, rec)
        else:
            counts = _count(art, mesh, grad=False)
        rec["temp_bytes_per_dev"] = counts["peak_bytes"]
        rec["dot_flops_per_dev"] = counts["flops"]
        rec["hbm_bytes_per_dev"] = counts["hbm_bytes"]
        rec["hbm_bytes_note"] = "unfused eager traffic: inputs + outputs of every local op"
        rec["collective_bytes_per_dev"] = sum(counts["coll_bytes"].values())
        rec["coll_by_op"] = counts["coll_bytes"]
        rec["coll_count"] = counts["coll_count"]
        rec["t_compute"] = counts["flops"] / PEAK_FLOPS
        rec["t_memory"] = counts["hbm_bytes"] / HBM_BW
        rec["t_collective"] = rec["collective_bytes_per_dev"] / NVLINK_BW
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
                 "collective": rec["t_collective"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        mf = model_flops(arch, shape)
        rec["model_flops_global"] = mf
        total = counts["flops"] * rec["chips"]
        rec["useful_flop_frac"] = mf / total if total else 0.0
        rec["fits_80gb"] = rec["argument_bytes_per_dev"] + counts["peak_bytes"] <= DEVICE_BYTES
        rec["constants"] = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
                            "device": "H100 SXM data sheet (computed, not measured)"}
        rec["ok"] = True
    except Exception as e:  # a failed cell is recorded: dry-run failures are faults
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["run_s"] = time.perf_counter() - t0
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _fmt(rec: dict) -> str:
    if not rec.get("ok"):
        return (f"FAIL {rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:6s} "
                f"{rec.get('error', '?')[:90]}")
    gb = (rec["argument_bytes_per_dev"] + rec["temp_bytes_per_dev"]) / 1e9
    return (f"ok   {rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:6s} "
            f"args/dev={rec['argument_bytes_per_dev'] / 1e9:7.2f}GB "
            f"temp/dev={rec['temp_bytes_per_dev'] / 1e9:7.2f}GB "
            f"{'fits' if gb <= DEVICE_BYTES / 1e9 else 'OVER'} "
            f"t_comp={rec['t_compute'] * 1e3:9.2f}ms t_mem={rec['t_memory'] * 1e3:9.2f}ms "
            f"t_coll={rec['t_collective'] * 1e3:9.2f}ms [{rec['bottleneck']}] "
            f"run={rec['run_s']:.0f}s")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + ["all"],
                    help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.abspath(DEFAULT_OUT))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true", help="list cells and exit")
    args = ap.parse_args(argv)

    grid = [(a, s) for a, s, _ in cells()
            if args.arch in (None, "all", a) and args.shape in (None, "all", s)]
    if args.list:
        for a, s in grid:
            print(a, s)
        return

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_fail = 0
    for mp in meshes:
        with fake_process_group(512 if mp else 256):
            for a, s in grid:
                rec = run_cell(a, s, mp, args.out, force=args.force)
                print(_fmt(rec), flush=True)
                n_fail += 0 if rec.get("ok") else 1
    n = len(grid) * len(meshes)
    print(f"\n{n - n_fail}/{n} cells passed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
