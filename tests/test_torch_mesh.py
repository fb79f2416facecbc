"""The sharded train step of the port (DTensor over a ``torch.distributed``
device mesh) against the JAX package's unsharded one.

One spawn of 4 gloo CPU processes on a (2, 2) ("data", "model") mesh runs
3 sharded train steps of six REDUCED configs under their full configs'
sharding overrides: granite-8b (tensor parallel, two microbatches),
nemotron-4-340b (the FSDP overlay: d_model over "data"), olmoe-1b-7b
(experts over "model"), qwen1.5-4b and minicpm3-4b (MLA) (sequence
parallel: "seq" over "model", q a local sequence shard at its query
offset in the flash forward and backward, only k and v gathered),
mamba2-370m (the SSD scan on each rank's batch and head block) and
grok-1-314b (FSDP, each expert's d_ff over "model": the down projection
contracts d_ff on each rank's blocks, as olmoe's combine contracts its
experts).  The
weights are JAX's init carried over through ``models.bridge``; the
batches are the shared numpy pipeline's.  Each worker records the local
operand of every all-gather of its sharded steps.

Before each step rank 0 writes the gathered parameters, and the parent runs
JAX's ``build_train_step`` on those same parameters and that step's batch:
each sharded step's loss and grad norm within the f32 tolerance of JAX's
(tests/test_kernels.py:16-17).  Same parameters, because three AdamW steps
from the same start part any two f32 runs: the first step moves every
element with a nonzero gradient by about lr, whatever its size, so an
element whose gradient is a rounding error from zero moves either way (the
unsharded port's own grad norm is 1.6e-4 from JAX's by the second step of
nemotron at these sizes).  Where a grad norm is farther than the tolerance,
JAX's own step in float64 on the same parameters witnesses that f32
rounding set the distance: the sharded step may be no farther from it than
3x JAX's f32 step is (the rule of tests/test_torch_training.py's gradient
parity).

The update itself is held too: rank 0 also runs the port's unsharded step
from each sharded step's starting parameters, moments and batch, and each
sharded step's new parameters and moments, gathered, must agree with it
leaf by leaf (moments on DTensors, the gradients' all-reduce or FSDP
reduce-scatter, the clip factor, the learning rate and decay).  The port's
unsharded step is held to JAX's AdamW by tests/test_torch_training.py.  It
also checks that each kind of leaf (parameters, Adam moments, batch) is
really sharded, not replicated by the divisibility fallback.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import attention as JATT  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JMAMBA  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 4
TOL = dict(rtol=3e-5, atol=3e-5)  # tests/test_kernels.py's f32 tolerance
ARCHS = {"granite-8b": 2, "nemotron-4-340b": 1, "olmoe-1b-7b": 1, "qwen1.5-4b": 1,
         "mamba2-370m": 1, "minicpm3-4b": 1, "grok-1-314b": 1}  # microbatches
# the MoE product that contracts a sharded index (grok-1's d_ff, olmoe's experts)
MOE_CONTRACTED = {"grok-1-314b": "gecf,efd->gecd", "olmoe-1b-7b": "gsec,gecd->gsd"}
SEQ_ARCHS = ("qwen1.5-4b", "minicpm3-4b")  # "seq" over "model"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
BATCH, SEQ, STEPS = 4, 16, 3
# Sharded against unsharded step, relative norm of the difference per leaf.
# The gradients agree to f32 rounding (at most 3e-5 relative: olmoe's
# router), so m within 1e-4 and v, quadratic in the gradient, within 2e-4.
# The update of step 1 is about lr * sign(g): an element whose gradient is a
# rounding error from zero moves either way (up to 2.3e-3, olmoe's wq), so
# 1e-2; a wrong learning rate, decay or clip factor is 10% or more.
APART = {"m": 1e-4, "v": 2e-4, "update": 1e-2}

WORKER = textwrap.dedent("""
    import json, sys

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import _device_batch
    from repro_torch.models import bridge
    from repro_torch.models import transformer as TF
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, tree_paths
    from repro_torch.training.train_step import build_train_step

    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    archs, opt, batch, seq, steps = json.loads(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    mesh = make_host_mesh(model=2)
    def tree_map(fn, tree):
        if isinstance(tree, (dict, tuple)):
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            out = {k: tree_map(fn, v) for k, v in items}
            return out if isinstance(tree, dict) else tuple(out.values())
        return fn(tree)

    def full(t):  # a copy: full_tensor() of a replicated DTensor is its local tensor
        return (t.full_tensor() if sh.is_dtensor(t) else t).clone()

    def rel(got, want):  # |got - want| / |want|; |got| where want is zero
        got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
        scale = want.norm().item()
        return ((got - want).norm().item() / scale) if scale else got.norm().item()

    axis_of = {mesh.get_group(i).group_name: n for i, n in enumerate(mesh.mesh_dim_names)}

    class Gathers(TorchDispatchMode):
        # the local operand shape of each all-gather issued below DTensor,
        # and the mesh axis it gathers over

        def __init__(self):
            super().__init__()
            self.shapes, self.axes = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func.namespace == "_c10d_functional" and func.__name__.startswith("all_gather"):
                self.shapes.append(list(args[0].shape))
                self.axes.append(axis_of[args[2]])
            return func(*args, **(kwargs or {}))

    from repro_torch.models import mamba2, moe

    products, ssd_x = [], []  # what the sharded steps' MoE products and SSD scans ran on
    sharded = [False]  # inside a sharded step

    def recorded_einsum(eq, *ts):
        out = sh.einsum(eq, *ts)
        if sharded[0]:
            products.append([eq, ["P" if p.is_partial() else str(p) for p in out.placements],
                             [list(t.to_local().shape) for t in ts if sh.is_dtensor(t)]])
        return out

    ssd = mamba2.ssd_chunked

    def recorded_ssd(x, *a, **kw):
        if sharded[0] and not sh.is_dtensor(x):  # a rank's block (the DTensor call runs it on one)
            ssd_x.append(list(x.shape))
        return ssd(x, *a, **kw)

    moe.einsum, mamba2.ssd_chunked = recorded_einsum, recorded_ssd

    flash_q = []  # q's local block at each sharded flash call (forward and remat's recompute)
    flash = ops.flash_attention

    def counted_flash(q, *a, **kw):
        if sh.is_dtensor(q):
            flash_q.append(list(q.to_local().shape))
        return flash(q, *a, **kw)

    ops.flash_attention = counted_flash  # the models call it through the module

    out = {}
    for arch, micro in archs.items():
        cfg = get_config(arch, reduced=True).replace(
            dtype=torch.float32, sharding_overrides=get_config(arch).sharding_overrides)
        rules = sh.ShardingRules(mesh).with_overrides(cfg.sharding_overrides)
        flat = np.load(f"{tmp}/{arch}.npz")
        tree = {}
        for key in flat.files:
            node = tree
            *path, leaf = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = flat[key]
        whole = bridge.params_from_numpy(tree, device="cpu")  # JAX's init
        params = sh.distribute_tree(whole, TF.param_template(cfg), rules)
        opt_state = adamw_init(params, AdamWConfig(**opt))
        step_fn = build_train_step(cfg, AdamWConfig(**opt), microbatches=micro)
        losses, norms, apart = [], [], []
        gathers = Gathers()
        flash_q.clear()
        products.clear()
        ssd_x.clear()
        for step in range(steps):
            before = {k: full(v).numpy() for k, v in tree_paths(params)}
            if rank == 0:
                np.savez(f"{tmp}/{arch}_{step}.npz", **before)
                # the port's unsharded step from the same state and batch
                plain = tree_map(full, (params, opt_state))
                plain = step_fn(*plain, _device_batch(cfg, batch, seq, step, 1,
                                                      torch.device("cpu")))
            else:
                tree_map(full, (params, opt_state))  # rank 0's gathers
            b = _device_batch(cfg, batch, seq, step, 1, torch.device("cpu"), rules)
            sharded[0] = True
            with sh.use_sharding_rules(rules), gathers:
                params, opt_state, m = step_fn(params, opt_state, b)
            sharded[0] = False
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            after = tree_map(full, (params, opt_state["m"], opt_state["v"]))
            if rank == 0:
                want = (plain[0], plain[1]["m"], plain[1]["v"])
                start = {k: torch.from_numpy(v) for k, v in before.items()}
                apart.append({kind: {k: rel(g - start[k] if kind == "update" else g,
                                            w - start[k] if kind == "update" else w)
                                     for (k, g), (_, w) in zip(tree_paths(got), tree_paths(ref))}
                              for kind, got, ref in zip(("update", "m", "v"), after, want)})

        def placed(tree):
            return {k: [str(p) for p in v.placements] for k, v in tree_paths(tree)}

        with sh.use_sharding_rules(rules):
            out[arch] = {"loss": losses, "grad_norm": norms, "apart": apart,
                         "params": placed(params),
                         "m": placed(opt_state["m"]), "v": placed(opt_state["v"]),
                         "batch": placed(b), "seq_sharded": sh.seq_sharded(),
                         "mesh": list(mesh.shape), "flash_q": flash_q[:],
                         "gathers": [g for g in gathers.shapes if len(g) == 4],
                         "model_gathers": [g for g, a in zip(gathers.shapes, gathers.axes)
                                           if a == "model"],
                         "products": products[:], "ssd_x": ssd_x[:]}
    if rank == 0:
        with open(f"{tmp}/out.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""")


def _unflat(flat) -> dict:
    tree: dict = {}
    for key in flat.files if hasattr(flat, "files") else flat:
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = flat[key]
    return tree


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64`` (see
    tests/test_torch_training.py): handed to the reference's modules, it
    runs the whole step in float64 under x64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@functools.lru_cache(maxsize=None)
def _jitted_step(arch, micro, wide):
    """JAX's train step, jitted; with ``wide`` traced in float64 (x64 must be
    on, here and at each call)."""
    jcfg = jax_get_config(arch, reduced=True)
    jcfg = jcfg.replace(dtype=jnp.float64 if wide else jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        if wide:
            for mod in (JTF, JL, JATT, JMOE, JMAMBA, JTS, JOPT):
                mp.setattr(mod, "jnp", _Wide())
        fn = jax.jit(JTS.build_train_step(jcfg, JOPT.AdamWConfig(**OPT), microbatches=micro))
        return fn.lower(*_abstract_args(jcfg, wide)).compile()


def _abstract_args(jcfg, wide):
    dt = jnp.float64 if wide else jnp.float32
    p = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, dt),
                     jax.eval_shape(lambda: JTF.init_params(jax.random.PRNGKey(0), jcfg)))
    o = jax.eval_shape(lambda: JOPT.adamw_init(p, JOPT.AdamWConfig(**OPT)))
    b = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
         for k, v in jax_pipeline.make_batch(jcfg, BATCH, SEQ, step=0, seed=1).items()}
    return p, o, b


def _jax_metrics(arch, micro, params, step, wide=False):
    """JAX's train step on ``params`` (numpy) and batch ``step``: (loss,
    grad norm), in float64 with ``wide``."""
    jcfg = jax_get_config(arch, reduced=True)
    batch = {k: jnp.asarray(v) for k, v in
             jax_pipeline.make_batch(jcfg, BATCH, SEQ, step=step, seed=1).items()}
    with jax.enable_x64(wide):
        fn = _jitted_step(arch, micro, wide)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64 if wide else jnp.float32), params)
        _, _, m = fn(p, JOPT.adamw_init(p, JOPT.AdamWConfig(**OPT)), batch)
        return float(m["loss"]), float(m["grad_norm"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' metrics, placements and the parameters each sharded step
    started from.  JAX compiles its f32 steps while the workers run."""
    tmp = tmp_path_factory.mktemp("mesh")
    for arch in ARCHS:
        jcfg = jax_get_config(arch, reduced=True).replace(dtype=jnp.float32)
        params = JTF.init_params(jax.random.PRNGKey(0), jcfg)
        np.savez(tmp / f"{arch}.npz", **{"/".join(k.key for k in path): np.asarray(v)
                                          for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    spec = json.dumps([ARCHS, OPT, BATCH, SEQ, STEPS])
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, str(tmp), spec],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    for arch, micro in ARCHS.items():
        _jitted_step(arch, micro, False)
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    with open(tmp / "out.json") as f:
        got = json.load(f)
    return tmp, got


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_steps_match_jax(runs, arch):
    tmp, got = runs
    far = []
    for step in range(STEPS):
        params = _unflat(np.load(tmp / f"{arch}_{step}.npz"))
        loss, norm = _jax_metrics(arch, ARCHS[arch], params, step)
        np.testing.assert_allclose(got[arch]["loss"][step], loss, **TOL, err_msg=f"step {step}")
        mine = got[arch]["grad_norm"][step]
        if abs(mine - norm) > TOL["atol"] + TOL["rtol"] * abs(norm):
            _, exact = _jax_metrics(arch, ARCHS[arch], params, step, wide=True)
            far.append((step, mine, norm, exact))
            assert abs(mine - exact) <= 3 * abs(norm - exact), far[-1]
    print(arch, "grad norms past the f32 tolerance (step, sharded, JAX f32, JAX f64):", far)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_update_matches_the_unsharded_step(runs, arch):
    """Each sharded step's new parameters and Adam moments, gathered, against
    the port's unsharded step from the same state and batch, leaf by leaf:
    the moments within ``APART["m"]`` / ``APART["v"]`` relative norm, the
    update (new minus old parameters) within ``APART["update"]``."""
    apart = runs[1][arch]["apart"]
    assert len(apart) == STEPS
    for step, kinds in enumerate(apart):
        for kind, leaves in kinds.items():
            worst = max(leaves, key=leaves.get)
            assert leaves[worst] <= APART[kind], (step, kind, worst, leaves[worst])


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_seq_parallel_training_keeps_q_local(runs, arch):
    """Under sequence parallelism every flash call of the sharded steps (the
    forward and remat's recompute) takes q as its local sequence block
    (half the batch over "data", half the sequence over "model"), and the
    steps gather no q: their all-gathers of operands of that block's shape
    are k's and v's, two a call (three while q was gathered too)."""
    rec = runs[1][arch]
    calls = rec["flash_q"]
    assert calls, "no flash call took a DTensor"
    q_block = calls[0]
    assert q_block[:2] == [BATCH // 2, SEQ // 2] and all(c == q_block for c in calls), calls
    assert rec["gathers"].count(q_block) == 2 * len(calls), rec["gathers"]


def _sharded_on(placements: dict, axis: int, mesh_dim: int) -> list[str]:
    """Leaves whose placement on ``mesh_dim`` is Shard(axis)."""
    return [k for k, pl in placements.items() if pl[mesh_dim] == f"S({axis})"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_kind_of_leaf_is_really_sharded(runs, arch):
    rec = runs[1][arch]
    assert rec["mesh"] == [2, 2]
    model = [k for k, pl in rec["params"].items() if pl[1].startswith("S(")]
    assert model, "no parameter sharded over 'model'"
    assert rec["m"] == rec["params"] and rec["v"] == rec["params"]
    assert rec["batch"]["tokens"][0] == "S(0)"  # the batch over "data"
    if arch == "nemotron-4-340b":  # FSDP: d_model over "data"
        assert "layers/mlp/w_up" in _sharded_on(rec["params"], 1, 0)
    if arch == "olmoe-1b-7b":  # experts over "model"
        assert {"layers/moe/w_up", "layers/moe/w_down"} <= set(_sharded_on(rec["params"], 1, 1))
    assert rec["seq_sharded"] == (arch in SEQ_ARCHS)
    assert "embed/tok" in _sharded_on(rec["params"], 0, 1)  # vocab over "model"
    if arch == "mamba2-370m":  # SSM heads over "model"
        assert "layers/mixer/a_log" in _sharded_on(rec["params"], 1, 1)



@pytest.mark.parametrize("arch", list(MOE_CONTRACTED))
def test_moe_product_contracts_its_sharded_index_in_training(runs, arch):
    """In the sharded train steps (forward and remat's recompute) grok-1's
    down projection and olmoe's combine run on each rank's blocks: their
    output is partial over "model", and no all-gather over "model" (forward
    or backward) takes an operand's block."""
    rec = runs[1][arch]
    calls = [c for c in rec["products"] if c[0] == MOE_CONTRACTED[arch]]
    assert calls, rec["products"]
    for _, placements, blocks in calls:
        assert placements[1] == "P", placements
        assert not [s for s in rec["model_gathers"] if s in blocks], (blocks, rec["model_gathers"])


def test_ssd_scans_each_rank_heads_in_training(runs):
    """In mamba2's sharded train steps every SSD scan (forward and remat's
    recompute) runs on the rank's block: half the batch over "data" and
    H / 2 heads over "model"."""
    rec = runs[1]["mamba2-370m"]
    h = jax_get_config("mamba2-370m", reduced=True).ssm_nheads
    assert rec["ssd_x"] and all(x[0] == BATCH // 2 and x[2] == h // 2 for x in rec["ssd_x"]), \
        rec["ssd_x"]
