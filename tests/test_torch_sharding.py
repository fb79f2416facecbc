"""The port's logical-axis sharding substrate (``repro_torch.distributed.sharding``)
against the JAX package's (``repro.distributed.sharding``).

For all 13 archs on the production meshes, (16, 16) ("data", "model") and
(2, 16, 16) ("pod", "data", "model"), the port's resolved spec equals the
reference's ``PartitionSpec`` for every parameter leaf, every cache leaf
(the int8 scales included) and every batch leaf of every cell; the mesh is
the stand-in of tests/test_sharding.py (axis names and sizes only), on both
sides.  Each rank's block under the port's placements is the block the
reference's ``NamedSharding`` gives that device (JAX over 8 host devices in
a subprocess).  Also: the template axes leaf by leaf, the divisibility
property, ``shard`` without rules, and attention on a rank whose q heads are
sharded while the KV heads stay whole (the GQA head offset).  On 4 gloo
ranks: ``sharding.einsum`` contracting a sharded index on each rank's
blocks (a ``Partial`` output, reduced to ``torch.einsum``'s, forward and
backward), rmsnorm over rows split across ranks (JAX's), and
``sharding.matmul`` contracting an FSDP weight over an idle axis on
permuted blocks where a rank holds few rows; and the rule that picks it,
``sharding.idle_contraction``, on the production cells' shapes.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")

import hypothesis.strategies as st  # noqa: E402
import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import fake_process_group  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ALL_ARCHS = C.ARCH_IDS + C.PAPER_IDS


class _FakeMesh:
    """Mesh stand-in (tests/test_sharding.py:14-27): spec resolution only
    needs axis names and sizes."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self._shape = tuple(sizes.values())

    @property
    def devices(self):
        return np.zeros(self._shape)


MESHES = {"single": _FakeMesh({"data": 16, "model": 16}),
          "multi": _FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _jax_specs(tree) -> dict:
    """A reference spec tree -> {path: spec as a tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    rules = sh.ShardingRules(MESHES[mesh]).with_overrides(C.get_config(arch).sharding_overrides)
    jrules = JSH.ShardingRules(MESHES[mesh]).with_overrides(JC.get_config(arch).sharding_overrides)
    got = _flat(sh.specs_from_template(TF.param_template(C.get_config(arch)), rules))
    want = _jax_specs(JSH.specs_from_template(JTF.param_template(JC.get_config(arch)), jrules))
    assert got == want


def _cells(arch):
    cfg = C.get_config(arch)
    return [sp for sp in C.SHAPES.values() if C.shape_applicable(cfg, sp)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    """Every cache leaf (the int8 scales included) and every batch leaf of
    each of the arch's cells.  The int8 cache of the enc-dec model is left
    out: the reference's ``cache_axes`` gives its self caches the axes of a
    cache without scales, so its spec tree does not match its cache tree."""
    quants = [False] if C.get_config(arch).family == "encdec" else [False, True]
    for quant in quants:
        cfg = C.get_config(arch).replace(kv_quant=quant)
        jcfg = JC.get_config(arch).replace(kv_quant=quant)
        rules = sh.ShardingRules(MESHES[mesh]).with_overrides(cfg.sharding_overrides)
        jrules = JSH.ShardingRules(MESHES[mesh]).with_overrides(jcfg.sharding_overrides)
        for sp in _cells(arch):
            if sp.kind == "train":
                got = sh.specs_for_axes(TS.make_batch_abstract(cfg, sp.global_batch, sp.seq_len),
                                        TS.batch_axes(cfg), rules)
                want = JSH.specs_for_axes(
                    JTS.make_batch_abstract(jcfg, sp.global_batch, sp.seq_len),
                    JTS.batch_axes(jcfg), jrules)
            else:
                caches = TF.init_caches(cfg, sp.global_batch, sp.seq_len, abstract=True)
                assert all(t.device.type == "meta" for t in _flat(caches).values())
                got = sh.specs_for_axes(caches, TF.cache_axes(cfg), rules)
                want = JSH.specs_for_axes(
                    JTF.init_caches(jcfg, sp.global_batch, sp.seq_len, abstract=True),
                    JTF.cache_axes(jcfg), jrules)
            assert _flat(got) == _jax_specs(want), (sp.name, quant)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_template_axes_equal_the_reference(arch):
    got = _flat(TF.param_template(C.get_config(arch)))
    want = {tuple(k.key for k in path): s for path, s in jax.tree_util.tree_flatten_with_path(
        JTF.param_template(JC.get_config(arch)), is_leaf=lambda x: isinstance(x, JSH.TensorSpec))[0]}
    assert got.keys() == want.keys()
    for key, spec in got.items():
        assert (spec.shape, spec.axes, spec.init) == (want[key].shape, want[key].axes,
                                                       want[key].init), key
    assert sh.param_count(TF.param_template(C.get_config(arch))) == \
        JSH.param_count(JTF.param_template(JC.get_config(arch)))


def test_template_spec_checks_its_rank():
    with pytest.raises(ValueError, match="rank"):
        sh.TensorSpec((4, 4), ("d_model",))
    stacked = sh.stack_template({"w": sh.TensorSpec((4, 8), ("d_model", "d_ff"))}, 3)
    assert stacked["w"].shape == (3, 4, 8) and stacked["w"].axes == ("layers", "d_model", "d_ff")


def _axis_prod(entry):
    sizes = {"pod": 2, "data": 16, "model": 16}
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return int(np.prod([sizes[a] for a in names]))


RULES = sh.ShardingRules(MESHES["multi"])
JRULES = JSH.ShardingRules(MESHES["multi"])


@settings(max_examples=60, deadline=None)
@given(
    dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    axes=st.lists(st.sampled_from(["batch", "heads", "d_ff", "vocab", "seq", None]),
                  min_size=1, max_size=4),
)
def test_spec_for_shape_always_divides(dims, axes):
    """Every resolved mesh-axis product divides its dim, no mesh axis is used
    twice, and the spec is the reference's."""
    n = min(len(dims), len(axes))
    dims, axes = dims[:n], axes[:n]
    spec = RULES.spec_for_shape(tuple(dims), axes)
    assert spec == tuple(JRULES.spec_for_shape(tuple(dims), axes))
    used = set()
    for d, e in zip(dims, list(spec) + [None] * (n - len(spec))):
        assert d % _axis_prod(e) == 0
        if e is not None:
            names = (e,) if isinstance(e, str) else tuple(e)
            assert not (set(names) & used)
            used.update(names)


def test_no_mesh_and_overrides():
    assert sh.ShardingRules(None).spec_for(("batch", "d_ff")) == ()
    assert sh.resolve_spec(("batch",)) == ()
    r2 = RULES.with_overrides({"d_model": ("data",)})
    assert r2.spec_for_shape((4096, 14336), ("d_model", "d_ff")) == ("data", "model")
    assert RULES.spec_for_shape((4096, 14336), ("d_model", "d_ff")) == (None, "model")


class _CoordMesh:
    """A mesh seen from one coordinate: what ``local_block`` reads."""

    def __init__(self, sizes: dict, coord: tuple):
        self.mesh_dim_names, self.shape, self._coord = tuple(sizes), tuple(sizes.values()), coord

    def get_coordinate(self):
        return list(self._coord)

    def size(self, i):
        return self.shape[i]


BLOCK_CASES = [((8, 4, 6), ("batch", "heads", None)), ((4, 6, 8), ("batch", "seq", "d_ff")),
               ((6, 16), ("d_model", "vocab")), ((2, 8, 4), ("batch", None, "heads"))]
NAMED_BLOCKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
    out = []
    for shape, spec in json.loads(sys.argv[1]):
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        out.append([[[s.start or 0, s.stop if s.stop is not None else n]
                     for s, n in zip(idx[d], shape)] for d in mesh.devices.flat])
    print(json.dumps(out))
""")


def test_rank_blocks_are_named_sharding_blocks():
    """On a (2, 2, 2) mesh each rank's block under the port's placements is
    the block JAX's ``NamedSharding`` gives the device at that coordinate,
    including ("pod", "data") on one dim (two ``Shard`` in mesh order)."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    rules = sh.ShardingRules(_FakeMesh(sizes)).with_overrides({"d_model": ("data",)})
    cases = [(shape, rules.spec_for_shape(shape, axes)) for shape, axes in BLOCK_CASES]
    assert ("pod", "data") in [spec[0] for _, spec in cases]
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run([sys.executable, "-c", NAMED_BLOCKS, json.dumps(cases)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout)
    for (shape, spec), blocks in zip(cases, want):
        for rank, block in enumerate(blocks):
            mesh = _CoordMesh(sizes, tuple(np.unravel_index(rank, (2, 2, 2))))
            got = sh.local_block(shape, mesh, sh.placements_for(spec, mesh, shape))
            assert [[s.start, s.stop] for s in got] == block, (shape, spec, rank)


def test_shard_is_the_identity_without_rules():
    x = torch.randn(4, 8)
    with sh.use_sharding_rules(sh.ShardingRules(MESHES["single"])):
        assert sh.shard(x, "batch", "d_ff") is x  # a plain tensor
    with fake_process_group(4):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        d = sh.distribute(x, ("data",), mesh)
        assert sh.current_rules() is None and sh.shard(d, "batch", "d_ff") is d  # no rules


@pytest.mark.parametrize("heads,kv,model", [(8, 2, 4), (8, 4, 2), (6, 2, 3)])
def test_gqa_q_head_shard_reads_its_kv_heads(heads, kv, model):
    """q's heads sharded over "model" while the KV heads stay whole (the
    rules replicate KV heads a 16-way axis does not divide): rank r holds
    global q heads r*H/m + h, which read KV heads (r*H/m + h) // n_rep.
    Each rank's block of the output is the unsharded attention's; the op
    run on the local q against the whole K/V (the kernel's h // n_rep on
    local heads, the fault) gives another answer on some rank."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 6, heads, 16, generator=gen)
    k = torch.randn(2, 6, kv, 16, generator=gen)
    v = torch.randn(2, 6, kv, 16, generator=gen)
    want = ops.flash_attention(q, k, v, causal=True, impl="ref")
    hl = heads // model
    faulty = False
    for rank in range(model):
        with fake_process_group(model, rank=rank):
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import DTensor, Replicate, Shard

            mesh = init_device_mesh("cpu", (model,), mesh_dim_names=("model",))
            q_local = q[:, :, rank * hl:(rank + 1) * hl]
            qd = DTensor.from_local(q_local, mesh, [Shard(2)], run_check=False)
            kd, vd = (DTensor.from_local(t, mesh, [Replicate()], run_check=False) for t in (k, v))
            out = ops.flash_attention(qd, kd, vd, causal=True, impl="ref")
        block = want[:, :, rank * hl:(rank + 1) * hl]
        assert out.placements == (Shard(2),) and out.shape == want.shape
        torch.testing.assert_close(out.to_local(), block, rtol=1e-6, atol=1e-6)
        naive = ops.flash_attention(q_local, k, v, causal=True, impl="ref")
        faulty |= not torch.allclose(naive, block, rtol=1e-4, atol=1e-4)
    assert faulty


def test_rmsnorm_blocks_give_w_a_partial_gradient():
    """rmsnorm of a batch-sharded x: the rank's block of the output is the
    unsharded one's, and w's gradient on the rank is its rows' share, marked
    partial over the batch axis (the fake group's all-reduce moves nothing,
    so the rank's share is what arrives)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 8, generator=gen)
    w = torch.randn(8, generator=gen)
    want = ops.rmsnorm(x, w, impl="ref")
    w_rows = w.clone().requires_grad_(True)
    ops.rmsnorm(x[2:], w_rows, impl="ref").sum().backward()
    with fake_process_group(2, rank=1):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        xd = DTensor.from_local(x[2:], mesh, [Shard(0)], run_check=False)
        wd = DTensor.from_local(w.clone(), mesh, [Replicate()], run_check=False).requires_grad_(True)
        out = ops.rmsnorm(xd, wd, impl="ref")
        assert out.placements == (Shard(0),)
        torch.testing.assert_close(out.to_local(), want[2:], rtol=0, atol=0)
        out.sum().backward()
        assert wd.grad.placements == (Partial(),)
        torch.testing.assert_close(wd.grad.to_local(), w_rows.grad, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Products that contract a sharded index, and rows split over the mesh, on
# 4 gloo ranks: a (2, 2) ("data", "model") mesh
# ---------------------------------------------------------------------------

# name -> (equation, operands as (shape, tensor dim sharded on "data" and on
# "model", None for replicated)); the output's placements the rule gives
CONTRACT_CASES = {
    # grok-1's down projection: groups over "data"; d_ff (f), the contracted
    # index, over "model" in both operands, d_model over "data" (FSDP)
    "grok_down": ("gecf,efd->gecd", [((4, 3, 5, 8), (0, 3)), ((3, 8, 6), (2, 1))],
                  ["S(0)", "P"]),
    # olmoe's combine: the experts (e), contracted, over "model" in both
    "olmoe_combine": ("gsec,gecd->gsd", [((4, 6, 4, 5), (0, 2)), ((4, 4, 5, 6), (0, 1))],
                      ["S(0)", "P"]),
    # the contracted index sharded in one operand only: the other is cut
    "one_side": ("ij,jk->ik", [((6, 8), (None, None)), ((8, 5), (None, 0))], ["R", "P"]),
    # an output index sharded beside a contracted one: the output's is kept
    "output_first": ("bk,kn->bn", [((4, 8), (0, 1)), ((8, 6), (None, 1))], ["S(0)", "S(1)"]),
}
SPLIT_NORM = {"x": ((4, 3, 16), (0, 2)), "w": ((16,), (None, 0))}  # the gated norm's layout
# name -> (x, w as (shape, dims as above)); the output's placements: a w whose
# rows are FSDP blocks over "data" and whose columns "model" does not shard
# (8 KV heads' wk on a 16-way axis): with few rows a rank (2, 2 and 3,
# fewer than K = 8) K is contracted over "model" on permuted blocks; with
# many (10) the whole product runs as before, w gathered over "data"
MATMUL_CASES = {
    "decode_wk": ([(4, 1, 8), (0, None)], [(8, 6), (0, None)], ["S(0)", "P"]),
    "router": ([(4, 8), (0, None)], [(8, 3), (0, None)], ["S(0)", "P"]),
    "three_rows": ([(2, 3, 8), (0, None)], [(8, 6), (0, None)], ["S(0)", "P"]),
    "prefill_wk": ([(4, 5, 8), (0, None)], [(8, 6), (0, None)], ["S(0)", "R"]),
}

CONTRACT_WORKER = textwrap.dedent("""
    import json, sys

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._python_dispatch import TorchDispatchMode

    torch.set_num_threads(1)
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops

    rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cases, norm, matmuls = json.loads(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    data = np.load(f"{tmp}/inputs.npz")

    axis = {mesh.get_group(i).group_name: n for i, n in enumerate(mesh.mesh_dim_names)}

    class Gathers(TorchDispatchMode):
        # (mesh axis, local operand shape) of each all-gather issued below
        # DTensor, and (mesh axis, operand shape, result shape) of each
        # all_to_all_single

        def __init__(self):
            super().__init__()
            self.shapes, self.permutes = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if func.namespace == "_c10d_functional" and func.__name__.startswith("all_gather"):
                self.shapes.append([axis[args[2]], list(args[0].shape)])
            if func.namespace == "_c10d_functional" and func.__name__.startswith("all_to_all"):
                self.permutes.append([axis[args[3]], list(args[0].shape), list(out.shape)])
            return out

    def placed(name, dims):
        pl = [Replicate() if d is None else Shard(d) for d in dims]
        return sh.distribute_as(torch.from_numpy(data[name]), mesh, pl).requires_grad_(True)

    def pl_str(t):
        return ["P" if p.is_partial() else "R" if p.is_replicate() else f"S({p.dim})"
                for p in t.placements]

    out, saved = {}, {}
    for name, (eq, operands, _) in cases.items():
        ins = [placed(f"{name}_{i}", dims) for i, (_, dims) in enumerate(operands)]
        with Gathers() as g:
            y = sh.einsum(eq, *ins)
        whole = y.redistribute(mesh, [Replicate()] * 2).to_local()
        (whole * torch.from_numpy(data[f"{name}_cot"])).sum().backward()
        out[name] = {"placements": pl_str(y), "gathers": g.shapes,
                     "blocks": [list(t.to_local().shape) for t in ins]}
        saved[f"{name}_out"] = whole.detach().numpy()
        for i, t in enumerate(ins):
            saved[f"{name}_grad{i}"] = t.grad.full_tensor().numpy()
    x, w = placed("norm_x", norm["x"][1]), placed("norm_w", norm["w"][1])
    with Gathers() as g:
        y = ops.rmsnorm(x, w, eps=1e-5, split_rows=True)
    y.full_tensor().mul(torch.from_numpy(data["norm_cot"])).sum().backward()
    out["norm"] = {"placements": pl_str(y), "gathers": g.shapes,
                   "x_block": list(x.to_local().shape)}
    saved.update(norm_out=y.full_tensor().detach().numpy(), norm_grad_x=x.grad.full_tensor().numpy(),
                 norm_grad_w=w.grad.full_tensor().numpy())
    for name, (xs, ws, _) in matmuls.items():
        x, w = placed(f"{name}_x", xs[1]), placed(f"{name}_w", ws[1])
        with Gathers() as g:
            y = sh.matmul(x, w)
        with Gathers() as gb:
            whole = y.redistribute(mesh, [Replicate()] * 2).to_local()
            (whole * torch.from_numpy(data[f"{name}_cot"])).sum().backward()
        out[name] = {"placements": pl_str(y), "dtype": str(y.dtype), "gathers": g.shapes,
                     "permutes": g.permutes, "bwd_permutes": gb.permutes,
                     "blocks": [list(t.to_local().shape) for t in (x, w)]}
        saved.update({f"{name}_out": whole.detach().numpy(),
                      f"{name}_grad0": x.grad.full_tensor().numpy(),
                      f"{name}_grad1": w.grad.full_tensor().numpy()})
    if rank == 0:
        np.savez(f"{tmp}/outputs.npz", **saved)
        with open(f"{tmp}/out.json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def contracted(tmp_path_factory):
    """The workers' outputs and gradients (gathered), their placements and
    all-gathers, beside the inputs and cotangents they were given."""
    import socket

    tmp = tmp_path_factory.mktemp("contract")
    rng = np.random.default_rng(11)
    inputs = {}
    for name, (eq, operands, _) in CONTRACT_CASES.items():
        for i, (shape, _) in enumerate(operands):
            inputs[f"{name}_{i}"] = rng.standard_normal(shape).astype(np.float32)
        ins = [inputs[f"{name}_{i}"] for i in range(len(operands))]
        inputs[f"{name}_cot"] = rng.standard_normal(np.einsum(eq, *ins).shape).astype(np.float32)
    for key, (shape, _) in SPLIT_NORM.items():
        inputs[f"norm_{key}"] = rng.standard_normal(shape).astype(np.float32)
    inputs["norm_cot"] = rng.standard_normal(SPLIT_NORM["x"][0]).astype(np.float32)
    for name, (xs, ws, _) in MATMUL_CASES.items():
        inputs[f"{name}_x"] = rng.standard_normal(xs[0]).astype(np.float32)
        inputs[f"{name}_w"] = rng.standard_normal(ws[0]).astype(np.float32)
        inputs[f"{name}_cot"] = rng.standard_normal((*xs[0][:-1], ws[0][1])).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inputs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    spec = json.dumps([CONTRACT_CASES, SPLIT_NORM, MATMUL_CASES])
    procs = [subprocess.Popen([sys.executable, "-c", CONTRACT_WORKER, str(r), port, str(tmp), spec],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    logs = [p.communicate(timeout=180)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    got = json.loads((tmp / "out.json").read_text())
    return inputs, dict(np.load(tmp / "outputs.npz")), got


@pytest.mark.parametrize("name", list(CONTRACT_CASES))
def test_einsum_contracting_a_sharded_index_is_partial(contracted, name):
    """``sharding.einsum`` on 4 gloo ranks: where the only shard on a mesh
    dim is of a contracted index, each rank contracts its own blocks and the
    output is ``Partial`` there (an output index, where one is sharded, is
    kept instead); the reduction equals ``torch.einsum`` of the whole
    operands, and each operand's gradient (through the reduction) equals
    autograd's, within 1e-5; no operand block is gathered over "model" on
    the way (grok's FSDP d_model is gathered over "data", as the
    reference gathers it)."""
    inputs, saved, got = contracted
    eq, operands, placements = CONTRACT_CASES[name]
    rec = got[name]
    assert rec["placements"] == placements
    ins = [torch.from_numpy(inputs[f"{name}_{i}"]).requires_grad_(True) for i in range(len(operands))]
    want = torch.einsum(eq, *ins)
    (want * torch.from_numpy(inputs[f"{name}_cot"])).sum().backward()
    np.testing.assert_allclose(saved[f"{name}_out"], want.detach().numpy(), rtol=1e-5, atol=1e-5)
    for i, t in enumerate(ins):
        np.testing.assert_allclose(saved[f"{name}_grad{i}"], t.grad.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"operand {i}")
    if placements[1] == "P":
        assert not [s for a, s in rec["gathers"] if a == "model" and s in rec["blocks"]], rec


def test_rmsnorm_over_a_split_row_matches_jax(contracted):
    """The SSM's gated-norm layout on 4 gloo ranks: x's batch over "data"
    and its last dim over "model", w's over "model".  The rows stay split
    (the output's placements are x's), the row statistic is one all-reduce
    of the (B, S, 1) sum of squares, x is never gathered; the output and
    the gradients of x and w equal JAX's ``layers.rmsnorm`` and its vjp
    within 1e-5."""
    inputs, saved, got = contracted
    rec = got["norm"]
    assert rec["placements"] == ["S(0)", "S(2)"]
    assert rec["gathers"] == [], rec
    from repro.models import layers as JL

    y, vjp = jax.vjp(lambda x, w: JL.rmsnorm(x, w, 1e-5), inputs["norm_x"], inputs["norm_w"])
    gx, gw = vjp(jax.numpy.asarray(inputs["norm_cot"]))
    np.testing.assert_allclose(saved["norm_out"], np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(saved["norm_grad_x"], np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(saved["norm_grad_w"], np.asarray(gw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(MATMUL_CASES))
def test_matmul_contracts_an_idle_axis_on_permuted_blocks(contracted, name):
    """``sharding.matmul`` on 4 gloo ranks, w's rows FSDP blocks over
    "data" and nothing sharded over "model".  With few rows a rank the
    output is an f32 ``Partial`` over "model": each rank received one block
    of w (one all_to_all_single over "data", w's block in and out, and its
    gradient sent back the same way) and gathered no block of w.  With many
    rows the placements are those of before: w gathered over "data", the
    whole product on each "model" rank, no permute.  Either way the output
    and the gradients of x and w equal the unsharded product's within the
    f32 tolerance 3e-5."""
    inputs, saved, got = contracted
    rec = got[name]
    placements = MATMUL_CASES[name][2]
    assert rec["placements"] == placements
    x = torch.from_numpy(inputs[f"{name}_x"]).requires_grad_(True)
    w = torch.from_numpy(inputs[f"{name}_w"]).requires_grad_(True)
    want = x @ w
    (want * torch.from_numpy(inputs[f"{name}_cot"])).sum().backward()
    np.testing.assert_allclose(saved[f"{name}_out"], want.detach().numpy(), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(saved[f"{name}_grad0"], x.grad.numpy(), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(saved[f"{name}_grad1"], w.grad.numpy(), rtol=3e-5, atol=3e-5)
    w_block = rec["blocks"][1]
    w_gathers = [a for a, s in rec["gathers"] if s == w_block]
    if placements[1] == "P":
        assert rec["dtype"] == "torch.float32"
        assert rec["permutes"] == [["data", w_block, w_block]], rec
        assert rec["bwd_permutes"] == [["data", w_block, w_block]], rec
        assert w_gathers == [], rec
    else:
        assert rec["permutes"] == [] and w_gathers == ["data"], rec


def _placements(mesh, x_dims, w_dims):
    _, Replicate, Shard = sh.placement_types()
    pl = [[Replicate()] * len(mesh.shape) for _ in range(2)]
    for k, dims in enumerate((x_dims, w_dims)):
        for axis, dim in dims.items():
            pl[k][mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return pl


SINGLE, MULTI = {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}
# (mesh, x shape, x's sharded dims by axis, w's by axis) -> the idle dim and
# w's FSDP dim, or None: the production cells' products under the FSDP overlay
IDLE_CASES = {
    # wk / wv in decode_32k: 8 rows a rank against blocks of 1,152 / 384 rows
    "nemotron_decode_wk": (SINGLE, (128, 1, 18432), {"data": 0}, {"data": 0}, (1, 0)),
    "nemotron_decode_wk_multi": (MULTI, (128, 1, 18432), {"pod": 0, "data": 0}, {"data": 0},
                                 (2, 1)),
    "grok_decode_wk": (SINGLE, (128, 1, 6144), {"data": 0}, {"data": 0}, (1, 0)),
    "grok_decode_router": (SINGLE, (128, 6144), {"data": 0}, {"data": 0}, (1, 0)),
    # prefill_32k: 65,536 rows a rank (32,768 on the multi-pod mesh)
    "nemotron_prefill_wk": (SINGLE, (32, 32768, 18432), {"data": 0}, {"data": 0}, None),
    "grok_prefill_router": (MULTI, (32 * 32768, 6144), {"pod": 0, "data": 0}, {"data": 0}, None),
    # train_4k's microbatch of 8 sequences: its batch is not sharded
    "nemotron_train_wk": (SINGLE, (8, 4096, 18432), {}, {"data": 0}, None),
    # wq: its heads' columns over "model"
    "nemotron_decode_wq": (SINGLE, (128, 1, 18432), {"data": 0}, {"data": 0, "model": 1}, None),
    # no FSDP overlay (granite-8b): w's rows are not sharded
    "granite_decode_wk": (SINGLE, (128, 1, 4096), {"data": 0}, {}, None),
    # a one-rank mesh: every axis of size 1
    "one_rank": ({"data": 1, "model": 1}, (8, 1, 64), {"data": 0}, {"data": 0}, None),
}


@pytest.mark.parametrize("name", list(IDLE_CASES))
def test_idle_contraction_follows_the_reference_cells(name):
    """``sharding.idle_contraction`` on the production meshes, from every
    coordinate's corner: the decode projections that the reference
    contracts over "model" (its collective-permutes of wk's, wv's and
    grok's router's FSDP blocks) meet it; a prefill's 65,536 rows a rank,
    a train microbatch that "data" does not shard, a weight whose columns
    "model" shards, a weight without FSDP blocks and a one-rank mesh do
    not."""
    sizes, x_shape, x_dims, w_dims, want = IDLE_CASES[name]
    for coord in ({a: 0 for a in sizes}, {a: n - 1 for a, n in sizes.items()}):
        mesh = _CoordMesh(sizes, tuple(coord.values()))
        x_pl, w_pl = _placements(mesh, x_dims, w_dims)
        assert sh.idle_contraction(x_shape, x_pl, w_pl, mesh) == want
