"""The port's launch layer (``repro_torch.launch.{steps,dryrun}``) against
tests/test_launch_specs.py and the JAX package's: the cell grid, every
cell's abstract inputs (shapes and dtypes), the optimizer and rule choices,
the roofline's model FLOPs, the per-device argument bytes the specs imply,
and per-device FLOPs counted on a rank's blocks.  One dry-run of granite-8b
``train_4k`` on the single-pod mesh runs in a subprocess (a fake process
group of 256 ranks)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import fake_process_group  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


class _Mesh:
    """A production mesh seen from rank 0: axis names and sizes for spec
    resolution (the reference's Mesh interface and DeviceMesh's)."""

    def __init__(self, sizes: dict):
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self.devices = np.zeros(self.shape)

    def get_coordinate(self):
        return [0] * len(self.shape)

    def size(self, i):
        return self.shape[i]


MESHES = {"single": _Mesh({"data": 16, "model": 16}),
          "multi": _Mesh({"pod": 2, "data": 16, "model": 16})}


def test_cell_grid_is_the_reference_grid(capsys):
    assert list(C.cells()) == list(JC.cells())
    assert list(C.cells(include_skipped=True)) == list(JC.cells(include_skipped=True))
    grid = list(C.cells())
    assert len(grid) == 10 * 4 - 8
    assert {a for a, s, _ in grid if s == "long_500k"} == {"mamba2-370m", "zamba2-2.7b"}
    dryrun.main(["--list"])
    assert capsys.readouterr().out.split("\n")[:-1] == [f"{a} {s}" for a, s, _ in JC.cells()]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _jax_leaves(tree):
    return {tuple(k.key for k in p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in JC.cells()])
def test_input_specs_equal_the_reference(arch, shape):
    got = _leaves(steps.input_specs(arch, shape))
    want = _jax_leaves(JSTEPS.input_specs(arch, shape))
    assert got.keys() == want.keys()
    for key, t in got.items():
        assert t.device.type == "meta", key  # never allocated
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
            (tuple(want[key].shape), jnp.dtype(want[key].dtype).name), key


def test_opt_config_bf16_moments_for_big_archs():
    for arch in C.ARCH_IDS + C.PAPER_IDS:
        want = JSTEPS.opt_config_for(JC.get_config(arch)).moment_dtype == jnp.bfloat16
        got = steps.opt_config_for(C.get_config(arch)).moment_dtype == torch.bfloat16
        assert got == want, arch
    assert steps.opt_config_for(C.get_config("nemotron-4-340b")).moment_dtype == torch.bfloat16
    assert steps.opt_config_for(C.get_config("granite-8b")).moment_dtype == torch.float32


def test_make_rules_applies_arch_overrides():
    mesh = MESHES["single"]
    assert steps.make_rules(C.get_config("nemotron-4-340b"), mesh).rules["d_model"] == ("data",)
    assert steps.make_rules(C.get_config("granite-8b"), mesh).rules["d_model"] is None
    for arch in C.ARCH_IDS:
        assert dict(steps.make_rules(C.get_config(arch), mesh).rules) == \
            dict(JSTEPS.make_rules(JC.get_config(arch), mesh).rules), arch


def test_model_flops_are_the_reference_formula():
    for arch, shape, _ in JC.cells():
        sp, n = JC.SHAPES[shape], JC.get_config(arch).approx_active_params()
        want = {"train": 6.0 * n * sp.seq_len * sp.global_batch,
                "prefill": 2.0 * n * sp.seq_len * sp.global_batch}.get(sp.kind, 2.0 * n * sp.global_batch)
        assert dryrun.model_flops(arch, shape) == pytest.approx(want, rel=1e-12), (arch, shape)
    olmoe = C.get_config("olmoe-1b-7b")
    assert olmoe.approx_active_params() < olmoe.approx_params()


def _reference_bytes(abstract, specs, sizes: dict) -> int:
    """Per-device bytes the reference's specs imply: each dim divided by the
    product of the mesh axes its spec entry names."""
    total = 0
    for sds, spec in zip(jax.tree.leaves(abstract), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = 1
        for i, dim in enumerate(sds.shape):
            e = spec[i] if i < len(spec) else None
            names = () if e is None else ((e,) if isinstance(e, str) else e)
            n *= dim // int(np.prod([sizes[a] for a in names]))
        total += n * jnp.dtype(sds.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
def test_granite_argument_bytes_are_the_reference_specs(mesh):
    """Parameters and caches of granite-8b's three cells, per device, as the
    port counts them (its blocks) and as the reference's specs imply."""
    m = MESHES[mesh]
    sizes = dict(zip(m.axis_names, m.shape))
    cfg, jcfg = C.get_config("granite-8b"), JC.get_config("granite-8b")
    rules, jrules = steps.make_rules(cfg, m), JSTEPS.make_rules(jcfg, m)
    p_want = _reference_bytes(JSH.abstract_from_template(JTF.param_template(jcfg)),
                              JSH.specs_from_template(JTF.param_template(jcfg), jrules), sizes)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        art = steps.build_cell("granite-8b", shape, m)
        assert steps.bytes_per_device(art.args[0], art.in_specs[0], m) == p_want
        sp = JC.SHAPES[shape]
        if sp.kind != "train":
            c_abs = JTF.init_caches(jcfg, sp.global_batch, sp.seq_len, abstract=True)
            c_want = _reference_bytes(c_abs, JSH.specs_for_axes(c_abs, JTF.cache_axes(jcfg), jrules),
                                      sizes)
            assert steps.bytes_per_device(art.args[-1], art.in_specs[-1], m) == c_want
    # 16-way tensor parallel, less the KV projections and norms it replicates
    assert sh.param_bytes(TF.param_template(cfg)) // 16 < p_want < sh.param_bytes(
        TF.param_template(cfg)) // 8


def test_flops_are_counted_per_device():
    """A (2048 x 4096) @ (4096 x 14336) product with the weight's columns over
    the 16-way "model" axis: each device does one sixteenth of it; at the
    DTensor level the flop counter sees the whole product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    full = 2 * 2048 * 4096 * 14336
    with fake_process_group(256):
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh()
        with FakeTensorMode(), dryrun._propagation_unfaked():
            x = sh.empty_sharded((2048, 4096), torch.bfloat16, (), mesh, "cpu")
            w = sh.empty_sharded((4096, 14336), torch.bfloat16, (None, "model"), mesh, "cpu")
            counter = dryrun.DeviceCounter()
            with counter:
                y = x @ w
            global_counter = FlopCounterMode(display=False)
            with global_counter:
                x @ w
    assert y.to_local().shape == (2048, 14336 // 16)
    assert counter.flops == full / 16
    assert global_counter.get_total_flops() == full
    assert counter.coll_count == {}


def test_dryrun_of_granite_train_4k_in_a_subprocess(tmp_path):
    """The CLI on one cell: ok, with the parameter bytes of the reference's
    specs, per-device FLOPs near MODEL_FLOPS / 256, and its roofline
    terms."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-8b", "--shape",
         "train_4k", "--mesh", "single", "--out", str(tmp_path), "--force"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "1/1 cells passed" in out.stdout
    rec = json.loads((tmp_path / "granite-8b__train_4k__single.json").read_text())
    assert rec["ok"] and rec["chips"] == 256 and rec["microbatches"] == 16
    m = MESHES["single"]
    jcfg = JC.get_config("granite-8b")
    jrules = JSTEPS.make_rules(jcfg, m)
    sizes = dict(zip(m.axis_names, m.shape))
    assert rec["param_bytes_per_dev"] == _reference_bytes(
        JSH.abstract_from_template(JTF.param_template(jcfg)),
        JSH.specs_from_template(JTF.param_template(jcfg), jrules), sizes)
    assert rec["opt_bytes_per_dev"] == 4 * rec["param_bytes_per_dev"] + 4  # f32 m, v and the step
    assert 0.3 < rec["useful_flop_frac"] <= 1.0
    assert rec["t_compute"] > 0 and rec["t_memory"] > 0 and rec["t_collective"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["fits_80gb"] is (rec["argument_bytes_per_dev"] + rec["temp_bytes_per_dev"] <= 80e9)
