"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to CUDA and refuse to fall back to the CPU, and a
kernel asked for on a CPU tensor raises."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention, ops, rmsnorm  # noqa: E402
from repro_torch.launch.train import run_train  # noqa: E402
from repro_torch.models import bridge  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])
CFG = get_config("granite-8b", reduced=True)
MLA_CFG = get_config("minicpm3-4b", reduced=True)
HYBRID_CFG = get_config("zamba2-2.7b", reduced=True)
ENCDEC_CFG = get_config("whisper-large-v3", reduced=True)
VLM_CFG = get_config("pixtral-12b", reduced=True)


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_isolation_covers_the_mla_and_maas_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("configs/minicpm3_4b.py", "models/attention.py", "models/kvcache.py",
                "workloads/__init__.py", "workloads/traces.py", "serving/traces.py",
                "obs/ledger.py", "obs/slo.py", "serving/maas/__init__.py",
                "serving/maas/tenant.py", "serving/maas/fleet.py", "launch/serve.py",
                "models/moe.py", "models/mamba2.py", "core/collectives.py",
                "configs/olmoe_1b_7b.py", "configs/mamba2_370m.py", "configs/zamba2_2_7b.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_isolation_covers_the_last_four_configs():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("grok_1_314b", "nemotron_4_340b", "whisper_large_v3", "pixtral_12b"):
        assert f"src/repro_torch/configs/{mod}.py" in names, mod


def test_isolation_covers_the_training_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("training/optimizer.py", "training/train_step.py", "training/checkpoint.py",
                "data/pipeline.py", "launch/train.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_isolation_covers_the_sharding_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("distributed/__init__.py", "distributed/sharding.py", "launch/mesh.py",
                "launch/steps.py", "launch/dryrun.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_isolation_covers_the_tools_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("core/zigzag.py", "core/simulator.py", "obs/export.py", "obs/critical_path.py",
                "obs/flightrec.py", "obs/report.py", "obs/steplog.py", "obs/__init__.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_isolation_covers_the_analysis_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("__init__", "core", "config", "baseline", "check", "import_smoke",
                "rules/__init__", "rules/determinism", "rules/iteration", "rules/exactfloat",
                "rules/layering", "rules/reentrancy"):
        assert f"src/repro_torch/analysis/{mod}.py" in names, mod


def test_isolation_covers_the_examples():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for ex in ("quickstart", "net_scenarios", "serve_maas", "serve_autoscale", "serve_disagg",
               "train_100m"):
        assert f"examples_torch/{ex}.py" in names, ex


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize(
    "call",
    [
        lambda: resolve_device(),
        lambda: TF.init_params(CFG, 0),
        lambda: TF.init_caches(CFG, 1, 8),
        lambda: bridge.params_from_numpy({"w": np.zeros(3, np.float32)}),
        lambda: TF.init_params(MLA_CFG, 0),
        lambda: TF.init_caches(MLA_CFG, 1, 8),
        lambda: TF.init_params(HYBRID_CFG, 0),
        lambda: TF.init_caches(HYBRID_CFG, 1, 8),
        lambda: TF.init_params(ENCDEC_CFG, 0),
        lambda: TF.init_caches(ENCDEC_CFG, 1, 8),
        lambda: TF.init_params(VLM_CFG, 0),
        lambda: bridge.opt_state_from_numpy({"step": np.zeros((), np.int32)}),
        lambda: run_train(CFG, AdamWConfig(), steps=1),
    ],
    ids=["resolve_device", "init_params", "init_caches", "params_from_numpy", "init_params_mla",
         "init_caches_mla", "init_params_hybrid", "init_caches_hybrid", "init_params_encdec",
         "init_caches_encdec", "init_params_vlm", "opt_state_from_numpy", "run_train"],
)
def test_entry_points_default_to_cuda_and_raise_without_it(call):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_explicit_cpu_device_runs():
    assert resolve_device("cpu").type == "cpu"
    assert TF.init_caches(CFG, 1, 8, device="cpu")["layers"]["k"].device.type == "cpu"


def _cpu_args():
    q = torch.zeros(1, 4, 4, 16)
    kv = torch.zeros(1, 4, 2, 16)
    cache = torch.zeros(1, 2, 8, 16)
    return {
        "rmsnorm": (ops.rmsnorm, (torch.zeros(2, 16), torch.ones(16))),
        "flash_attention": (ops.flash_attention, (q, kv, kv)),
        "decode_attention": (
            ops.decode_attention,
            (torch.zeros(1, 4, 16), cache, cache, torch.ones(1, dtype=torch.int32)),
        ),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention", "decode_attention"])
def test_kernel_impl_on_cpu_tensor_raises(name):
    fn, args = _cpu_args()[name]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, impl="kernel")
    with ops.use_impl("kernel"), pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    fn(*args)  # auto on a CPU tensor: the plain version


@pytest.mark.parametrize(
    "wrapper,args",
    [
        (rmsnorm.fused_rmsnorm, (torch.zeros(2, 16), torch.ones(16))),
        (flash_attention.flash_attention, (torch.zeros(1, 4, 4, 16),) + (torch.zeros(1, 4, 2, 16),) * 2),
        (decode_attention.decode_attention,
         (torch.zeros(1, 4, 16),) + (torch.zeros(1, 2, 8, 16),) * 2 + (torch.ones(1, dtype=torch.int32),)),
        (rmsnorm.fused_rmsnorm_bwd, (torch.zeros(2, 16), torch.ones(16), torch.zeros(2, 16))),
        (flash_attention.flash_attention_bwd,
         (torch.zeros(1, 4, 4, 16),) + (torch.zeros(1, 4, 2, 16),) * 2 + (torch.zeros(1, 4, 4, 16),) * 2),
    ],
    ids=["rmsnorm", "flash_attention", "decode_attention", "rmsnorm_bwd", "flash_attention_bwd"],
)
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, args):
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert ops.launch_counts() == before


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros(2, 4), torch.ones(4), impl="pallas")
    with pytest.raises(ValueError):
        with ops.use_impl("fast"):
            pass
