"""The benchmark stands apart: no module under ``blitzbench/`` imports JAX or
the JAX package (top-level names compared whole: ``repro_torch`` is not
``repro``) or reads the JAX benchmarks' folder, the plain reference imports
nothing of the port, and a run exits non-zero without a result where it
cannot run: no card, or a checkout that holds only the benchmark."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from blitzbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
MODULES = sorted(HERE.rglob("*.py"))
RUN_MODULES = [p for p in MODULES if p.parent.name != "tests"]  # what a run can load
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _roots(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(str(arg.value).split(".")[0])
    return out


def test_the_walk_covers_every_part():
    names = {str(p.relative_to(HERE)) for p in MODULES}
    for part in ("run.py", "harness.py", "generate.py", "counts.py", "check.py", "trace.py",
                 "weights.py", "reference/model.py", "reference/quant.py",
                 "drivers/replay.py", "tools/control.py", "metrics/decode_attn_roofline.py"):
        assert part in names, part


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", RUN_MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_reads_the_jax_benchmarks(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks/" not in node.value and "BENCH_" not in node.value


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    roots = _roots(path)
    assert "repro_torch" not in roots and not roots & FORBIDDEN
    inner = {n.module for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.ImportFrom) and n.module and n.module.startswith("blitzbench")}
    assert all(m.startswith("blitzbench.reference") for m in inner), inner


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchish", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert "repro" in harness.forbidden_modules()


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "blitzbench/run.py", "--workload", "granite-8b.long32k",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(p: subprocess.CompletedProcess) -> bool:
    lines = p.stdout.strip().splitlines()
    try:
        json.loads(lines[-1])
        return False
    except (IndexError, ValueError):
        return True


def test_a_run_without_a_card_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = _run(ROOT)
    assert p.returncode != 0 and _no_result(p)


def test_a_checkout_of_the_benchmark_alone_exits_nonzero_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "blitzbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = _run(tmp_path)
    assert p.returncode != 0 and _no_result(p)
