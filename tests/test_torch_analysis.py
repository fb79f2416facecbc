"""The port's static checker (``repro_torch.analysis``) held to the
reference's (``repro.analysis``) on the CPU.

Every fixture of ``tests/analysis_fixtures/`` (read, never edited) goes
through both checkers: the reference's as module ``repro.net._fix_*``, the
port's on the same text with the module name and the ``repro`` imports
mapped to ``repro_torch`` in memory.  The findings must be equal (rule,
line, column, symbol and message, names mapped).  The same equality holds
for the pragmas, ``module_name_for``, the baseline, the CLI's exit codes
and JSON report, the import-graph dumps and the import smoke's walker.

Then the port's own gate: ``src/repro_torch`` is clean under the committed
``analysis_baseline_torch.json``, every edge the port's table adds over the
reference's is used, two mutations of real port modules fire, and the import
smoke passes over the port and ``examples_torch`` with ``jax`` and ``repro``
refused.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

import repro.analysis as J
import repro_torch.analysis as P
from repro.analysis import check as j_check
from repro.analysis import config as j_config
from repro.analysis import import_smoke as j_smoke
from repro.analysis.core import module_name_for as j_module_name_for
from repro_torch.analysis import check as p_check
from repro_torch.analysis import config as p_config
from repro_torch.analysis import import_smoke as p_smoke
from repro_torch.analysis.core import module_name_for as p_module_name_for
from repro_torch.analysis.rules.layering import import_graph as p_import_graph

FIXTURES = pathlib.Path(__file__).parent / "analysis_fixtures"
REPO = pathlib.Path(__file__).resolve().parent.parent
SRC_PORT = REPO / "src" / "repro_torch"
RULES = ("determinism", "event-reentrancy", "exact-float", "layering", "set-iteration")


def to_port(text: str) -> str:
    """Module names and imports of ``repro`` -> ``repro_torch``."""
    return re.sub(r"\brepro\b(?!_torch)", "repro_torch", text)


def _findings(pkg, text: str, module: str, path: str = "fixture.py", **kw):
    unit = pkg.SourceUnit(path, text, module=module)
    ctx = pkg.AnalysisContext(config=pkg.default_config(), units=[unit], **kw)
    return pkg.run_rules(ctx)


def _as_dicts(findings, mapped: bool = False) -> list[dict]:
    out = []
    for f in findings:
        d = f.as_dict()
        if mapped:
            d = {k: to_port(v) if isinstance(v, str) else v for k, v in d.items()}
        out.append(d)
    return out


def _both(text: str, module: str, **kw) -> tuple[list[dict], list[dict]]:
    """(reference findings mapped to the port's names, port findings)."""
    ref = _findings(J, text, module, **kw)
    port = _findings(P, to_port(text), to_port(module), **kw)
    return _as_dicts(ref, mapped=True), _as_dicts(port)


# ---------------------------------------------------------------------------
# every rule on every fixture
# ---------------------------------------------------------------------------

FIXTURE_MODULES = [(f.name, f"repro.net._fix_{f.stem}") for f in sorted(FIXTURES.glob("*.py"))] + [
    ("det_bad.py", "repro.core.multicast"),  # the planner allowlist
    ("det_bad.py", "repro.models.block"),  # out of the determinism scope
    ("float_bad.py", "repro.core.sim"),  # out of the exact-float scope
    ("iter_bad.py", "repro.core.simulator"),  # in the set-iteration scope
    ("layer_bad.py", "repro.obs._fix_layer_bad"),  # obs may not see serving either
    ("layer_clean.py", "repro.workloads._fix"),  # the bottom layer sees nothing
]


@pytest.mark.parametrize("fixture,module", FIXTURE_MODULES,
                         ids=[f"{f}-{m}" for f, m in FIXTURE_MODULES])
def test_fixture_findings_equal_the_reference(fixture, module):
    text = (FIXTURES / fixture).read_text(encoding="utf-8")
    ref, port = _both(text, module)
    assert port == ref
    if fixture.endswith("_bad.py") and module.startswith("repro.net."):
        assert port, "a bad fixture in scope must fire"


@pytest.mark.parametrize("fixture", ["iter_bad.py", "iter_clean.py"])
def test_fix_sorted_suggestions_equal_the_reference(fixture):
    text = (FIXTURES / fixture).read_text(encoding="utf-8")
    ref, port = _both(text, "repro.net._fix_iter", fix_sorted=True)
    assert port == ref


def test_layering_bad_fixture_names_the_port_packages():
    text = to_port((FIXTURES / "layer_bad.py").read_text(encoding="utf-8"))
    found = _findings(P, text, "repro_torch.net._fix_layer_bad")
    assert sorted(f.line for f in found) == [7, 12]
    assert "repro_torch.serving" in found[0].message
    assert "lazy" in found[1].message and "repro_torch.obs" in found[1].message


def test_rule_registry_equals_the_reference():
    j_rules, p_rules = J.all_rules(), P.all_rules()
    assert sorted(p_rules) == sorted(j_rules) == list(RULES)
    assert {k: r.summary for k, r in p_rules.items()} == {k: r.summary for k, r in j_rules.items()}


# ---------------------------------------------------------------------------
# pragmas
# ---------------------------------------------------------------------------

PRAGMA_CASES = [
    "a = 1  # simcheck: disable=determinism\n",
    "# simcheck: disable=set-iteration\nfor_x = 1\nuntouched = 2\n",
    "# simcheck: disable-file=exact-float\na = 1\nb = 2\n",
    "a = 1  # simcheck: disable=determinism,set-iteration\n",
    "a = 1  # simcheck: disable=layering -- CLI entrypoint, not library\n",
    "a = 1  # simcheck: exact-float -- sentinel compare\n",
    "a = 1  # simcheck: disable=*\n",
    "a = 1  # simcheck: nonsense\n",
    "x = (\n    1,  # simcheck: disable=layering\n)\n",
]


@pytest.mark.parametrize("src", PRAGMA_CASES, ids=range(len(PRAGMA_CASES)))
def test_pragmas_equal_the_reference(src):
    ju, pu = J.SourceUnit("x.py", src), P.SourceUnit("x.py", src)
    n = len(src.splitlines()) + 1
    for rule in (*RULES, "CLI", "nonsense"):
        for line in range(1, n + 1):
            assert pu.disabled(rule, line) == ju.disabled(rule, line), (rule, line)


def test_pragma_suppresses_through_run_rules():
    src = ("import time\n"
           "def f():\n"
           "    return time.time()  # simcheck: disable=determinism -- ok\n"
           "def g():\n"
           "    return time.time()\n")
    ref, port = _both(src, "repro.net._fix_pragma")
    assert port == ref and [f["line"] for f in port] == [5]


# ---------------------------------------------------------------------------
# module naming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [
    "src/repro/net/flowsim.py",
    "src/repro/net/__init__.py",
    "src/repro/core/zigzag.py",
    "/abs/checkout/src/repro/serving/maas/fleet.py",
    "tests/analysis_fixtures/det_bad.py",
    "examples/quickstart.py",
])
def test_module_name_for_equals_the_reference(path):
    ported = path.replace("/repro/", "/repro_torch/")
    assert p_module_name_for(ported) == to_port(j_module_name_for(path))


def test_module_name_for_roots_at_repro_torch_only():
    # the reference's root name is not the port's: a file under src/repro
    # falls back to its stem for the port's checker
    assert p_module_name_for("src/repro_torch/net/flowsim.py") == "repro_torch.net.flowsim"
    assert p_module_name_for("src/repro/net/flowsim.py") == "flowsim"


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def _det_findings(pkg, to):
    text = (FIXTURES / "det_bad.py").read_text(encoding="utf-8")
    return _findings(pkg, to(text), to("repro.net._fix_det_bad"), path="src/x/bad.py")


@pytest.mark.parametrize("case", ["round_trip", "stale", "placeholder", "missing", "version"])
def test_baseline_equals_the_reference(tmp_path, case):
    results = []
    for pkg, to in ((J, str), (P, to_port)):
        findings = _det_findings(pkg, to)
        bl = pkg.Baseline.from_findings(findings)
        path = tmp_path / f"{pkg.__name__}.json"
        if case in ("round_trip", "stale"):
            for e in bl.entries:
                e["justification"] = "kept for the rule test"
            bl.save(str(path))
            loaded = pkg.Baseline.load(str(path))
            new, old, stale = loaded.split([] if case == "stale" else findings)
            results.append((len(new), len(old), stale, path.read_text()))
            continue
        if case == "placeholder":
            bl.save(str(path))
        elif case == "missing":
            path.write_text(json.dumps({"version": 1, "entries": [{"rule": "determinism"}]}))
        else:
            path.write_text(json.dumps({"version": 99, "entries": []}))
        with pytest.raises(ValueError) as err:
            pkg.Baseline.load(str(path))
        results.append(str(err.value).replace(str(path), "PATH"))
    assert results[1] == results[0]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _tree(root: pathlib.Path, pkg_dir: str, fixture: str, name: str = "bad.py", to=str):
    """An src-style tree holding one fixture as ``<pkg_dir>.net.<name>``."""
    d = root / "src" / pkg_dir / "net"
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(to((FIXTURES / fixture).read_text(encoding="utf-8")))
    return root / "src"


CLI_CASES = {
    "findings": ("det_bad.py", []),
    "clean": ("det_clean.py", []),
    "rule_filter": ("det_bad.py", ["--rule", "set-iteration"]),
    "unknown_rule": ("det_bad.py", ["--rule", "nonsense"]),
    "missing_baseline": ("det_bad.py", ["--baseline", "{tmp}/no.json"]),
    "json": ("det_bad.py", ["--format", "json"]),
    "fix_sorted": ("iter_bad.py", ["--rule", "set-iteration", "--fix-sorted"]),
    "layering": ("layer_bad.py", []),
    "reentrancy": ("reent_bad.py", []),
    "float": ("float_bad.py", ["--format", "json", "--json-out", "{tmp}/report.json"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_equals_the_reference(tmp_path, capsys, case):
    fixture, extra = CLI_CASES[case]
    got = []
    for cli, pkg_dir, to in ((j_check, "repro", str), (p_check, "repro_torch", to_port)):
        base = tmp_path / pkg_dir
        root = _tree(base, pkg_dir, fixture, to=to)
        rc = cli.main([str(root), *[a.format(tmp=base) for a in extra]])
        out, err = capsys.readouterr()
        report = (base / "report.json").read_text() if "--json-out" in extra else ""
        got.append((rc, *(to_port(s.replace(str(base), "TMP")) for s in (out, err, report))))
    assert got[1] == got[0]
    assert got[1][0] == {"clean": 0, "rule_filter": 0, "unknown_rule": 2,
                         "missing_baseline": 2}.get(case, 1)


def test_cli_update_baseline_cycle_equals_the_reference(tmp_path, capsys):
    got = []
    for cli, pkg_dir, to in ((j_check, "repro", str), (p_check, "repro_torch", to_port)):
        base = tmp_path / pkg_dir
        root = _tree(base, pkg_dir, "det_bad.py", to=to)
        bl = base / "baseline.json"
        rcs = [cli.main([str(root), "--baseline", str(bl), "--update-baseline"])]
        rcs.append(cli.main([str(root), "--baseline", str(bl)]))  # placeholders: 2
        data = json.loads(bl.read_text())
        for e in data["entries"]:
            e["justification"] = "grandfathered for the CLI round-trip test"
        bl.write_text(json.dumps(data))
        rcs.append(cli.main([str(root), "--baseline", str(bl)]))  # baselined: 0
        shutil.copy(FIXTURES / "det_clean.py", root / pkg_dir / "net" / "bad.py")
        rcs.append(cli.main([str(root), "--baseline", str(bl)]))  # stale: 1
        out, err = capsys.readouterr()
        got.append((rcs, to_port(out.replace(str(base), "TMP")), to_port(err.replace(str(base), "TMP"))))
    assert got[1] == got[0]
    assert got[1][0] == [0, 2, 0, 1]
    assert "[baselined]" in got[1][1] and "stale baseline entry" in got[1][1]


def test_cli_list_rules_equals_the_reference(capsys):
    assert j_check.main(["--list-rules"]) == 0
    ref = capsys.readouterr().out
    assert p_check.main(["--list-rules"]) == 0
    assert capsys.readouterr().out == ref


def test_cli_defaults_to_the_port(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert p_check.main([]) == 0
    assert capsys.readouterr().out == "simcheck: clean\n"


# ---------------------------------------------------------------------------
# import-graph dumps
# ---------------------------------------------------------------------------

def _mini_package(root: pathlib.Path, name: str) -> pathlib.Path:
    """The same small package under ``name``: top-level, lazy, symbol and
    star imports, and an import of a module outside the scan."""
    pkg = root / name
    (pkg / "net").mkdir(parents=True)
    (pkg / "core").mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "net" / "__init__.py").write_text(f"from {name}.net.flows import Flow\n")
    (pkg / "net" / "flows.py").write_text(
        f"from {name}.core.topology import Topology\nclass Flow: pass\n")
    (pkg / "core" / "topology.py").write_text("class Topology: pass\n")
    (pkg / "core" / "sim.py").write_text(
        f"import {name}.net\nfrom {name}.core import *\n"
        f"def f():\n    from {name}.obs import trace\n    import {name}.net.flows\n")
    return pkg


@pytest.mark.parametrize("fmt", ["json", "dot"])
def test_import_graph_equals_the_reference(tmp_path, capsys, fmt):
    outs = []
    for cli, name in ((j_check, "repro"), (p_check, "repro_torch")):
        pkg = _mini_package(tmp_path / name / "src", name)
        for _ in range(2):  # deterministic: two dumps are equal
            assert cli.main(["--import-graph", fmt, str(pkg)]) == 0
            outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert outs[2] == to_port(outs[0])


def test_import_graph_of_the_port_is_deterministic(tmp_path, capsys):
    assert p_check.main(["--import-graph", "json", str(SRC_PORT)]) == 0
    first = capsys.readouterr().out
    out_file = tmp_path / "graph.json"
    assert p_check.main(["--import-graph", "json", "--import-graph-out", str(out_file),
                         str(SRC_PORT)]) == 0
    capsys.readouterr()
    assert out_file.read_text() == first
    graph = json.loads(first)
    assert "repro_torch.net.flowsim" in graph["nodes"]
    assert any(e["src"] == "repro_torch.core.simulator" and e["dst"].startswith("repro_torch.workloads")
               for e in graph["edges"])


# ---------------------------------------------------------------------------
# the import smoke's walker
# ---------------------------------------------------------------------------

def _smoke_tree(root: pathlib.Path, kind: str) -> list[str]:
    """A tree for the import smoke; its package is named after ``kind`` and
    ``root`` so that no two trees share a name in ``sys.modules``."""
    name = f"smokepkg_{kind}_{root.name}"
    if kind == "src":
        pkg = root / "src" / name
        (pkg / "sub").mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "mod.py").write_text("X = 1\n")
        (pkg / "sub" / "__init__.py").write_text("")
        (pkg / "sub" / "leaf.py").write_text("Y = 2\n")
        return [str(root / "src")]
    if kind == "plain":
        pkg = root / f"bench_{root.name}"
        pkg.mkdir(parents=True)
        (pkg / "common.py").write_text("X = 1\n")
        return [str(pkg)]
    pkg = root / "src" / name
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    body = {"syntax": "def f(:\n", "import": "import no_such_module_anywhere_xyz\n",
            "ok": "VALUE = 40 + 2\n"}[kind]
    (pkg / "m.py").write_text(body)
    return [str(root / "src")]


@pytest.mark.parametrize("kind", ["src", "plain"])
def test_iter_modules_equals_the_reference(tmp_path, kind):
    roots = _smoke_tree(tmp_path / "t", kind)
    assert p_smoke.iter_modules(roots[0]) == j_smoke.iter_modules(roots[0])
    assert p_smoke.iter_modules(str(SRC_PORT)) == j_smoke.iter_modules(str(SRC_PORT))


@pytest.mark.parametrize("kind", ["ok", "syntax", "import", "missing"])
def test_import_smoke_exit_codes_equal_the_reference(tmp_path, capsys, kind):
    got = []
    for smoke, tag in ((j_smoke, "j"), (p_smoke, "p")):
        roots = ([str(tmp_path / "nope")] if kind == "missing"
                 else _smoke_tree(tmp_path / tag, kind))
        rc = smoke.main(roots)
        out = capsys.readouterr().out
        got.append((rc, out.replace(f"smokepkg_{kind}_{tag}", "PKG").replace(str(tmp_path / tag), "TMP")))
    assert got[1] == got[0]
    assert got[1][0] == {"ok": 0, "missing": 2}.get(kind, 1)


REFUSE_AND_SMOKE = """
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ModuleNotFoundError(f"refused: {name}", name=name)
        return None

sys.meta_path.insert(0, Refuse())
from repro_torch.analysis import import_smoke
sys.exit(import_smoke.main(["src/repro_torch", "examples_torch"]))
"""


def test_import_smoke_passes_over_the_port_with_jax_and_repro_refused():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", REFUSE_AND_SMOKE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    n = len(p_smoke.iter_modules(str(SRC_PORT))) + len(p_smoke.iter_modules(str(REPO / "examples_torch")))
    assert proc.stdout.strip().splitlines()[-1] == f"import-smoke: {n} compiled, {n} imported, 0 failure(s)"


# ---------------------------------------------------------------------------
# the port's own gate
# ---------------------------------------------------------------------------

def test_src_repro_torch_is_clean_under_the_committed_baseline():
    bl = P.Baseline.load(str(REPO / "analysis_baseline_torch.json"))
    new, old, stale = p_check.run_check([str(SRC_PORT)], baseline=bl)
    assert new == [], "\n".join(f.format() for f in new)
    assert stale == []
    assert bl.entries == []  # the port is made clean through its config


def test_the_port_config_is_the_reference_policy_renamed():
    j, p = j_config.default_config(), p_config.default_config()
    for field in ("determinism_scopes", "iteration_scopes", "float_eq_scopes"):
        assert getattr(p, field) == tuple(to_port(s) for s in getattr(j, field)), field
    assert dict(p.determinism_allowlist) == {to_port(k): v for k, v in j.determinism_allowlist.items()}
    for field in ("wall_clock_calls", "seeded_rng_constructors", "order_insensitive_calls",
                  "order_passthrough_calls", "order_sensitive_reducers", "float_eq_helpers",
                  "subscribe_method", "reentrancy_forbidden", "reentrancy_sanctioned"):
        assert getattr(p, field) == getattr(j, field), field
    # every reference edge is kept, renamed
    for key, targets in j_config.ALLOWED_EDGES.items():
        assert set(map(to_port, targets)) <= set(p_config.ALLOWED_EDGES[to_port(key)]), key


def _added_edges() -> list[tuple[str, str]]:
    ref = {to_port(k): set(map(to_port, v)) for k, v in j_config.ALLOWED_EDGES.items()}
    return sorted((k, t) for k, ts in p_config.ALLOWED_EDGES.items() for t in ts
                  if t not in ref.get(k, set()))


def test_the_port_adds_only_the_edges_its_design_needs():
    assert _added_edges() == [
        ("repro_torch.core", "repro_torch.kernels.ops"),
        ("repro_torch.kernels", "repro_torch.distributed"),
        ("repro_torch.models", "repro_torch.device"),
        ("repro_torch.models", "repro_torch.kernels.ops"),
        ("repro_torch.serving", "repro_torch.kernels.ops"),
    ]
    # models may not see all of kernels: kernels.ref -> models.layers is the
    # other way, and a package-wide edge would hide a cycle
    assert "repro_torch.kernels" not in p_config.ALLOWED_EDGES["repro_torch.models"]


@pytest.mark.parametrize("key,target", _added_edges(), ids=lambda x: x)
def test_every_added_edge_is_used_by_the_port(key, target):
    graph = p_import_graph(P.load_tree([str(SRC_PORT)]))
    keys = list(p_config.ALLOWED_EDGES)

    def layer(module):
        best = [k for k in keys if module == k or module.startswith(k + ".")]
        return max(best, key=len) if best else None

    used = [e for e in graph["edges"]
            if layer(e["src"]) == key and (e["dst"] == target or e["dst"].startswith(target + "."))]
    assert used, f"no module of {key} imports {target}"


def test_models_and_kernels_form_no_module_cycle():
    graph = p_import_graph(P.load_tree([str(SRC_PORT)]))
    adj: dict[str, set[str]] = {}
    for e in graph["edges"]:
        if e["toplevel"]:
            adj.setdefault(e["src"], set()).add(e["dst"])
    state: dict[str, int] = {}

    def visit(n, trail):
        if state.get(n) == 1:
            raise AssertionError("import cycle: " + " -> ".join(trail + [n]))
        if state.get(n) == 2:
            return
        state[n] = 1
        for m in sorted(adj.get(n, ())):
            visit(m, trail + [n])
        state[n] = 2

    for n in sorted(adj):
        visit(n, [])


MUTATIONS = [
    ("net/flowsim.py", "repro_torch.net.flowsim", "\nimport repro_torch.serving\n", "layering"),
    ("core/simulator.py", "repro_torch.core.simulator",
     "\nimport time\n\ndef _wall():\n    return time.time()\n", "determinism"),
]


@pytest.mark.parametrize("rel,module,tail,rule", MUTATIONS, ids=[m[3] for m in MUTATIONS])
def test_a_mutation_of_a_port_module_fires(rel, module, tail, rule):
    path = SRC_PORT / rel
    text = path.read_text(encoding="utf-8")
    assert _findings(P, text, module, path=f"src/repro_torch/{rel}") == []
    found = _findings(P, text + tail, module, path=f"src/repro_torch/{rel}")
    assert [f.rule for f in found] == [rule]
    assert found[0].line == len((text + tail).splitlines())  # the mutation's last line
