"""Import smoke — byte-compile and import every module, executing nothing.

``python -m repro_torch.analysis.import_smoke src/repro_torch examples_torch`` walks
each root, byte-compiles every ``*.py`` (syntax rot fails immediately,
even in files no test touches) and then imports each module by dotted
name (dead imports, moved symbols and circular-import regressions in
non-tier-1 files fail fast instead of three PRs later).  "No execution"
means no ``main()`` runs: modules are imported exactly once, so anything
with import-time side effects beyond definitions is itself a bug this
check is designed to surface.

Exit codes: 0 = everything compiles and imports, 1 = failures (each
listed with its traceback tail), 2 = usage error.
"""

from __future__ import annotations

import argparse
import importlib
import os
import py_compile
import sys
import traceback

__all__ = ["main", "iter_modules"]


def iter_modules(root: str) -> list[tuple[str, str]]:
    """-> sorted [(file path, dotted module name)] under ``root``.

    For an ``src``-style root the dotted name starts below the root
    (``src/repro_torch/net/flows.py`` -> ``repro_torch.net.flows``);
    plain package dirs like ``examples_torch`` keep the root dir as the package name.
    """
    out: list[tuple[str, str]] = []
    root = root.rstrip("/")
    # `src` itself is a search path, not a package
    prefix_parent = root if os.path.basename(root) == "src" else os.path.dirname(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, prefix_parent)
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts.pop()
            if not parts:
                continue
            out.append((path, ".".join(parts)))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.import_smoke",
        description="byte-compile and import every module under the given "
        "roots (no execution)",
    )
    ap.add_argument("roots", nargs="+", help="e.g. src/repro_torch examples_torch")
    args = ap.parse_args(argv)

    failures: list[tuple[str, str, str]] = []  # (stage, target, error)
    n_compiled = n_imported = 0
    for root in args.roots:
        if not os.path.isdir(root):
            print(f"import-smoke: no such directory: {root}", file=sys.stderr)
            return 2
        # make both `src`-style roots and sibling packages importable
        search = root if os.path.basename(root) == "src" else os.path.dirname(root) or "."
        if search not in sys.path:
            sys.path.insert(0, search)
        for path, module in iter_modules(root):
            try:
                py_compile.compile(path, doraise=True)
                n_compiled += 1
            except py_compile.PyCompileError as e:
                failures.append(("compile", path, str(e)))
                continue
            try:
                importlib.import_module(module)
                n_imported += 1
            except Exception:
                tail = traceback.format_exc().strip().splitlines()[-1]
                failures.append(("import", module, tail))

    for stage, target, err in failures:
        print(f"import-smoke: {stage} FAILED {target}: {err}")
    print(
        f"import-smoke: {n_compiled} compiled, {n_imported} imported, "
        f"{len(failures)} failure(s)"
    )
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
