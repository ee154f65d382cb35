"""The ``kernels`` prong: every CUDA kernel of the port has a registered
plain twin and a live gate test.

Counterpart of ``ringpop_tpu/analysis/kernel_coverage.py``.  The port's
convention is that each ``csrc/*.cu`` kernel ships with a wrapper in
``ops/`` that launches it through ``_build.library().call(...)``
(``ops/_build.py`` ``KernelLibrary.call``), a plain PyTorch version of the
same function in the same module, a test holding the plain version against
the JAX function on the CPU, and a test holding the batching rule; one
``ops/toolkit.py`` ``TWIN_REGISTRY`` row names all of them.  This prong
makes the convention machine-checked: the sources and the launch sites are
found by walking the tree, and every registry row must point at things
that exist.

Findings (prong "kernels"):

- ``unregistered-kernel``: a ``csrc/*.cu`` that no row names as its
  ``source``, or an ``ops/`` module holding a ``library().call(...)`` site
  that no row names as its ``module``;
- ``missing-kernel-entry`` / ``missing-twin-entry``: a row's
  ``kernel_entry`` / ``plain_entry`` is not a top-level def of its module;
- ``missing-gate-test``: a row's ``gate_test`` or ``batch_gate_test`` does
  not exist or never names the kernel entry (a rename would orphan it);
- ``stale-registry-row``: a row's ``source`` is gone, or its module holds
  no launch site (the kernel was removed: drop the row).

Exempt, as the JAX prong exempts ``toolkit`` (shared scaffolding, not a
kernel): ``csrc/common.cuh``, the header of helpers every kernel includes
(no entry point of its own; only ``.cu`` files are kernel sources), and
``csrc/probe/``, the measurement probes that ``block_loop_probe.py``
builds apart from the kernel library; no main path launches them.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ringpop_tpu_torch.analysis.findings import Finding

PRONG = "kernels"

EXEMPT_DIRS = ("probe",)


def _finding(rule: str, path: str, message: str, line: int = 0) -> Finding:
    return Finding(rule=rule, path=path, line=line, message=message, prong=PRONG)


def kernel_sources(csrc: Path) -> List[Path]:
    """The kernel sources under ``csrc``: every ``*.cu`` outside the
    exempt directories."""
    return sorted(
        p for p in csrc.rglob("*.cu")
        if not set(p.relative_to(csrc).parts[:-1]) & set(EXEMPT_DIRS)
    )


def launch_lines(tree: ast.AST) -> List[int]:
    """Line numbers of ``<...>library().call(...)`` sites: the one way a
    wrapper launches a kernel of the library."""
    lines = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "call"
            and isinstance(node.func.value, ast.Call)
        ):
            continue
        fn = node.func.value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
        if name == "library":
            lines.append(node.lineno)
    return lines


def _toplevel_defs(tree: ast.AST) -> set:
    return {
        node.name
        for node in ast.iter_child_nodes(tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def check_kernel_coverage(
    pkg_root: Optional[Path] = None,
    registry: Optional[Sequence] = None,
    repo_root: Optional[Path] = None,
) -> List[Finding]:
    """Run the coverage rules.  ``pkg_root`` (the package directory holding
    ``ops/`` and ``csrc/``), ``registry`` and ``repo_root`` default to the
    live tree and ``toolkit.TWIN_REGISTRY``; the mutation tests point them
    at a doctored tree."""
    if pkg_root is None:
        pkg_root = Path(__file__).resolve().parents[1]
    if repo_root is None:
        repo_root = pkg_root.parent
    if registry is None:
        from ringpop_tpu_torch.ops import toolkit

        registry = toolkit.TWIN_REGISTRY
    ops_root, csrc = pkg_root / "ops", pkg_root / "csrc"

    findings: List[Finding] = []
    trees: Dict[str, ast.AST] = {}
    launchers: Dict[str, tuple] = {}
    for path in sorted(ops_root.glob("*.py")):
        if path.name == "__init__.py":
            continue
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError as e:
            findings.append(_finding(
                "unregistered-kernel", str(path), "unparseable ops module: %s" % e,
                e.lineno or 0))
            continue
        trees[path.stem] = tree
        lines = launch_lines(tree)
        if lines:
            launchers[path.stem] = (path, lines)

    def rel(p: Path) -> str:
        try:
            return p.resolve().relative_to(repo_root.resolve()).as_posix()
        except ValueError:
            return p.as_posix()

    sources = {rel(p): p for p in kernel_sources(csrc)} if csrc.is_dir() else {}
    registered_sources = {row.source for row in registry}
    for src in sorted(set(sources) - registered_sources):
        findings.append(_finding(
            "unregistered-kernel", src,
            "%s is a kernel source no toolkit.TWIN_REGISTRY row names: register "
            "its wrapper, plain version and gate tests" % src))

    registered_modules = {row.module for row in registry}
    for mod, (path, lines) in sorted(launchers.items()):
        if mod not in registered_modules:
            findings.append(_finding(
                "unregistered-kernel", rel(path),
                "ops/%s.py launches a kernel (library().call) but has no "
                "toolkit.TWIN_REGISTRY row" % mod, lines[0]))

    for row in registry:
        where = "<registry:%s>" % row.module
        if row.source not in sources:
            findings.append(_finding(
                "stale-registry-row", where,
                "TWIN_REGISTRY row %s.%s names source %s, which is not a kernel "
                "source of the tree" % (row.module, row.kernel_entry, row.source)))
        if row.module not in trees:
            findings.append(_finding(
                "stale-registry-row", where,
                "TWIN_REGISTRY names ops module %r, which does not exist" % row.module))
            continue
        if row.module not in launchers:
            findings.append(_finding(
                "stale-registry-row", where,
                "TWIN_REGISTRY row %s.%s is registered but ops/%s.py holds no "
                "library().call launch site: drop the row"
                % (row.module, row.kernel_entry, row.module)))
        defs = _toplevel_defs(trees[row.module])
        if row.kernel_entry not in defs:
            findings.append(_finding(
                "missing-kernel-entry", where,
                "registered kernel entry %s.%s does not exist" % (row.module, row.kernel_entry)))
        if row.plain_entry not in defs:
            findings.append(_finding(
                "missing-twin-entry", where,
                "registered plain version %s.%s does not exist" % (row.module, row.plain_entry)))
        for test in dict.fromkeys((row.gate_test, row.batch_gate_test)):
            test_path = repo_root / test
            if not test_path.is_file():
                findings.append(_finding(
                    "missing-gate-test", test,
                    "gate test %s for %s.%s does not exist" % (test, row.module, row.kernel_entry)))
            elif row.kernel_entry not in test_path.read_text():
                findings.append(_finding(
                    "missing-gate-test", test,
                    "gate test %s never names kernel entry %r: a rename orphaned "
                    "the gate" % (test, row.kernel_entry)))
    return findings
