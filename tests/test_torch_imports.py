"""The port stands alone: nothing in ringpop_tpu_torch/ or chip_smoke.py
imports JAX or the JAX package (only the tests import both)."""

from __future__ import annotations

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "ringpop_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "ringpop_tpu"


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = ["%d: %s" % (ln, mod) for ln, mod in _imports(path) if _forbidden(mod)]
    assert not bad, "%s imports %s" % (os.path.relpath(path, ROOT), bad)


def test_scanner_catches_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom ringpop_tpu.ops import toolkit\nimport ringpop_tpu_torch\n"
    tree = ast.parse(src)
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert [m for m in mods if _forbidden(m)] == ["jax.numpy", "ringpop_tpu.ops"]


def test_the_analysis_package_is_scanned():
    # the static analysis (ringpop_tpu_torch/analysis/) stands alone too
    rels = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("__main__", "astlint", "dataflow", "findings", "graph_audit",
                 "kernel_coverage", "noninterference", "prongs"):
        assert os.path.join("ringpop_tpu_torch", "analysis", name + ".py") in rels
