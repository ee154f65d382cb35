"""Nothing the benchmark loads is JAX or the JAX package; the reference
loads nothing of the program.  Top-level names are compared whole: the
port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from portbench.lib.guard import FORBIDDEN, forbidden_modules
from portbench.tests.conftest import REPO

PKG = os.path.join(REPO, "portbench")


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["ringpop_tpu_torch.ops", "portbench.run", "jaxtyping"]) == []
    assert forbidden_modules(["ringpop_tpu.ops.farmhash32"]) == ["ringpop_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _py_files(PKG):
        bad = set(_imported_tops(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_names_nothing_of_the_program():
    for path in _py_files(os.path.join(PKG, "reference")):
        text = open(path).read()
        assert "ringpop_tpu_torch" not in text, path
        assert not set(_imported_tops(path)) & (FORBIDDEN | {"ringpop_tpu_torch"}), path


def test_what_a_run_loads(tiny_checkout):
    """Every module a run's process holds, after a whole run of each
    driver: no JAX, no JAX package; the reference's modules alone hold no
    module of the program."""
    script = """
import sys
sys.path.insert(0, %r)
from portbench.reference import ensemble, storm, checksum, farmhash, mix
ref_only = sorted({m.split('.')[0] for m in sys.modules})
from portbench import run as R
for cell in ("tiny-sim.pulse", "tiny-storm.cycle"):
    code, result = R.run(["--workload", cell, "--seed", "3", "--seconds", "0.5",
                          "--trace", "0", "--device", "cpu"])
    assert code == 0 and result["correct"], (cell, code, result)
print(" ".join(ref_only))
print(" ".join(sorted({m.split('.')[0] for m in sys.modules})))
""" % tiny_checkout
    proc = subprocess.run([sys.executable, "-c", script], cwd=tiny_checkout,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_only, after = (set(line.split()) for line in proc.stdout.strip().splitlines()[-2:])
    assert "ringpop_tpu_torch" not in ref_only
    assert not ref_only & FORBIDDEN and not after & FORBIDDEN
    assert "ringpop_tpu_torch" in after
