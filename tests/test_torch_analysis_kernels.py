"""The ``kernels`` prong of the port's analysis: the tree is clean, and —
mutation-proven in doctored trees — each rule fires: an unregistered
``.cu``, an unregistered launch site, a missing entry, twin or gate test,
a gate test that never names its entry, and a stale row; the JAX prong's
own mutations give the same rule ids."""

from __future__ import annotations

import tempfile
from pathlib import Path

import pytest

from ringpop_tpu.analysis import kernel_coverage as jkc
from ringpop_tpu.ops import toolkit as jtk
from ringpop_tpu_torch.analysis import kernel_coverage as kc
from ringpop_tpu_torch.analysis.findings import render_text
from ringpop_tpu_torch.ops import toolkit
from tests._xla_mappings import bounded_mappings  # noqa: F401  (an autouse fixture)


def _rules(findings):
    return {f.rule for f in findings}


def test_tree_is_clean():
    findings = kc.check_kernel_coverage()
    assert findings == [], "\n" + render_text(findings)


def test_every_kernel_source_is_registered():
    rows = {t.source for t in toolkit.TWIN_REGISTRY}
    got = {p.name for p in kc.kernel_sources(Path(kc.__file__).resolve().parents[1] / "csrc")}
    assert {Path(s).name for s in rows} == got == {
        "apply_updates.cu", "pb_budget.cu", "fused_stream.cu", "exchange.cu", "block_loop.cu",
        "member_records.cu", "prp_walk.cu", "ping_req_select.cu", "ping_req_combine.cu",
        "ping_req_hits.cu", "ping_req_respond.cu"}


LAUNCHER = """
from ringpop_tpu_torch.ops import _build

def my_entry(x):
    _build.library().call("ringpop_my", x.device, [x.data_ptr()], 1)
    return x

def my_plain(x):
    return x
"""


def _tree(td: Path, launcher: str = LAUNCHER, cu: bool = True) -> Path:
    pkg = td / "ringpop_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "csrc" / "probe").mkdir(parents=True)
    (pkg / "ops" / "__init__.py").write_text("")
    (pkg / "ops" / "mykernel.py").write_text(launcher)
    (pkg / "csrc" / "common.cuh").write_text("// shared helpers\n")
    (pkg / "csrc" / "probe" / "timing.cu").write_text("// a probe\n")
    if cu:
        (pkg / "csrc" / "my.cu").write_text('extern "C" int ringpop_my() { return 0; }\n')
    (td / "tests").mkdir()
    (td / "tests" / "test_my.py").write_text("def test_gate():\n    assert 'my_entry'\n")
    return pkg


def _row(**kw):
    fields = dict(module="mykernel", kernel_entry="my_entry", plain_entry="my_plain",
                  source="ringpop_tpu_torch/csrc/my.cu", jax_entry="x:y",
                  gate_test="tests/test_my.py", replaces="x.py:1",
                  batch_gate_test="tests/test_my.py")
    fields.update(kw)
    return toolkit.KernelTwin(**fields)


def _check(td: Path, rows, **tree_kw):
    pkg = _tree(td, **tree_kw)
    return kc.check_kernel_coverage(pkg_root=pkg, registry=tuple(rows), repo_root=td)


def test_doctored_tree_with_its_row_is_clean(tmp_path):
    assert _check(tmp_path, [_row()]) == []


def test_unregistered_kernel_fires(tmp_path):
    findings = _check(tmp_path, [])
    assert _rules(findings) == {"unregistered-kernel"}
    # the .cu and the launch site, each once; the header and probe exempt
    assert sorted(f.path for f in findings) == [
        "ringpop_tpu_torch/csrc/my.cu", "ringpop_tpu_torch/ops/mykernel.py"]


def test_missing_entries_and_tests_fire(tmp_path):
    row = _row(kernel_entry="no_such_entry", plain_entry="no_such_plain",
               gate_test="tests/no_such_test.py", batch_gate_test="tests/no_such_batch.py")
    findings = _check(tmp_path, [row])
    assert _rules(findings) == {"missing-kernel-entry", "missing-twin-entry",
                                "missing-gate-test"}
    assert len([f for f in findings if f.rule == "missing-gate-test"]) == 2


def test_gate_test_must_name_the_entry(tmp_path):
    pkg = _tree(tmp_path)
    (tmp_path / "tests" / "test_batch.py").write_text("def test_other(): pass\n")
    row = _row(batch_gate_test="tests/test_batch.py")
    findings = kc.check_kernel_coverage(pkg_root=pkg, registry=(row,), repo_root=tmp_path)
    assert _rules(findings) == {"missing-gate-test"}
    (tmp_path / "tests" / "test_batch.py").write_text("def test_rule():\n    'my_entry'\n")
    assert kc.check_kernel_coverage(pkg_root=pkg, registry=(row,), repo_root=tmp_path) == []


def test_stale_row_fires(tmp_path):
    # the source is gone and the module launches nothing
    findings = _check(tmp_path, [_row()], launcher="def my_entry(x):\n    return x\n"
                      "def my_plain(x):\n    return x\n", cu=False)
    assert _rules(findings) == {"stale-registry-row"}
    assert len(findings) == 2


def test_launch_site_detection():
    import ast

    src = "def f(x):\n    _build.library().call('a', d, p)\n    lib.call('b')\n    library().call()\n"
    assert kc.launch_lines(ast.parse(src)) == [2, 4]


# -- against the JAX prong's mutations --------------------------------------

JAX_KERNEL = """
from jax.experimental import pallas as pl

def my_entry(x):
    return pl.pallas_call(lambda i, o: None, out_shape=x)(x)

def my_twin(x):
    return x
"""


def _jax_check(body: str, rows, test_body: str = "def test_gate():\n    assert 'my_entry'\n"):
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        ops = td / "ops"
        ops.mkdir()
        (ops / "__init__.py").write_text("")
        (ops / "mykernel.py").write_text(body)
        (td / "tests").mkdir()
        (td / "tests" / "test_my.py").write_text(test_body)
        return _rules(jkc.check_kernel_coverage(ops_root=ops, registry=tuple(rows),
                                                repo_root=td))


def _jax_row(**kw):
    fields = dict(module="mykernel", kernel_entry="my_entry", twin_entry="my_twin",
                  gate_test="tests/test_my.py")
    fields.update(kw)
    return jtk.KernelTwin(**fields)


@pytest.mark.parametrize("case", ["unregistered", "missing", "unnamed", "stale", "clean"])
def test_same_rule_ids_as_the_jax_prong(case, tmp_path):
    if case == "unregistered":
        want = _jax_check(JAX_KERNEL, [])
        got = _rules(_check(tmp_path, []))
    elif case == "missing":
        want = _jax_check(JAX_KERNEL, [_jax_row(kernel_entry="nope", twin_entry="nope2",
                                                gate_test="tests/none.py")])
        got = _rules(_check(tmp_path, [_row(kernel_entry="nope", plain_entry="nope2",
                                            gate_test="tests/none.py")]))
    elif case == "unnamed":
        want = _jax_check(JAX_KERNEL, [_jax_row()], test_body="def test_other(): pass\n")
        pkg = _tree(tmp_path)
        (tmp_path / "tests" / "test_my.py").write_text("def test_other(): pass\n")
        got = _rules(kc.check_kernel_coverage(pkg_root=pkg, registry=(_row(),),
                                              repo_root=tmp_path))
    elif case == "stale":
        want = _jax_check("def my_entry(x):\n    return x\ndef my_twin(x):\n    return x\n",
                          [_jax_row()])
        got = _rules(_check(tmp_path, [_row()], launcher="def my_entry(x):\n    return x\n"
                            "def my_plain(x):\n    return x\n"))
    else:
        want = _jax_check(JAX_KERNEL, [_jax_row()])
        got = _rules(_check(tmp_path, [_row()]))
    assert got == want
