"""The prong registry — the one place a prong of the port's analysis is
declared.

Counterpart of ``ringpop_tpu/analysis/prongs.py``.  CLI help, ``--prong
all``, the default prong set, ``--list-rules`` and the README's port prong
table all derive from :data:`PRONGS` (tests/test_torch_analysis_cli.py
pins the table and the CLI's dispatch against it).  Adding a prong means
a :class:`ProngSpec` here plus its runner arm in ``__main__``.

The JAX package's ``overflow``, ``scale``, ``donation``, ``retrace`` and
``cost`` prongs have no port counterpart yet; ROADMAP.md lists them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ProngSpec", "PRONGS", "DEFAULT_PRONGS", "ALL_PRONGS"]


@dataclasses.dataclass(frozen=True)
class ProngSpec:
    name: str
    summary: str  # one line, shown by --list-rules and pinned in README
    rules: Tuple[str, ...]  # finding rule ids this prong can emit
    default: bool  # in the default CLI set
    ci: str  # the tests that exercise it


PRONGS: Dict[str, ProngSpec] = {
    spec.name: spec
    for spec in (
        ProngSpec(
            name="ast",
            summary=(
                "AST lint over ringpop_tpu_torch/: host reads in tick "
                "contexts, dtype pinning, in-place writes to tick inputs"
            ),
            # the rule list lives in astlint.ALL_RULES (with per-rule scope
            # and summary); these are what the lint itself emits
            rules=("syntax-error", "unreadable-file"),
            default=True,
            ci="tests/test_torch_analysis_ast.py",
        ),
        ProngSpec(
            name="graph",
            summary=(
                "recorded-op audit of every registered entry point: host "
                "reads against each entry's declared count, int32 hash-path "
                "dtypes"
            ),
            rules=("host-sync", "wide-dtype-on-hash-path", "trace-failure"),
            default=True,
            ci="tests/test_torch_analysis_graph.py",
        ),
        ProngSpec(
            name="kernels",
            summary=(
                "every csrc/*.cu kernel and library().call site has a "
                "TWIN_REGISTRY row, live entries and a gate test"
            ),
            rules=(
                "unregistered-kernel",
                "missing-kernel-entry",
                "missing-twin-entry",
                "missing-gate-test",
                "stale-registry-row",
            ),
            default=True,
            ci="tests/test_torch_analysis_kernels.py",
        ),
        ProngSpec(
            name="noninterference",
            summary=(
                "recorded dataflow slice per obs entry point: no obs-only "
                "input field reaches a trajectory output field"
            ),
            rules=("obs-interference", "unclassified-state-field", "trace-failure"),
            default=True,
            ci="tests/test_torch_analysis_noninterference.py",
        ),
    )
}

DEFAULT_PRONGS = tuple(s.name for s in PRONGS.values() if s.default)
ALL_PRONGS = tuple(PRONGS)
