"""The prong registry — the one place a prong of the port's analysis is
declared.

Counterpart of ``ringpop_tpu/analysis/prongs.py``.  CLI help, ``--prong
all``, the default prong set, ``--list-rules`` and the README's port prong
table all derive from :data:`PRONGS` (tests/test_torch_analysis_cli.py
pins the table and the CLI's dispatch against it).  Adding a prong means
a :class:`ProngSpec` here plus its runner arm in ``__main__``.

Ten prongs, the JAX package's set: ``overflow`` stands for JAX's
``ranges`` interpreter and its consumer, ``graph`` for ``jaxpr``, and
``traffic`` for ``scripts/check_traffic_model.py``.  A prong
whose full run alone on the tree takes under ~10 s on one core is in the
default set (the wall of each, measured on an 8-core CPU sandbox, is
beside its spec); the others are opt-in (``--prong all``
runs every prong, and ``chip_smoke.py`` runs all ten).  ``traffic`` is
opt-in because it runs the shard mesh on a device (``--device``, the card
unless ``cpu``), so the default set stays a CPU analysis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ProngSpec", "PRONGS", "DEFAULT_PRONGS", "ALL_PRONGS", "BUDGET_PRONGS"]


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
        ProngSpec(
            name="overflow",
            summary=(
                "interval ranges over every entry's recorded ops: dtype escapes, "
                "unbounded state carries and int32 index lanes at the declared N"
            ),
            rules=("dtype-overflow", "unbounded-carry", "index-overflow", "stale-allowlist",
                   "trace-failure"),
            default=False,  # ~22 s alone (every entry recorded with detail)
            ci="tests/test_torch_analysis_ranges.py + tests/test_torch_analysis_overflow.py",
        ),
        ProngSpec(
            name="scale",
            summary=(
                "each entry's footprint polynomial in N and its feasible N* under the "
                "H100's memory, against budgets/SCALE_BUDGET.json"
            ),
            rules=("scale-budget", "scale-failure"),
            default=False,  # ~17 s alone (the recordings)
            ci="tests/test_torch_analysis_scale.py",
        ),
        ProngSpec(
            name="cost",
            summary=(
                "each entry's recorded ops, bytes accessed and peak bytes at toy size, "
                "against budgets/COST_BUDGET.json"
            ),
            rules=("cost-budget", "cost-failure"),
            default=False,  # ~16 s alone (the recordings)
            ci="tests/test_torch_analysis_cost.py",
        ),
        ProngSpec(
            name="donation",
            summary=(
                "the drivers' aliasing surface: inputs written in place and outputs "
                "sharing an input's storage, against budgets/DONATION_BUDGET.json"
            ),
            rules=("donation-budget", "donation-failure", "inplace-input-write"),
            default=True,  # ~7 s
            ci="tests/test_torch_analysis_donation.py",
        ),
        ProngSpec(
            name="retrace",
            summary=(
                "probes of host-table uploads, per-device tables, kernel-library builds "
                "and custom ops, against budgets/RETRACE_BUDGET.json"
            ),
            rules=("retrace-budget", "probe-failure"),
            default=True,  # ~6 s
            ci="tests/test_torch_analysis_retrace.py",
        ),
        ProngSpec(
            name="traffic",
            summary=(
                "the shard mesh's measured exchange bytes against the traffic model "
                "and budgets/TRAFFIC_BUDGET.json"
            ),
            rules=("traffic-budget", "traffic-failure"),
            default=False,  # ~2 s, but on --device (the card unless cpu)
            ci="tests/test_torch_tools.py",
        ),
    )
}

# the prongs with a committed manifest (``--write``, ``--budget``)
BUDGET_PRONGS = ("scale", "cost", "donation", "retrace", "traffic")

DEFAULT_PRONGS = tuple(s.name for s in PRONGS.values() if s.default)
ALL_PRONGS = tuple(PRONGS)
