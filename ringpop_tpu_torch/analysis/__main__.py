"""torchgate CLI: ``python -m ringpop_tpu_torch.analysis``.

Runs the registered prongs (:mod:`ringpop_tpu_torch.analysis.prongs`)
over ``ringpop_tpu_torch/`` on the CPU and exits non-zero on any
unsuppressed finding.  The opt-in ``traffic`` prong runs the shard mesh
on ``--device``: the card unless ``--device cpu``.

Examples::

    python -m ringpop_tpu_torch.analysis                       # every prong
    python -m ringpop_tpu_torch.analysis --format json         # + per-prong wall time
    python -m ringpop_tpu_torch.analysis --prong ast ringpop_tpu_torch/ops/u32.py
    python -m ringpop_tpu_torch.analysis --prong graph,noninterference
    python -m ringpop_tpu_torch.analysis --changed-only        # files git sees changed
    python -m ringpop_tpu_torch.analysis --list-rules
    python -m ringpop_tpu_torch.analysis --prong all           # the opt-in prongs too
    python -m ringpop_tpu_torch.analysis --prong traffic --device cpu
    python -m ringpop_tpu_torch.analysis --prong scale --write # regenerate a manifest
    python -m ringpop_tpu_torch.analysis --prong cost --budget /tmp/COST.json

The budget prongs (``scale``, ``cost``, ``donation``, ``retrace``,
``traffic``) diff the
manifests in ``analysis/budgets/``; ``--write`` regenerates the selected
ones instead (and refuses an entry that failed), ``--budget`` names another
manifest file for a single budget prong.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.analysis import astlint, findings as fmod
from ringpop_tpu_torch.analysis.prongs import ALL_PRONGS, BUDGET_PRONGS, DEFAULT_PRONGS, PRONGS

PKG_ROOT = Path(__file__).resolve().parents[1]  # .../ringpop_tpu_torch
REPO_ROOT = PKG_ROOT.parent

# package paths the graph prong records through: a scoped run records only
# when one of them is in scope
_GRAPH_SOURCES = ("ops/", "models/", "parallel/", "fuzz/", "analysis/")
# ... and the kernels prong's inputs
_KERNEL_SOURCES = ("ops/", "csrc/", "analysis/")


def _changed_files() -> List[Path]:
    out: set = set()
    for cmd in (
        ["git", "diff", "--name-only"],
        ["git", "diff", "--name-only", "--cached"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True,
                                  check=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
        out.update(line.strip() for line in proc.stdout.splitlines())
    return [
        REPO_ROOT / f
        for f in sorted(out)
        if f.startswith("ringpop_tpu_torch/")
        and f.endswith((".py", ".cu", ".cuh"))
        and (REPO_ROOT / f).exists()
    ]


def _pkg_rel(files: List[Path]) -> List[str]:
    """Package-relative posix paths ('models/sim/engine.py')."""
    out = []
    for f in files:
        r = f.resolve()
        if r.is_relative_to(PKG_ROOT):
            out.append(r.relative_to(PKG_ROOT).as_posix())
    return out


class _Stopwatch:
    """Adds the wall seconds of its block to ``seconds[name]``."""

    def __init__(self, seconds: dict, name: str):
        self.seconds, self.name = seconds, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.seconds[self.name] = self.seconds.get(self.name, 0.0) + time.perf_counter() - self.t0


def _write(names: List[str], path: Optional[Path], device: Optional[str]) -> int:
    """``--write``: measure and commit each named budget prong's manifest."""
    from ringpop_tpu_torch.analysis import cost, donation, retrace, scale_budget, traffic

    if "traffic" in names:  # the card is asked for before any prong runs
        device = resolve_device(device)
    prongs = {"scale": (scale_budget.collect_budgets, scale_budget.write_manifest),
              "cost": (cost.collect_costs, cost.write_manifest),
              "donation": (donation.collect, donation.write_manifest),
              "retrace": (retrace.run_probes, retrace.write_manifest),
              "traffic": (lambda: traffic.collect_measurements(device=device),
                          traffic.write_manifest)}
    for name in names:
        collect, write = prongs[name]
        try:
            print("wrote %s" % write(collect(), path))
        except ValueError as e:
            print("%s: %s" % (name, e), file=sys.stderr)
            return 2
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ringpop_tpu_torch.analysis",
        description="torchgate: machine-checked static analysis of the PyTorch port",
    )
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: the ringpop_tpu_torch package)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument(
        "--prong",
        default=",".join(DEFAULT_PRONGS),
        help="comma list of prongs to run: %s (or 'all'; default %s)"
        % (", ".join(ALL_PRONGS), ",".join(DEFAULT_PRONGS)),
    )
    parser.add_argument("--changed-only", action="store_true",
                        help="scope to files git sees changed (diff, cached, untracked)")
    parser.add_argument("--list-rules", action="store_true", help="print the rule table")
    parser.add_argument("--write", action="store_true",
                        help="regenerate the selected budget prongs' manifests (%s)"
                        % ", ".join(BUDGET_PRONGS))
    parser.add_argument("--budget", type=Path, default=None,
                        help="manifest file for a single budget prong (default: analysis/budgets/)")
    parser.add_argument("--device", default=None,
                        help="where the traffic prong runs the mesh: cuda (the default) or cpu; "
                        "without a card, cpu must be asked for")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in astlint.ALL_RULES:
            print(f"{rule.name:26s} [{rule.scope}]")
            print(f"    {rule.summary}")
        print()
        for spec in PRONGS.values():
            default = "default" if spec.default else "opt-in"
            print(f"{spec.name} prong ({default}): {', '.join(spec.rules)}")
            print(f"    {spec.summary}")
            print(f"    tests: {spec.ci}")
        print(
            "\nsuppress per line with  # torchgate: ignore[rule-a,rule-b]  "
            "(bare 'ignore' silences all);\nmark a host helper with  "
            "# torchgate: host  on its def line"
        )
        return 0

    prongs = (
        set(ALL_PRONGS)
        if args.prong.strip() == "all"
        else {p.strip() for p in args.prong.split(",") if p.strip()}
    )
    unknown = prongs - set(ALL_PRONGS)
    if unknown:
        parser.error(f"unknown prong(s): {sorted(unknown)}")
    budgets = [p for p in BUDGET_PRONGS if p in prongs]
    if (args.write or args.budget) and not budgets:
        parser.error("--write and --budget need a budget prong: %s" % ", ".join(BUDGET_PRONGS))
    if args.budget and len(budgets) != 1:
        parser.error("--budget names the manifest of one budget prong")
    if args.write:
        return _write(budgets, args.budget, args.device)

    all_findings: List[fmod.Finding] = []
    prong_seconds: dict = {}

    files: Optional[List[Path]] = None
    if args.changed_only:
        files = _changed_files()
    if args.paths:
        explicit: List[Path] = []
        for p in args.paths:
            path = Path(p)
            if not path.exists() and not path.is_absolute():
                anchored = REPO_ROOT / p
                if anchored.exists():
                    path = anchored
            if path.is_dir():
                explicit.extend(sorted(f for f in path.rglob("*.py")
                                       if "__pycache__" not in f.parts))
            else:
                explicit.append(path)
        if files is None:
            files = explicit
        else:
            explicit_set = {e.resolve() for e in explicit}
            files = [f for f in files if f.resolve() in explicit_set]

    scoped_rel = _pkg_rel(files) if files is not None else None

    def in_scope(sources) -> bool:
        return scoped_rel is None or any(r.startswith(sources) for r in scoped_rel)

    # the traffic prong's device, asked for before any prong runs
    run_traffic = "traffic" in prongs and in_scope(_GRAPH_SOURCES + ("obs/",))
    traffic_device = resolve_device(args.device) if run_traffic else None

    if "ast" in prongs:
        with _Stopwatch(prong_seconds, "ast"):
            lint_files = None if files is None else [f for f in files if f.suffix == ".py"]
            all_findings.extend(astlint.lint_paths(PKG_ROOT, files=lint_files))

    # the detail prongs first: their recordings (a superset) serve graph and
    # noninterference from the shared cache
    if "overflow" in prongs:
        from ringpop_tpu_torch.analysis import overflow

        entry_names = None if scoped_rel is None else overflow.entries_for_changed(scoped_rel)
        if entry_names is None or entry_names:
            with _Stopwatch(prong_seconds, "overflow"):
                all_findings.extend(overflow.check_overflow(entry_names))

    if "scale" in prongs and in_scope(_GRAPH_SOURCES):
        from ringpop_tpu_torch.analysis import scale_budget

        with _Stopwatch(prong_seconds, "scale"):
            all_findings.extend(scale_budget.check_against_manifest(path=args.budget))

    if "cost" in prongs and in_scope(_GRAPH_SOURCES):
        from ringpop_tpu_torch.analysis import cost

        with _Stopwatch(prong_seconds, "cost"):
            all_findings.extend(cost.check_against_manifest(path=args.budget))

    if "donation" in prongs:
        from ringpop_tpu_torch.analysis import donation

        if in_scope(donation.SOURCES):
            with _Stopwatch(prong_seconds, "donation"):
                all_findings.extend(donation.check_against_manifest(path=args.budget))

    if "retrace" in prongs and in_scope(_GRAPH_SOURCES):
        from ringpop_tpu_torch.analysis import retrace

        with _Stopwatch(prong_seconds, "retrace"):
            all_findings.extend(retrace.check_against_manifest(path=args.budget))

    if run_traffic:
        from ringpop_tpu_torch.analysis import traffic

        with _Stopwatch(prong_seconds, "traffic"):
            all_findings.extend(traffic.check_against_manifest(path=args.budget,
                                                               device=traffic_device))

    if "graph" in prongs and in_scope(_GRAPH_SOURCES):
        from ringpop_tpu_torch.analysis import graph_audit

        with _Stopwatch(prong_seconds, "graph"):
            all_findings.extend(graph_audit.audit_entries())

    if "kernels" in prongs and in_scope(_KERNEL_SOURCES):
        from ringpop_tpu_torch.analysis import kernel_coverage

        with _Stopwatch(prong_seconds, "kernels"):
            all_findings.extend(kernel_coverage.check_kernel_coverage())

    if "noninterference" in prongs:
        from ringpop_tpu_torch.analysis import noninterference

        entry_names = None
        if scoped_rel is not None:
            # a scoped run re-checks only the entries a changed module feeds
            entry_names = noninterference.entries_for_changed(scoped_rel)
        if entry_names is None or entry_names:
            with _Stopwatch(prong_seconds, "noninterference"):
                all_findings.extend(noninterference.check_noninterference(entry_names))

    if args.format == "json":
        print(fmod.render_json(
            all_findings,
            meta={"prong_seconds": {k: round(v, 3) for k, v in prong_seconds.items()}},
        ))
    else:
        print(fmod.render_text(all_findings))
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main())
