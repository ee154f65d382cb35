#!/usr/bin/env python3
"""Runs of one or more cells in a row, one process each, with their spread.

    python3 portbench/series.py --out DIR --seconds 20 \\
        --run <cell>:<seed>[:trace][:control][:fault=<name>] [--run ...]

Each run is ``python3 portbench/run.py`` in its own process, one after
another (one process on the card at a time).  Every run's result line
goes to ``DIR/runs.jsonl`` with the cell, seed, flags, exit code, wall
and the end of its standard error; the summary printed last gives, per
cell and metric, the median and the spread (first to third quartile as a
share of the median, ``statistics.quantiles(values, n=4)``), and the
card's name and power limit.  ``fault=<name>`` plants one of the faults
of ``tests/test_faults.py`` under the run (the check of ``correct`` at the
cell's own size): its result must say ``"correct": false``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path[0] = ROOT


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def _planted(name: str, argv: list) -> str:
    """A program that plants fault ``name`` and then makes one run."""
    from portbench.tests.test_faults import ENSEMBLE_FAULTS, STORM_FAULTS

    code = dict(STORM_FAULTS, **{"ensemble." + k: v for k, v in ENSEMBLE_FAULTS.items()})[name]
    return "\n".join([
        "import sys, textwrap",
        "sys.path[0] = %r" % ROOT,
        "from portbench import run as R",
        "exec(textwrap.dedent(%r))" % code,
        "sys.exit(R.main(%r))" % argv,
    ])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/series.py")
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--run", action="append", required=True,
                   help="cell:seed[:trace][:control]")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    log = os.path.join(args.out, "runs.jsonl")
    rows = []
    for spec in args.run:
        parts = spec.split(":")
        cell, seed, flags = parts[0], int(parts[1]), set(parts[2:])
        argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(args.seconds),
                "--trace", "1" if "trace" in flags else "0"]
        if "control" in flags:
            argv.append("--control")
        cmd = [sys.executable, os.path.join(HERE, "run.py")] + argv
        faults = [f.split("=", 1)[1] for f in flags if f.startswith("fault=")]
        if faults:
            cmd = [sys.executable, "-c", _planted(faults[0], argv)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = dict(cell=cell, seed=seed, flags=sorted(flags), rc=proc.returncode, wall_s=wall,
                   result=result, stderr=proc.stderr[-3000:])
        rows.append(row)
        with open(log, "a") as f:
            f.write(json.dumps(row) + "\n")
        brief = {k: round(v["value"], 4) for k, v in (result or {}).get("metrics", {}).items()}
        print("%s seed=%d %s rc=%d wall=%.1f correct=%s %s" % (
            cell, seed, ",".join(sorted(flags)), proc.returncode, wall,
            None if result is None else result["correct"], json.dumps(brief)), flush=True)
        if result is None:
            print(proc.stderr[-2000:], flush=True)
    summary = {"card": card()}
    for cell in sorted({r["cell"] for r in rows}):
        for trace in (False, True):
            done = [r["result"] for r in rows if r["cell"] == cell and r["result"]
                    and ("trace" in r["flags"]) == trace
                    and not any(f == "control" or f.startswith("fault=") for f in r["flags"])]
            names = sorted({k for d in done for k in d["metrics"]})
            for name in names:
                vals = [d["metrics"][name]["value"] for d in done if name in d["metrics"]]
                summary["%s%s %s" % (cell, " trace" if trace else "", name)] = dict(
                    n=len(vals), median=statistics.median(vals), spread=spread(vals),
                    values=vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
