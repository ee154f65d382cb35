"""Scenario-fuzzer operator CLI over the port's ``fuzz/``: sweep seed
ranges, shrink failures, replay fixtures, crash-and-recover.  The
counterpart of the JAX package's ``scripts/fuzz_sweep.py``, with the same
subcommands, arguments, per-seed lines and exit codes, plus ``--device``.

Examples::

    # 512 full-engine storms, n=8, default loss menu
    python -m ringpop_tpu_torch.tools.fuzz_sweep sweep --engine full --seeds 0:512

    # shrink one failing seed to a minimal schedule and save the fixture
    python -m ringpop_tpu_torch.tools.fuzz_sweep shrink --engine full --seed 45 \\
        --out runs_torch/my_bug.json

    # replay committed fixtures on the port's engines
    python -m ringpop_tpu_torch.tools.fuzz_sweep replay tests/fuzz/fixtures/*.json

    # crash-and-recover gate: the final state after a resume must equal the
    # uninterrupted run's, bit for bit
    python -m ringpop_tpu_torch.tools.fuzz_sweep crash --driver routed --n 64 --seeds 0:16

A sweep exits nonzero when any scenario violates an invariant, printing
per-seed violation names: feed the failing seed to ``shrink``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List, Optional

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.fuzz import crash
from ringpop_tpu_torch.fuzz import executor as fex
from ringpop_tpu_torch.fuzz import invariants as inv
from ringpop_tpu_torch.fuzz import scenarios as sc
from ringpop_tpu_torch.fuzz import shrinker
from ringpop_tpu_torch.tools import RUNS_DIR


def _seed_range(spec: str) -> List[int]:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return list(range(int(lo), int(hi)))
    return [int(s) for s in spec.split(",")]


def _config(args) -> sc.ScenarioConfig:
    return sc.ScenarioConfig(
        engine=args.engine,
        n=args.n,
        ticks=args.ticks,
        loss_levels=tuple(float(x) for x in args.loss.split(",")),
    )


def cmd_sweep(args) -> int:
    cfg = _config(args)
    runs = fex.sweep(_seed_range(args.seeds), cfg, device=args.device)
    n_bad = 0
    for run in runs:
        for b, vs in sorted(inv.check_run(run).items()):
            n_bad += 1
            print("FAIL seed=%d loss=%g invariants=%s"
                  % (run.seeds[b], run.params.packet_loss, ",".join(inv.violation_names(vs))))
            for v in vs[: args.verbose_violations]:
                print("  %s: %s" % (v.invariant, v.message))
    total = sum(len(r.seeds) for r in runs)
    print("%d/%d scenarios clean (%s engine, n=%d, T=%d, %d loss buckets)"
          % (total - n_bad, total, cfg.engine, cfg.n, cfg.ticks, len(runs)))
    return 1 if n_bad else 0


def cmd_shrink(args) -> int:
    cfg = _config(args)
    ex = fex.executor_for(cfg, packet_loss=sc.packet_loss_of(args.seed, cfg),
                          device=args.device)
    res = shrinker.shrink_seed(ex, args.seed)
    print("seed %d -> %d fault cells (%d evaluations): %s"
          % (args.seed, len(res.faults), res.evaluations, res.invariant_names))
    for f in res.faults:
        print("  %s t=%d node=%d value=%d" % f)
    if args.out:
        shrinker.save_fixture(res, args.out, note=args.note)
        print("fixture written: %s" % args.out)
    return 0


def cmd_replay(args) -> int:
    bad = 0
    for path in args.fixtures:
        doc = shrinker.load_fixture(path)
        vs = shrinker.replay_fixture(doc, device=args.device)
        if vs:
            bad += 1
            print("FAIL %s: %s" % (path, sorted({v.invariant for v in vs})))
            for v in vs[:4]:
                print("  %s: %s" % (v.invariant, v.message))
        else:
            print("ok   %s (guards: %s)" % (path, ",".join(doc["invariants"])))
    return 1 if bad else 0


def cmd_crash(args) -> int:
    cfg = sc.ScenarioConfig(n=args.n, ticks=args.ticks)
    if args.workdir:
        workdir = args.workdir
    else:
        RUNS_DIR.mkdir(parents=True, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="crash-", dir=RUNS_DIR)
    reports = crash.sweep_crash(_seed_range(args.seeds), workdir, driver=args.driver,
                                config=cfg, every=args.every, keep=args.keep,
                                shards=args.shards, device=args.device)
    n_bad = 0
    for seed, rep in sorted(reports.items()):
        n_bad += bool(rep.violations)
        print("%s seed=%d kill=%d corrupt=%s resumed=%s skipped=%s"
              % ("ok  " if not rep.violations else "FAIL", seed, rep.kill_tick, rep.corrupt,
                 rep.resumed_tick, ",".join(rep.skipped_errors) or "-"))
        for v in rep.violations[: args.verbose_violations]:
            print("  %s: %s" % (v.invariant, v.message))
    print("%d/%d crash-resume exercises bit-exact (%s driver, n=%d, T=%d, every=%d, shards=%d)"
          % (len(reports) - n_bad, len(reports), args.driver, cfg.n, cfg.ticks, args.every,
             args.shards))
    return 1 if n_bad else 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="fuzz-sweep", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="cuda (the default) or cpu; without a card, cpu must be asked for")

    def common(sp):
        sp.add_argument("--engine", choices=("full", "scalable"), default="full")
        sp.add_argument("--n", type=int, default=None)
        sp.add_argument("--ticks", type=int, default=24)
        sp.add_argument("--loss", default="0.0,0.05,0.2")
        device(sp)

    sp = sub.add_parser("sweep", help="run a seed range, check invariants")
    common(sp)
    sp.add_argument("--seeds", default="0:64", help="lo:hi or comma list")
    sp.add_argument("--verbose-violations", type=int, default=2)
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("shrink", help="minimize one failing seed")
    common(sp)
    sp.add_argument("--seed", type=int, required=True)
    sp.add_argument("--out", default=None, help="fixture JSON path")
    sp.add_argument("--note", default="", help="fixture provenance note")
    sp.set_defaults(fn=cmd_shrink)

    sp = sub.add_parser("replay", help="replay committed fixtures")
    sp.add_argument("fixtures", nargs="+")
    device(sp)
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("crash", help="crash-and-recover gate (resume-bitwise invariant)")
    sp.add_argument("--driver", choices=("full", "scalable", "routed"), default="scalable")
    sp.add_argument("--n", type=int, default=64)
    sp.add_argument("--ticks", type=int, default=12)
    sp.add_argument("--seeds", default="0:8", help="lo:hi or comma list")
    sp.add_argument("--every", type=int, default=3, help="checkpoint cadence")
    sp.add_argument("--keep", type=int, default=3, help="keep-last-K rotation")
    sp.add_argument("--shards", type=int, default=1)
    sp.add_argument("--workdir", default=None,
                    help="checkpoint family root (default: a new folder under runs_torch/)")
    sp.add_argument("--verbose-violations", type=int, default=2)
    device(sp)
    sp.set_defaults(fn=cmd_crash)

    args = p.parse_args(argv)
    resolve_device(args.device)  # before any file is made
    if getattr(args, "n", None) is None and hasattr(args, "engine"):
        args.n = 8 if args.engine == "full" else 32
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
