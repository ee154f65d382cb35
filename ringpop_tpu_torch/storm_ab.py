"""Compare a single-device path between checkouts on one card, each run
in its own process, in the order given:

    python3 -m ringpop_tpu_torch.storm_ab DIR [DIR ...] [--sim] [--out FILE]

Each DIR is the root of a checkout that holds ``chip_smoke.py``.  By
default its ``storm_headline`` (a cold and a warm run of the 60-tick storm
of ``benchmarks/storm_1m.py`` on ``ScalableCluster``) runs with DIR as the
working directory, so each checkout builds and launches its own kernels.
``--sim`` runs ``SimCluster(n=1024)`` instead, in fast and farmhash modes:
its ``headline`` (bootstrap, converge, a warm and a timed 256-tick
window), then launches and host reads a tick of a profiled 16-tick quiet
window.
Give the checkouts in an alternating order (A B B A), so that a drift of
the card or of the host shows as a difference between the two runs of
one checkout; a checkout named more than once gets the quartiles (25th,
50th, 75th percentile) of each number over its runs in ``summary``.
Each run also times a fixed piece of pure-Python work
(``host_ref_ms``), which tracks how fast the host issues work at that
moment.  Prints one JSON object as its last line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = r"""
import json, sys, time
sys.path.insert(0, ".")
import chip_smoke
from ringpop_tpu_torch.ops import _build

_build.library()
t0 = time.perf_counter()
acc = 0
for i in range(2_000_000):
    acc ^= i * 2654435761 & 0xFFFFFFFF
host_ref_ms = (time.perf_counter() - t0) * 1e3
runs = chip_smoke.storm_headline()
print(json.dumps(dict(host_ref_ms=host_ref_ms, runs=runs)))
"""

_RUN_SIM = r"""
import json, sys, time
sys.path.insert(0, ".")
import chip_smoke
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
from ringpop_tpu_torch.ops import _build

_build.library()
t0 = time.perf_counter()
acc = 0
for i in range(2_000_000):
    acc ^= i * 2654435761 & 0xFFFFFFFF
host_ref_ms = (time.perf_counter() - t0) * 1e3
runs = {}
for mode in ("fast", "farmhash"):
    h = chip_smoke.headline(mode)
    sim = SimCluster(n=1024, params=engine.SimParams(n=1024, checksum_mode=mode), device="cuda")
    sim.bootstrap()
    sim.run_until_converged(max_ticks=96, quiet_after=1)
    quiet = EventSchedule(ticks=16, n=1024)
    prof = chip_smoke._profile_window(lambda: sim.run(quiet), quiet.ticks, "cuda")
    runs[mode] = dict(ms_per_tick=h["window_s"] / h["ticks"] * 1e3,
                      node_ticks_per_s=h["node_ticks_per_s"], converged_in=h["converged_in"],
                      replays=h["replays"], host_reads_per_tick=prof["host_reads_per_tick"],
                      launches_per_tick=prof["launches_per_tick"])
print(json.dumps(dict(host_ref_ms=host_ref_ms, runs=runs)))
"""


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def run_one(checkout: str, timeout: float, sim: bool = False) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN_SIM if sim else _RUN], cwd=checkout,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError("run in %s exited %d:\n%s" % (checkout, proc.returncode,
                                                        proc.stderr[-4000:]))
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if sim:
        return dict(checkout=checkout, host_ref_ms=got["host_ref_ms"], **got["runs"])
    by = {r["run"]: r for r in got["runs"]}
    return dict(checkout=checkout, host_ref_ms=got["host_ref_ms"],
                warm_ms_per_tick=by["warm"]["ms_per_tick"],
                cold_ms_per_tick=by["cold"]["ms_per_tick"],
                host_syncs_per_tick=by["warm"]["host_syncs_per_tick"],
                exchange_launches=by["warm"]["exchange_launches"],
                ring_checksum_after=by["warm"]["ring_checksum_after"])


def _numbers(run: dict, prefix: str = "") -> dict:
    """A run's numbers, nested keys joined with '.'."""
    out = {}
    for k, v in run.items():
        if isinstance(v, dict):
            out.update(_numbers(v, prefix + k + "."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = float(v)
    return out


def summarize(runs) -> dict:
    """Per checkout, each number's quartiles over its runs."""
    import numpy as np

    by = {}
    for r in runs:
        for k, v in _numbers(r).items():
            by.setdefault(r["checkout"], {}).setdefault(k, []).append(v)
    return {c: {k: dict(zip(("q25", "median", "q75"), np.percentile(v, (25, 50, 75)).tolist()),
                        runs=len(v)) for k, v in nums.items()}
            for c, nums in by.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--sim", action="store_true", help="SimCluster n=1024, not the 1M storm")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run")
    ap.add_argument("--out", help="also write the result here")
    args = ap.parse_args(argv)
    card = _card()
    print("card: %s" % card, flush=True)
    runs = []
    for checkout in args.checkouts:
        r = run_one(os.path.abspath(checkout), args.timeout, args.sim)
        print(json.dumps(r), flush=True)
        runs.append(r)
    out = dict(card=card, runs=runs, summary=summarize(runs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
