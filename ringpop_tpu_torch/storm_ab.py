"""Compare the 1M churn storm's single-device path between checkouts on
one card, each run in its own process, in the order given:

    python3 -m ringpop_tpu_torch.storm_ab DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout that holds ``chip_smoke.py``.  Its
``storm_headline`` (a cold and a warm run of the 60-tick storm of
``benchmarks/storm_1m.py`` on ``ScalableCluster``) runs with DIR as the
working directory, so each checkout builds and launches its own kernels.
Give the checkouts in an alternating order (A B B A), so that a drift of
the card or of the host shows as a difference between the two runs of
one checkout.  Each run also times a fixed piece of pure-Python work
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


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def run_one(checkout: str, timeout: float) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=checkout, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError("storm in %s exited %d:\n%s" % (checkout, proc.returncode,
                                                          proc.stderr[-4000:]))
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    by = {r["run"]: r for r in got["runs"]}
    return dict(checkout=checkout, host_ref_ms=got["host_ref_ms"],
                warm_ms_per_tick=by["warm"]["ms_per_tick"],
                cold_ms_per_tick=by["cold"]["ms_per_tick"],
                host_syncs_per_tick=by["warm"]["host_syncs_per_tick"],
                exchange_launches=by["warm"]["exchange_launches"],
                ring_checksum_after=by["warm"]["ring_checksum_after"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run")
    ap.add_argument("--out", help="also write the result here")
    args = ap.parse_args(argv)
    card = _card()
    print("card: %s" % card, flush=True)
    runs = []
    for checkout in args.checkouts:
        r = run_one(os.path.abspath(checkout), args.timeout)
        print(json.dumps(r), flush=True)
        runs.append(r)
    out = dict(card=card, runs=runs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
