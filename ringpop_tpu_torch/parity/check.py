"""Engine vs host-oracle checksum parity at scale: the port's counterpart of
the JAX package's ``scripts/parity_check.py``.

Steps the port's :class:`~ringpop_tpu_torch.models.sim.cluster.SimCluster`
(farmhash checksums; on the card unless ``--device cpu``) in lockstep with
the port's :class:`~ringpop_tpu_torch.parity.oracle.OracleCluster` (one host
``Membership`` per node, hashed with the C++ FarmHash) through the same
schedule: join all, a churn pulse every 10 ticks (n//200 kills plus one
revive of an earlier victim), then a quiet tail of max(T//3, 12) ticks.  The
per-node checksums must be bitwise equal after every tick.  Prints one JSON
report with the JAX script's keys (plus the device and the two sides'
walls) and exits 1 on any mismatched tick.

Usage: python -m ringpop_tpu_torch.parity.check [-n 1024] [--ticks 40]
       [--seed 0] [-o PARITY.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim.cluster import SimCluster, default_addresses
from ringpop_tpu_torch.parity.oracle import OracleCluster

EVENT_KEYS = ("kill", "revive", "join", "partition", "leave", "resume")


def schedule(n: int, ticks: int, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """``parity_check.py``'s schedule: tick 0 joins every node; at ticks
    ≡ 5 (mod 10) before the quiet tail, kill n//200 (at least one) random
    nodes and revive the oldest still-dead victims' last batch."""
    rng = np.random.default_rng(seed)
    out: List[Dict[str, np.ndarray]] = [{"join": np.ones(n, bool)}]
    down: list = []
    quiet_tail = max(ticks // 3, 12)
    for t in range(1, ticks):
        ev: Dict[str, np.ndarray] = {}
        if t % 10 == 5 and t < ticks - quiet_tail:
            kill = np.zeros(n, bool)
            victims = rng.choice(n, size=max(1, n // 200), replace=False)
            kill[victims] = True
            ev["kill"] = kill
            if down:
                rv = np.zeros(n, bool)
                rv[down.pop()] = True
                ev["revive"] = rv
            down.append(victims)
        out.append(ev)
    return out


def run_lockstep(
    params: engine.SimParams,
    device,
    events: List[Dict[str, np.ndarray]],
    seed: int = 0,
    mismatch_log=None,
) -> dict:
    """Step ``SimCluster(params, device)`` and ``OracleCluster`` through
    ``events`` and compare the checksums after every tick.  Returns the
    counts and the two sides' walls: ``engine_s`` (the tick and the host
    read of its checksums) and ``oracle_s``.  Each mismatched tick is
    written as a JSON line to ``mismatch_log`` when one is given."""
    n = params.n
    addresses = default_addresses(n)
    sim = SimCluster(addresses=addresses, params=params, seed=seed, device=device)
    oracle = OracleCluster(sim.params, addresses, seed=seed)
    mismatched = 0
    converged = False
    engine_s = oracle_s = 0.0
    for t, ev in enumerate(events):
        inputs = sim.quiet_inputs()._replace(
            **{k: torch.as_tensor(v, device=sim.device) for k, v in ev.items() if k in EVENT_KEYS}
        )
        t0 = time.perf_counter()
        metrics = sim.step(inputs)
        got = sim.checksums()
        t1 = time.perf_counter()
        res = oracle.tick(ev)
        oracle_s += time.perf_counter() - t1
        engine_s += t1 - t0
        converged = bool(metrics.converged)
        bad = np.flatnonzero(got != res.checksums)
        if bad.size or converged != res.converged:
            mismatched += 1
            if mismatch_log is not None:
                print(json.dumps({
                    "tick": t,
                    "mismatched_nodes": bad[:8].tolist(),
                    "engine": [int(x) for x in got[bad[:4]]],
                    "oracle": [int(x) for x in res.checksums[bad[:4]]],
                    "converged": [converged, res.converged],
                }), file=mismatch_log)
    return {
        "n_nodes": n,
        "ticks": len(events),
        "checksum_comparisons": n * len(events),
        "mismatched_ticks": mismatched,
        "converged_at_end": converged,
        "engine_s": engine_s,
        "oracle_s": oracle_s,
        "parity_replays": sim.parity_replays,
        "params": {k: getattr(sim.params, k) for k in
                   ("fused_tick", "fused_checksum", "parity_recompute", "hash_impl")},
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="parity-check")
    p.add_argument("-n", type=int, default=1024)
    p.add_argument("--ticks", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; without a card, cpu must be asked for")
    args = p.parse_args(argv)

    params = engine.SimParams(n=args.n, checksum_mode="farmhash")
    t0 = time.time()
    got = run_lockstep(params, args.device, schedule(args.n, args.ticks, args.seed),
                       seed=args.seed, mismatch_log=sys.stderr)
    report = {
        "metric": "checksum_parity_engine_vs_host_oracle",
        "n_nodes": got["n_nodes"],
        "ticks": got["ticks"],
        "checksum_comparisons": got["checksum_comparisons"],
        "mismatched_ticks": got["mismatched_ticks"],
        "parity": got["mismatched_ticks"] == 0,
        "converged_at_end": got["converged_at_end"],
        "elapsed_s": round(time.time() - t0, 1),
        "checksum_mode": "farmhash (bit-exact reference strings)",
        "device": str(torch.device("cuda" if args.device is None else args.device)),
        "engine_s": round(got["engine_s"], 3),
        "oracle_s": round(got["oracle_s"], 3),
    }
    print(json.dumps(report))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f)
    return 0 if got["mismatched_ticks"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
