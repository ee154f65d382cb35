"""Export the offline Node-parity replay artifact from the port's engine:
the counterpart of the JAX package's ``scripts/export_parity_replay.py``.

A churny full-engine run (farmhash mode, ``suspicion_ticks=6``): every node
joins at tick 0, three seeded victims die at tick 10 and revive at 26.  At
the checkpoint ticks {6, 12, 20, 30, T-1} three observers' complete
membership views — (address, status string, incarnationNumber ms) triples
as the reference's member records hold them — are written with the
engine's FarmHash32 checksum of each view.  ``scripts/replay_node``'s
``validate_replay.js`` rebuilds ringpop-node's ``generateChecksumString``
for each snapshot (sort by address, concat address+status+incarnation,
join ';') and compares ``farmhash.hash32`` of it.

The JSON has the JAX file's keys and validator; only ``generator`` and
``engine`` name the port.  ``--fused`` (the default) drives the fused
record-cache encode and ``fused_stream``; ``--no-fused`` the classic
``membership_rows`` + ``hash32_rows`` recompute (``block_loop``).  On the
card the tick launches ``apply_updates`` and ``pb_budget`` too.

Usage: python -m ringpop_tpu_torch.tools.export_parity_replay [-n 64]
       [--ticks 48] [--seed 0] [-o FILE] [--no-fused] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.models.sim.cluster import default_addresses
from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import u32
from ringpop_tpu_torch.obs.perf import fence
from ringpop_tpu_torch.tools import default_path

GENERATOR = "ringpop_tpu_torch/tools/export_parity_replay.py"


def replay(n: int = 64, ticks: int = 48, seed: int = 0, fused: bool = True,
           device=None) -> Tuple[dict, dict]:
    """Run the schedule; returns ``(artifact, walls)``, ``walls`` holding
    the engine's seconds (``engine_s``, the ticks to their end) and the
    host's (``host_s``, the snapshot reads and their views)."""
    dev = resolve_device(device)
    params = engine.SimParams(
        n=n,
        checksum_mode="farmhash",
        suspicion_ticks=6,
        # direct engine use, as the JAX script: parity_recompute stays
        # "auto" ("full" on the fused pipeline, "gated" on the classic one)
        fused_checksum="on" if fused else "off",
    )
    addresses = default_addresses(n)
    universe = ce.Universe.from_addresses(addresses)
    state = engine.init_state(params, seed=seed, universe=universe, device=dev)

    rng = np.random.default_rng(seed)
    victims = rng.choice(n, size=3, replace=False)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[torch.as_tensor(victims, device=dev)] = True
    checkpoint_ticks = {
        6,  # post-bootstrap dissemination
        12,  # suspects in flight (kill at 10, suspicion 6 ticks)
        20,  # faulties escalated
        30,  # revived with fresh incarnations
        ticks - 1,  # reconverged
    }
    observers = [0, int(n // 3), int(victims[0])]
    quiet = engine.TickInputs.quiet(n, dev)
    snapshots: List[dict] = []
    engine_s = host_s = 0.0
    for t in range(ticks):
        inputs = quiet
        if t == 0:
            inputs = quiet._replace(join=torch.ones(n, dtype=torch.bool, device=dev))
        elif t == 10:
            inputs = quiet._replace(kill=mask)
        elif t == 26:
            inputs = quiet._replace(revive=mask)
        t0 = time.perf_counter()
        state, _ = fence(engine.tick(state, inputs, params, universe))
        t1 = time.perf_counter()
        engine_s += t1 - t0
        if t not in checkpoint_ticks:
            continue
        known = state.known.cpu().numpy()
        status = state.status.cpu().numpy()
        inc_ms = engine.stamp_to_ms(state.inc, params).cpu().numpy()
        checksums = u32.to_numpy(state.checksum)
        alive = state.proc_alive.cpu().numpy()
        for o in observers:
            if not alive[o]:
                continue
            members = [
                {
                    "address": addresses[j],
                    "status": ce.STATUS_STRINGS[int(status[o, j])],
                    "incarnationNumber": int(inc_ms[o, j]),
                }
                for j in range(n)
                if known[o, j]
            ]
            snapshots.append({
                "tick": t,
                "observer": addresses[o],
                "members": members,
                "expected_checksum": int(checksums[o]),
            })
        host_s += time.perf_counter() - t1

    statuses = {m["status"] for s in snapshots for m in s["members"]}
    if not {"alive", "suspect", "faulty"} <= statuses:
        raise AssertionError(
            "snapshots must exercise alive+suspect+faulty strings: %r" % statuses
        )
    doc = {
        "description": (
            "Membership-checksum parity replay against ringpop-node: for "
            "each snapshot, rebuild the reference checksum string "
            "(lib/membership/index.js:101-123 — members sorted by "
            "address, address+status+incarnationNumber joined with ';') "
            "and compare farmhash.hash32(str) >>> 0 to expected_checksum."
        ),
        "generator": GENERATOR,
        "engine": (
            "ringpop_tpu_torch full-fidelity engine on %s, farmhash mode" % dev.type
            + (" (fused record-cache encode + streaming hash)" if fused else "")
        ),
        "n": n,
        "ticks": ticks,
        "seed": seed,
        "validator": "scripts/replay_node.md",
        "status_values_present": sorted(statuses),
        "snapshots": snapshots,
    }
    return doc, {"engine_s": engine_s, "host_s": host_s}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="export-parity-replay")
    p.add_argument("-n", type=int, default=64)
    p.add_argument("--ticks", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", "-o", default=None,
                   help="default: runs_torch/PARITY_REPLAY.json")
    p.add_argument("--fused", action="store_true", default=True, dest="fused")
    p.add_argument("--no-fused", action="store_false", dest="fused")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; without a card, cpu must be asked for")
    args = p.parse_args(argv)
    if args.ticks < 32:
        p.error(
            "--ticks must be >= 32 (kill at 10, revive at 26, checkpoint "
            "at 30 are fixed; fewer ticks drops the faulty/revive "
            "coverage the artifact exists to exercise)"
        )
    resolve_device(args.device)  # before any file is made
    output = args.output or default_path("PARITY_REPLAY.json")
    doc, walls = replay(args.n, args.ticks, args.seed, args.fused, args.device)
    with open(output, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({
        "snapshots": len(doc["snapshots"]),
        "statuses": doc["status_values_present"],
        "output": output,
        "engine_s": round(walls["engine_s"], 3),
        "host_s": round(walls["host_s"], 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
