"""Export the full-trajectory Node-parity artifact from the port's engine:
the counterpart of the JAX package's ``scripts/export_parity_trajectory.py``.

A scripted tick-cluster schedule at full width by default (n=1024, 42
ticks, farmhash mode, ``suspicion_ticks=6``): every node joins at tick 0,
two seeded victims die at tick 8 and revive at 20, two more die at 24.
For every tick the artifact carries the checksum-group view the
reference's tick-cluster harness prints (live, ready nodes grouped by
membership checksum, largest group first) and, for the first
``--max-groups`` groups, one representative observer's complete view as
[address, status, incarnationNumber] triples.  ``scripts/replay_node``'s
``validate_trajectory.js`` checks each represented checksum against
``farmhash.hash32`` of ringpop-node's ``generateChecksumString`` over the
view.  The JSON has the JAX file's keys; only ``generator`` names the port.

On the card every tick launches ``apply_updates`` and ``pb_budget`` at
the update sites and ``fused_stream`` for the checksums.  ``known``,
``status`` and ``inc`` are read to the host only on ticks that represent
a group.

Usage: python -m ringpop_tpu_torch.tools.export_parity_trajectory
       [-n 1024] [--ticks 42] [--seed 0] [--max-groups 2] [-o FILE]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
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

GENERATOR = "ringpop_tpu_torch/tools/export_parity_trajectory.py"


def trajectory(n: int = 1024, ticks: int = 42, seed: int = 0, max_groups: int = 2,
               device=None) -> Tuple[dict, dict]:
    """Run the schedule; returns ``(artifact, walls)``: ``engine_s`` (the
    ticks to their end), ``read_s`` (the host reads of the checksum,
    liveness and view planes) and ``host_s`` (grouping and the views)."""
    dev = resolve_device(device)
    params = engine.SimParams(n=n, checksum_mode="farmhash", suspicion_ticks=6)
    addresses = default_addresses(n)
    universe = ce.Universe.from_addresses(addresses)
    state = engine.init_state(params, seed=seed, universe=universe, device=dev)

    rng = np.random.default_rng(seed)
    victims = [int(v) for v in rng.choice(n, size=4, replace=False)]
    # the scripted schedule (recorded in the artifact): bootstrap ->
    # kill wave -> suspects -> faulties -> revive -> reconverge
    schedule = {0: {"join": "all"}, 8: {"kill": victims[:2]},
                20: {"revive": victims[:2]}, 24: {"kill": victims[2:]}}

    def mask(idx):
        m = torch.zeros(n, dtype=torch.bool, device=dev)
        m[torch.as_tensor(idx, device=dev)] = True
        return m

    quiet = engine.TickInputs.quiet(n, dev)
    ticks_out: List[dict] = []
    total_unrepresented = 0
    engine_s = read_s = host_s = 0.0
    for t in range(ticks):
        inputs = quiet
        ev = schedule.get(t, {})
        if ev.get("join") == "all":
            inputs = inputs._replace(join=torch.ones(n, dtype=torch.bool, device=dev))
        if "kill" in ev:
            inputs = inputs._replace(kill=mask(ev["kill"]))
        if "revive" in ev:
            inputs = inputs._replace(revive=mask(ev["revive"]))
        t0 = time.perf_counter()
        state, _ = fence(engine.tick(state, inputs, params, universe))
        t1 = time.perf_counter()
        checksums = u32.to_numpy(state.checksum)
        part = (state.proc_alive & state.ready).cpu().numpy()
        t2 = time.perf_counter()
        groups: dict = {}
        for i in np.flatnonzero(part):
            groups.setdefault(int(checksums[i]), []).append(int(i))
        ordered = sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0]))
        known = status = inc_ms = None
        entry_groups = []
        for gi, (cs, members_idx) in enumerate(ordered):
            g = {"checksum": cs, "count": len(members_idx)}
            if gi < max_groups:
                if known is None:
                    t3 = time.perf_counter()
                    known = state.known.cpu().numpy()
                    status = state.status.cpu().numpy()
                    inc_ms = engine.stamp_to_ms(state.inc, params).cpu().numpy()
                    t2 += time.perf_counter() - t3  # a read, not host work
                o = members_idx[0]
                g["representative"] = {
                    "observer": addresses[o],
                    # compact member triples: [address, status, incMs]
                    "members": [
                        [addresses[j], ce.STATUS_STRINGS[int(status[o, j])], int(inc_ms[o, j])]
                        for j in range(n)
                        if known[o, j]
                    ],
                }
            else:
                total_unrepresented += len(members_idx)
            entry_groups.append(g)
        ticks_out.append({"tick": t, "distinct_checksums": len(ordered), "groups": entry_groups})
        t4 = time.perf_counter()
        engine_s += t1 - t0
        read_s += t2 - t1
        host_s += t4 - t2

    if ticks_out[-1]["distinct_checksums"] != 1:
        raise AssertionError("trajectory must reconverge by its last tick")
    doc = {
        "description": (
            "Full-trajectory membership-checksum parity vs ringpop-node: "
            "per tick, live nodes grouped by checksum (the tick-cluster "
            "convergence view, scripts/tick-cluster.js:87-114); each "
            "represented group's checksum must equal farmhash.hash32 of "
            "generateChecksumString (lib/membership/index.js:101-123 — "
            "sort members by address, concat "
            "address+status+incarnationNumber, join ';') over the "
            "representative view.  Member triples are "
            "[address, status, incarnationNumber]."
        ),
        "generator": GENERATOR,
        "validator": "scripts/replay_node.md (validate_trajectory.js)",
        "n": n,
        "ticks": ticks,
        "seed": seed,
        "schedule": {str(k): v for k, v in schedule.items()},
        "max_groups_represented_per_tick": max_groups,
        "unrepresented_group_nodes_total": total_unrepresented,
        "ticks_data": ticks_out,
    }
    return doc, {"engine_s": engine_s, "read_s": read_s, "host_s": host_s}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="export-parity-trajectory")
    p.add_argument("-n", type=int, default=1024)
    p.add_argument("--ticks", type=int, default=42)  # reconverges at 39
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-groups", type=int, default=2)
    p.add_argument("--output", "-o", default=None,
                   help="default: runs_torch/PARITY_TRAJECTORY.json")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; without a card, cpu must be asked for")
    args = p.parse_args(argv)
    resolve_device(args.device)  # before any file is made
    output = args.output or default_path("PARITY_TRAJECTORY.json")
    doc, walls = trajectory(args.n, args.ticks, args.seed, args.max_groups, args.device)
    with open(output, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    print(json.dumps({
        "ticks": len(doc["ticks_data"]),
        "final_distinct": doc["ticks_data"][-1]["distinct_checksums"],
        "unrepresented_total": doc["unrepresented_group_nodes_total"],
        "bytes": os.path.getsize(output),
        "output": output,
        **{k: round(v, 3) for k, v in walls.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
