"""Where a tick's time goes on the card: the headline cluster's windows
under ``torch.profiler``.

    python3 -m ringpop_tpu_torch.tick_profile [--n 1024] [--ticks 64] [--out FILE]
    python3 -m ringpop_tpu_torch.tick_profile --storm [--n 1000000] [--out FILE]
    python3 -m ringpop_tpu_torch.tick_profile --classic [--n 1024] [--out FILE]
    python3 -m ringpop_tpu_torch.tick_profile --route [--n 1000000] [--q 1048576] [--out FILE]

For each checksum mode it builds ``SimCluster(n)`` on the card, bootstraps
and converges it (as ``chip_smoke.py`` does), then measures two windows:

- ``quiet``: the converged steady state after a 256-tick settle (the
  headline window's shape);
- ``churn``: ``EventSchedule.churn_window`` — a kill wave early, revives at
  mid-window, so suspicion, ping-req, expiry and the checksum recompute
  all run.

Each window is timed once plain (host clock around work that ends in a
synchronize) and once under the profiler, which gives the device time
summed over kernels (busy share = device time / wall time of the profiled
window), the top kernels by device time, and the number of host reads of
device values (``aten::_local_scalar_dense``: one per gated phase). Prints
one JSON object as its last line; needs a CUDA device.

``--classic`` profiles the classic configuration instead
(``fused_tick="off"``, ``fused_checksum="off"``: the classic tick and the
unfused "gated" farmhash recompute through ``block_loop``), same windows.

``--storm`` profiles the scalable engine's churn storm instead
(``ScalableCluster(n)``, u=512, the 60-tick schedule of
``benchmarks/storm_1m.py``): the ``fail`` window (ticks 0-11: the kill
wave, suspicion and the indirect rounds) and the ``rejoin`` window (ticks
28-39: suspicion expiry, the revive wave and its dissemination), each
run once to warm up, then timed plain and under the profiler, all three
from the same starting state; the ``exchange`` kernel's launches and
device time are reported beside the top ten kernels.

``--route`` profiles the routed storm (``RoutedStorm(n)`` with
``RouteParams(queries_per_tick=q)``, the incremental ring) over 16-tick
windows of sparse churn, random kills each tick revived two ticks later:
``fallback`` (32 kills a tick, as ``benchmarks/tpu_measure.py``'s route
phase: more dirty buckets than ``max_dirty``, so the ring update falls
back to the full re-compaction) and ``incremental`` (8 kills a tick, as
``bench.py``'s: every update stays incremental).  Each window runs once to
warm up, then timed plain and under the profiler from the same state; the
ring fallbacks a tick and ``exchange``'s launches and device time are
reported beside the top ten kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _window(sim, sched):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(sched)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiled(sim, sched, top: int = 8, watch=()) -> dict:
    """The window under the profiler: device time, busy share, host reads,
    launches, the ``top`` kernels by device time and, for each name in
    ``watch``, the kernels whose name holds it (count, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _window(sim, sched)
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # kernel rows only: an operator row's self device time repeats the
    # device time of the kernels it launched
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    device_us = sum(dev_us(e) for e in kernels)
    syncs = sum(e.count for e in rows if e.key == "aten::_local_scalar_dense")
    launches = sum(e.count for e in rows if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    kernels.sort(key=dev_us, reverse=True)
    return dict(
        profiled_wall_s=wall,
        device_s=device_us / 1e6 if device_us else None,
        busy_share=(device_us / 1e6 / wall) if device_us else None,
        host_reads=syncs,
        kernel_launches=launches,
        top=[dict(name=e.key[:80], count=e.count, device_ms=dev_us(e) / 1e3)
             for e in kernels[:top]],
        watched={w: dict(count=sum(e.count for e in kernels if w in e.key),
                         device_ms=sum(dev_us(e) for e in kernels if w in e.key) / 1e3)
                 for w in watch},
    )


def _params(mode: str, n: int):
    from ringpop_tpu_torch.models.sim import engine

    if mode == "classic":
        return engine.SimParams(n=n, checksum_mode="farmhash", fused_tick="off",
                                fused_checksum="off")
    return engine.SimParams(n=n, checksum_mode=mode)


def profile_mode(mode: str, n: int, ticks: int) -> dict:
    import torch

    from ringpop_tpu_torch.models.sim.cluster import EventSchedule, SimCluster
    from ringpop_tpu_torch.ops import block_loop

    sim = SimCluster(n=n, params=_params(mode, n), device="cuda")
    sim.bootstrap()
    if sim.run_until_converged(max_ticks=96, quiet_after=1) < 0:
        raise RuntimeError("%s: n=%d did not converge" % (mode, n))
    # settle as the headline's warm window does: the changes of the
    # bootstrap wave stay piggybacked for ~15*ceil(log10(n+1)) ticks
    sim.run(EventSchedule(ticks=256, n=n))
    out = dict(mode=mode, n=n, ticks=ticks)
    for name, sched in (
        ("quiet", EventSchedule(ticks=ticks, n=n)),
        ("churn", EventSchedule.churn_window(ticks, n)),
    ):
        pre = sim.state
        _window(sim, sched)  # warm
        sim.state = pre
        replays = sim.parity_replays
        launches = block_loop.block_loop.launches
        wall = _window(sim, sched)
        launches = block_loop.block_loop.launches - launches
        sim.state = pre
        prof = _profiled(sim, sched)
        sim.state = pre
        out[name] = dict(
            wall_s=wall,
            ms_per_tick=wall / ticks * 1e3,
            node_ticks_per_s=n * ticks / wall,
            replays=sim.parity_replays - replays,
            block_loop_launches=launches,
            **prof,
        )
        torch.cuda.synchronize()
    return out


def profile_storm(n: int) -> dict:
    import torch

    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import ScalableCluster, StormSchedule

    full = StormSchedule.churn_storm(60, n, fraction=0.10, fail_tick=2, seed=0)

    def part(a, b):
        return StormSchedule(ticks=b - a, n=n, kill=full.kill[a:b], revive=full.revive[a:b])

    sim = ScalableCluster(n=n, params=es.ScalableParams(n=n, u=512), device="cuda")
    out = dict(n=n, u=512)
    pos = 0
    for name, a, b in (("fail", 0, 12), ("rejoin", 28, 40)):
        if pos < a:
            sim.run(part(pos, a))
        pre = sim.state
        _window(sim, part(a, b))  # warm: the allocator's first-use growth
        sim.state = pre
        reads = es.host_read.count
        wall = _window(sim, part(a, b))
        reads = es.host_read.count - reads
        sim.state = pre
        prof = _profiled(sim, part(a, b), top=10, watch=("exchange_kernel",))
        pos = b
        out[name] = dict(
            ticks=b - a,
            wall_s=wall,
            ms_per_tick=wall / (b - a) * 1e3,
            node_ticks_per_s=n * (b - a) / wall,
            host_reads_per_tick=reads / (b - a),
            **prof,
        )
        torch.cuda.synchronize()
    return out


def profile_route(n: int, q: int, ticks: int = 16) -> dict:
    import torch

    from ringpop_tpu_torch.models.route.plane import RoutedStorm, RouteParams
    from ringpop_tpu_torch.models.sim import engine_scalable as es
    from ringpop_tpu_torch.models.sim.storm import StormSchedule

    out = dict(n=n, q=q, ticks=ticks)
    for name, churn in (("fallback", 32), ("incremental", 8)):
        rs = RoutedStorm(n, params=es.ScalableParams(n=n),
                         route=RouteParams(n=n, queries_per_tick=q), seed=0, device="cuda")
        sched = StormSchedule.sparse_churn(ticks, n, churn)
        pre = (rs.cluster.state, rs.rstate)
        _window(rs, sched)  # warm
        rs.cluster.state, rs.rstate = pre
        reads = es.host_read.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rm = rs.run(sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reads = es.host_read.count - reads
        rs.cluster.state, rs.rstate = pre
        prof = _profiled(rs, sched, top=10, watch=("exchange_kernel",))
        out[name] = dict(
            churn_per_tick=churn,
            bucket_bits=rs.route_params.bucket_bits,
            wall_s=wall,
            ms_per_tick=wall / ticks * 1e3,
            queries_per_s=q * ticks / wall,
            host_reads_per_tick=reads / ticks,
            launches_per_tick=prof["kernel_launches"] / ticks,
            full_rebuilds=[int(x) for x in rm.route_ring_full_rebuilds],
            dirty_buckets=[int(x) for x in rm.route_ring_dirty_buckets],
            **prof,
        )
        del rs, pre
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help="nodes (default 1024, or 1000000 with --storm or --route)")
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--storm", action="store_true",
                    help="profile the scalable churn storm")
    ap.add_argument("--classic", action="store_true",
                    help="profile the classic tick with the unfused checksum path")
    ap.add_argument("--route", action="store_true",
                    help="profile the routed storm (sparse churn, two schedules)")
    ap.add_argument("--q", type=int, default=1 << 20,
                    help="queries a tick with --route (default 2^20)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tick_profile: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60,
    ).stdout.strip()
    if args.route:
        result = dict(card=card, route=profile_route(args.n or 1_000_000, args.q))
    elif args.storm:
        result = dict(card=card, storm=profile_storm(args.n or 1_000_000))
    elif args.classic:
        result = dict(card=card, modes=[profile_mode("classic", args.n or 1024, args.ticks)])
    else:
        result = dict(card=card, modes=[profile_mode(m, args.n or 1024, args.ticks)
                                        for m in ("fast", "farmhash")])
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
