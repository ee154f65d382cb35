#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell (``workloads/<cell>.json``: its configuration, traffic mix
and driver) from the seed, sets it up and warms every shape it will use
(``setup_s``), then runs whole chunks of the mix through the driver's
timed call until ``--seconds`` have passed; the window ends with the last
chunk.  With ``--trace 1`` the same window runs under ``torch.profiler``
and the cell's per-layer metrics are read from it instead of the
end-to-end ones.  After the window the program's state is freed and the
plain reference (``reference/``) judges what the timed path produced;
every number compared is printed beside its limit.  The last line of
standard output is the result as one JSON object.

Needs a CUDA card: without one it exits 3 and prints no result.
``--device cpu`` runs the same path on the CPU (the plain versions of the
kernels) for tests; such a result says ``"platform": "cpu"``.
``--control`` puts the reference, with one stated guarantee broken, in the
program's place: its runs must come out not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # import the checkout's packages, never portbench's folders as
    # top-level modules
    sys.path[0] = ROOT


def _parser():
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", action="store_true")
    return p


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device_info(torch, device, chips: int, held_bytes: int) -> dict:
    """The card, and the window's memory peak less the ``held_bytes`` of
    the harness's own snapshots (allocated before the window, held
    through it)."""
    if device.type == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = int(torch.cuda.max_memory_allocated(device)) - held_bytes
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}


def run(argv=None, t_start: float = None) -> tuple:
    """One run; returns ``(exit code, result or None)``."""
    t_start = T_START if t_start is None else t_start
    args = _parser().parse_args(argv)
    if args.seed < 0:
        _log("--seed must be a whole number >= 0")
        return 2, None

    from portbench.lib import guard, registry

    bench = registry.benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        _log("cell %r is not in BENCHMARK.json" % args.workload)
        return 2, None
    spec = registry.cell(args.workload)
    if (spec["cell"]["config"], spec["cell"]["traffic"]) != (entry[0]["config"],
                                                              entry[0]["traffic"]):
        _log("workloads/%s.json and BENCHMARK.json name different pieces" % args.workload)
        return 2, None
    chips = int(entry[0]["chips"])

    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            _log("needs %d CUDA card(s); found %d" % (
                chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
            return 3, None
        torch.cuda.set_device(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    driver = spec["driver"].Driver(spec["cell"], spec["config"], spec["mix"], args.seed, device,
                                   args.control, seconds=args.seconds)
    driver.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    driver.window_start()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync()

    prof = launches = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        from portbench.lib.launches import LaunchLog

        # the card's activity only (lib/trace.py says why)
        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
        launches = LaunchLog().__enter__()
        prof = profile(activities=acts)
        prof.__enter__()
    counters0 = driver.counters()
    ticks = 0
    chunk_s = []
    # what set-up left behind is not the window's to collect
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    while True:
        ticks += driver.chunk()
        chunk_s.append(time.perf_counter() - t0 - sum(chunk_s))
        if time.perf_counter() - t0 >= args.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    counters1 = driver.counters()
    if args.trace:
        prof.__exit__(None, None, None)
        launches.__exit__(None, None, None)

    found = guard.forbidden_modules()
    if found:
        _log("loaded in the measured process: %s" % ", ".join(found))
        return 4, None
    device_info = _device_info(torch, device, chips, driver.held_bytes())

    rec = dict(driver.work(ticks), window_s=window_s, setup_s=setup_s,
               counters={k: counters1[k] - counters0.get(k, 0) for k in counters1})
    breakdown = None
    if args.trace:
        from portbench.lib.trace import Trace

        trace = Trace(prof, window_s)
        del prof
        rec.update(trace=trace, launches=dict(launches.calls))
        device_info.update(busy_s=trace.busy_s, window_s=window_s)
        breakdown = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}

    metrics = {}
    for m in registry.metrics_of(bench, args.workload, bool(args.trace)):
        reader = registry.load_module("metrics", m["name"])
        value = None if reader is None else reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    compared = driver.judge(_log)
    found = guard.forbidden_modules()
    if found:
        _log("loaded in the measured process: %s" % ", ".join(found))
        return 4, None
    correct = all(value <= limit for _, value, limit in compared)
    for name, value, limit in compared:
        _log("%s %s limit %s" % (name, value, limit))
    result = {
        "correct": correct,
        "attempted": int(rec["ticks"]),
        "failed": 0 if correct else int(rec["ticks"]),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    # each timed call's seconds and the snapshots' bytes left out of the
    # peak (not read by the check; for diagnosis)
    result["chunk_s"] = chunk_s
    result["snapshot_bytes"] = driver.held_bytes()
    result["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in compared}
    return 0, result


def main(argv=None) -> int:
    code, result = run(argv)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
