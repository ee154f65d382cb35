#!/usr/bin/env python3
"""A cell's traced window split by the program's own spans.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> [--log 0|1]

Sets the cell up as ``run.py`` does, then runs whole chunks for
``--seconds`` under ``torch.profiler`` (the card's activity only, as
``run.py --trace 1``) with the program's span log installed
(``ringpop_tpu_torch.obs.perf.tracing``).  ``lib/spans.py`` pairs each
device record with the runtime call that launched it and puts both, and
each idle gap, in the program's innermost span.  The last line of
standard output is one JSON object: the window, the per-layer numbers
the spans and counters give (``checksum_device_ms_per_tick.sim``,
``hashed_rows_dirty_pct.sim``, ``host_issue_ms_per_tick.storm``,
``host_wait_ms_per_tick.storm``, ``ring_device_ms_per_tick.storm``, each
where the cell has it), the existing per-layer readers on the same
window, per span name its calls, host self ms and device ms a tick, and
the idle gaps by span.  ``--log 0`` runs the same traced window with no
span log installed: the two give what the log costs when it is on.
Judges nothing: ``run.py`` is the benchmark.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT


def _parser():
    p = argparse.ArgumentParser(prog="portbench/spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--log", type=int, choices=(0, 1), default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def window(argv=None) -> dict:
    """One traced window of the cell; returns the result object."""
    args = _parser().parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.lib import readers, registry, spans
    from portbench.lib.trace import Trace
    from portbench.series import card
    from ringpop_tpu_torch.obs import perf

    spec = registry.cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card")
        torch.cuda.set_device(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    driver = spec["driver"].Driver(spec["cell"], spec["config"], spec["mix"], args.seed, device,
                                   False, seconds=args.seconds)
    driver.setup()
    sync()
    setup_s = time.perf_counter() - T_START
    driver.window_start()
    sync()
    timer = perf.DispatchTimer()
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.__enter__()
    gc.collect()
    gc.freeze()
    ticks = 0
    with perf.tracing(timer) if args.log else contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            ticks += driver.chunk()
            if time.perf_counter() - t0 >= args.seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)

    st = spans.SpanTrace.from_profiler(prof, timer.log, timer.counters)
    trace = Trace(prof, window_s)
    del prof
    rec = dict(driver.work(ticks), window_s=window_s, trace=trace, launches={})
    existing = {}
    for name, read in (("launches_per_tick", readers.launches_per_tick),
                       ("engine_device_ms_per_tick", readers.engine_device_ms_per_tick),
                       ("device_busy_pct", readers.device_busy_pct)):
        existing[name] = read(rec)
    fused = [d for _, d in trace.kernel_records(readers.PORT_KERNELS["fused_stream"])]
    existing["fused_stream_device_ms_per_tick"] = sum(fused) / 1e6 / ticks if ticks else None
    per_layer = {}
    if spec["config"]["driver"] == "ensemble":
        per_layer["checksum_device_ms_per_tick.sim"] = spans.checksum_device_ms_per_tick(st, ticks)
        per_layer["hashed_rows_dirty_pct.sim"] = spans.hashed_rows_dirty_pct(st)
    else:
        per_layer["host_issue_ms_per_tick.storm"] = spans.host_issue_ms_per_tick(st, ticks)
        per_layer["host_wait_ms_per_tick.storm"] = spans.host_wait_ms_per_tick(st, ticks)
        per_layer["ring_device_ms_per_tick.storm"] = spans.ring_device_ms_per_tick(st, ticks)
    idle_ns = st.idle_ns()
    return {
        "cell": args.workload, "seed": args.seed, "log": args.log, "ticks": ticks,
        "window_s": window_s, "ms_per_tick": 1e3 * window_s / ticks, "setup_s": setup_s,
        "card": card() if device.type == "cuda" else "cpu",
        "per_layer": per_layer, "existing": existing,
        "attributed_pct": None if st.attributed_share() is None else
        100.0 * st.attributed_share(),
        "unpaired_records": st.unpaired(), "device_records": len(st.device),
        "idle_s": idle_ns / 1e9,
        "bare_host_idle_pct": 100.0 * st.idle_ns(bare=True) / idle_ns if idle_ns else None,
        "spans": st.table(ticks) if ticks else {}, "counters": timer.counters,
        "idle_gaps": st.idle_gaps(top=24),
        "launch_spans": {k: sorted({str(s) for s in st.launch_spans(v)})
                         for k, v in readers.PORT_KERNELS.items()},
    }


def main(argv=None) -> int:
    print(json.dumps(window(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
