"""What the per-layer metric files share.  Each reader takes the run's
record (``run.py``: ticks, window, counters, and in a traced run
``trace`` and ``launches``) and returns a number, or None when it finds
nothing to read."""

from __future__ import annotations

from portbench.lib import registry

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12  # H100 SXM, 32-bit operations outside the tensor cores

# the port's hand-written kernels: the cost module's name and the kernel's
# function name in the device records
PORT_KERNELS = {
    "apply_updates": "apply_updates_kernel",
    "pb_budget": "pb_budget_kernel",
    "fused_stream": "fused_stream_kernel",
    "exchange": "exchange_kernel",
    "block_loop": "block_loop_kernel",
}


def launches_per_tick(rec):
    trace = rec.get("trace")
    if trace is None or not rec["ticks"] or not trace.device:
        return None
    return len(trace.kernel_records()) / rec["ticks"]


def engine_device_ms_per_tick(rec):
    """Device ms a tick of every record that is not one of the port's
    kernels: the plain PyTorch ops, copies and fills."""
    trace = rec.get("trace")
    if trace is None or not rec["ticks"] or not trace.device:
        return None
    ns = sum(d for n, _, d in trace.device if not any(k in n for k in PORT_KERNELS.values()))
    return ns / 1e6 / rec["ticks"]


def device_busy_pct(rec):
    """The union of device records over the window, less the idle time
    the profiler itself made (``Trace.overhead_s``)."""
    trace = rec.get("trace")
    if trace is None or not trace.device:
        return None
    return 100.0 * trace.busy_s / (rec["window_s"] - trace.overhead_s)


def bound_s(cost) -> float:
    """The least time the card could take: bytes at its HBM rate or
    operations at its 32-bit rate, whichever is longer."""
    nbytes, ops = cost
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def roofline_pct(rec, kernel: str):
    """The kernel's mean bound a launch (``costs/<kernel>.py`` over the
    launches' shapes) over its mean device time a launch, in percent."""
    trace = rec.get("trace")
    calls = (rec.get("launches") or {}).get("ringpop_" + kernel)
    if trace is None or not calls:
        return None
    times = [d for _, d in trace.kernel_records(PORT_KERNELS[kernel])]
    costs = registry.load_module("costs", kernel)
    if not times or costs is None:
        return None
    mean_bound = sum(bound_s(costs.cost(ints, present)) for ints, present in calls) / len(calls)
    return 100.0 * mean_bound / (sum(times) / len(times) / 1e9)
