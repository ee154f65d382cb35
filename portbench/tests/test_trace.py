"""The trace reduction on hand-made records: the busy union, the idle
gaps by host record, the profiler's own idle time, the readers."""

import types

import pytest
from torch.autograd import DeviceType

from portbench.lib import readers
from portbench.lib.trace import Trace


def _event(name, t0, dur, device=True, annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: t0, duration_ns=lambda: dur,
        device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=lambda: annotation)


def _trace(events, window_s):
    results = types.SimpleNamespace(events=lambda: events)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))
    return Trace(prof, window_s)


def test_union_gaps_and_overhead():
    ms = 1_000_000
    events = [
        _event("k_a apply_updates_kernel", 0, 4 * ms),
        _event("k_b", 2 * ms, 4 * ms),  # overlaps k_a: counted once
        _event("Memcpy HtoD", 10 * ms, 1 * ms),
        _event("k_c exchange_kernel", 30 * ms, 10 * ms),
        _event("a range", 0, 40 * ms, annotation=True),  # not device work
        _event("cudaStreamSynchronize", 6 * ms, 4 * ms, device=False),
        _event("Command Buffer Full", 11 * ms, 19 * ms, device=False),
    ]
    t = _trace(events, window_s=0.040)
    assert t.busy_s == pytest.approx(0.017)
    idle = dict(t.idle_gaps())
    assert idle == pytest.approx({"cudaStreamSynchronize": 0.004, "Command Buffer Full": 0.019})
    assert t.overhead_s == pytest.approx(0.019)
    assert len(t.kernel_records()) == 3 and len(t.kernel_records("exchange_kernel")) == 1
    rec = {"trace": t, "window_s": 0.040, "ticks": 2,
           "launches": {"ringpop_exchange": [((1000, 16, 4, 1, 1, 0, 1, 0), (True,) * 6 + (False,))]}}
    # busy over the window less the profiler's own idle time
    assert readers.device_busy_pct(rec) == pytest.approx(100 * 0.017 / 0.021)
    assert readers.launches_per_tick(rec) == 1.5
    # every record that is not a port kernel: k_b and the copy
    assert readers.engine_device_ms_per_tick(rec) == pytest.approx(2.5)
    share = readers.roofline_pct(rec, "exchange")
    assert 0 < share < 1  # a 10 ms record of a 0.4 MB launch
    assert readers.roofline_pct(rec, "apply_updates") is None  # no launch logged


def test_no_device_records_reads_nothing():
    t = _trace([_event("aten::add", 0, 5, device=False)], window_s=1.0)
    rec = {"trace": t, "window_s": 1.0, "ticks": 3, "launches": {}}
    assert t.busy_s == 0 and t.idle_gaps() == []
    for read in (readers.device_busy_pct, readers.launches_per_tick,
                 readers.engine_device_ms_per_tick):
        assert read(rec) is None
