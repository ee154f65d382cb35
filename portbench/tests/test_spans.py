"""The span pairing of ``lib/spans.py`` on hand-made records, and on the
card the program's spans against the profiler's records of a tiny cell."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench.lib import spans
from portbench.lib.trace import Trace
from portbench.tests.conftest import TINY_SIM, TINY_STORM

MS = 1_000_000


def _event(name, t0, dur, device=True, corr=0, linked=0):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: t0, duration_ns=lambda: dur,
        device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=lambda: False, correlation_id=lambda: corr,
        linked_correlation_id=lambda: linked)


# the program's spans: a tick with two phases, a checksum site with its
# hash, a wait; the ring outside the tick
LOG = [
    ["storm.tick", 0, 20 * MS, -1, None],       # 0
    ["exchange", 1 * MS, 6 * MS, 0, None],      # 1
    ["checksum", 6 * MS, 18 * MS, 0, None],     # 2
    ["checksum.hash", 7 * MS, 9 * MS, 2, None],  # 3
    ["wait", 10 * MS, 17 * MS, 2, None],        # 4
    ["storm.ring", 30 * MS, 40 * MS, -1, None],  # 5
]


def _events(corr_on_device="correlation_id"):
    def dev(name, t0, dur, corr):
        key = {"corr": corr} if corr_on_device == "correlation_id" else {"linked": corr}
        return _event(name, t0, dur, **key)

    return [
        # runtime calls on the host
        _event("cudaLaunchKernel", 2 * MS, 1000, device=False, corr=11),
        _event("cudaLaunchKernel", 8 * MS, 1000, device=False, corr=12),
        _event("cudaStreamSynchronize", 10 * MS, 7 * MS, device=False, corr=13),
        _event("cudaLaunchKernel", 31 * MS, 1000, device=False, corr=14),
        _event("cudaLaunchKernel", 50 * MS, 1000, device=False, corr=15),
        # device records: the exchange kernel runs long after its launch,
        # inside the checksum span's time: it is still the exchange's
        dev("exchange_kernel", 9 * MS, 2 * MS, 11),
        dev("fused_stream_kernel", 11 * MS, 3 * MS, 12),
        dev("ring_kernel", 32 * MS, 4 * MS, 14),
        dev("outside_kernel", 51 * MS, 1 * MS, 15),
        dev("orphan_kernel", 53 * MS, 1 * MS, 99),
    ]


@pytest.mark.parametrize("where", ["correlation_id", "linked_correlation_id"])
def test_records_pair_by_correlation_and_go_to_the_launching_span(where):
    device, host = spans.records(_events(where))
    st = spans.SpanTrace(device, host, LOG, {"rows_hashed": 8, "rows_dirty": 2})
    assert [r[3] for r in st.device] == [11, 12, 14, 15, 99]
    assert st.launch_spans("exchange_kernel") == ["exchange"]
    assert st.launch_spans("fused_stream_kernel") == ["checksum.hash"]
    assert st.launch_spans("ring_kernel") == ["storm.ring"]
    assert st.launch_spans("outside_kernel") == [None]
    assert st.unpaired() == 1
    assert st.device_ns(("checksum",)) == 3 * MS
    assert st.device_ns() == 9 * MS
    assert st.attributed_share() == pytest.approx(9 / 11)
    ticks = 2
    assert spans.checksum_device_ms_per_tick(st, ticks) == pytest.approx(1.5)
    assert spans.ring_device_ms_per_tick(st, ticks) == pytest.approx(2.0)
    assert spans.host_wait_ms_per_tick(st, ticks) == pytest.approx(3.5)
    # the tick's 20 ms less its 7 ms wait
    assert spans.host_issue_ms_per_tick(st, ticks) == pytest.approx(6.5)
    assert spans.hashed_rows_dirty_pct(st) == pytest.approx(25.0)
    table = st.table(ticks)
    assert table["checksum"]["calls"] == 1
    # 12 ms less the hash's 2 and the wait's 7
    assert table["checksum"]["host_self_ms"] == pytest.approx(1.5)
    assert table["checksum.hash"]["device_ms"] == pytest.approx(1.5)


def test_gap_labels_name_the_span_and_the_runtime_call():
    events = [
        _event("cudaStreamSynchronize", 10 * MS, 6 * MS, device=False, corr=1),
        _event("k1", 0, 1 * MS, corr=2),
        _event("k2", 3 * MS, 1 * MS, corr=3),    # gap 1-3: in exchange
        _event("k3", 12 * MS, 1 * MS, corr=4),   # gap 4-12: in the hash
        _event("k4", 16 * MS, 1 * MS, corr=5),   # gap 13-16: the wait, in a sync
        _event("k5", 45 * MS, 1 * MS, corr=6),   # gap 17-45: in the ring
        _event("k6", 60 * MS, 1 * MS, corr=7),   # gap 46-60: outside every span
    ]
    device, host = spans.records(events)
    st = spans.SpanTrace(device, host, LOG)
    gaps = dict(st.idle_gaps())
    assert gaps == pytest.approx({"exchange|host": 0.002, "checksum.hash|host": 0.008,
                                  "wait|cudaStreamSynchronize": 0.003,
                                  "storm.ring|host": 0.028, "host": 0.014})
    assert st.idle_ns() == 55 * MS and st.idle_ns(bare=True) == 14 * MS
    # outside every span the label is the trace's own
    outside = dict(spans.SpanTrace(device, host, []).idle_gaps())
    results = types.SimpleNamespace(events=lambda: events)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))
    assert outside == pytest.approx(dict(Trace(prof, 0.05).idle_gaps()))


def test_without_a_span_log_every_reader_reads_nothing():
    device, host = spans.records(_events())
    st = spans.SpanTrace(device, host, [], {"rows_hashed": 4, "rows_dirty": 1})
    assert st.attributed_share() is None
    assert spans.checksum_device_ms_per_tick(st, 3) is None
    assert spans.hashed_rows_dirty_pct(st) is None
    assert spans.host_issue_ms_per_tick(st, 3) is None
    assert spans.host_wait_ms_per_tick(st, 3) is None
    assert spans.ring_device_ms_per_tick(st, 3) is None
    st = spans.SpanTrace(device, host, LOG)
    assert spans.host_wait_ms_per_tick(st, 0) is None
    assert spans.hashed_rows_dirty_pct(st) is None  # no counters


def test_tiny_cells_on_the_cpu(tiny_checkout):
    for cell in (TINY_SIM, TINY_STORM):
        proc = subprocess.run([sys.executable, "portbench/spans.py", "--workload", cell,
                               "--seed", "2147483693", "--seconds", "0.5", "--device", "cpu"],
                              cwd=tiny_checkout, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["ticks"] > 0 and out["spans"]
        assert all(v is not None for k, v in out["per_layer"].items()
                   if "device" not in k), out["per_layer"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


# the full engine's update sites: the phases that launch apply_updates
UPDATE_SITES = {"join", "receive", "respond", "ping_req", "expiry"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kernel,sites", [(TINY_SIM, "apply_updates", UPDATE_SITES),
                                               (TINY_STORM, "exchange", {"exchange"})])
def test_spans_share_the_profilers_clock_on_the_card(card, tiny_checkout, cell, kernel, sites):
    proc = subprocess.run([sys.executable, "portbench/spans.py", "--workload", cell, "--seed",
                           "77", "--seconds", "2"], cwd=tiny_checkout, capture_output=True,
                          text=True, timeout=900, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    launched = out["launch_spans"][kernel]
    assert launched and set(launched) <= sites, launched
    assert out["attributed_pct"] >= 99.0, out
    assert all(v is not None for v in out["per_layer"].values()), out["per_layer"]
