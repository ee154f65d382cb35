"""A traced window: ``torch.profiler`` records reduced to what readers need.

:class:`Trace` holds the device records of the window (kernels, copies,
fills), the busy time (the union of their intervals), the idle gaps
between them labelled by what the host was doing, and the top device
operations.  The profiler records the card's activity only (with it come
the CUDA runtime calls on the host): recording every host operation
slows a host-paced window and so understates the busy share.  The
records come from ``kineto_results.events()``: the profiler's event tree
(``key_averages``) costs seconds at a batched tick's record count.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# host records of the profiler's own work: a gap they hold is the trace's
# cost, not the program's (one stalled a device-paced window for 11 s)
PROFILER_RECORDS = frozenset({"Command Buffer Full", "Activity Buffer Request", "Buffer Flush"})


def _start_ns(e) -> int:
    return int(e.start_ns()) if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _annotation(e) -> bool:
    """A ``record_function`` range copied onto the device's timeline: no
    device work."""
    return bool(getattr(e, "is_user_annotation", lambda: False)())


class Trace:
    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        device, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            t0, dur = _start_ns(e), int(e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if dur > 0 and not _annotation(e):
                    device.append((e.name(), t0, dur))
            else:
                cpu.append((t0, t0 + dur, e.name()))
        device.sort(key=lambda r: r[1])
        self.device = device
        # the window as the card saw it: first record to last
        self.w0 = device[0][1] if device else None
        self.w1 = max(t + d for _, t, d in device) if device else None
        self._cpu = sorted(cpu)
        self.busy_s, gaps = self._union()
        self._idle = self._label(gaps)
        # idle time the profiler made: left out of the busy share
        self.overhead_s = sum(ns for n, ns in self._idle.items() if n in PROFILER_RECORDS) / 1e9

    def _union(self):
        busy = 0
        gaps = []
        end = self.w0
        for _, t0, dur in self.device:
            if t0 > end:
                gaps.append((end, t0))
            if t0 + dur > end:
                busy += t0 + dur - max(t0, end)
                end = t0 + dur
        if self.w1 is not None and self.w1 > end:
            gaps.append((end, self.w1))
        return busy / 1e9, gaps

    def kernel_records(self, key: str = None):
        """``(name, dur_ns)`` of kernel records (no copies or fills); with
        ``key``, only those whose name holds it."""
        return [(n, d) for n, _, d in self.device
                if not n.startswith(("Memcpy", "Memset")) and (key is None or key in n)]

    def device_ops(self, top: int = 10):
        per = defaultdict(int)
        for n, _, d in self.device:
            per[n[:120]] += d
        return [[n, ns / 1e9] for n, ns in sorted(per.items(), key=lambda kv: -kv[1])[:top]]

    def _label(self, gaps):
        """Idle ns by what the host was doing: the host record (a CUDA
        runtime call, or the profiler's own) that holds the middle of each
        gap; "host" where none does (Python and PyTorch issuing the next
        operation)."""
        starts = [c[0] for c in self._cpu]
        per = defaultdict(int)
        for a, b in gaps:
            mid = (a + b) // 2
            label = "host"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(-1, i - 8), -1):
                if self._cpu[j][1] >= mid:
                    label = self._cpu[j][2]
                    break
            per[label[:120]] += b - a
        return per

    def idle_gaps(self, top: int = 10):
        """The ``top`` labels of :meth:`_label` by idle seconds."""
        return [[n, ns / 1e9] for n, ns in sorted(self._idle.items(), key=lambda kv: -kv[1])[:top]]
