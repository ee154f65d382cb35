"""Host-side phase timing: dispatch timers around the drivers' entry points.

A copy of ``ringpop_tpu/obs/perf.py`` — the performance observatory's
wall-clock plane (device-side latency distributions live in
``ops.histogram`` / ``obs.histograms``):

- :class:`DispatchTimer` — wraps a callable with a fenced timer: every
  call is timed until its OUTPUTS are ready (the fence never touches the
  inputs).  The exact per-call walls are retained (ring-bounded), so the
  reported p50/p95/p99 are true nearest-rank order statistics of the
  measured dispatches, not bucket bounds.
- ``perf.phase`` run-log rows (:meth:`DispatchTimer.emit`) and a host-
  timeline Chrome-trace track (:meth:`DispatchTimer.chrome_trace_events`)
  that ``obs.chrome_trace.add_host_timeline`` merges into the flight
  trace.
- :func:`timed_window` — the one warm-then-measure loop a bench shares.
- The span log: :func:`span` and :func:`phases` mark the program's own
  layers (driver calls, engine phases, host reads), :func:`count` adds to
  a host-side counter, and :func:`tracing` installs a timer as the log
  for a ``with`` block.  With no timer installed, ``span``/``phases``
  return one shared no-op object and ``count`` returns at once: no clock
  read, no allocation, no torch call.  A logged span holds its name,
  start and end in Unix-epoch ns (the clock ``torch.profiler`` stamps
  its records with), the index of its parent span and the shard body it
  ran in (:attr:`DispatchTimer.body`, set by ``parallel.comm.lockstep``);
  the log keeps every span until the timer is dropped.

Three differences from the JAX module, forced by torch:

- :func:`fence` walks the output pytree and synchronises each distinct
  CUDA device it finds there (``torch.cuda.synchronize(device)``), never
  only the current one: a mesh runs on ``cuda:0..3``.  On the CPU, and for
  numpy outputs, it is the identity.  The drivers' ``step``/``run`` return
  numpy metrics, read to the host after the tick's work, so the fence adds
  no host read to a wrapped driver.
- There is no jit cache to probe: every timed call is noted with
  ``compiled`` None, so ``compile_calls`` and ``cache_hits`` stay 0 and
  every call counts warm.  A first call's warm-up (the kernels' build,
  the allocator's growth) lands in the walls; :func:`timed_window`'s
  ``warmup`` keeps it out of a measured window.
- :func:`wrap_cluster` wraps the public ``step`` and ``run`` of a driver
  (phases ``tick`` and ``scan``), never its private tick: a port driver's
  window loops its ``_tick`` once a tick, so a timed ``_tick`` would fence
  every tick of a window (host syncs the unwrapped window does not have)
  and count scan ticks as ``tick`` calls.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ringpop_tpu_torch.obs.histograms import DEFAULT_QS, compute_protocol_delay
from ringpop_tpu_torch.obs.statsd_bridge import PERF_TIMER_KEYS


@contextlib.contextmanager
def stopwatch(sink: Dict[str, float], key: str):
    """Accumulate the wall time of a ``with`` block into ``sink[key]``:
    seconds, monotonic, additive across re-entries (host phases that are
    not a dispatch)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[key] = sink.get(key, 0.0) + (time.perf_counter() - t0)


def _tensors(value: Any):
    """Every tensor of a pytree (tensors, tuples incl. NamedTuples, lists,
    dicts); other leaves are skipped."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def fence(value: Any) -> Any:
    """Wait until the work producing a pytree's CUDA tensors is done on
    each distinct card they lie on; returns the value.  Identity for CPU
    tensors and numpy outputs."""
    for dev in dict.fromkeys(t.device for t in _tensors(value) if t.is_cuda):
        torch.cuda.synchronize(dev)
    return value


class PhaseStats:
    """Accumulated timing for one named phase.  The exact per-call warm
    walls are retained (ring-bounded) so the reported percentiles are
    true nearest-rank order statistics of the measured dispatches —
    not bucket bounds."""

    def __init__(self, name: str, keep_walls: int = 4096):
        self.name = name
        self.calls = 0
        self.total_s = 0.0
        self.compile_calls = 0  # calls that grew the jit cache
        self.compile_s = 0.0  # wall spent in those calls (trace+compile+run)
        self.cache_hits = 0  # calls OBSERVED warm via the cache probe
        self.warm_walls: List[float] = []  # exact walls, non-compile calls
        self._keep_walls = keep_walls
        self.last_s: Optional[float] = None

    def observe(self, wall_s: float, compiled: Optional[bool]) -> None:
        """``compiled`` is tri-state: True = the call grew the jit
        cache, False = the probe confirmed a cache hit, None = no probe
        (plain callables, host spans) — counted warm but never as a
        cache hit."""
        self.calls += 1
        self.total_s += wall_s
        self.last_s = wall_s
        if compiled:
            self.compile_calls += 1
            self.compile_s += wall_s
        else:
            if compiled is False:
                self.cache_hits += 1
            self.warm_walls.append(wall_s)
            if len(self.warm_walls) > self._keep_walls:
                del self.warm_walls[: -self._keep_walls]

    def warm_s(self) -> float:
        return self.total_s - self.compile_s

    def warm_calls(self) -> int:
        return self.calls - self.compile_calls

    def summary(self, qs: Sequence[float] = DEFAULT_QS) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "phase": self.name,
            "calls": self.calls,
            "wall_s": self.total_s,
            "compile_calls": self.compile_calls,
            "compile_s": self.compile_s,
            "cache_hits": self.cache_hits,
            "warm_calls": self.warm_calls(),
            "warm_s": self.warm_s(),
        }
        out.update(percentiles_exact(self.warm_walls, qs))
        return out


class DispatchTimer:
    """Per-phase dispatch timing and a host timeline (the compile/execute
    split stays in the rows and reads 0 compile calls: see the module
    docstring)."""

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        keep_spans: int = 4096,
    ):
        self._clock = clock
        self._t0 = clock()
        self.phases: Dict[str, PhaseStats] = {}
        # (name, start_s, end_s, compiled) relative to timer birth; ring-
        # bounded so a long storm cannot grow the host timeline unboundedly
        self.spans: List[Tuple[str, float, float, bool]] = []
        self._keep_spans = keep_spans
        # the span log (span/phases under tracing): [name, start_ns,
        # end_ns, parent index or -1, shard body or None], epoch ns
        self.log: List[list] = []
        self.counters: Dict[str, int] = {}
        # the shard body running (parallel.comm.lockstep); None outside a mesh
        self.body: Optional[int] = None
        self._stacks: Dict[Optional[int], List[int]] = {None: []}
        self.epoch_offset_ns = time.time_ns() - time.perf_counter_ns()
        self._birth_ns = time.perf_counter_ns() + self.epoch_offset_ns

    def _stats(self, name: str) -> PhaseStats:
        st = self.phases.get(name)
        if st is None:
            st = self.phases[name] = PhaseStats(name)
        return st

    def _note(
        self, name: str, t0: float, t1: float, compiled: Optional[bool]
    ) -> None:
        self._stats(name).observe(t1 - t0, compiled)
        self.spans.append(
            (name, t0 - self._t0, t1 - self._t0, bool(compiled))
        )
        if len(self.spans) > self._keep_spans:
            del self.spans[: -self._keep_spans]

    def wrap(self, name: str, fn: Callable) -> Callable:
        """Timed twin of a callable: fence on its outputs.  The port has
        no jit cache to probe, so every call is noted with ``compiled``
        None (warm, never a cache hit)."""

        def timed_call(*args, **kwargs):
            t0 = self._clock()
            out = fence(fn(*args, **kwargs))
            t1 = self._clock()
            self._note(name, t0, t1, None)
            return out

        timed_call.__name__ = "timed_%s" % name
        timed_call.__wrapped__ = fn
        # sentinel for wrap_cluster's idempotence check (a bound method
        # wrapped by functools carries __wrapped__ too); the bound timer
        # rides along so a re-instrumentation can recover it
        timed_call.__perf_timed__ = True
        timed_call.__perf_timer__ = self
        return timed_call

    def phase(self, name: str):
        """Context manager timing an arbitrary host-side span.  No
        cache probe exists here, so ``compiled`` is recorded as None
        (unknown) — the span counts warm but NEVER as a cache hit
        (cache_hits must mean an observed probe, not an assumption)."""
        timer = self

        class _Span:
            def __enter__(self_inner):
                self_inner._s0 = timer._clock()
                return self_inner

            def __exit__(self_inner, exc_type, exc, tb):
                timer._note(name, self_inner._s0, timer._clock(), None)

        return _Span()

    # -- the span log -----------------------------------------------------

    def open_span(self, name: str) -> int:
        """Log a span that starts now; returns its index.  Its parent is
        the innermost open span of the same shard body, or, for a body's
        outermost span, the innermost open span outside every body: never
        another body's span."""
        stack = self._stacks.setdefault(self.body, [])
        outer = stack or self._stacks[None]
        index = len(self.log)
        self.log.append([name, time.perf_counter_ns() + self.epoch_offset_ns, None,
                         outer[-1] if outer else -1, self.body])
        stack.append(index)
        return index

    def close_span(self, index: int) -> None:
        """End span ``index`` now, with any span of its body still open
        inside it (one a raised exception left open)."""
        rec = self.log[index]
        if rec[2] is not None:  # closed with a span around it
            return
        now = time.perf_counter_ns() + self.epoch_offset_ns
        stack = self._stacks[rec[4]]
        while stack:
            inner = stack.pop()
            if self.log[inner][2] is None:
                self.log[inner][2] = now
            if inner == index:
                break

    # -- reporting --------------------------------------------------------

    def summary(self, qs: Sequence[float] = DEFAULT_QS) -> List[Dict[str, Any]]:
        return [
            self.phases[name].summary(qs) for name in sorted(self.phases)
        ]

    def emit(self, recorder, qs: Sequence[float] = DEFAULT_QS, **extra) -> int:
        """One ``perf.phase`` event row per phase onto a RunRecorder
        (field set validated by scripts/check_metrics_schema.py)."""
        rows = 0
        for row in self.summary(qs):
            recorder.record_event("perf.phase", **row, **extra)
            rows += 1
        return rows

    def emit_statsd(self, bridge, key_map: Optional[Dict[str, str]] = None) -> int:
        """Per-phase warm p50/p95/p99 as statsd TIMER samples through a
        StatsdBridge (``|ms`` wire type) — phase names mapped onto the
        reference timing-key scheme via ``key_map`` (default:
        obs.statsd_bridge.PERF_TIMER_KEYS, unmapped phases ride
        ``sim.perf.<phase>``)."""
        key_map = PERF_TIMER_KEYS if key_map is None else key_map
        emitted = 0
        for row in self.summary():
            key = key_map.get(row["phase"], "sim.perf.%s" % row["phase"])
            for q in ("p50_ms", "p95_ms", "p99_ms"):
                v = row.get(q)
                if v is not None:
                    bridge.timing("%s.%s" % (key, q[:-3]), v)
                    emitted += 1
        return emitted

    def chrome_trace_events(self, pid: int = 0, tid: int = 0) -> List[dict]:
        """The host-timeline track: complete ("X") Trace Event Format
        events, microsecond timestamps, one per recorded span — merged
        into the flight-recorder Perfetto export by
        obs.chrome_trace.add_host_timeline."""
        events = []
        for name, s0, s1, compiled in self.spans:
            events.append(
                {
                    "name": name,
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": s0 * 1e6,
                    # >= 1 us: the trace schema requires X spans dur > 0
                    "dur": max((s1 - s0) * 1e6, 1.0),
                    "cat": "host",
                    "args": {"compiled": compiled},
                }
            )
        # the span log, timed from the timer's birth as the spans above
        # are with the default clock; a shard body's spans on their own row
        for index, (name, t0, t1, parent, shard) in enumerate(self.log):
            t1 = t0 if t1 is None else t1
            events.append(
                {
                    "name": name,
                    "ph": "X",
                    "pid": pid,
                    "tid": tid if shard is None else tid + 1 + shard,
                    "ts": (t0 - self._birth_ns) / 1e3,
                    "dur": max((t1 - t0) / 1e3, 1.0),
                    "cat": "span",
                    "args": {"span": index, "parent": parent, "shard": shard},
                }
            )
        return events

    # -- the load-bearing consumer ---------------------------------------

    def protocol_delay_ms(
        self, phase: str = "tick", min_period_ms: float = 200.0
    ) -> float:
        """computeProtocolDelay over a phase's exact warm-dispatch
        walls: ``max(2 * p50, minProtocolPeriod)``
        (lib/gossip/index.js:42-50).  The phase wall IS the simulated
        ping round's host latency."""
        st = self.phases.get(phase)
        p50 = None
        if st is not None:
            p50 = percentiles_exact(st.warm_walls, (50,))["p50_ms"]
        return compute_protocol_delay(p50, min_period_ms)


class _NoSpan:
    """What :func:`span` and :func:`phases` return with no log installed:
    its enter, exit, ``next`` and ``end`` do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def next(self, name: str) -> None:
        pass

    def end(self) -> None:
        pass


_NO_SPAN = _NoSpan()
# the timer :func:`tracing` installed: the one span log of the process
_ACTIVE: Optional[DispatchTimer] = None


class _Span:
    __slots__ = ("_timer", "_name", "_index")

    def __init__(self, timer: DispatchTimer, name: str):
        self._timer, self._name = timer, name

    def __enter__(self):
        self._index = self._timer.open_span(self._name)
        return self

    def __exit__(self, *exc):
        self._timer.close_span(self._index)
        return False


class _Phases:
    """The phases of a tick, one span each: ``next(name)`` ends the open
    phase and opens ``name``; ``end()`` ends the last."""

    __slots__ = ("_timer", "_index")

    def __init__(self, timer: DispatchTimer):
        self._timer, self._index = timer, None

    def next(self, name: str) -> None:
        self.end()
        self._index = self._timer.open_span(name)

    def end(self) -> None:
        if self._index is not None:
            self._timer.close_span(self._index)
            self._index = None


def active() -> Optional[DispatchTimer]:
    """The installed span log, or None."""
    return _ACTIVE


def span(name: str):
    """A context manager logging a span of the installed timer; the
    shared no-op with none installed."""
    timer = _ACTIVE
    if timer is None:
        return _NO_SPAN
    return _Span(timer, name)


def phases():
    """The phase spans of one tick (:class:`_Phases`); the shared no-op
    with no timer installed."""
    timer = _ACTIVE
    if timer is None:
        return _NO_SPAN
    return _Phases(timer)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the installed timer's counter ``name``."""
    timer = _ACTIVE
    if timer is not None:
        timer.counters[name] = timer.counters.get(name, 0) + k


@contextlib.contextmanager
def tracing(timer: DispatchTimer):
    """Install ``timer`` as the span log for a ``with`` block (the one
    before it comes back after); the epoch offset of its clock is taken
    here."""
    global _ACTIVE
    previous = _ACTIVE
    timer.epoch_offset_ns = time.time_ns() - time.perf_counter_ns()
    _ACTIVE = timer
    try:
        yield timer
    finally:
        _ACTIVE = previous


def wrap_cluster(cluster, timer: Optional[DispatchTimer] = None) -> DispatchTimer:
    """Instrument a driver in place: rebinds the instance's public
    ``step`` (phase ``tick``) and ``run`` (phase ``scan``) to timed twins —
    ``SimCluster``, ``BatchedSimClusters`` (no ``step``: its ``run`` only),
    ``ScalableCluster``, ``RoutedStorm``, ``ShardedSim``, ``ShardedStorm``.
    ``bootstrap``, ``run_until_converged`` and the fault keys go through
    the instance's ``step`` and are timed as ``tick``, as in JAX.  One
    count differs from JAX's: a bounded-parity overflow replay is a
    second ``_tick`` call there and stays inside one ``step`` here.
    Returns the timer; re-instrumenting an already-wrapped driver without
    an explicit ``timer`` returns the ORIGINAL bound timer (the one the
    dispatches flow into), never a fresh disconnected one."""
    handles = (("step", "tick"), ("run", "scan"))
    if timer is None:
        for attr, _ in handles:
            fn = getattr(cluster, attr, None)
            if fn is not None and getattr(fn, "__perf_timed__", False):
                timer = fn.__perf_timer__
                break
    timer = timer or DispatchTimer()
    for attr, phase in handles:
        fn = getattr(cluster, attr, None)
        if fn is not None and not getattr(fn, "__perf_timed__", False):
            setattr(cluster, attr, timer.wrap(phase, fn))
    return timer


def timed_window(
    run: Callable[[], Any],
    warmup: int = 1,
    repeats: int = 1,
    recorder=None,
    phase: Optional[str] = None,
    timer: Optional[DispatchTimer] = None,
    **extra: Any,
) -> Tuple[Any, float]:
    """The shared warm-then-measure loop: call ``run`` ``warmup`` times
    (first dispatch, unmeasured), then ``repeats`` times fenced and timed.
    Returns ``(last_result, measured_wall_s)`` — the wall covers ALL
    measured repeats.  With ``recorder`` + ``phase`` a ``perf.phase``
    event row is stamped (calls/warm percentiles from the per-repeat
    walls); ``timer`` accumulates into an existing DispatchTimer
    instead of a throwaway one."""
    for _ in range(warmup):
        fence(run())
    timer = timer or DispatchTimer()
    out = None
    t0 = time.perf_counter()
    for _ in range(repeats):
        with timer.phase(phase or "window"):
            out = fence(run())
    wall = time.perf_counter() - t0
    if recorder is not None and phase is not None:
        row = timer.phases[phase].summary()
        row.update(extra)
        recorder.record_event("perf.phase", **row)
    return out, wall


def percentiles_exact(walls_s: Sequence[float], qs=DEFAULT_QS) -> Dict[str, float]:
    """Exact (un-bucketed) nearest-rank percentiles of raw wall samples
    in ms — for callers that kept the per-call walls."""
    arr = np.sort(np.asarray(list(walls_s), np.float64))
    out = {}
    for q in qs:
        if arr.size == 0:
            out["p%g_ms" % q] = None
        else:
            rank = max(1, int(np.ceil(q / 100.0 * arr.size)))
            out["p%g_ms" % q] = float(arr[rank - 1] * 1e3)
    return out


__all__: List[str] = [
    "DispatchTimer",
    "PhaseStats",
    "active",
    "count",
    "fence",
    "percentiles_exact",
    "phases",
    "span",
    "stopwatch",
    "timed_window",
    "tracing",
    "wrap_cluster",
]
