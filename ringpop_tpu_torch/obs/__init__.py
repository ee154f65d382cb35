"""The port's telemetry layer: host halves of the obs planes and the
host-side observatory around the drivers.

The counterpart of ``ringpop_tpu/obs``, module for module:

- ``recorder`` — ``RunRecorder``: append-only JSONL run logs in the JAX
  package's schema.
- ``statsd_bridge`` — device counters onto the reference's statsd keys.
- ``prometheus`` — Prometheus text of drained device histograms, the SLO
  plane and recorded tick series (the live node's exposition stays in the
  JAX package: the port has no live facade).
- ``sim_tap`` — ``SimTracerHost``: the trace store attached to a
  simulation driver (``sim.tick.metrics``, ``sim.flight.events``).
- ``events`` / ``chrome_trace`` — flight-recorder decoding, reconciliation,
  wavefronts and the Perfetto export with its host-timeline track.
- ``histograms`` — exact percentiles of the device histograms, the
  ``hist.drain`` rows and the adaptive protocol period.
- ``perf`` — fenced dispatch timers around the drivers' ``step``/``run``,
  ``perf.phase`` rows and the shared warm-then-measure loop.
- ``exchange_stats`` / ``requests`` — the mesh exchange telemetry and the
  request observatory's host halves.
- ``slo`` — the sliding-window SLO plane over the routing plane's drains.
- ``xprof`` — the ``torch.profiler`` capture harness and its
  ``xprof.capture`` rows.

The names the JAX package exports here are exported too, each loaded on
first use: the drivers import ``obs.events`` and ``obs.histograms`` while
this package's own modules import the drivers' ops, so nothing is imported
eagerly.
"""

from __future__ import annotations

import importlib
from typing import Any

# exported name -> (module, attribute)
_EXPORTS = {
    "RunRecorder": ("recorder", "RunRecorder"),
    "read_run_log": ("recorder", "read_run_log"),
    "validate_run_log": ("recorder", "validate_run_log"),
    "StatsdBridge": ("statsd_bridge", "StatsdBridge"),
    "render_tick_series": ("prometheus", "render_tick_series"),
    "SimTracerHost": ("sim_tap", "SimTracerHost"),
    "decode_events": ("events", "decode_events"),
    "dissemination_summary": ("events", "dissemination_summary"),
    "reconcile": ("events", "reconcile"),
    "rumor_wavefronts": ("events", "rumor_wavefronts"),
    "scalable_wavefront_summary": ("events", "scalable_wavefront_summary"),
    "validate_event_stream": ("events", "validate_event_stream"),
    "add_host_timeline": ("chrome_trace", "add_host_timeline"),
    "export_chrome_trace": ("chrome_trace", "export_chrome_trace"),
    "validate_chrome_trace": ("chrome_trace", "validate_chrome_trace"),
    "write_chrome_trace": ("chrome_trace", "write_chrome_trace"),
    "AdaptiveProtocolPeriod": ("histograms", "AdaptiveProtocolPeriod"),
    "compute_protocol_delay": ("histograms", "compute_protocol_delay"),
    "summarize_histograms": ("histograms", "summarize"),
    "DispatchTimer": ("perf", "DispatchTimer"),
    "timed_window": ("perf", "timed_window"),
    "wrap_cluster": ("perf", "wrap_cluster"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError("module %r has no attribute %r" % (__name__, name)) from None
    value = getattr(importlib.import_module("%s.%s" % (__name__, module)), attr)
    globals()[name] = value
    return value
