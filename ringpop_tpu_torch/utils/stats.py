"""Metrics primitives: EWMA meters and a sampling histogram.

A copy of ``ringpop_tpu/utils/stats.py``: ``Meter`` and ``Histogram``
(the run recorder folds per-tick metrics into them, and a live
``Ringpop`` meters its request planes and times its protocol periods),
``NullStatsd`` and ``CapturingStatsd`` (a live node's statsd client and
its test double) and ``NullLogger`` (the trace host,
``obs.sim_tap.SimTracerHost``, logs to it unless given a logger); the
port keeps its own copy so that it imports nothing of the JAX package.

The reference pulls these from the npm ``metrics`` package — Meters for
client/server/total request rates (index.js:158-160) and a Histogram of
protocol-period timing that feeds the adaptive gossip delay
(lib/gossip/index.js:37,52-55).  Rebuilt minimally here: an exponentially
weighted moving-average meter and a bounded-reservoir histogram with
percentile queries.
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Any, Dict, List, Optional


class Meter:
    """Events/second with 1/5/15-minute EWMAs."""

    TICK_S = 5.0

    def __init__(self, now=time.time):
        self._now = now
        self._start = now()
        self._last_tick = self._start
        self._count = 0
        self._uncounted = 0
        self._rates = {60: 0.0, 300: 0.0, 900: 0.0}
        self._initialized = False
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self._tick_if_needed()
            self._count += n
            self._uncounted += n

    def _tick_if_needed(self) -> None:
        now = self._now()
        while now - self._last_tick >= self.TICK_S:
            inst = self._uncounted / self.TICK_S
            self._uncounted = 0
            for window in self._rates:
                alpha = 1 - math.exp(-self.TICK_S / window)
                if not self._initialized:
                    self._rates[window] = inst
                else:
                    self._rates[window] += alpha * (inst - self._rates[window])
            self._initialized = True
            self._last_tick += self.TICK_S

    def mean_rate(self) -> float:
        elapsed = self._now() - self._start
        return self._count / elapsed if elapsed > 0 else 0.0

    def one_minute_rate(self) -> float:
        with self._lock:
            self._tick_if_needed()
            return self._rates[60]

    def five_minute_rate(self) -> float:
        with self._lock:
            self._tick_if_needed()
            return self._rates[300]

    def fifteen_minute_rate(self) -> float:
        with self._lock:
            self._tick_if_needed()
            return self._rates[900]

    def to_dict(self) -> Dict[str, float]:
        return {
            "count": self._count,
            "m1": self.one_minute_rate(),
            "m5": self.five_minute_rate(),
            "m15": self.fifteen_minute_rate(),
            "meanRate": self.mean_rate(),
        }


class Histogram:
    """Reservoir-sampled value distribution with percentile queries."""

    def __init__(self, size: int = 1028, rng: Optional[random.Random] = None):
        self._size = size
        self._values: List[float] = []
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._sum = 0.0
        self._rng = rng or random.Random()
        self._lock = threading.Lock()

    def update(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            self._min = value if self._min is None else min(self._min, value)
            self._max = value if self._max is None else max(self._max, value)
            if len(self._values) < self._size:
                self._values.append(value)
            else:
                idx = self._rng.randrange(self._count)
                if idx < self._size:
                    self._values[idx] = value

    def percentiles(self, ps) -> Dict[float, Optional[float]]:
        with self._lock:
            values = sorted(self._values)
        out: Dict[float, Optional[float]] = {}
        for p in ps:
            if not values:
                out[p] = None
                continue
            pos = p * (len(values) + 1)
            if pos < 1:
                out[p] = values[0]
            elif pos >= len(values):
                out[p] = values[-1]
            else:
                lower = values[int(pos) - 1]
                upper = values[int(pos)]
                out[p] = lower + (pos - int(pos)) * (upper - lower)
        return out

    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def to_dict(self) -> Dict[str, Any]:
        pct = self.percentiles([0.5, 0.75, 0.95, 0.99, 0.999])
        return {
            "count": self._count,
            "min": self._min,
            "max": self._max,
            "mean": self.mean(),
            "p50": pct[0.5],
            "p75": pct[0.75],
            "p95": pct[0.95],
            "p99": pct[0.99],
            "p999": pct[0.999],
        }


class NullStatsd:
    """No-op statsd client (lib/nulls.js analog)."""

    def increment(self, key: str, value: int = 1) -> None:
        pass

    def gauge(self, key: str, value: Any) -> None:
        pass

    def timing(self, key: str, value: Any) -> None:
        pass


class CapturingStatsd:
    """Test double recording every emission."""

    def __init__(self):
        self.records: List[tuple] = []

    def increment(self, key: str, value: int = 1) -> None:
        self.records.append(("increment", key, value))

    def gauge(self, key: str, value: Any) -> None:
        self.records.append(("gauge", key, value))

    def timing(self, key: str, value: Any) -> None:
        self.records.append(("timing", key, value))


class NullLogger:
    """No-op structured logger (lib/nulls.js analog)."""

    def debug(self, *a, **k):
        pass

    def info(self, *a, **k):
        pass

    def warning(self, *a, **k):
        pass

    warn = warning

    def error(self, *a, **k):
        pass
