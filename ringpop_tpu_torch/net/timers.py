"""Timer service: schedulable delayed callbacks with a fake-time twin.

A copy of ``ringpop_tpu/net/timers.py``: the port's trace host
(``obs.sim_tap.SimTracerHost``) schedules ``TracerStore``'s expiry on it.

The reference leans on the Node event loop's ``setTimeout`` for every
protocol clock — gossip periods (lib/gossip/index.js:68), suspicion timers
(lib/gossip/suspicion.js:58-76), proxy retry schedules (lib/request-proxy/
send.js:210-228) — and its tests swap in mock timers to advance time by hand
(test/lib/alloc-ringpop.js:24-63 wires time-mock).  This module is the same
split: ``Timers`` drives real ``threading.Timer`` objects; ``FakeTimers``
holds a virtual clock that tests step with ``advance()``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Tuple


class Timers:
    """Real timers backed by ``threading.Timer``."""

    def set_timeout(self, fn: Callable[[], None], delay_s: float):
        t = threading.Timer(delay_s, fn)
        t.daemon = True
        t.start()
        return t

    def clear_timeout(self, handle) -> None:
        if handle is not None:
            handle.cancel()

    def now_ms(self) -> int:
        return int(time.time() * 1000)

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeTimers(Timers):
    """Virtual clock; pending callbacks fire on ``advance()``."""

    def __init__(self, start_ms: int = 1414142122274):
        self._now_ms = start_ms
        self._pending: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self._lock = threading.Lock()

    def set_timeout(self, fn: Callable[[], None], delay_s: float):
        with self._lock:
            self._seq += 1
            entry = (self._now_ms + delay_s * 1000.0, self._seq, fn)
            self._pending.append(entry)
            return entry

    def clear_timeout(self, handle) -> None:
        with self._lock:
            try:
                self._pending.remove(handle)
            except ValueError:
                pass

    def now_ms(self) -> int:
        return int(self._now_ms)

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> int:
        """Move the clock forward, firing due callbacks in time order.
        Returns the number of callbacks fired."""
        target = self._now_ms + seconds * 1000.0
        fired = 0
        while True:
            with self._lock:
                due = [e for e in self._pending if e[0] <= target]
                if not due:
                    self._now_ms = target
                    return fired
                due.sort(key=lambda e: (e[0], e[1]))
                entry = due[0]
                self._pending.remove(entry)
                self._now_ms = max(self._now_ms, entry[0])
            entry[2]()
            fired += 1
