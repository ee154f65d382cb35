"""One generator for every churn mix: kill waves and their revives.

A mix (``traffic/<mix>.json``) is data::

    {"chunk_ticks": 40, "period": 10, "phase": 5,
     "kill_fraction": 0.005, "revive_after": 40, "draw": "live"}

Wave ``w`` kills ``max(1, int(n * kill_fraction))`` nodes at tick
``phase + w * period`` (``kill_fraction`` 0 means no waves) and revives the
same nodes ``revive_after`` ticks later.  Its victims are drawn from
``numpy.random.default_rng([seed, w])``: from every node (``"any"``) or
from the nodes that are up at that tick and not being revived at it
(``"live"``).  Ticks count from the first tick of chunk 0; chunk ``c``
covers ticks ``[c * chunk_ticks, (c + 1) * chunk_ticks)``.  So every seed
gets the same sizes and the same arrivals; only which nodes differ.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

KEYS = ("chunk_ticks", "period", "phase", "kill_fraction", "revive_after", "draw")


class ChurnPlan:
    """The kill/revive plan of one mix for ``n`` nodes from ``seed``."""

    def __init__(self, mix: dict, n: int, seed: int):
        missing = [k for k in KEYS if k not in mix]
        if missing:
            raise ValueError("traffic mix lacks %s" % ", ".join(missing))
        if mix["draw"] not in ("any", "live"):
            raise ValueError("draw must be 'any' or 'live', got %r" % (mix["draw"],))
        self.mix, self.n, self.seed = dict(mix), n, int(seed)
        self.chunk_ticks = int(mix["chunk_ticks"])
        self.period = int(mix["period"])
        self.phase = int(mix["phase"])
        self.kill_fraction = float(mix["kill_fraction"])
        self.revive_after = int(mix["revive_after"])
        self.draw = mix["draw"]
        if self.chunk_ticks < 1 or self.period < 1 or self.phase < 0 or self.revive_after < 1:
            raise ValueError("chunk_ticks, period and revive_after must be >= 1, phase >= 0")
        self.kills = max(1, int(n * self.kill_fraction)) if self.kill_fraction > 0 else 0
        self._victims: Dict[int, np.ndarray] = {}
        self._rows_set: Dict[int, set] = {}

    def wave_tick(self, w: int) -> int:
        return self.phase + w * self.period

    def victims(self, w: int) -> np.ndarray:
        """Wave ``w``'s victims, sorted (drawn once, then remembered)."""
        if w not in self._victims:
            rng = np.random.default_rng([self.seed, w])
            if self.draw == "live":
                t = self.wave_tick(w)
                down = np.zeros(self.n, bool)
                # waves whose [kill, revive] interval holds t are down or
                # come back at t: a live draw skips them
                first = max(0, -(-(t - self.revive_after - self.phase) // self.period))
                for v in range(first, w):
                    down[self.victims(v)] = True
                pool = np.flatnonzero(~down)
            else:
                pool = np.arange(self.n)
            pick = rng.choice(pool.size, size=min(self.kills, pool.size), replace=False)
            self._victims[w] = np.sort(pool[pick])
        return self._victims[w]

    def _waves_killed_in(self, t0: int, t1: int):
        if self.kills == 0:
            return range(0)
        lo = max(0, -(-(t0 - self.phase) // self.period))
        hi = max(0, -(-(t1 - self.phase) // self.period))
        return range(lo, hi)

    def prepare(self, first: int, count: int) -> None:
        """Draw the victims of chunks ``[first, first + count)`` now (in
        set-up), so that :meth:`fill` only writes them."""
        t0, t1 = first * self.chunk_ticks, (first + count) * self.chunk_ticks
        for w in self._waves_killed_in(t0 - self.revive_after, t1):
            self.victims(w)

    def chunk(self, c: int):
        """``(kill, revive)``: ``[chunk_ticks, n]`` bool plans of chunk ``c``."""
        kill = np.zeros((self.chunk_ticks, self.n), bool)
        revive = np.zeros((self.chunk_ticks, self.n), bool)
        self.fill(c, kill, revive)
        return kill, revive

    def fill(self, c: int, kill: np.ndarray, revive: np.ndarray) -> None:
        """Write chunk ``c``'s plans into ``kill`` / ``revive``: zero, or
        as the previous :meth:`fill` into the same arrays left them (only
        the rows it set are cleared)."""
        for a in (kill, revive):
            rows = self._rows_set.pop(id(a), None)
            if rows:
                a[sorted(rows)] = False
        t0 = c * self.chunk_ticks
        t1 = t0 + self.chunk_ticks
        set_k, set_r = set(), set()
        for w in self._waves_killed_in(t0, t1):
            kill[self.wave_tick(w) - t0, self.victims(w)] = True
            set_k.add(self.wave_tick(w) - t0)
        for w in self._waves_killed_in(t0 - self.revive_after, t1 - self.revive_after):
            revive[self.wave_tick(w) + self.revive_after - t0, self.victims(w)] = True
            set_r.add(self.wave_tick(w) + self.revive_after - t0)
        self._rows_set[id(kill)], self._rows_set[id(revive)] = set_k, set_r
        # forget waves whose revive lies behind this chunk
        for w in [w for w in self._victims if self.wave_tick(w) + self.revive_after < t0]:
            del self._victims[w]

    def down_after(self, c: int) -> np.ndarray:
        """[n] bool: the nodes the plan holds down at the end of chunk
        ``c`` (killed, not yet revived), from an all-up start."""
        t1 = (c + 1) * self.chunk_ticks
        down = np.zeros(self.n, bool)
        fresh = ChurnPlan(self.mix, self.n, self.seed)
        for w in self._waves_killed_in(0, t1):
            if self.wave_tick(w) + self.revive_after >= t1:
                down[fresh.victims(w)] = True
        return down
