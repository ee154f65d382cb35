"""Central config store.

A copy of ``ringpop_tpu/utils/config.py``.  It mirrors the reference's
``config.js`` (ringpop-node config.js:29-104): a key/value store seeded
from constructor options with per-key validators and defaults, emitting
``set`` and ``set.<key>`` events on mutation, plus the protocol-constant
knobs that the reference passes as plain constructor options
(ringpop-node index.js:112-120), in :class:`ProtocolParams`.  The trace
host (``obs.sim_tap.SimTracerHost``) publishes through the
:class:`EventEmitter`; a live ``Ringpop`` and the parity oracle's
per-node context hold a :class:`Config`.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional


class EventEmitter:
    """Minimal synchronous event emitter (the reference leans on Node's)."""

    def __init__(self) -> None:
        self._listeners: Dict[str, List[Callable[..., Any]]] = {}

    def on(self, event: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        self._listeners.setdefault(event, []).append(fn)
        return fn

    def once(self, event: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        def wrapper(*args: Any, **kw: Any) -> Any:
            self.remove_listener(event, wrapper)
            return fn(*args, **kw)

        wrapper.__wrapped__ = fn  # type: ignore[attr-defined]
        return self.on(event, wrapper)

    def remove_listener(self, event: str, fn: Callable[..., Any]) -> None:
        fns = self._listeners.get(event, [])
        for cand in list(fns):
            if cand is fn or getattr(cand, "__wrapped__", None) is fn:
                fns.remove(cand)

    def remove_all_listeners(self, event: Optional[str] = None) -> None:
        if event is None:
            self._listeners.clear()
        else:
            self._listeners.pop(event, None)

    def emit(self, event: str, *args: Any, **kw: Any) -> None:
        for fn in list(self._listeners.get(event, [])):
            fn(*args, **kw)

    def listener_count(self, event: str) -> int:
        return len(self._listeners.get(event, []))


def _num_validator(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and not (
        isinstance(v, float) and math.isnan(v)
    )


def _blacklist_validator(vals: Any) -> bool:
    if not isinstance(vals, (list, tuple)):
        return False
    return all(isinstance(v, re.Pattern) for v in vals)


class Config(EventEmitter):
    """Key/value config store with seeded defaults and validators.

    Defaults follow ringpop-node config.js:54-98 exactly (including
    ``TEST_KEY``, which tests and lives depend on).
    """

    DEFAULTS: List[tuple] = [
        ("TEST_KEY", 100, None, None),
        ("autoGossip", True, None, None),
        ("dampScoringEnabled", True, None, None),
        ("dampScoringDecayEnabled", True, None, None),
        ("dampScoringDecayInterval", 1000, None, None),
        ("dampScoringHalfLife", 60, None, None),
        ("dampScoringInitial", 0, None, None),
        ("dampScoringMax", 10000, None, None),
        ("dampScoringMin", 0, None, None),
        ("dampScoringPenalty", 500, None, None),
        ("dampScoringReuseLimit", 2500, None, None),
        ("dampScoringSuppressDuration", 60 * 60 * 1000, None, None),
        ("dampScoringSuppressLimit", 5000, None, None),
        (
            "memberBlacklist",
            [],
            _blacklist_validator,
            "expected to be array of RegExp objects",
        ),
        ("maxJoinAttempts", 50, _num_validator, None),
    ]

    def __init__(self, ringpop: Any = None, seed: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.ringpop = ringpop
        self.store: Dict[str, Any] = {}
        self._seed(seed or {})

    def get(self, key: str) -> Any:
        return self.store.get(key)

    def get_all(self) -> Dict[str, Any]:
        return self.store

    def set(self, key: str, value: Any) -> None:
        old = self.store.get(key)
        self.store[key] = value
        self.emit("set", key, value, old)
        self.emit("set." + key, value, old)

    def _seed(self, seed: Dict[str, Any]) -> None:
        for name, default, validator, reason in self.DEFAULTS:
            if isinstance(default, (list, dict)):
                default = default.copy()  # fresh per instance, like JS's []
            if name not in seed:
                self.set(name, default)
            elif validator is not None and not validator(seed[name]):
                if self.ringpop is not None and getattr(self.ringpop, "logger", None):
                    self.ringpop.logger.warning(
                        "ringpop using default value for config after being "
                        "passed invalid seed value",
                        extra={
                            "config": name,
                            "seedVal": repr(seed[name]),
                            "defaultVal": default,
                            "reason": reason,
                        },
                    )
                self.set(name, default)
            else:
                self.set(name, seed[name])


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    """Protocol constants, expressed in discrete simulation ticks.

    The reference is timer-driven; the simulator maps wall-clock knobs onto a
    discrete-time model where one tick == one gossip protocol period
    (>= 200 ms, ringpop-node lib/gossip/index.js:194-196).  Timeouts become
    tick counts via ceil(ms / protocol_period_ms).

    Reference values: joinSize/pingReqSize/parallelismFactor and timeouts at
    ringpop-node index.js:112-120, lib/gossip/join-sender.js:51-66,
    suspicion at lib/gossip/suspicion.js:111-113, replica points at
    lib/ring/index.js:28, piggyback factor at lib/gossip/dissemination.js:41.
    """

    join_size: int = 3
    ping_req_size: int = 3
    join_parallelism_factor: int = 2
    replica_points: int = 100
    piggyback_factor: int = 15
    min_protocol_period_ms: int = 200
    ping_timeout_ms: int = 1500
    ping_req_timeout_ms: int = 5000
    join_timeout_ms: int = 1000
    suspicion_timeout_ms: int = 5000
    proxy_req_timeout_ms: int = 30000
    max_join_duration_ms: int = 300000
    max_join_attempts: int = 50

    @property
    def suspicion_timeout_ticks(self) -> int:
        return max(1, math.ceil(self.suspicion_timeout_ms / self.min_protocol_period_ms))

    def max_piggyback_count(self, server_count: int) -> int:
        # 15 * ceil(log10(n + 1)) — lib/gossip/dissemination.js:41
        return self.piggyback_factor * math.ceil(math.log10(server_count + 1)) if server_count >= 0 else self.piggyback_factor

    @staticmethod
    def default_max_piggyback_count() -> int:
        # Dissemination.Defaults.maxPiggybackCount — dissemination.js:179
        return 1
