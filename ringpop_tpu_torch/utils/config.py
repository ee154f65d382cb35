"""The event emitter of the reference's config store.

A copy of the ``EventEmitter`` class of ``ringpop_tpu/utils/config.py``
(the class alone: the port's trace host, ``obs.sim_tap.SimTracerHost``,
publishes its ``tickMetrics`` / ``flightEvents`` through one; the JAX
module's ``Config`` store serves the live node and is not copied).
"""

from __future__ import annotations

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
