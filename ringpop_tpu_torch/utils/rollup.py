"""Membership update rollup (lib/membership/rollup.js rebuilt).

Buffers membership updates per address and flushes one batched debug-log
entry after a quiet interval (5 s, index.js:68) instead of logging every
gossip-storm update individually.  Buffer is force-flushed when it grows
past ``MAX_NUM_UPDATES`` (250, rollup.js:26) distinct addresses.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from ringpop_tpu_torch.utils.config import EventEmitter

MAX_NUM_UPDATES = 250  # rollup.js:26
DEFAULT_FLUSH_INTERVAL_MS = 5000  # index.js:68


class MembershipUpdateRollup(EventEmitter):
    def __init__(self, ringpop: Any, flush_interval_ms: int = DEFAULT_FLUSH_INTERVAL_MS,
                 max_num_updates: int = MAX_NUM_UPDATES):
        super().__init__()
        self.ringpop = ringpop
        self.flush_interval_ms = flush_interval_ms
        self.max_num_updates = max_num_updates
        self.buffer: Dict[str, List[dict]] = {}
        self.first_update_time: float = 0
        self.last_flush_time: float = 0
        self.last_update_time: float = 0
        self.flush_timer = None

    def _num_updates(self) -> int:
        return sum(len(v) for v in self.buffer.values())

    def track_updates(self, updates) -> None:
        if not updates:
            return
        since_last = (
            time.time() * 1000.0 - self.last_update_time
            if self.last_update_time
            else 0
        )
        if since_last >= self.flush_interval_ms:
            self.renew_buffer()
        if not self.buffer:
            self.first_update_time = time.time() * 1000.0
        for update in updates:
            d = update.to_dict() if hasattr(update, "to_dict") else dict(update)
            self.buffer.setdefault(d["address"], []).append(d)
        if self._num_updates() >= self.max_num_updates:
            self.flush_buffer()
        else:
            self._restart_flush_timer()
        self.last_update_time = time.time() * 1000.0

    def renew_buffer(self) -> None:
        self.flush_buffer()

    def _restart_flush_timer(self) -> None:
        if self.flush_timer is not None:
            self.ringpop.timers.clear_timeout(self.flush_timer)
        self.flush_timer = self.ringpop.timers.set_timeout(
            self.flush_buffer, self.flush_interval_ms / 1000.0
        )

    def flush_buffer(self) -> None:
        if self.flush_timer is not None:
            self.ringpop.timers.clear_timeout(self.flush_timer)
            self.flush_timer = None
        if not self.buffer:
            return
        now = time.time() * 1000.0
        since_flush = now - self.last_flush_time if self.last_flush_time else None
        self.ringpop.logger.debug(
            "ringpop membership update rollup",
            extra={
                "local": self.ringpop.whoami(),
                "updateCount": self._num_updates(),
                "checksum": self.ringpop.membership.checksum,
                "sinceFirstUpdate": now - self.first_update_time,
                "sinceLastFlush": since_flush,
                "updates": self.buffer,
            },
        )
        self.buffer = {}
        self.last_flush_time = now
        self.emit("flushed")

    def destroy(self) -> None:
        if self.flush_timer is not None:
            self.ringpop.timers.clear_timeout(self.flush_timer)
            self.flush_timer = None
