"""Dense fault-schedule machinery shared by the port's cluster loops.

Counterpart of ``ringpop_tpu/models/sim/schedule.py``: ``as_inputs()``
converts a schedule's host numpy planes into the engine's input tuple ONCE
per device and memoizes the tensors (re-running one schedule — warm, then
measure — must not re-upload ``[T, N]`` planes every run), so a schedule
is frozen at its first run; ``invalidate()`` drops the memo after
mutating the planes.  ``window(t0, t1)`` slices ticks ``[t0, t1)`` into a
new schedule (the checkpoint cadence and the crash harness), which reads
its parent's memoized device inputs as views.
"""

from __future__ import annotations

import dataclasses


class DeviceScheduleMixin:
    """Memoized ``as_inputs(device)``/``invalidate()`` over
    ``_build_inputs(device)``."""

    def window(self, t0: int, t1: int):
        """A new schedule holding ticks ``[t0, t1)`` of this one — the
        checkpoint-cadence/crash-resume slice (``recovery._run_chunked``,
        ``fuzz/crash.py``).  Dense ``[T, N]`` planes are sliced and copied
        (mutating the window never leaks into the parent or the reverse);
        ``None`` planes stay ``None``."""
        if not (0 <= t0 <= t1 <= self.ticks):
            raise ValueError(
                "window [%d, %d) outside schedule of %d ticks" % (t0, t1, self.ticks)
            )
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v[t0:t1].copy() if hasattr(v, "ndim") else v
        kw["ticks"] = t1 - t0
        out = type(self)(**kw)
        # inputs this schedule already holds on a device: the window reads
        # slices of them instead of uploading its planes again
        cached = self.__dict__.get("_device_inputs", {})
        out.__dict__["_device_inputs"] = {
            key: type(inp)(*(None if x is None else x[t0:t1] for x in inp))
            for key, inp in cached.items()
        }
        return out

    def as_inputs(self, device="cpu"):
        """Engine input tuple of ``[T, N]`` tensors on ``device``
        (memoized: mutate the planes before the first run, or call
        :meth:`invalidate` after)."""
        cache = self.__dict__.setdefault("_device_inputs", {})
        key = str(device)
        if key not in cache:
            cache[key] = self._build_inputs(device)
        return cache[key]

    def invalidate(self) -> None:
        """Drop the memoized inputs after mutating the schedule."""
        self.__dict__.pop("_device_inputs", None)

    def _build_inputs(self, device):
        raise NotImplementedError
