"""Kernel records a tick in the traced window."""

from portbench.lib.readers import launches_per_tick as read  # noqa: F401
