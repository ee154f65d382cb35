"""Device ms a tick of the records that are not the port's own kernels."""

from portbench.lib.readers import engine_device_ms_per_tick as read  # noqa: F401
