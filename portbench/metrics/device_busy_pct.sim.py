"""The union of device records over the traced window, in percent."""

from portbench.lib.readers import device_busy_pct as read  # noqa: F401
