"""device_idle.host: share of the traced calls' host span with nothing on
the device, % (grid1024.knight; moves call_ms_p95.host)."""

from portbench.layers import device_idle as read  # noqa: F401
