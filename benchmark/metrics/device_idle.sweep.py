"""device_idle.sweep: share of the traced calls' host span with nothing on
the device, % (mesh1k.mc16k; moves solves_per_s)."""

from portbench.layers import device_idle as read  # noqa: F401
