"""sband_roofline: the scalar-band kernel's share of its roofline, %, bound
by bytes over 3.35 TB/s (mesh1k.mc16k; moves solves_per_s)."""

from portbench.layers import sband_roofline as read  # noqa: F401
