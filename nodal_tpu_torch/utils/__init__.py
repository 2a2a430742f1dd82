"""Utilities: netlist generators, the device check, the CUDA kernel build
and the spans and counters of the hot paths (``tracing``)."""
