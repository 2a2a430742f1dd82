"""Utilities: netlist generators, the device check and the CUDA kernel
build."""
