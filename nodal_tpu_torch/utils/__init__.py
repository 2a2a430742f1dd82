"""Utilities: netlist generators and the CUDA kernel build."""
