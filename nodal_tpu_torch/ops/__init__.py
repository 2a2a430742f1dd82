"""Device-side operations: assembly, solves, and the wrappers of the CUDA
kernels."""
