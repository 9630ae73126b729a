"""Measurement scripts for the port's kernels (they need a CUDA card)."""
