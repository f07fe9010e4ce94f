"""Measurement scripts for the port's kernels; each runs on one CUDA card."""
