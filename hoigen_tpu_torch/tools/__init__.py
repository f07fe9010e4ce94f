"""Measurement scripts for the port's kernels, each of which runs on one
CUDA card, and writers of synthetic inputs (datasets on disk, checkpoint
files) for the tests and ``chip_smoke.py``."""
