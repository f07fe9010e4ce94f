"""The 90th percentile of every batch's time in the window, from its
hand-off to its outputs on the host (ms)."""
import numpy as np


def read(runs):
    times = [t for r in runs for t in r.batch_ms]
    return float(np.percentile(times, 90)) if times else None
