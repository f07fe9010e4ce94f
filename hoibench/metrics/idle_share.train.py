"""The device: the traced window's idle share, 1 - busy / window, in %,
from torch.profiler."""
from hoibench.readers import idle_share


def read(runs):
    return idle_share(runs)
