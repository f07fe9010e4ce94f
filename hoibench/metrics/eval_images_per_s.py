"""The images whose outputs reached the host in the window, over the
window (images/s)."""
from hoibench.readers import images_per_s


def read(runs):
    return images_per_s(runs)
