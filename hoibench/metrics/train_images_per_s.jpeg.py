"""The images of every training step completed in the window, fed from
the files, over the window (images/s)."""
from hoibench.readers import images_per_s


def read(runs):
    return images_per_s(runs)
