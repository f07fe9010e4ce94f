"""The whole step: the model FLOPs of the window's steps at each
precision's peak over the window, in %."""
from hoibench.readers import step_mfu


def read(runs):
    return step_mfu(runs)
