"""The data layer: the mean wait (ms) of a training step for its batch,
a span around each next() on the batch stream."""
from hoibench.readers import span_ms


def read(runs):
    return span_ms(runs, "loader_wait")
