"""The training step's host time a call (ms): a span around each call
into the graphed step (weight check, input staging, replay enqueue)."""
from hoibench.readers import span_ms


def read(runs):
    return span_ms(runs, "train_call")
