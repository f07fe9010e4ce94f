"""The eval step's host time a call (ms): a span around each call into
the graphed eval step, from call to return."""
from hoibench.readers import span_ms


def read(runs):
    return span_ms(runs, "eval_call")
