"""The captures the graphed training step made inside the window
(``GraphedTrainStep.records()``, the program's own counter): each change
of batch signature runs an eager step and captures again."""


def read(runs):
    counts = [r.counters["graph_captures"] for r in runs
              if "graph_captures" in r.counters]
    return float(max(counts)) if counts else None
