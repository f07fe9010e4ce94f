"""Set-up: from the process's start to the window's, the slowest
process's (s)."""


def read(runs):
    return max(r.setup_s for r in runs)
