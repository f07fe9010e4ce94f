"""The reference runs in one process: a collective is the identity."""


def all_reduce(t, group=None):
    return t
