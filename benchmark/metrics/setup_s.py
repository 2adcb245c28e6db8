"""Rank 0's seconds from its process's start to the first timed step:
imports, the runtime's init, the kernels' load (and build, in a
checkout's first run), the weights, the checked steps (warm-up and
capture among them) and the steps that size the window."""


def read(run):
    return run.records[0]["setup_s"]
