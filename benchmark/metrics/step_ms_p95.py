"""The 95th percentile (nearest rank) of the durations of every step of
the window on every rank: the gaps between CUDA events recorded on the
step's stream after consecutive steps, read after the window."""

import math


def read(run):
    steps = sorted(ms for r in run.records for ms in r["step_ms"])
    return steps[math.ceil(0.95 * len(steps)) - 1]
