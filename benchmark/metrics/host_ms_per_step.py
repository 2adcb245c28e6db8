"""The host's enqueue time of a step: the host clock around one step call
started on an idle device, with no synchronize inside, the median of the
probed steps, the largest over the ranks."""

import statistics


def read(run):
    probes = [statistics.median(r["host_ms"]) for r in run.records
              if r.get("host_ms")]
    return max(probes) if probes else None
