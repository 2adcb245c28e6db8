"""The share of the traced window in which no kernel, copy or memset ran
on the card (the union of the device's intervals), the largest over the
ranks, in percent."""

import trace_read


def read(run):
    shares = [1.0 - trace_read.length((d[2], d[3]) for d in t["device"]) /
              t["window_us"] for t in run.traces() if t["device"]]
    return 100.0 * max(shares) if shares else None
