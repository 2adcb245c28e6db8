"""The max-min kernels' share of their roofline over the traced window:
the sum over the launches of B1, B3 and B4 of each launch's least time
(its bytes at the card's memory rate or its fp32 operations at the fp32
rate, whichever is longer; ``kernel_work``) over the sum of their device
times, every rank's launches together, in percent.

A launch's bytes follow from the step's shapes, so the reader holds the
trace to them: every traced step must have launched each kernel as often as
``kernel_work.step_launches`` gives. Where it did not, the reader reads
nothing."""

import collections


def read(run):
    work = run.kernel_work
    if work is None or not run.peaks:
        return None
    red = run.cell.traffic["reducer"]
    launches = work.step_launches(run.cell.config["params"], run.world,
                                  red["bits"], red["bucket_size"])
    per_step = collections.Counter(name for name, _, _ in launches)
    least = sum(work.least_seconds(b, ops, run.peaks)
                for _, b, ops in launches)
    want_s = spent_s = 0.0
    for rank in run.records:
        t = rank.get("trace")
        if not t or not t["device"]:
            continue
        seen = collections.Counter()
        for name, cat, start, end in t["device"]:
            wrapper = work.kernel_of(name) if cat == "kernel" else None
            if wrapper:
                seen[wrapper] += 1
                spent_s += (end - start) * 1e-6
        steps = rank["traced_steps"]
        if seen != {k: v * steps for k, v in per_step.items()}:
            return None
        want_s += least * steps
    return 100.0 * want_s / spent_s if spent_s else None
