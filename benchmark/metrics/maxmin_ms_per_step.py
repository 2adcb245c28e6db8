"""Device ms a step in the max-min kernels B1, B3 and B4 (their names in
``kernel_work``), the largest over the ranks."""


def read(run):
    work = run.kernel_work
    if work is None:
        return None
    per_rank = []
    for rank in run.records:
        t = rank.get("trace")
        if not t or not t["device"]:
            continue
        us = sum(end - start for name, cat, start, end in t["device"]
                 if cat == "kernel" and work.kernel_of(name))
        if us:
            per_rank.append(us / 1e3 / rank["traced_steps"])
    return max(per_rank) if per_rank else None
