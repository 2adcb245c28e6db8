"""Device ms a step in NCCL's kernels (``nccl*``) that no other kernel,
copy or memset on the card overlaps: the exchange's time not hidden behind
the backward pass, the largest over the ranks."""

import trace_read


def read(run):
    per_rank = []
    for rank in run.records:
        t = rank.get("trace")
        if not t or not t["device"]:
            continue
        nccl = [(s, e) for name, cat, s, e in t["device"]
                if cat == "kernel" and name.lower().startswith("nccl")]
        if not nccl:
            continue
        other = [(s, e) for name, cat, s, e in t["device"]
                 if not (cat == "kernel" and name.lower().startswith("nccl"))]
        per_rank.append(trace_read.minus(nccl, other) / 1e3 /
                        rank["traced_steps"])
    return max(per_rank) if per_rank else None
