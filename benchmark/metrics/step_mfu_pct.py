"""The traced steps' model FLOPs (the training FLOPs an image of
``flops/`` times the images) over the traced window's length times the
cards' dense bf16 peak, in percent, the mean over the ranks: the whole
step's share of the peak, which bounds what any kernel's roofline share can
buy."""


def read(run):
    if not run.peaks:
        return None
    shares = []
    for rank in run.records:
        t = rank.get("trace")
        if not t or not t["device"]:
            continue
        flops = run.flops_per_image * run.batch * rank["traced_steps"]
        shares.append(flops / (t["window_us"] * 1e-6) /
                      run.peaks["bf16_flops"])
    return 100.0 * sum(shares) / len(shares) if shares else None
