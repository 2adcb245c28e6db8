"""The largest ``torch.cuda.max_memory_allocated()`` over the ranks, the
peak reset before the model was built: weights, optimizer state, residuals,
activations and the CUDA graphs' pools."""


def read(run):
    if not any(r["peak_bytes"] for r in run.records):
        return None
    return max(r["peak_bytes"] for r in run.records) / 2**30
