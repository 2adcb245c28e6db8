"""Images trained by all ranks in the window over the window's wall time
(host clock; the window ends after ``torch.cuda.synchronize()``); the
slowest rank's window."""


def read(run):
    return run.images_per_s()
