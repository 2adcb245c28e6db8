"""The window's model FLOP/s (images/s times the model's training FLOPs
an image: 3 x 2 x the forward multiply-adds of every convolution and
linear layer, ``flops/``) over the cards' dense bf16 peak, in percent."""


def read(run):
    if not run.peaks:
        return None
    return 100.0 * run.images_per_s() * run.flops_per_image / (
        run.peaks["bf16_flops"] * run.world)
