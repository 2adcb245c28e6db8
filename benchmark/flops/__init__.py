"""FLOP counters, one a model family: ``forward_macs(config)``, the
multiply-adds of every convolution and linear layer of one image's forward
pass, counted from the configuration's layer table (batch norm, pooling
and elementwise work are not counted). A training step does three times a
forward pass's work: the forward, and the backward's products for the
inputs and for the weights, at 2 FLOPs a multiply-add."""


def train_flops_per_image(macs: int) -> int:
    return 3 * 2 * macs
