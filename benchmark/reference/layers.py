"""The layers the plain references share, in plain PyTorch.

A reference computes in float32 (``"fp32"``; the caller turns TF32 off),
or, as the control of a cell whose configuration computes in bfloat16, in
float8 (``"fp8"``): each operand of a convolution or a linear layer
rounded to ``float8_e4m3fn`` in the forward pass and each gradient that
flows back through it to ``float8_e5m2``, both under a per-tensor scale
that maps the tensor's largest magnitude to the format's largest value (the
usual fp8 training recipe), the products then taken in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")


def _to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    top = torch.finfo(dtype).max
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x * scale).to(dtype).to(x.dtype)) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _to_fp8(grad, torch.float8_e5m2)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of a ``SAME`` window: the output has
    ``ceil(size / stride)`` positions, the odd pixel of padding goes
    high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW) padded for a ``SAME`` window of ``kernel``/``stride``."""
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def conv(x: torch.Tensor, weight: torch.Tensor, bias, stride: int,
         padding, precision: str) -> torch.Tensor:
    """A convolution; ``padding`` ``"SAME"`` or a symmetric int."""
    if padding == "SAME":
        x = pad_same(x, weight.shape[-1], stride)
        padding = 0
    return F.conv2d(operand(x, precision), operand(weight, precision),
                    bias, stride=stride, padding=padding)


def linear(x: torch.Tensor, weight: torch.Tensor, bias,
           precision: str) -> torch.Tensor:
    return F.linear(operand(x, precision), operand(weight, precision), bias)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Training-mode batch norm: normalized by the batch's mean and biased
    variance over (N, H, W); the running statistics play no part in
    it."""
    return F.batch_norm(x, None, None, weight, bias, training=True,
                        momentum=0.0, eps=eps)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(pad_same(x, kernel, stride, value=-math.inf),
                        kernel, stride)
