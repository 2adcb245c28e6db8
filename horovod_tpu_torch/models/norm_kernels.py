"""Batch norm with the ReLU and the residual add that follow it: the CUDA
kernels of ``csrc/batch_norm.cu``, their plain PyTorch version and launch
counts.

``batch_norm_act(x, ...)`` computes ``act(batch_norm(x) [+ residual])``
with flax's statistics (``models/resnet.py``'s ``BatchNorm``: momentum on
the old running statistic, the biased batch variance folded into the
running variance), ``act`` ReLU or none. For a tensor on the CPU it runs
the plain version, which is the models' arithmetic before the kernels:
``F.batch_norm`` on copies of the running statistics, flax's fix-up of the
running variance, ``+`` and ``F.relu``. For a CUDA tensor it runs the
kernels through :class:`BatchNormAct`, a ``torch.autograd.Function``, and
raises for any other device: there is no fallback.

On CUDA a training call is two passes over x (the statistics, then the
apply, which also reads the residual and applies the ReLU) and its backward
two more (the reduce, then dx); each reduction ends in a small finalize
launch over its fp32 partials. Backward keeps x, the per-channel mean and
inverse std and, under ReLU after a residual add, the output z (ReLU's
mask is ``z > 0``; under ReLU alone the kernels recompute the
pre-activation from x): no pre-activation, no mask. Activations are
viewed as ``[rows, C]`` rows of channels (a channels-last ``[N, C, H, W]``
as it is; any other layout is copied into one), C a multiple of 8; x, the
residual and the output share fp32, bf16 or fp16, the parameters and
running statistics are fp32.

``LAUNCHES`` counts launches by kernel, in Python, so the replay of a step
captured in a CUDA graph adds nothing to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils import cuda_build

LAUNCHES: Dict[str, int] = {
    "bn_stats": 0,
    "bn_stats_finalize": 0,
    "bn_apply": 0,
    "bn_bwd_reduce": 0,
    "bn_bwd_finalize": 0,
    "bn_bwd_apply": 0,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_VEC = 8  # channels a thread moves: C must be a multiple of it


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.lib()
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_float)
    lib.hvd_bn_chunks.argtypes = [i64, i32, i32]
    lib.hvd_bn_stats.argtypes = [ptr, i32, i64, i32, i32, ptr, ptr]
    lib.hvd_bn_stats_finalize.argtypes = [ptr, i32, i64, i32, ptr, i32, f32,
                                          f32, ptr, ptr, ptr, ptr, ptr]
    lib.hvd_bn_apply.argtypes = [ptr, ptr, ptr, i32, i64, i32, ptr, ptr, i32,
                                 f32, ptr, ptr, i32, ptr]
    lib.hvd_bn_bwd_reduce.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, i32,
                                      ptr, ptr, i32, f32, ptr, ptr, i32, ptr,
                                      ptr]
    lib.hvd_bn_bwd_finalize.argtypes = [i64, i32, ptr, i32, ptr, i32, f32,
                                        ptr, i32, ptr, ptr, ptr, ptr]
    lib.hvd_bn_bwd_apply.argtypes = [ptr, ptr, ptr, i32, i64, i32, ptr, ptr,
                                     i32, f32, ptr, ptr, ptr, i32, ptr]
    for fn in (lib.hvd_bn_chunks, lib.hvd_bn_stats, lib.hvd_bn_stats_finalize,
               lib.hvd_bn_apply, lib.hvd_bn_bwd_reduce,
               lib.hvd_bn_bwd_finalize, lib.hvd_bn_bwd_apply):
        fn.restype = i32
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def rows_of(t: torch.Tensor) -> torch.Tensor:
    """``t`` ``[N, C, ...]`` as a row-major ``[rows, C]`` tensor, 16-byte
    aligned: a view where ``t`` is channels-last contiguous, else a copy."""
    r = t.movedim(1, -1)
    if not r.is_contiguous():
        r = r.contiguous()
    if r.data_ptr() % 16:
        r = r.clone()
    return r.view(-1, t.shape[1])


def _unrows(r: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """``[rows, C]`` back to ``shape`` ``[N, C, ...]`` (channels-last
    strides)."""
    return r.view(shape[0], *shape[2:], shape[1]).movedim(-1, 1)


def batch_norm_act_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor, training: bool,
                         momentum: float, eps: float,
                         residual: Optional[torch.Tensor] = None,
                         relu: bool = False) -> torch.Tensor:
    """The plain version: ``act(batch_norm(x) [+ residual])`` as the models
    composed it from PyTorch's operators."""
    if not training:
        y = F.batch_norm(x, running_mean, running_var, weight, bias, False,
                         0.0, eps)
    else:
        # batch_norm updates the statistics it is given in place and saves
        # them for backward, so it gets copies.
        mean, var = running_mean.clone(), running_var.clone()
        y = F.batch_norm(x, mean, var, weight, bias, True, 1.0 - momentum,
                         eps)
        # PyTorch folds the unbiased batch variance into the running
        # variance and flax the biased one: rescale the folded-in part by
        # (n-1)/n.
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            running_mean.copy_(mean)
            folded = var.sub(running_var, alpha=momentum)
            running_var.mul_(momentum).add_(folded, alpha=(n - 1) / n)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


def _check(x, weight, bias, running_mean, running_var, residual) -> None:
    """Raise for what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"x lies on {x.device}: the kernels run on CUDA "
                         "and their plain version on the CPU only")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32, bfloat16 or float16 on CUDA, "
                        f"got {x.dtype}")
    if x.dim() < 2 or x.shape[1] % _VEC or x.numel() == 0:
        raise ValueError(f"the kernels take [N, C, ...] with C a multiple of "
                         f"{_VEC} and at least one row, got {tuple(x.shape)}")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.dtype != torch.float32 or t.shape != (c,) or \
                t.device != x.device:
            raise TypeError(f"{name} must be float32 [{c}] on {x.device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if residual is not None and (residual.shape != x.shape or
                                 residual.dtype != x.dtype or
                                 residual.device != x.device):
        raise ValueError(f"the residual must have x's shape, type and device"
                         f" ({tuple(x.shape)}, {x.dtype}, {x.device}), got "
                         f"{tuple(residual.shape)}, {residual.dtype}, "
                         f"{residual.device}")


def _chunks(rows: int, c: int, backward: bool) -> int:
    return _lib().hvd_bn_chunks(rows, c, int(backward))


def _f32(c: int, device, n: int = 1) -> torch.Tensor:
    return torch.empty(n * c, dtype=torch.float32, device=device)


class Channels(NamedTuple):
    """A norm's per-channel fp32 tensors: ``mean`` and ``stat`` (the
    inverse std, or the running variance where ``from_var``: eval mode),
    ``weight`` and ``bias``."""
    mean: torch.Tensor
    stat: torch.Tensor
    from_var: bool
    eps: float
    weight: torch.Tensor
    bias: torch.Tensor

    def args(self):
        return (self.mean.data_ptr(), self.stat.data_ptr(),
                int(self.from_var), self.eps, self.weight.data_ptr(),
                self.bias.data_ptr())


# ReLU's mask in the backward: none; z > 0 of the saved output, the masked
# gradient written out (ReLU after a residual add); or the pre-activation
# recomputed from x (ReLU alone: csrc/batch_norm.cu, kMaskFromX).
NO_MASK, MASK_FROM_Z, MASK_FROM_X = 0, 1, 2


# The four passes over rows ``[rows, C]`` (``rows_of``); each is one
# kernel, each reduction with its finalize launch.

def bn_stats(xr: torch.Tensor, running_mean: torch.Tensor,
             running_var: torch.Tensor, momentum: float, eps: float):
    """Mean and inverse std of each channel of ``xr``; the running
    statistics take them in place (flax's rule)."""
    lib, dtype = _lib(), _DTYPES[xr.dtype]
    rows, c = xr.shape
    n_chunks = _chunks(rows, c, False)
    partial = _f32(c, xr.device, 2 * n_chunks)
    mean, invstd = _f32(c, xr.device), _f32(c, xr.device)
    cuda_build.launch(LAUNCHES, "bn_stats", lib.hvd_bn_stats, xr.data_ptr(),
                      dtype, rows, c, n_chunks, partial.data_ptr())
    cuda_build.launch(LAUNCHES, "bn_stats_finalize",
                      lib.hvd_bn_stats_finalize, xr.data_ptr(), dtype, rows,
                      c, partial.data_ptr(), n_chunks, eps, momentum,
                      running_mean.data_ptr(),
                      running_var.data_ptr(), mean.data_ptr(),
                      invstd.data_ptr())
    return mean, invstd


def bn_apply(xr: torch.Tensor, rr: Optional[torch.Tensor], k: Channels,
             relu: bool) -> torch.Tensor:
    """``act(y [+ rr])`` in ``xr``'s type."""
    rows, c = xr.shape
    z = torch.empty_like(xr)
    cuda_build.launch(LAUNCHES, "bn_apply", _lib().hvd_bn_apply,
                      xr.data_ptr(), _ptr(rr), z.data_ptr(),
                      _DTYPES[xr.dtype], rows, c, *k.args(), int(relu))
    return z


def bn_bwd_reduce(g: torch.Tensor, xr: torch.Tensor, k: Channels,
                  mask: int, training: bool,
                  z: Optional[torch.Tensor] = None):
    """dweight, dbias, the coefficients of dx and, with ``MASK_FROM_Z``
    (which needs ``z``), dy' = ``g`` masked by ``z > 0``."""
    lib, dtype = _lib(), _DTYPES[xr.dtype]
    rows, c = xr.shape
    dy = torch.empty_like(xr) if mask == MASK_FROM_Z else None
    n_chunks = _chunks(rows, c, True)
    partial = _f32(c, xr.device, 2 * n_chunks)
    cuda_build.launch(LAUNCHES, "bn_bwd_reduce", lib.hvd_bn_bwd_reduce,
                      g.data_ptr(), xr.data_ptr(), _ptr(z), _ptr(dy), dtype,
                      rows, c, n_chunks, *k.args(), mask,
                      partial.data_ptr())
    dweight, dbias = _f32(c, xr.device), _f32(c, xr.device)
    coef = _f32(c, xr.device, 3)
    cuda_build.launch(LAUNCHES, "bn_bwd_finalize", lib.hvd_bn_bwd_finalize,
                      rows, c, partial.data_ptr(), n_chunks,
                      k.stat.data_ptr(), int(k.from_var), k.eps,
                      k.weight.data_ptr(), int(training), dweight.data_ptr(),
                      dbias.data_ptr(), coef.data_ptr())
    return dweight, dbias, coef, dy


def bn_bwd_apply(dy: torch.Tensor, xr: torch.Tensor, k: Channels,
                 mask_from_x: bool, coef: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx from ``dy`` (masked as ``MASK_FROM_X`` masks where
    ``mask_from_x``), into ``out`` (a buffer the caller no longer needs,
    not ``dy``) where given."""
    rows, c = xr.shape
    dx = torch.empty_like(xr) if out is None else out
    cuda_build.launch(LAUNCHES, "bn_bwd_apply", _lib().hvd_bn_bwd_apply,
                      dy.data_ptr(), xr.data_ptr(), dx.data_ptr(),
                      _DTYPES[xr.dtype], rows, c, *k.args(),
                      coef.data_ptr(), int(mask_from_x))
    return dx


class BatchNormAct(torch.autograd.Function):
    """``act(batch_norm(x) [+ residual])`` by the kernels; its backward by
    the kernels too. In training the running statistics are updated in
    place."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                training, momentum, eps, relu):
        xr = rows_of(x)
        if training:
            mean, stat = bn_stats(xr, running_mean, running_var, momentum,
                                  eps)
        else:
            mean, stat = running_mean, running_var
        k = Channels(mean, stat, not training, eps, weight, bias)
        z = bn_apply(xr, None if residual is None else rows_of(residual), k,
                     relu)
        # ReLU after a residual add masks its backward by z; ReLU alone by
        # the pre-activation, recomputed from x.
        keep_z = relu and residual is not None
        ctx.save_for_backward(xr, z if keep_z else None, mean, stat, weight,
                              bias)
        ctx.shapes = (x.shape, None if residual is None else residual.shape)
        ctx.flags = (training, eps, relu)
        return _unrows(z, x.shape)

    @staticmethod
    def backward(ctx, dz):
        xr, z, mean, stat, weight, bias = ctx.saved_tensors
        training, eps, relu = ctx.flags
        x_shape, r_shape = ctx.shapes
        k = Channels(mean, stat, not training, eps, weight, bias)
        g = rows_of(dz)
        if z is not None:
            # The reduce writes dy' (the residual's gradient) and dx is
            # computed from it, unmasked, into g where g is a copy of dz's
            # values (dz not channels-last, as the pooled mean's gradient):
            # nothing else reads g then.
            dweight, dbias, coef, dy = bn_bwd_reduce(g, xr, k, MASK_FROM_Z,
                                                     training, z)
            copied = g.untyped_storage().data_ptr() != \
                dz.untyped_storage().data_ptr()
            dx = bn_bwd_apply(dy, xr, k, False, coef,
                              out=g if copied else None)
            d_res = dy
        else:
            mask = MASK_FROM_X if relu else NO_MASK
            dweight, dbias, coef, _ = bn_bwd_reduce(g, xr, k, mask, training)
            dx = bn_bwd_apply(g, xr, k, relu, coef)
            d_res = g
        return (_unrows(dx, x_shape), dweight, dbias,
                None if r_shape is None else _unrows(d_res, r_shape), None,
                None, None, None, None, None)


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   training: bool, momentum: float, eps: float,
                   residual: Optional[torch.Tensor] = None,
                   relu: bool = False) -> torch.Tensor:
    """``act(batch_norm(x) [+ residual])``: the plain version for a tensor
    on the CPU, the kernels for a CUDA tensor (raising for a type or shape
    they do not take), and an error for any other device. ``momentum`` is
    flax's, the weight of the old running statistic; in training the
    running statistics are updated in place."""
    if x.device.type == "cpu":
        return batch_norm_act_plain(x, weight, bias, running_mean,
                                    running_var, training, momentum, eps,
                                    residual, relu)
    _check(x, weight, bias, running_mean, running_var, residual)
    if training and x.numel() == x.shape[1]:
        raise ValueError("expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")
    return BatchNormAct.apply(x, weight, bias, residual, running_mean,
                              running_var, bool(training), float(momentum),
                              float(eps), bool(relu))
