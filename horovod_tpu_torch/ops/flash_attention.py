"""Fused (flash) attention: CUDA wrappers, plain versions, launch counts.

Counterpart of ``horovod_tpu/ops/flash_attention.py``: ``repeat_kv_heads``
(:64), ``flash_attention`` (:362) and the custom VJP (:274-359), which here
is a ``torch.autograd.Function``. Its three Pallas kernels become CUDA C++
for Hopper in ``horovod_tpu_torch/csrc/``:

* B7 ``flash_fwd`` (``_fwd_call``/``_fwd_kernel``): ``o`` and the row
  logsumexp of causal or bidirectional softmax attention;
* B8 ``flash_dkdv`` (``_dkdv_kernel``): dK and dV, per key tile;
* B9 ``flash_dq`` (``_dq_kernel``): dQ, per query tile.

The kernels take ``[BH, S, D]`` tensors in bf16 or fp32 and keep ``lse``
as fp32 ``[BH, S]``; nothing is padded (the TPU's lane-replicated
``[BH, S, 128]`` statistics and the padding of S to 128 are not carried
over). The type chooses the route: bf16 runs on the tensor cores
(``flash_attention_mma.cu``: ``mma.sync`` tiles fed by ``cp.async``, with
P and dS rounded to bf16 before their products, see
:func:`mma_rounding_terms`); fp32 runs the CUDA-core kernels of
``flash_attention.cu``. Each wrapper takes the plain PyTorch version beside
it for tensors on the CPU, launches its kernel for CUDA tensors, and raises
for any other device: there is no fallback. ``LAUNCHES`` counts kernel
launches and ``ROUTES`` the launches of each kernel by the route the C
entry point reports it took.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from ..utils import cuda_build

NEG_INF = -1e30  # the TPU kernels' masked logit: exp never sees inf - inf

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_dkdv": 0, "flash_dq": 0}
# Launches of B7, B8 and B9 by route: the tensor-core kernels (bf16) or the
# CUDA-core ones (fp32), as ``hvd_flash_last_route`` reports the branch the
# C entry point launched from.
ROUTES: Dict[str, Dict[str, int]] = {
    name: {"mma_bf16": 0, "fp32": 0} for name in LAUNCHES}
_ROUTE_NAMES = {1: "mma_bf16", 2: "fp32"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


def _count_route(name: str) -> None:
    code = _lib().hvd_flash_last_route()
    if code not in _ROUTE_NAMES:
        raise RuntimeError(f"{name}: the library reports route {code}")
    ROUTES[name][_ROUTE_NAMES[code]] += 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.lib()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32, i32, i32, f32, i32, i32, ptr]  # bh S D scale causal bf16
    lib.hvd_flash_fwd.argtypes = [ptr] * 5 + shape
    lib.hvd_flash_fwd.restype = i32
    lib.hvd_flash_dkdv.argtypes = [ptr] * 8 + shape
    lib.hvd_flash_dkdv.restype = i32
    lib.hvd_flash_dq.argtypes = [ptr] * 7 + shape
    lib.hvd_flash_dq.restype = i32
    lib.hvd_flash_last_route.argtypes = []
    lib.hvd_flash_last_route.restype = i32
    return lib


def _check(q: torch.Tensor, *others: torch.Tensor) -> bool:
    """Validate ``[BH, S, D]`` arguments of one type; True when they lie on
    the CPU (the plain version runs), False on CUDA (the kernel runs).
    Raises otherwise."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention takes bf16 or fp32, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"expected [BH, S, D], got {tuple(q.shape)}")
    bh, s, d = q.shape
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"head_dim must be a multiple of 8 up to 128, "
                         f"got {d}")
    if s < 1 or bh < 1 or bh > 65535:
        raise ValueError(f"need S >= 1 and 1 <= BH <= 65535, got "
                         f"{tuple(q.shape)}")
    for t in others:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"arguments differ: {q.dtype} "
                             f"{tuple(q.shape)} and {t.dtype} "
                             f"{tuple(t.shape)}")
    return _check_device(q, *others)


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    """``lse`` and ``delta``: fp32 ``[BH, S]`` on q's device."""
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"lse and delta must be fp32 "
                             f"{tuple(q.shape[:2])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_device(q, *stats)


def _check_device(first: torch.Tensor, *others: torch.Tensor) -> bool:
    for t in others:
        if t.device != first.device:
            raise ValueError(f"arguments lie on {first.device} and "
                             f"{t.device}")
    if first.device.type == "cpu":
        return True
    if first.device.type != "cuda":
        raise ValueError(f"arguments lie on {first.device}: the kernel runs "
                         "on CUDA and its plain version on the CPU only")
    for t in (first,) + others:
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")
    return False


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The tensor-core kernels (bf16) copy rows with 16-byte ``cp.async``:
    each bf16 input must be 16-byte aligned (a view that starts inside an
    allocation may not be). The CUDA-core kernels (fp32) load one element
    at a time and need no check."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"argument at {t.data_ptr():#x} is not 16-byte "
                             "aligned")


def _flags(q: torch.Tensor, scale: float, causal: bool):
    bh, s, d = q.shape
    return (bh, s, d, scale, int(causal), int(q.dtype == torch.bfloat16))


# ---------------------------------------------------------------------------
# plain versions (fp32 math on the given inputs)
# ---------------------------------------------------------------------------

def _logits(q, k, scale: float, causal: bool) -> torch.Tensor:
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, scale: float, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B7: ``(o, lse)``, softmax over whole rows."""
    s = _logits(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    o = torch.matmul(p, v.float()) / safe
    return o.to(q.dtype), (m + torch.log(safe))[..., 0]


def _dscores(q, k, v, do, lse, delta, scale, causal):
    """``p = exp(s - lse)`` and ``dS = p (dO Vᵀ - delta)``."""
    p = torch.exp(_logits(q, k, scale, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_dkdv_plain(q, k, v, do, lse, delta, scale: float, causal: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B8: ``(dK, dV)``."""
    p, ds = _dscores(q, k, v, do, lse, delta, scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool
                   ) -> torch.Tensor:
    """Plain version of B9: ``dQ``."""
    _, ds = _dscores(q, k, v, do, lse, delta, scale, causal)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def mma_rounding_terms(q, k, v, do, lse, delta, scale: float, causal: bool
                       ) -> Dict[str, torch.Tensor]:
    """What the tensor-core route (bf16 B7, B8 and B9) may add to the bound
    of its outputs against the plain versions, element by element, in fp32.

    That route multiplies bf16 operands exactly with fp32 sums, but rounds
    two fp32 intermediates to bf16 before they enter a product: P (before
    ``P V`` and ``Pᵀ dO``) and dS (before ``dSᵀ Q`` and ``dS K``).
    Rounding to nearest moves a value x by at most u|x|, u = 2^-8, so an
    output element ``sum_j x_j y_j`` moves by ``sum_j e_j y_j`` with
    ``|e_j| <= u |x_j|``. The term is ``4 u sqrt(sum_j x_j^2 y_j^2)``: for
    ``o`` x is p (normalised: ``exp(s - lse)``) and y is v; for dV p and
    dO; for dK dS and q, for dQ dS and k, both times ``scale``. Where at
    most 16 products carry the sum, the worst case ``u sum_j |x_j y_j|`` is
    within it (Cauchy-Schwarz); where many do, the rounding errors act as
    independent, zero-mean and of
    variance at most ``u^2 x_j^2 / 3``, and the term is 6.9 of the sum's
    standard deviations (a normal tail of 4e-12 an element). The worst-case
    sum itself would grow to several times a typical value of ``o`` in long
    causal rows and let an error of a few percent pass.
    ``tests/test_torch_flash_rounding.py`` holds an emulation of the route
    to this bound and shows that a 2% error fails it. lse and fp32 outputs
    get no term. Costs one product of squares each."""
    p, ds = _dscores(q, k, v, do, lse, delta, scale, causal)
    factor = 4 * 2.0 ** -8

    def rss(x, y):
        return torch.matmul(x.square(), y.float().square()).sqrt()

    return {"o": factor * rss(p, v),
            "dv": factor * rss(p.transpose(-1, -2), do),
            "dk": (factor * scale) * rss(ds.transpose(-1, -2), q),
            "dq": (factor * scale) * rss(ds, k)}


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7: attention output ``o`` (q's type) and fp32 row logsumexp
    ``lse [BH, S]`` for ``[BH, S, D]`` q, k, v."""
    if _check(q, k, v):
        return flash_fwd_plain(q, k, v, scale, causal)
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        cuda_build.launch(LAUNCHES, "flash_fwd", _lib().hvd_flash_fwd,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(),
                          *_flags(q, scale, causal))
    _count_route("flash_fwd")
    return o, lse


def flash_dkdv(q, k, v, do, lse, delta, scale: float, causal: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8: ``(dK, dV)`` in q's type, from the forward's ``lse`` and
    ``delta = rowsum(dO * O)``."""
    on_cpu = _check(q, k, v, do)
    _check_stats(q, lse, delta)
    if on_cpu:
        return flash_dkdv_plain(q, k, v, do, lse, delta, scale, causal)
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v, do)
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    with torch.cuda.device(q.device):
        cuda_build.launch(LAUNCHES, "flash_dkdv", _lib().hvd_flash_dkdv,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(),
                          *_flags(q, scale, causal))
    _count_route("flash_dkdv")
    return dk, dv


def flash_dq(q, k, v, do, lse, delta, scale: float, causal: bool
             ) -> torch.Tensor:
    """B9: ``dQ`` in q's type."""
    on_cpu = _check(q, k, v, do)
    _check_stats(q, lse, delta)
    if on_cpu:
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal)
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v, do)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        cuda_build.launch(LAUNCHES, "flash_dq", _lib().hvd_flash_dq,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), *_flags(q, scale, causal))
    _count_route("flash_dq")
    return dq


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

class _FlashBHSD(torch.autograd.Function):
    """B7 forward; B8 and B9 backward, with ``delta`` in plain torch as the
    JAX package leaves it to XLA. Under ``torch.utils.checkpoint`` the
    recompute runs ``forward`` again, and the saved ``lse`` is the
    recomputed one."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dk, dv = flash_dkdv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def repeat_kv_heads(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """Grouped-query attention: tile ``[B, S, Hkv, D]`` K/V heads up to the
    query head count (each kv head serves ``n_q_heads // Hkv`` neighbouring
    query heads)."""
    n_kv = k.shape[2]
    if n_kv == n_q_heads:
        return k
    if n_q_heads % n_kv:
        raise ValueError(f"query heads ({n_q_heads}) not a multiple of kv "
                         f"heads ({n_kv})")
    return torch.repeat_interleave(k, n_q_heads // n_kv, dim=2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Fused attention. q: ``[B, S, H, D]``; k/v: ``[B, S, Hkv, D]`` where
    ``Hkv`` divides ``H``. Differentiable (B8/B9 backward).

    ``causal=True`` (decoder) skips the key tiles past the diagonal;
    ``causal=False`` (encoder) attends every key."""
    k = repeat_kv_heads(k, q.shape[2])
    v = repeat_kv_heads(v, q.shape[2])
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)

    def to_bhsd(x):
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    o = _FlashBHSD.apply(to_bhsd(q), to_bhsd(k), to_bhsd(v), scale,
                         bool(causal))
    return o.view(b, h, s, d).transpose(1, 2)
