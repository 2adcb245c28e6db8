"""PowerSGD: low-rank gradient compression (Vogels et al., arXiv:1905.13727).

Counterpart of ``horovod_tpu/compression/powersgd.py``. For each gradient
leaf of two or more dims, reshaped to a matrix ``M = x.reshape(x.shape[0],
-1)`` in fp32, with a warm-started factor ``Q`` and an error-feedback
residual ``E`` (JAX ``powersgd_allreduce_p``, :139-186):

1. ``M += E``
2. ``P = M @ Q``; the sum of ``P`` over the axis, divided by its size;
   ``P`` orthonormalized by modified Gram-Schmidt
3. ``Q = Mᵀ @ P``; the sum over the axis, divided by its size
4. ``approx = P @ Qᵀ`` (the same on every rank); ``E = M - approx``

Vectors and scalars take the dense Average allreduce. The factors go
through the unchecked sum launch (``lax.psum(p) / n``: a sum, then a
division, so the rounding follows the reference's), the P factors of every
matrix leaf in one flat exchange and the Q factors in another; the vectors
in one fused Average. The products stay ``torch.matmul``.

The reshape keeps dim 0 whatever the layout: torch's ``(out, in, kh, kw)``
weights become ``[out, in·kh·kw]`` (the usual PowerSGD matrix), flax's
``(kh, kw, in, out)`` kernels ``[kh, kw·in·out]``. The same rule gives
another approximation on another layout, so the port is held against the
reference on gradients in flax's layout.

Every rank must start from the same ``Q``: each leaf's is drawn from a CPU
``torch.Generator`` seeded from ``(seed, leaf index)`` and moved to the
leaf's device. JAX's ``jax.random.normal`` cannot be reproduced here, so
:func:`powersgd_state_from_jax` carries a JAX state (as numpy) across.
Residuals are this rank's own state, ``[rows, cols]`` a leaf; the cap and
the warning are reckoned on the reference's global figure, ``4 · world ·
rows · cols`` bytes over the matrix leaves, so a setting raises at the same
point in both packages.

Leaves are taken in the JAX package's order: a dict's values by sorted key,
a list's or tuple's in order, nested.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import runtime
from ..ops import collectives as C
from ..utils import envvars as ev
from ..utils import logging as log


class PowerSGDState(NamedTuple):
    """Per-leaf state: warm-start factors ``qs`` (``[cols, r]``, None for a
    leaf on the dense path) and this rank's residuals ``errors``
    (``[rows, cols]`` fp32, empty on the dense path)."""
    qs: tuple
    errors: tuple


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order, and the
    function that rebuilds a tree of that structure from new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(leaves) for leaves, _ in parts]

    def unflatten(leaves):
        out, at = [], 0
        for (_, rebuild), n in zip(parts, counts):
            out.append(rebuild(leaves[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return [leaf for leaves, _ in parts for leaf in leaves], unflatten


def _as_matrix(x: torch.Tensor) -> torch.Tensor:
    """``[a, b, c, ...] -> [a, b·c·...]``: dim 0 stays, the rest flatten."""
    return x.reshape(x.shape[0], -1)


def _matrix_shape(x) -> Tuple[int, int]:
    shape = tuple(x.shape)
    return shape[0], int(np.prod(shape[1:]))


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the columns, each divided by
    ``max(norm, 1e-8)``."""
    cols = []
    for i in range(p.shape[1]):
        c = p[:, i]
        for prev in cols:
            c = c - torch.dot(prev, c) * prev
        c = c / torch.clamp(torch.linalg.vector_norm(c), min=1e-8)
        cols.append(c)
    return torch.stack(cols, dim=1)


def _leaf_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of leaf ``index``: the pair mixed into the 32 bits
    the generator's Mersenne twister keeps of its seed."""
    mixed = (seed * 0x9E3779B1 + index * 0x85EBCA77 + 1) & 0xFFFFFFFF
    return torch.Generator().manual_seed(mixed)


def powersgd_init(grads, rank: int = 2, seed: int = 0, world_size: int = 1,
                  max_residual_bytes: Optional[int] = None
                  ) -> PowerSGDState:
    """State for :func:`powersgd_allreduce` (JAX ``powersgd_init``, :69):
    for each leaf of two or more dims a normal ``Q [cols, min(rank, rows,
    cols)]`` from the leaf's seeded generator and a zero residual, on the
    leaf's device.

    ``world_size``: the ranks of the reduction's axis, for the cap alone.
    ``max_residual_bytes`` (or ``$HVDTPU_POWERSGD_RESIDUAL_CAP``) raises
    when the global residual state would pass it; without a cap, a global
    figure over ``$HVDTPU_POWERSGD_RESIDUAL_WARN`` bytes (1 GiB by default)
    logs a warning."""
    leaves, _ = _flatten(grads)
    residual_bytes = sum(4 * world_size * rows * cols for rows, cols in (
        _matrix_shape(leaf) for leaf in leaves if leaf.dim() >= 2))
    cap = max_residual_bytes
    if cap is None and ev.get_str(ev.HVDTPU_POWERSGD_RESIDUAL_CAP):
        cap = ev.get_int(ev.HVDTPU_POWERSGD_RESIDUAL_CAP, 0)
    if cap is not None and residual_bytes > cap:
        raise ValueError(
            f"PowerSGD residual state would take {residual_bytes:,} bytes "
            f"globally (world_size={world_size} x fp32 gradient size), over "
            f"the {cap:,}-byte cap: lower world_size or raise the cap")
    warn_at = ev.get_int(ev.HVDTPU_POWERSGD_RESIDUAL_WARN,
                         ev.DEFAULT_POWERSGD_RESIDUAL_WARN)
    if cap is None and residual_bytes > warn_at:
        log.warning(
            f"PowerSGD residual state is {residual_bytes / (1 << 30):.1f} "
            f"GiB globally (world_size={world_size} x fp32 gradients); each "
            "rank holds one fp32 copy of its gradients")
    qs, errors = [], []
    for i, leaf in enumerate(leaves):
        if leaf.dim() >= 2:
            rows, cols = _matrix_shape(leaf)
            r = min(rank, rows, cols)
            q = torch.randn(cols, r, generator=_leaf_generator(seed, i))
            qs.append(q.to(leaf.device))
            errors.append(torch.zeros(rows, cols, dtype=torch.float32,
                                      device=leaf.device))
        else:
            qs.append(None)
            errors.append(torch.zeros(0, dtype=torch.float32,
                                      device=leaf.device))
    return PowerSGDState(qs=tuple(qs), errors=tuple(errors))


def powersgd_state_from_jax(state, index: int, world_size: int,
                            device=None) -> PowerSGDState:
    """A JAX ``PowerSGDState`` (its leaves as numpy arrays, or None) as the
    port's state of the rank at ``index`` of an axis of ``world_size``: the
    factors as they are, and that rank's rows of each global residual
    (stacked over the axis on dim 0, as ``powersgd_state_specs`` shards
    them)."""
    qs = tuple(None if q is None else torch.from_numpy(
        np.array(q, dtype=np.float32)).to(device) for q in state.qs)
    errors = []
    for e in state.errors:
        e = np.asarray(e, dtype=np.float32)
        if e.size:
            rows = e.shape[0] // world_size
            e = e[index * rows:(index + 1) * rows]
        errors.append(torch.from_numpy(np.array(e)).to(device))
    return PowerSGDState(qs=qs, errors=tuple(errors))


def _check_state(leaves: Sequence[torch.Tensor], state: PowerSGDState,
                 rank: int) -> None:
    if len(leaves) != len(state.qs):
        raise ValueError(
            f"state built for {len(state.qs)} leaves, got {len(leaves)}: "
            "rebuild with powersgd_init(grads, rank)")
    for leaf, q in zip(leaves, state.qs):
        if q is None:
            continue
        expect = min(rank, *_matrix_shape(leaf))
        if q.shape[1] != expect:
            raise ValueError(
                f"rank={rank} does not match the state's factors (Q rank "
                f"{q.shape[1]}): pass the rank the state was built with "
                "(powersgd_init)")


def _mean_factors(factors: List[torch.Tensor], group, n: int
                  ) -> List[torch.Tensor]:
    """Every factor summed over ``group`` in one flat exchange, then
    divided by ``n``."""
    if not factors:
        return []
    flat = torch.cat([f.reshape(-1) for f in factors])
    summed = C._launch_reduce(flat, C.ReduceOp.SUM, 1.0, 1.0, inplace=True,
                              group=group).wait() / n
    return [part.view_as(f) for part, f in zip(
        summed.split([f.numel() for f in factors]), factors)]


def powersgd_allreduce(grads, state: PowerSGDState, axis=None,
                       rank: int = 2):
    """PowerSGD-compressed gradient averaging over mesh axis ``axis`` (the
    data-parallel axis by default). Returns ``(average_tree, new_state)``:
    the average is the same on every rank, lossy at rank ``rank``, whose
    loss the residual carries to the next call. ``rank`` must match the
    state's (:func:`powersgd_init`)."""
    leaves, unflatten = _flatten(grads)
    _check_state(leaves, state, rank)
    group = runtime.group(axis)
    n = C._size(group)
    matrix = [i for i, q in enumerate(state.qs) if q is not None]
    dense = [i for i, q in enumerate(state.qs) if q is None]
    mats = {i: _as_matrix(leaves[i]).to(torch.float32) + state.errors[i]
            for i in matrix}
    ps = _mean_factors([mats[i] @ state.qs[i] for i in matrix], group, n)
    ps = [_orthonormalize(p) for p in ps]
    new_qs = _mean_factors([mats[i].T @ p for i, p in zip(matrix, ps)],
                           group, n)
    outs = list(leaves)
    qs, errors = list(state.qs), list(state.errors)
    for i, p, q in zip(matrix, ps, new_qs):
        approx = p @ q.T
        errors[i] = mats[i] - approx
        qs[i] = q
        outs[i] = approx.reshape(leaves[i].shape).to(leaves[i].dtype)
    if dense:
        averaged = C._launch_grouped([leaves[i] for i in dense],
                                     C.ReduceOp.AVERAGE, 1.0, 1.0,
                                     group=group).wait()
        for i, out in zip(dense, averaged):
            outs[i] = out
    return unflatten(outs), PowerSGDState(qs=tuple(qs), errors=tuple(errors))


def wire_floats(grads, rank: int = 2) -> Tuple[int, int]:
    """Floats a rank sends a step: ``(factors, dense)``, the P and Q of the
    matrix leaves (``r·(rows + cols)`` each) and the elements of the
    others."""
    leaves, _ = _flatten(grads)
    factors = dense = 0
    for leaf in leaves:
        if leaf.dim() >= 2:
            rows, cols = _matrix_shape(leaf)
            factors += min(rank, rows, cols) * (rows + cols)
        else:
            dense += leaf.numel()
    return factors, dense


class PowerSGDOptimizer:
    """A ``torch.optim`` optimizer whose gradients are averaged by
    PowerSGD first (JAX ``PowerSGDOptimizer``, :189): ``step()`` reads every
    parameter's ``grad`` (zeros where there is none), reduces them over
    mesh axis ``axis`` with :func:`powersgd_allreduce`, writes the averages
    back into ``grad`` and steps ``optimizer``.

    The leaves are the parameters in the order of ``optimizer``'s
    ``param_groups``. The state (:attr:`powersgd_state`) is built from the
    parameters at construction, the cap reckoned for the axis's size;
    :meth:`state_dict` carries it beside the inner optimizer's, so a
    checkpoint resumes both."""

    def __init__(self, optimizer: torch.optim.Optimizer, rank: int = 2,
                 axis=None, seed: int = 0):
        self.optimizer = optimizer
        self.rank = rank
        self.axis = axis
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"]]
        world = C._size(runtime.group(axis)) if runtime.is_initialized() \
            else 1
        self.powersgd_state = powersgd_init(self._params, rank=rank,
                                            seed=seed, world_size=world)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def synchronize(self) -> None:
        """Reduce every gradient and write the averages into ``grad``."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self._params]
        out, self.powersgd_state = powersgd_allreduce(
            grads, self.powersgd_state, axis=self.axis, rank=self.rank)
        with torch.no_grad():
            for p, g in zip(self._params, out):
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad.copy_(g)

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "powersgd": {"qs": list(self.powersgd_state.qs),
                             "errors": list(self.powersgd_state.errors)}}

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict["optimizer"])
        saved = state_dict["powersgd"]
        self.powersgd_state = PowerSGDState(
            qs=tuple(None if q is None else q.to(p.device)
                     for q, p in zip(saved["qs"], self._params)),
            errors=tuple(e.to(p.device)
                         for e, p in zip(saved["errors"], self._params)))
