"""Distributed optimizer: data-parallel gradient reduction for torch.optim.

Counterpart of ``horovod_tpu/parallel/optimizer.py`` (``allreduce_gradients``
:30-93, the fused two-axis reduction :95-157, ``DistributedOptimizer``
:171, its quantized route ``_compressed_reduce`` :290-362,
``broadcast_parameters`` :422, ``broadcast_optimizer_state`` :429), in the
torch-side shape of ``horovod_tpu/torch/optimizer.py`` (hooks,
``backward_passes_per_step``, ``synchronize``, ``skip_synchronize``): the
wrapper is a dynamic subclass of the wrapped optimizer's class (reference:
``horovod/torch/optimizer.py:383``), so ``isinstance`` and LR schedulers keep
working.

Each parameter that requires grad carries a ``post_accumulate_grad_hook``
that counts down ``backward_passes_per_step`` backward passes. The
gradients are reduced in units, each launched from the hook of its last
member to become ready, so the exchange overlaps the rest of the backward
pass:

* dense gradients (no compression, or a wire cast) in buckets of one dtype,
  filled in reverse registration order (the order backward produces them)
  up to ``HVDTPU_FUSION_THRESHOLD`` bytes (64 MiB by default); a bucket
  copies its gradients into one flat buffer, allocated once and reused, and
  starts an async allreduce on it (over the data-parallel axis, a mesh
  axis ``axis``, or, with ``hierarchical=(inner, outer)``, the two-level
  reduction of :func:`~horovod_tpu_torch.ops.collectives.
  hierarchical_allreduce`; Adasum combines each gradient of a bucket with
  its own coefficients);
* quantized gradients in one fused ``compressed_grouped_allreduce`` per
  quantizer, over its members in registration order (the JAX package's
  leaf order), with the error-feedback residuals in the optimizer's
  ``state`` (so they travel in its ``state_dict``).

``synchronize()`` (which ``step()`` calls) launches what the hooks did not
(a parameter without a gradient contributes zeros, so every rank joins
every exchange), waits, and writes the reduced gradients into ``p.grad``.
The first ``synchronize()`` checks once that every rank built the same
units, before any gradient moves: its hooks only count, and it launches
the units itself. So does the first one after the runtime was initialized
anew (``runtime.epoch()``: an elastic reset), since the world's ranks may
have changed. No later launch exchanges a descriptor, since a host
round trip inside a backward hook would stall the card. An exchange's
buffer stays referenced by its pending handle until ``synchronize()``.
What a step keeps (the error-feedback residuals, the dense buckets' flat
buffers) is allocated once and then updated in place, so that a whole
step can be captured in a CUDA graph (:func:`~horovod_tpu_torch.step.
run_step`); :meth:`passes_in_window` tells a step of one backward pass
where it stands in a window of ``backward_passes_per_step``.

In process mode (``init(mode="process")``) a dense bucket is one op of the
native core, named ``DistributedOptimizer.bucket.{k}`` on every rank (an
Adasum bucket enqueues each gradient as ``.{i}`` of it); the hook copies
the bucket into pinned host memory and waits for the stream before it
enqueues, and ``synchronize()`` copies the result back. A quantizer's
group takes the JAX package's eager process path
(:func:`~horovod_tpu_torch.compression.reducers.
compressed_grouped_allreduce`). ``broadcast_parameters`` and
``broadcast_optimizer_state`` enqueue every tensor in one grouped window.
"""

from __future__ import annotations

import contextlib
import warnings
import weakref
import zlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import torch

from .. import runtime
from ..compression import (CompressionConfig, Compressor, MaxMinQuantizer,
                           NormalizedQuantizer, TopKCompressor,
                           init_error_feedback)
from ..compression.error_feedback import update_residuals
from ..compression.reducers import compressed_grouped_allreduce
from ..exceptions import HvdTpuInternalError
from ..functions import broadcast_object
from ..ops import collectives as C
from ..utils import envvars as ev
from .strategy import choose_hierarchical

_RESIDUAL = "hvd_residual"


def _resolve(axis, hierarchical, op, nbytes: int):
    """Where the gradients are reduced: ``(group, None)``, one reduction
    over the group of ``axis``, or ``(group, (inner, outer))``, the
    hierarchical one (``group`` then spans both axes). ``("auto", inner,
    outer)`` asks the calibration table at ``nbytes`` and reduces flat
    over both axes when it says so (JAX ``optimizer.py:69-86``); Adasum
    ignores a flat choice, since its two-axis form is the hierarchical one
    (JAX ``optimizer.py:111-122``)."""
    if hierarchical is None:
        return runtime.group(axis), None
    runtime.require_spmd("hierarchical gradient reduction")
    if len(hierarchical) == 3 and hierarchical[0] == "auto":
        hier = tuple(hierarchical[1:])
        if op != C.ReduceOp.ADASUM and not choose_hierarchical(*hier,
                                                                nbytes):
            return runtime.group(hier), None
    elif len(hierarchical) == 2:
        hier = tuple(hierarchical)
    else:
        raise ValueError("hierarchical takes (inner_axis, outer_axis) or "
                         "(\"auto\", inner_axis, outer_axis)")
    return runtime.group(hier), hier


def _launch_dense(buf: torch.Tensor, op, prescale: float, postscale: float,
                  group, hier, sizes, name: Optional[str] = None):
    """Reduce a fused buffer of gradients whose lengths are ``sizes`` over
    ``group``, or hierarchically over the axes ``hier``. Adasum gets
    ``sizes``: a coefficient per gradient. ``name`` names the op for the
    native core."""
    sizes = sizes if op == C.ReduceOp.ADASUM else None
    if hier is None:
        return C._launch_reduce(buf, op, prescale, postscale, inplace=True,
                                group=group, sizes=sizes, name=name)
    return C._launch_hierarchical(buf, op, *hier, prescale, postscale,
                                  sizes=sizes)


def allreduce_gradients(grads, op: C.ReduceOp = C.ReduceOp.AVERAGE,
                        compression=None, prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0, axis=None,
                        hierarchical=None):
    """Allreduce a list (or a dict) of gradients, returned in the same
    form: the functional form of :func:`DistributedOptimizer`'s reduction
    (JAX ``allreduce_gradients``, ``optimizer.py:30-93``; reference
    ``DistributedGradientTape``).

    ``hierarchical=(inner_axis, outer_axis)`` reduces each dtype's fused
    buffer by :func:`~horovod_tpu_torch.ops.collectives.
    hierarchical_allreduce`; ``("auto", inner, outer)`` asks the
    calibration table (:func:`~horovod_tpu_torch.parallel.strategy.
    autotune_hierarchical`) at the gradients' total bytes and reduces flat,
    one allreduce over both axes, when it says so or has no entry. Neither
    takes a compressor."""
    if hierarchical is not None and compression is not None:
        raise ValueError(
            "hierarchical allreduce does not take a compressor; use "
            "hierarchical_compressed_allreduce over the slow axis instead")
    keys = list(grads) if isinstance(grads, dict) else None
    leaves = list(grads.values()) if keys is not None else list(grads)
    if hierarchical is None:
        out = C.grouped_allreduce(leaves, op=op, compression=compression,
                                  prescale_factor=prescale_factor,
                                  postscale_factor=postscale_factor,
                                  name="grads", axis=axis)
    else:
        group, hier = _resolve(axis, hierarchical, op, sum(
            g.numel() * g.element_size() for g in leaves))
        C._plan_grouped(leaves, op, None, "grads", group)
        _, _, groups = C._grouped_inputs(leaves, None)
        out = [None] * len(leaves)
        for idxs in groups:
            buf = torch.cat([leaves[i].reshape(-1) for i in idxs])
            red = _launch_dense(buf, op, prescale_factor, postscale_factor,
                                group, hier,
                                [leaves[i].numel() for i in idxs]).wait()
            for i, part in zip(idxs, red.split([leaves[i].numel()
                                                for i in idxs])):
                out[i] = part.view(leaves[i].shape)
    return dict(zip(keys, out)) if keys is not None else out


class DistributedGradientTape:
    """Wrap a function that returns gradients so that they come back
    allreduced (JAX ``DistributedGradientTape``, ``horovod_tpu/parallel/
    optimizer.py:438``; reference ``horovod/tensorflow/__init__.py:527``).
    The function returns a list or dict of gradients, or ``(value,
    gradients)``; the gradients go through :func:`allreduce_gradients`
    with this tape's ``op``, ``compression``, ``axis`` and
    ``hierarchical``."""

    def __init__(self, grad_fn, op: C.ReduceOp = C.ReduceOp.AVERAGE,
                 compression=None, axis=None, hierarchical=None):
        self._grad_fn = grad_fn
        self._op = op
        self._compression = compression
        self._axis = axis
        self._hierarchical = hierarchical

    def _reduce(self, grads):
        return allreduce_gradients(grads, op=self._op,
                                   compression=self._compression,
                                   axis=self._axis,
                                   hierarchical=self._hierarchical)

    def __call__(self, *args, **kwargs):
        out = self._grad_fn(*args, **kwargs)
        if isinstance(out, tuple) and len(out) == 2:
            value, grads = out
            return value, self._reduce(grads)
        return self._reduce(out)


class _Unit:
    """Gradients reduced in one call: a bucket of dense gradients (its
    ``compressor`` None or a wire compressor) or a quantizer's group."""

    def __init__(self, params, compressor, quantized: bool, name: str = ""):
        self.params = params
        self.compressor = compressor
        self.quantized = quantized
        self.name = name      # a dense bucket's name for the native core
        self.ready = 0        # members whose countdown reached zero
        self.pending = None   # the launched reduction
        self.buffer = None    # a dense bucket's flat buffer


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression, op,
                 prescale_factor: float, postscale_factor: float,
                 backward_passes_per_step: int, axis, group, hier):
        super(self.__class__, self).__init__(params)
        self._op = op
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._axis = axis
        self._group = group
        self._hier = hier
        # None or a wire compressor (Compression.fp16/bf16) keeps every
        # gradient dense; a quantizer or a config sends them through the
        # compressed reducers.
        self._config = None
        self._wire = None
        if isinstance(compression, CompressionConfig):
            self._config = compression
        elif isinstance(compression, (MaxMinQuantizer, NormalizedQuantizer,
                                      TopKCompressor)):
            self._config = CompressionConfig(default_compressor=compression)
        else:
            self._wire = compression
        if self._config is not None and op not in (C.ReduceOp.SUM,
                                                   C.ReduceOp.AVERAGE):
            raise ValueError(f"op={op!r} is not supported with quantized "
                             "compression (the compressed reducers are "
                             "sum-based, like the reference's)")

        # Index-based names for every param, overridden by named_parameters
        # (never id(p): names must agree across processes).
        self._names: Dict[int, str] = {}
        for gi, group in enumerate(self.param_groups):
            for pi, p in enumerate(group["params"]):
                self._names[id(p)] = f"allreduce.noname.{gi}.{pi}"
        if named_parameters is not None:
            named_parameters = list(named_parameters)
            names = [n for n, _ in named_parameters]
            if len(set(names)) != len(names):
                raise ValueError("parameter names in named_parameters must "
                                 "be unique")
            known = {id(p) for g in self.param_groups for p in g["params"]}
            named = {id(p) for _, p in named_parameters}
            if known - named:
                raise ValueError("named_parameters was given, but one or more "
                                 "model parameters were not named")
            for name, p in named_parameters:
                self._names[id(p)] = name

        self.backward_passes_per_step = backward_passes_per_step
        self._units = self._plan()
        self._unit_of = {p: u for u in self._units for p in u.params}
        self._delay = {p: backward_passes_per_step for p in self._unit_of}
        self._fired = set()  # parameters whose hook fired in this window
        # The runtime epoch whose world checked the layout: a world made
        # anew (an elastic reset) checks it again, every rank together.
        self._checked_epoch = None
        # Grows at every load_state_dict, which makes new state tensors: a
        # step captured before it would go on reading the old ones.
        self._generation = 0
        self._synchronized = False
        self._should_synchronize = True
        # Reductions the hooks launched since the last synchronize().
        self.hook_launches = 0
        # The hook holds the optimizer weakly: a parameter keeps its hooks on
        # the C++ side, where the collector cannot see a cycle through them,
        # so a strong reference would keep the optimizer, its buffers and
        # the parameters alive for the life of the process.
        ref = weakref.ref(self)

        def hook(p):
            opt = ref()
            if opt is not None:
                opt._hook(p)
        for p in self._unit_of:
            p.register_post_accumulate_grad_hook(hook)

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.param_groups for p in g["params"]
                if p.requires_grad]

    def _compressor(self, p):
        """(compressor, quantized) of a parameter's gradient."""
        if self._config is None:
            return self._wire, False
        comp = self._config.for_name(self._names[id(p)])
        if comp is None or (isinstance(comp, type) and
                            issubclass(comp, Compressor)):
            return comp, False
        return comp, True

    def _plan(self) -> List[_Unit]:
        """Dense buckets, then one group per quantizer."""
        cap = ev.get_int(ev.HVDTPU_FUSION_THRESHOLD,
                         ev.DEFAULT_FUSION_THRESHOLD)
        buckets: List[_Unit] = []
        open_bucket: Dict[tuple, _Unit] = {}
        filled: Dict[tuple, int] = {}
        quantized: Dict[object, List[torch.nn.Parameter]] = {}
        routed = [(p, *self._compressor(p)) for p in self._params()]
        for p, comp, is_quantized in routed:
            if is_quantized:
                quantized.setdefault(comp, []).append(p)
        for p, comp, is_quantized in reversed(routed):
            if is_quantized:
                continue
            key = (comp, p.dtype, p.device)
            nbytes = p.numel() * p.element_size()
            unit = open_bucket.get(key)
            if unit is None or filled[key] + nbytes > cap:
                unit = open_bucket[key] = _Unit(
                    [], comp, False,
                    f"DistributedOptimizer.bucket.{len(buckets)}")
                filled[key] = 0
                buckets.append(unit)
            unit.params.append(p)
            filled[key] += nbytes
        return buckets + [_Unit(ps, comp, True)
                          for comp, ps in quantized.items()]

    # -- hooks ---------------------------------------------------------------

    def _hook(self, p: torch.nn.Parameter) -> None:
        if self._delay[p] == 0:
            raise AssertionError(
                "gradient for this parameter was already reduced; call "
                "optimizer.step() or synchronize() between backward "
                "passes, or raise backward_passes_per_step")
        self._fired.add(p)
        self._delay[p] -= 1
        if self._delay[p]:
            return
        unit = self._unit_of[p]
        unit.ready += 1
        if unit.ready == len(unit.params) and \
                self._checked_epoch == runtime.epoch():
            self._launch(unit)
            self.hook_launches += 1

    def _launch(self, unit: _Unit) -> None:
        for p in unit.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in unit.params]
        if unit.quantized:
            unit.pending = self._reduce_compressed(unit.params, grads,
                                                   unit.compressor)
            return
        wire = unit.compressor
        flat = [(g if wire is None else wire.compress(g)[0]).reshape(-1)
                for g in grads]
        if unit.buffer is None:
            unit.buffer = torch.empty(sum(f.numel() for f in flat),
                                      dtype=flat[0].dtype,
                                      device=flat[0].device)
        torch.cat(flat, out=unit.buffer)
        unit.pending = _launch_dense(unit.buffer, self._op, self._prescale,
                                     self._postscale, self._group,
                                     self._hier, [f.numel() for f in flat],
                                     unit.name)

    def _reduce_compressed(self, params, grads, comp) -> List[torch.Tensor]:
        kwargs = dict(reduction=self._config.reduction, op=self._op,
                      prescale_factor=self._prescale,
                      postscale_factor=self._postscale, axis=self._axis)
        if not self._config.error_feedback:
            return compressed_grouped_allreduce(grads, comp, **kwargs)
        missing = [p for p in params if _RESIDUAL not in self.state[p]]
        for p, r in zip(missing, init_error_feedback(missing)):
            self.state[p][_RESIDUAL] = r
        residuals = [self.state[p][_RESIDUAL] for p in params]
        reduced, new_res = compressed_grouped_allreduce(
            grads, comp, residuals=residuals, **kwargs)
        update_residuals(residuals, new_res)
        return reduced

    def _finish(self, unit: _Unit) -> None:
        """Wait for a unit's reduction and write it into ``p.grad``."""
        if unit.quantized:
            reduced = unit.pending
        else:
            flat = unit.pending.wait()
            reduced = [part.view(p.shape) for p, part in zip(
                unit.params, flat.split([p.numel() for p in unit.params]))]
            if unit.compressor is not None:
                reduced = [unit.compressor.decompress(r, p.grad.dtype)
                           for r, p in zip(reduced, unit.params)]
        for p, g in zip(unit.params, reduced):
            p.grad.copy_(g)
        unit.pending = None
        unit.ready = 0

    def _check_layout(self) -> None:
        """Every rank must have built the same units (names, sizes and
        dtypes, in order): one descriptor exchange, before any gradient
        moves."""
        layout = [self._axis, self._hier, C._size(self._group)] + [
            (u.quantized, repr(u.compressor),
             [(self._names[id(p)], p.numel(), str(p.dtype))
              for p in u.params]) for u in self._units]
        params = list(self._unit_of)
        C._agree("DistributedOptimizer",
                 (len(self._units), sum(p.numel() for p in params)),
                 params[0].dtype if params else torch.float32,
                 group=runtime.world_group(), op=self._op,
                 sig=zlib.crc32(repr(layout).encode()))

    # -- synchronization -------------------------------------------------------

    def synchronize(self) -> None:
        """Launch every reduction the hooks did not (zeros for a missing
        gradient, a parameter's partial sum where it is still
        accumulating), wait for them all, and write the reduced gradients
        into ``p.grad`` (reference: ``horovod/torch/optimizer.py:198-221``)."""
        if self._checked_epoch != runtime.epoch():
            self._check_layout()
            self._checked_epoch = runtime.epoch()
        for unit in self._units:
            if unit.pending is None:
                self._launch(unit)
        for unit in self._units:
            self._finish(unit)
        self._new_window()
        self._synchronized = True

    def _new_window(self) -> None:
        """Start every countdown again."""
        for p in self._delay:
            self._delay[p] = self.backward_passes_per_step
        self._fired.clear()
        self.hook_launches = 0

    def set_backward_passes_per_step(self, passes: int) -> None:
        """Change the accumulation window; every countdown starts again
        (reference: ``horovod/torch/optimizer.py:99-102``)."""
        self.backward_passes_per_step = passes
        for p in self._delay:
            self._delay[p] = passes

    def load_state_dict(self, *args, **kwargs):
        """Load a checkpoint and reset the countdowns and pending
        reductions (reference: ``optimizer.py:81-89``): counters left from
        before the reload would put the ranks out of step."""
        for unit in self._units:
            if unit.pending is not None and not unit.quantized:
                try:
                    unit.pending.wait()
                except HvdTpuInternalError:
                    pass  # it failed with its world; it is dropped anyway
            unit.pending = None
            unit.ready = 0
        self._new_window()
        self._synchronized = False
        self._should_synchronize = True
        self._generation += 1
        super(self.__class__, self).load_state_dict(*args, **kwargs)

    def passes_in_window(self) -> int:
        """Backward passes accumulated in the current window: 0 after
        ``synchronize()``, ``backward_passes_per_step`` once the window is
        full. A step of one backward pass decides by it whether to zero the
        gradients first (0) and to step after its pass (full)."""
        if not self._fired:
            return 0
        return self.backward_passes_per_step - min(self._delay[p]
                                                   for p in self._fired)

    # -- capture (step.run_step) -----------------------------------------------
    # A replayed graph runs no Python: the countdowns, the units' counts and
    # the pending reductions stay where the capture left them. run_step keys
    # its graphs by _window_key, takes _window_snapshot after a capture and
    # puts it back after each replay of that graph.

    def _window_key(self) -> tuple:
        """What a captured step depends on besides its tensors: the
        countdowns (the position in the window), whether this world has
        checked the layout (the check exchanges it on the host, so that
        step is never captured) and the state's generation."""
        return (tuple(sorted(set(self._delay.values()))),
                self._checked_epoch == runtime.epoch(), self._generation)

    def _window_snapshot(self) -> tuple:
        if any(u.pending is not None for u in self._units):
            raise RuntimeError(
                "a captured step left a gradient reduction in flight: the "
                "step that fills the window must call step() or "
                "synchronize()")
        return (dict(self._delay), set(self._fired),
                [u.ready for u in self._units], self.hook_launches,
                self._synchronized)

    def _window_restore(self, snapshot: tuple) -> None:
        delay, fired, ready, launches, synchronized = snapshot
        self._delay.update(delay)
        self._fired = set(fired)
        for unit, count in zip(self._units, ready):
            unit.ready = count
        self.hook_launches = launches
        self._synchronized = synchronized

    @contextlib.contextmanager
    def skip_synchronize(self) -> Iterator[None]:
        """Let ``step()`` skip ``synchronize()``, after a manual call
        (reference: ``optimizer.skip_synchronize()``)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without a new backward pass "
                    "after synchronize(); use skip_synchronize() to avoid a "
                    "redundant synchronization")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._fired or any(u.pending is not None for u in self._units):
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(); the "
                "pending gradients would be lost")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[
                             Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         op: C.ReduceOp = C.ReduceOp.AVERAGE,
                         gradient_predivide_factor: float = 1.0,
                         prescale_factor: Optional[float] = None,
                         postscale_factor: Optional[float] = None,
                         axis=None, hierarchical=None
                         ) -> torch.optim.Optimizer:
    """Wrap a torch optimizer so ``step()`` uses gradients reduced across
    ranks, reduced while ``backward()`` runs (reference:
    ``hvd.DistributedOptimizer``, ``horovod/torch/optimizer.py:383``).

    * ``compression``: ``None``/``Compression.fp16``/``bf16`` (dense, cast on
      the wire), a :class:`MaxMinQuantizer`, :class:`NormalizedQuantizer`
      or :class:`TopKCompressor`, or a :class:`CompressionConfig` (per-name
      compressors, the reducer, and error feedback, applied once a
      reduction). No ``key`` reaches the reducers, as in the JAX package:
      stochastic rounding draws seed 0 every step.
    * ``backward_passes_per_step`` k: the gradients of k backward passes
      accumulate in ``p.grad`` (summed, as PyTorch and the reference torch
      binding sum them) and are reduced once, in the k-th pass. The JAX
      package's ``optax.MultiSteps`` averages the k gradients instead: scale
      each micro-batch's loss by 1/k for its result.
    * ``op``: ``Average`` (default), ``Sum`` or ``Adasum`` (each gradient
      combined with its own coefficients; not with quantized
      compression); dense gradients also take ``Min``/``Max``/``Product``.
    * ``gradient_predivide_factor`` f splits the averaging: gradients are
      scaled by f/size before the sum and by 1/f after (op must be
      Average; size is the ranks the reduction spans); otherwise
      ``prescale_factor``/``postscale_factor`` scale before and after.
    * ``axis``: reduce over the ranks of this mesh axis (the
      data-parallel axis by default, as in the JAX package).
    * ``hierarchical``: ``(inner_axis, outer_axis)`` reduces each dense
      bucket by :func:`~horovod_tpu_torch.ops.collectives.
      hierarchical_allreduce` (Adasum: sum within the inner axis, Adasum
      across the outer one); ``("auto", inner, outer)`` asks the
      calibration table at the gradients' total bytes when the optimizer
      is built, and reduces flat over both axes when it says so or has no
      entry (Adasum stays hierarchical). Not with a compressor.

    ``opt.hook_launches`` counts the reductions the hooks launched since
    the last ``synchronize()`` (in Python: a replayed CUDA graph of the
    step does not count them).
    """
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be at least 1")
    if hierarchical is not None and compression is not None:
        raise ValueError(
            "hierarchical gradient reduction does not take a compressor; "
            "use hierarchical_compressed_allreduce over the slow axis "
            "instead")
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    group, hier = _resolve(axis, hierarchical, op, sum(
        p.numel() * p.element_size() for p in params))
    if gradient_predivide_factor != 1.0:
        if op != C.ReduceOp.AVERAGE:
            raise ValueError("gradient_predivide_factor not supported with "
                             "op != Average")
        pre = gradient_predivide_factor / C._size(group)
        post = 1.0 / gradient_predivide_factor
        op = C.ReduceOp.SUM
    else:
        pre = 1.0 if prescale_factor is None else prescale_factor
        post = 1.0 if postscale_factor is None else postscale_factor
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression, op,
               pre, post, backward_passes_per_step, axis, group, hier)


def _tensors(params) -> List[torch.Tensor]:
    if isinstance(params, dict):
        params = params.items()
    out = []
    for item in params:
        t = item[1] if isinstance(item, tuple) else item
        out.append(t.data if isinstance(t, torch.nn.Parameter) else t)
    return out


def _broadcast_grouped(tensors: List[torch.Tensor], root_rank: int,
                       prefix: str) -> None:
    """Process mode: every tensor enqueued as ``{prefix}.{i}`` in one
    grouped window, one negotiation round for the whole tree (JAX
    ``_broadcast_tree``, ``optimizer.py:401-420``), then written in
    place."""
    with C.grouped_enqueue():
        handles = [C.broadcast_async(t, root_rank, name=f"{prefix}.{i}")
                   for i, t in enumerate(tensors)]
    for t, h in zip(tensors, handles):
        t.copy_(C.synchronize(h))


def broadcast_parameters(params: Union[dict, Iterable], root_rank: int = 0
                         ) -> None:
    """Broadcast parameters or buffers from ``root_rank`` in place
    (reference: ``horovod/torch/functions.py:30``). Takes a ``state_dict``,
    ``named_parameters()`` or a list of tensors."""
    if runtime.mode() == "process":
        _broadcast_grouped(_tensors(params), root_rank,
                           "broadcast_parameters")
        return
    for t in _tensors(params):
        C.broadcast_(t, root_rank)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast an optimizer's state tensors and hyperparameters from
    ``root_rank`` in place (reference: ``horovod/torch/functions.py:62``).
    Every rank must hold state for the same parameters."""
    hyper = broadcast_object([{k: v for k, v in g.items() if k != "params"}
                              for g in optimizer.param_groups], root_rank)
    for group, values in zip(optimizer.param_groups, hyper):
        group.update(values)
    if runtime.mode() == "process":
        _broadcast_grouped(
            [v for group in optimizer.param_groups for p in group["params"]
             for v in optimizer.state.get(p, {}).values()
             if torch.is_tensor(v)], root_rank, "broadcast_optimizer_state")
        return
    dev = runtime.device()
    for group in optimizer.param_groups:
        for p in group["params"]:
            for value in optimizer.state.get(p, {}).values():
                if not torch.is_tensor(value):
                    continue
                if value.device == dev:
                    C.broadcast_(value, root_rank)
                else:
                    # e.g. Adam's step count, kept on the CPU.
                    value.copy_(C.broadcast(value.to(dev), root_rank))
