"""ResNet's batch norm with its ReLU and residual add
(``horovod_tpu_torch/models/norm_kernels.py``, ``csrc/batch_norm.cu``).

On the CPU (float64): the plain path of ``models.resnet.norm_act`` and of
``BatchNorm.forward``, and ``norm_kernels.batch_norm_act_plain``, against
the composition the models used before the kernels (``_composed`` below:
``F.batch_norm`` on copies of the running statistics, flax's fix-up of the
running variance, ``+``, ``F.relu``), bitwise, over every variant (ReLU or
not; no residual, the identity or a projection; training or eval):
output, dx, dweight, dbias, the residual's gradient and the running
statistics after three steps. The blocks against their earlier forward;
``SyncBatchNorm`` and a model converted by ``convert_sync_batchnorm`` take
the composed path.

The tests marked ``cuda`` hold the kernels against the plain version on the
card (``python -m pytest --noconftest -m cuda
tests/test_torch_port_batch_norm.py``): at every (rows, C) shape of
ResNet-50's 53 batch norms at 256 images of 224x224 and at three ragged
ones, in bf16 and fp32, against the plain version in float64 on the same
inputs. Tolerances, and why:

* the output, dx and the residual's gradient are computed in fp32 and
  rounded once to x's type, so they may land one step of that type from
  the float64 value: 2^-8 of the value in bf16 (fp32: 1e-5); plus 1e-4 of
  the largest value (fp32: 1e-5) for the fp32 statistics and coefficients,
  each within about 1e-6 of its float64 value;
* mean and inverse std within 1e-5 relative: fp32 sums of a few hundred
  values a thread, then float64;
* dweight and dbias within 1e-5 of the channel's sum of |terms| (fp32 sums
  as above);
* the running statistics within 1e-5 relative plus 1e-7.

The backward is held given the kernel's own ReLU mask (``z > 0`` of its
output): where a pre-activation lies within fp32 rounding of 0, float64
may mask it otherwise, which moves dx there by a whole term. Two eager
calls, and an eager call and a CUDA-graph replay, agree bitwise; a
ResNet-50 step launches each of the six kernels 53 times."""

import functools

import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import norm_kernels
from horovod_tpu_torch.models.resnet import (BatchNorm,
                                             BottleneckResNetBlock, ResNet,
                                             ResNet50, ResNetBlock, norm_act)

C = 8
N_STEPS = 3


def _composed(bn, x, residual=None, relu=True):
    """The models' arithmetic before the kernels: ``BatchNorm.forward`` as
    it was, then ``F.relu(residual + y)``."""
    if not bn.training:
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
    else:
        mean, var = bn.running_mean.clone(), bn.running_var.clone()
        y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True,
                         1.0 - bn.momentum, bn.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            folded = var.sub(bn.running_var, alpha=bn.momentum)
            bn.running_var.mul_(bn.momentum).add_(folded, alpha=(n - 1) / n)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


def _bn(seed, dtype=torch.float64, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(C, generator=g, dtype=dtype))
        bn.bias.copy_(torch.randn(C, generator=g, dtype=dtype))
        bn.running_mean.copy_(torch.randn(C, generator=g, dtype=dtype))
        bn.running_var.copy_(torch.rand(C, generator=g, dtype=dtype) + 0.5)
    return bn.to(device)


def _bitwise(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _run(forward, project, bn, proj, xs, rs, relu, training):
    """Three steps of ``forward(bn, x, residual, relu)`` (the residual
    ``project(proj, rs[i])`` where ``proj``, else ``rs[i]`` or none); each
    step's output and gradients, and the running statistics after them."""
    bn.train(training)
    if proj is not None:
        proj.train(training)
    out = []
    for i, x in enumerate(xs):
        x = x.clone().requires_grad_()
        r = None if rs is None else rs[i].clone().requires_grad_()
        params = [bn.weight, bn.bias]
        residual = r
        if proj is not None:
            residual = project(proj, r)
            params += [proj.weight, proj.bias]
        y = forward(bn, x, residual, relu)
        g = torch.Generator().manual_seed(100 + i)
        dz = torch.randn(y.shape, generator=g, dtype=y.dtype)
        grads = torch.autograd.grad(y, [x, *params] + ([] if r is None
                                                       else [r]), dz)
        out.append((y.detach(), *grads))
    out.append((bn.running_mean.clone(), bn.running_var.clone()))
    if proj is not None:
        out.append((proj.running_mean.clone(), proj.running_var.clone()))
    return out


def _plain(bn, x, residual, relu):
    return norm_kernels.batch_norm_act_plain(
        x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.training,
        bn.momentum, bn.eps, residual, relu)


def _through_module(bn, x, residual, relu):
    """``BatchNorm.forward`` itself, then the composition."""
    y = bn(x)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


@pytest.mark.parametrize("form", ["norm_act", "plain", "module"])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("residual", [None, "identity", "projection"])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_path_matches_composition(form, training, residual, relu):
    g = torch.Generator().manual_seed(7)
    xs = [torch.randn(4, C, 5, 3, generator=g, dtype=torch.float64) * 3 + 1
          for _ in range(N_STEPS)]
    rs = None if residual is None else [
        torch.randn(4, C, 5, 3, generator=g, dtype=torch.float64)
        for _ in range(N_STEPS)]
    forward = {"norm_act": norm_act, "plain": _plain,
               "module": _through_module}[form]

    def run(fn, project):
        proj = _bn(2) if residual == "projection" else None
        return _run(fn, project, _bn(1), proj, xs, rs, relu, training)

    got = run(forward, lambda p, r: p(r))
    want = run(_composed, lambda p, r: _composed(p, r, relu=False))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for t, u in zip(a, b):
            _bitwise(t, u)


def _old_bottleneck(block, x):
    y = _composed(block.bn1, block.conv1(x))
    y = _composed(block.bn2, block.conv2(y))
    y = _composed(block.bn3, block.conv3(y), relu=False)
    residual = x
    if block.conv_proj is not None:
        residual = _composed(block.norm_proj, block.conv_proj(x), relu=False)
    return F.relu(residual + y)


def _old_basic(block, x):
    y = _composed(block.bn1, block.conv1(x))
    y = _composed(block.bn2, block.conv2(y), relu=False)
    residual = x
    if block.conv_proj is not None:
        residual = _composed(block.norm_proj, block.conv_proj(x), relu=False)
    return F.relu(residual + y)


@pytest.mark.parametrize("kind,in_ch,filters,stride", [
    ("bottleneck", 16, 4, 1),    # identity residual
    ("bottleneck", 8, 4, 2),     # projection
    ("basic", 8, 8, 1),          # identity residual
    ("basic", 8, 16, 2),         # projection
])
def test_blocks_match_their_earlier_forward(kind, in_ch, filters, stride):
    """A block's output, every gradient and its running statistics over
    three training steps and an eval step, in float64, bitwise against the
    forward it had (bn3 before the projection's norm, ``F.relu(residual +
    y)``)."""
    cls, old = ((BottleneckResNetBlock, _old_bottleneck)
                if kind == "bottleneck" else (ResNetBlock, _old_basic))
    torch.manual_seed(0)
    block = cls(in_ch, filters, stride).double()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, BatchNorm):
                m.weight.normal_()
                m.bias.normal_()
    twin = cls(in_ch, filters, stride).double()
    twin.load_state_dict(block.state_dict())
    g = torch.Generator().manual_seed(3)
    for step in range(N_STEPS + 1):
        training = step < N_STEPS
        block.train(training)
        twin.train(training)
        x = torch.randn(2, in_ch, 6, 6, generator=g, dtype=torch.float64)
        outs = []
        for model, fn in ((block, cls.forward), (twin, old)):
            xi = x.clone().requires_grad_()
            y = fn(model, xi)
            dz = torch.randn(y.shape, dtype=y.dtype,
                             generator=torch.Generator().manual_seed(step))
            grads = torch.autograd.grad(
                y, [xi, *model.parameters()], dz)
            outs.append((y.detach(), *grads))
        for a, b in zip(*outs):
            _bitwise(a, b)
    for k, v in block.state_dict().items():
        _bitwise(v, twin.state_dict()[k])


def _small_resnet():
    torch.manual_seed(0)
    return ResNet([1, 1, 1, 1], BottleneckResNetBlock, num_classes=10,
                  num_filters=8).double()


def _count_calls(model, kind):
    calls = []
    for m in model.modules():
        if isinstance(m, kind):
            m.register_forward_hook(lambda *a: calls.append(1))
    return calls


def test_sync_batch_norm_takes_the_composed_path(monkeypatch):
    """At a world of one, a ResNet whose norms ``SyncBatchNorm`` (the
    flax-style one, and the torch frontend's after
    ``convert_sync_batchnorm``) replaced runs each norm through its own
    ``forward``, never through ``norm_kernels``; its output matches the
    unconverted model's within 1e-3 (the flax-style ``SyncBatchNorm`` sums
    its statistics in fp32, ROADMAP C)."""
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.torch.sync_batch_norm import \
        convert_sync_batchnorm

    def refuse(*args, **kwargs):
        raise AssertionError("norm_kernels.batch_norm_act was called")

    x = torch.randn(4, 32, 32, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    want = _small_resnet()(x)
    n_norms = sum(isinstance(m, BatchNorm) for m in _small_resnet().modules())
    thvd.init(device="cpu")
    try:
        monkeypatch.setattr(norm_kernels, "batch_norm_act", refuse)
        for convert, kind in (
                (thvd.SyncBatchNorm.convert_sync_batchnorm,
                 thvd.SyncBatchNorm),
                (convert_sync_batchnorm, ht.SyncBatchNorm)):
            model = convert(_small_resnet())
            calls = _count_calls(model, kind)
            y = model(x)
            y.sum().backward()
            assert len(calls) == n_norms == 17
            torch.testing.assert_close(y, want, rtol=1e-3, atol=1e-3)
    finally:
        thvd.shutdown()


def test_wrapper_refuses_other_devices():
    x = torch.empty(4, C, 2, 2, device="meta")
    p = torch.empty(C, device="meta")
    with pytest.raises(ValueError, match="meta"):
        norm_kernels.batch_norm_act(x, p, p, p, p, True, 0.9, 1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (rows, C) of ResNet-50's batch norms at 256 images of 224x224 (the stem,
# then each stage's bn1, bn2, bn3 and projection), and three ragged shapes:
# a row count no chunk divides, C of 3 vectors (a warp of 10 rows and 2 idle
# lanes) and C of 33 vectors (a second column tile with one).
RESNET50_SHAPES = [
    (3_211_264, 64), (802_816, 64), (802_816, 256), (802_816, 128),
    (200_704, 128), (200_704, 512), (200_704, 256), (50_176, 256),
    (50_176, 1024), (50_176, 512), (12_544, 512), (12_544, 2048)]
RAGGED_SHAPES = [(12_345, 64), (777, 24), (1_001, 264)]
VARIANTS = ["none", "relu", "relu_residual", "eval_relu_residual"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _inputs(rows, c, dtype, dev, seed):
    """x [rows/4, C, 2, 2] channels-last (offset from 0, as conv outputs
    are), a residual, dz, and fp32 parameters and running statistics."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = -(-rows // 4)
    shape = (n, c, 2, 2) if rows % 4 == 0 else (rows, c, 1, 1)

    def rand(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, generator=g, device=dev) * scale + shift

    def act(t):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    x = act(rand(*shape, scale=2.0, shift=0.5))
    r = act(rand(*shape))
    dz = act(rand(*shape))
    params = (rand(c), rand(c), rand(c, scale=0.1), rand(c).abs() + 0.5)
    return x, r, dz, params


def _kernel_step(x, r, dz, params, variant):
    """The kernels' output and gradients (x, weight, bias, residual), and
    the running statistics after the call."""
    weight, bias, rm, rv = (t.clone() for t in params)
    weight.requires_grad_()
    bias.requires_grad_()
    xi = x.detach().clone().requires_grad_()
    ri = r.detach().clone().requires_grad_() if "residual" in variant \
        else None
    z = norm_kernels.batch_norm_act(
        xi, weight, bias, rm, rv, not variant.startswith("eval"), 0.9, 1e-5,
        ri, "relu" in variant)
    inputs = [xi, weight, bias] + ([ri] if ri is not None else [])
    grads = torch.autograd.grad(z, inputs, dz)
    return z.detach(), grads, rm, rv


def _reference(x, r, dz, params, variant, z):
    """The plain version in float64 on the same inputs; its backward given
    the kernel's mask ``z > 0``."""
    weight, bias, rm, rv = (t.double().clone() for t in params)
    training = not variant.startswith("eval")
    relu, res = "relu" in variant, "residual" in variant
    xd = x.double().requires_grad_()
    wd, bd = weight.requires_grad_(), bias.requires_grad_()
    rd = r.double() if res else None
    want = norm_kernels.batch_norm_act_plain(
        xd.detach(), wd.detach(), bd.detach(), rm.clone(), rv.clone(),
        training, 0.9, 1e-5, rd, relu)
    y = norm_kernels.batch_norm_act_plain(xd, wd, bd, rm, rv, training,
                                          0.9, 1e-5)
    dy = dz.double() * (z > 0) if relu else dz.double()
    grads = torch.autograd.grad(y, [xd, wd, bd], dy)
    return want, grads + ((dy,) if res else ()), rm, rv, dy


def _close(got, want, rel, abs_share, what):
    got = got.double()
    bound = rel * want.abs() + abs_share * float(want.abs().max())
    excess = ((got - want).abs() - bound).max()
    assert excess <= 0, (what, float(excess), float(bound.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows,c", RESNET50_SHAPES + RAGGED_SHAPES)
def test_cuda_kernels_match_plain(rows, c, dtype, variant):
    dev = _cuda()
    x, r, dz, params = _inputs(rows, c, dtype, dev, rows + c)
    z, grads, rm, rv = _kernel_step(x, r, dz, params, variant)
    want, want_grads, want_rm, want_rv, dy = _reference(x, r, dz, params,
                                                        variant, z)
    rel, abs_share = ((2**-8, 1e-4) if dtype != torch.float32
                      else (1e-5, 1e-5))
    _close(z, want, rel, abs_share, "output")
    _close(grads[0], want_grads[0], rel, abs_share, "dx")
    if "residual" in variant:
        _close(grads[3], want_grads[3], 0, 0, "dresidual")
    # dweight and dbias against each channel's sum of |terms|.
    xd = x.double()
    if variant.startswith("eval"):
        mean, inv = params[2].double(), (params[3].double() + 1e-5).rsqrt()
    else:
        dims = [d for d in range(xd.dim()) if d != 1]
        mean = xd.mean(dims)
        inv = (xd.var(dims, unbiased=False) + 1e-5).rsqrt()
    shape = [1, -1] + [1] * (xd.dim() - 2)
    xhat = (xd - mean.view(shape)) * inv.view(shape)
    dims = [d for d in range(xd.dim()) if d != 1]
    for i, terms in ((1, (dy * xhat).abs().sum(dims)),
                     (2, dy.abs().sum(dims))):
        err = (grads[i].double() - want_grads[i]).abs()
        assert (err <= 1e-5 * terms + 1e-7).all(), (i, float(err.max()))
    torch.testing.assert_close(rm.double(), want_rm, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(rv.double(), want_rv, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(3_211_264, 64), (12_544, 2048),
                                    (1_001, 264)])
def test_cuda_kernels_are_deterministic(rows, c):
    """Two eager calls, and an eager call and the replay of a CUDA graph
    of the same call, give the same bits: output, every gradient and the
    running statistics."""
    dev = _cuda()
    x, r, dz, params = _inputs(rows, c, torch.bfloat16, dev, 11)
    step = functools.partial(_kernel_step, x, r, dz, params,
                             "relu_residual")

    def flat(out):
        z, grads, rm, rv = out
        return [z, *grads, rm, rv]

    first, second = flat(step()), flat(step())
    for a, b in zip(first, second):
        _bitwise(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flat(step())
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(first, captured):
        _bitwise(a, b)


@pytest.mark.cuda
def test_cuda_resnet50_launches_each_kernel_per_norm():
    """A ResNet-50 training step launches each of the six kernels once for
    each of its 53 batch norms; an eval forward the apply alone."""
    dev = _cuda()
    model = ResNet50(num_classes=10).to(dev,
                                        memory_format=torch.channels_last)
    x = torch.randn(2, 64, 64, 3, device=dev)
    norm_kernels.reset_launches()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = model(x).square().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert norm_kernels.LAUNCHES == dict.fromkeys(norm_kernels.LAUNCHES, 53)
    norm_kernels.reset_launches()
    model.eval()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model(x)
    want = dict.fromkeys(norm_kernels.LAUNCHES, 0)
    want["bn_apply"] = 53
    assert norm_kernels.LAUNCHES == want


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernels_do_not_take():
    dev = _cuda()
    p = torch.ones(12, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        norm_kernels.batch_norm_act(torch.ones(4, 12, 2, 2, device=dev),
                                    p, p, p, p, True, 0.9, 1e-5)
    p = torch.ones(8, device=dev)
    with pytest.raises(TypeError, match="float64"):
        norm_kernels.batch_norm_act(
            torch.ones(4, 8, 2, 2, device=dev, dtype=torch.float64),
            p, p, p, p, True, 0.9, 1e-5)
