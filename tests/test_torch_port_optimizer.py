"""The port's DistributedOptimizer and the whole slice, held against the JAX
package's eager DistributedOptimizer on a 1-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as thvd
from horovod_tpu.compression import CompressionConfig as JaxConfig
from horovod_tpu.compression import MaxMinQuantizer as JaxMaxMin
from horovod_tpu.compression import NormalizedQuantizer as JaxNorm
from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu_torch.compression import (CompressionConfig,
                                           MaxMinQuantizer,
                                           NormalizedQuantizer,
                                           TopKCompressor, from_env,
                                           make_compressor)
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.convert import flax_to_torch
from test_torch_port_model import random_variables

SHAPES = {"a": (7, 33), "b": (40,), "c": (3, 5, 8)}


@pytest.fixture
def worlds(make_runtime):
    """A 1-device JAX mesh and a 1-rank gloo world of the port."""
    jhvd = make_runtime(mesh_shape={"dp": 1}, devices=jax.devices()[:1])
    thvd.init(device="cpu")
    yield jhvd
    thvd.shutdown()


_QUANTIZERS = {
    "maxmin": (lambda: JaxMaxMin(4, 64, use_pallas=False),
               lambda: MaxMinQuantizer(4, 64)),
    "norm": (lambda: JaxNorm(4, 64, use_pallas=False),
             lambda: NormalizedQuantizer(4, 64)),
}


@pytest.mark.parametrize("reduction,quant", [
    pytest.param(r, "maxmin", id=r)
    for r in ("scatter_allgather", "allgather", "ps")] + [
    pytest.param(r, "norm", id=f"{r}-norm")
    for r in ("scatter_allgather", "ring", "tree")])
def test_three_compressed_steps_match_jax(worlds, reduction, quant):
    """The same numpy gradients for 3 steps of SGD(0.1, momentum 0.9) with
    4-bit max-min or normalized (uniform levels, linf) compression and
    error feedback: params and residuals agree within 1e-6."""
    jhvd = worlds
    jax_quant, port_quant = _QUANTIZERS[quant]
    rng = np.random.RandomState(4)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]

    jopt = jhvd.DistributedOptimizer(
        optax.sgd(0.1, momentum=0.9),
        compression=JaxConfig(jax_quant(), reduction=reduction,
                              error_feedback=True))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

    # The port fuses in parameter order; give it the pytree's (sorted) one.
    tparams = {k: torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in sorted(SHAPES)}
    topt = thvd.DistributedOptimizer(
        torch.optim.SGD(list(tparams.values()), lr=0.1, momentum=0.9),
        named_parameters=list(tparams.items()),
        compression=CompressionConfig(port_quant(), reduction=reduction,
                                      error_feedback=True))
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()

    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(topt.state[p]["hvd_residual"].numpy(),
                                   np.asarray(jstate[1][k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    # The residuals ride the optimizer's state_dict.
    saved = topt.state_dict()["state"]
    assert all("hvd_residual" in v for v in saved.values())


def test_dense_and_scaled_steps(worlds):
    """Without compression at world 1, Average/Sum and pre/postscale reduce
    to plain scaling of the gradient."""
    p = torch.nn.Parameter(torch.ones(6))
    opt = thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                    prescale_factor=0.5,
                                    postscale_factor=3.0, op=thvd.Sum)
    p.grad = torch.full((6,), 2.0)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 3.0)
    q = torch.nn.Parameter(torch.ones(4))
    opt = thvd.DistributedOptimizer(torch.optim.SGD([q], lr=1.0),
                                    gradient_predivide_factor=2.0)
    q.grad = torch.full((4,), 4.0)
    opt.step()
    np.testing.assert_allclose(q.detach().numpy(), 1.0 - 4.0)
    assert isinstance(opt, torch.optim.SGD)


@pytest.mark.parametrize("compression", [
    MaxMinQuantizer(4, 64, stochastic=True), NormalizedQuantizer(2, 64),
    TopKCompressor(0.25)], ids=repr)
def test_quantizers_pass_directly(worlds, compression):
    """Each quantizer given as ``compression`` sends the fused gradients
    through the default reducer, scatter_allgather, with no key."""
    from horovod_tpu_torch.compression import compressed_grouped_allreduce
    rng = np.random.RandomState(8)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in SHAPES.values()]
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
    opt = thvd.DistributedOptimizer(torch.optim.SGD(params, lr=1.0),
                                    compression=compression)
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt.step()
    want = compressed_grouped_allreduce(grads, compression)
    for p, w in zip(params, want):
        torch.testing.assert_close(p.detach(), -w, rtol=0, atol=0)
    assert any(not torch.equal(p.detach(), -g) for p, g in zip(params, grads))


def _bucket_units(leaves, bits, bucket):
    """For each value of ``leaves``, the quantization unit of the bucket it
    falls in when the leaves are fused in this order (zero-padded tail)."""
    flat = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for v in leaves])
    n_buckets = -(-flat.size // bucket)
    padded = np.zeros(n_buckets * bucket, np.float32)
    padded[:flat.size] = flat
    rows = padded.reshape(n_buckets, bucket)
    per_value = np.repeat((rows.max(1) - rows.min(1)) / ((1 << bits) - 1),
                          bucket)
    out, off = [], 0
    for v in leaves:
        out.append(per_value[off:off + v.size].reshape(v.shape))
        off += v.size
    return out


def test_whole_slice_step_from_converted_weights(worlds):
    """One step of the slice on a small ResNet converted from flax
    variables drawn from a seed:
    forward, backward, 4-bit scatter_allgather compression with error
    feedback, SGD.

    The two packages fuse the gradients in different orders and layouts
    (HWIO against OIHW), so their buckets differ, and each side is held to
    its own buckets: at world 1 with a zero residual, the reduced gradient
    is quantized twice in the same buckets, so each value lies within half
    a unit of the first quantization plus half of the second (no wider than
    the first, up to rounding) of the true gradient — within one unit of
    its own bucket (times 1 + 1e-5, plus 1e-6 for the decode's rounding).
    The port's reduced gradient has at most 2**bits values per bucket, and
    SGD applied it. The stepped parameters of the two packages then differ
    by at most lr times both sides' units plus the gap between the two
    true gradients."""
    jhvd = worlds
    lr, bits = 0.1, 4
    flax_model = jax_resnet.ResNet(
        stage_sizes=[1, 1], block_cls=jax_resnet.BottleneckResNetBlock,
        num_classes=10, num_filters=8, dtype=jnp.float32)
    rng = np.random.RandomState(5)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 4)
    variables = random_variables(flax_model, x, 2)

    def loss_fn(params):
        logits, _ = flax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    jopt = jhvd.DistributedOptimizer(
        optax.sgd(lr, momentum=0.9),
        compression=JaxConfig(JaxMaxMin(bits, 512, use_pallas=False),
                              reduction="scatter_allgather",
                              error_feedback=True))
    updates, _ = jopt.update(grads, jopt.init(variables["params"]),
                             variables["params"])
    to_port = lambda tree: {k: v.numpy() for k, v in flax_to_torch(
        {"params": jax.tree.map(np.asarray, tree)}).items()}
    want = to_port(optax.apply_updates(variables["params"], updates))
    jax_true = to_port(grads)
    # The first momentum step's update is -lr times the reduced gradient.
    jax_reduced = to_port(jax.tree.map(lambda u: -u / lr, updates))
    leaves, treedef = jax.tree.flatten(grads)
    jax_units = to_port(jax.tree.unflatten(
        treedef, _bucket_units(leaves, bits, 512)))

    model = resnet.ResNet(stage_sizes=[1, 1],
                          block_cls=resnet.BottleneckResNetBlock,
                          num_classes=10, num_filters=8)
    model.load_state_dict(flax_to_torch(variables))
    model.train()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=CompressionConfig(MaxMinQuantizer(bits, 512),
                                      reduction="scatter_allgather",
                                      error_feedback=True))
    thvd.broadcast_parameters(model.state_dict(), root_rank=0)
    loss = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    names = [k for k, _ in model.named_parameters()]
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    port_true = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    port_units = dict(zip(names, _bucket_units(
        [port_true[k] for k in names], bits, 512)))
    opt.step()

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    reduced = {k: p.grad.numpy() for k, p in model.named_parameters()}
    fused = np.concatenate([reduced[k].reshape(-1) for k in names])
    assert max(len(np.unique(fused[i:i + 512]))
               for i in range(0, fused.size, 512)) <= 1 << bits
    for k, p in model.named_parameters():
        np.testing.assert_allclose(port_true[k], jax_true[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        for got, true, unit, side in (
                (reduced[k], port_true[k], port_units[k], "port"),
                (jax_reduced[k], jax_true[k], jax_units[k], "jax")):
            err = np.abs(got - true)
            assert (err <= unit * (1 + 1e-5) + 1e-6).all(), \
                (side, k, float((err - unit).max()))
        torch.testing.assert_close(p.detach(), before[k] - lr * p.grad,
                                   rtol=1e-6, atol=1e-7)
        gap = lr * ((port_units[k] + jax_units[k]) * (1 + 1e-5) + 2e-6 +
                    np.abs(port_true[k] - jax_true[k])) + 1e-6
        assert (np.abs(p.detach().numpy() - want[k]) <= gap).all(), k


def test_optimizer_is_freed_with_its_model(worlds):
    """Dropping the model and its DistributedOptimizer frees both, with
    the parameters and the bucket buffers: the gradient hooks hold the
    optimizer weakly."""
    import gc
    import weakref

    model = torch.nn.Linear(4, 4)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    refs = [weakref.ref(o) for o in (model, opt, model.weight)]
    del model, opt
    gc.collect()
    assert all(r() is None for r in refs)


def test_config_factory(monkeypatch):
    assert make_compressor("none") is None
    assert make_compressor("int4") == MaxMinQuantizer(4, 512)
    assert make_compressor("maxmin", bits=2, bucket_size=64) == \
        MaxMinQuantizer(2, 64)
    # uni, exp and topk build the right compressor, as the JAX factory.
    assert make_compressor("uni") == NormalizedQuantizer(4, 512, "uni",
                                                         "linf")
    assert make_compressor("exp", bits=8, norm="l2") == \
        NormalizedQuantizer(8, 512, "exp", "l2")
    assert make_compressor("topk", topk_ratio=0.05) == TopKCompressor(0.05)
    with pytest.raises(ValueError):
        make_compressor("bogus")
    monkeypatch.setenv("HVDTPU_COMPRESSION", "maxmin")
    monkeypatch.setenv("HVDTPU_QUANTIZATION_BITS", "8")
    monkeypatch.setenv("HVDTPU_COMPRESSION_BUCKET_SIZE", "128")
    monkeypatch.setenv("HVDTPU_REDUCTION", "ps")
    monkeypatch.setenv("HVDTPU_COMPRESSION_ERROR_FEEDBACK", "1")
    cfg = from_env()
    assert cfg.default_compressor == MaxMinQuantizer(8, 128)
    assert cfg.reduction == "ps" and cfg.error_feedback
    monkeypatch.setenv("HVDTPU_COMPRESSION", "none")
    assert from_env() is None
    monkeypatch.setenv("HVDTPU_COMPRESSION", "uni")
    monkeypatch.setenv("HVDTPU_COMPRESSION_NORM_TYPE", "L2")
    assert from_env().default_compressor == NormalizedQuantizer(8, 128, "uni",
                                                                "l2")
    monkeypatch.setenv("HVDTPU_COMPRESSION", "topk")
    monkeypatch.setenv("HVDTPU_COMPRESSION_TOPK_RATIO", "0.25")
    assert from_env().default_compressor == TopKCompressor(0.25)


def test_yaml_config_matches_jax(tmp_path, monkeypatch):
    """``CompressionConfig.load`` resolves the same compressors per name as
    the JAX package's, and the env names the file."""
    from horovod_tpu.compression.quantize import (
        NormalizedQuantizer as JaxNormQ, TopKCompressor as JaxTopK)
    cfg_file = tmp_path / "comp.yaml"
    cfg_file.write_text(
        "default:\n  compressor: uni\n  bits: 4\n  bucket_size: 256\n"
        "layers:\n"
        "  - pattern: '.*bias.*'\n    ignore: true\n"
        "  - pattern: 'fc'\n    compressor: maxmin\n    bits: 8\n"
        "  - pattern: 'embed'\n    compressor: topk\n    topk_ratio: 0.5\n"
        "  - pattern: 'head'\n    norm: l2\n")
    jcfg = JaxConfig.load(str(cfg_file), reduction="ring")
    monkeypatch.setenv("HVDTPU_COMPRESSION_CONFIG_FILE", str(cfg_file))
    monkeypatch.setenv("HVDTPU_REDUCTION", "ring")
    cfg = from_env()
    assert cfg.reduction == "ring" and not cfg.error_feedback
    for name in ("conv/weight", "conv/bias", "fc/weight", "embed/table",
                 "head/weight"):
        got, want = cfg.for_name(name), jcfg.for_name(name)
        if want is None:
            assert got is None, name
        elif isinstance(want, JaxTopK):
            assert got == TopKCompressor(want.ratio), name
        elif isinstance(want, JaxNormQ):
            assert got == NormalizedQuantizer(want.bits, want.bucket_size,
                                              want.kind, want.norm), name
        else:
            assert got == MaxMinQuantizer(want.bits, want.bucket_size), name
