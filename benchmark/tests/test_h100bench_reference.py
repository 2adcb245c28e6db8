"""The plain reference against the measured program, on the CPU at a tiny
size and in float32: the models' forward and backward, the reducer, and
whole checked steps through the harness."""

from __future__ import annotations

import importlib

import pytest
import torch
import torch.nn.functional as F

import compare
import harness
import inputs
import spec
from conftest import tiny_configs

CONFIGS = tiny_configs()


def _port_model(cfg):
    module, attr = cfg["port"]["model"].split(":")
    return getattr(importlib.import_module(module), attr)(
        **cfg["port"]["kwargs"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_models_agree_in_float32(name):
    cfg = CONFIGS[name]
    ref = importlib.import_module(f"reference.{cfg['family']}").build(cfg)
    port = _port_model(cfg)
    shapes = [(n, p.shape) for n, p in ref.named_parameters()]
    weights = inputs.weights(shapes, cfg["init"], 3, "cpu")
    with torch.no_grad():
        for module in (ref, port):
            for n, p in module.named_parameters():
                p.copy_(weights[n])
    images, labels = inputs.batch(cfg, 3, 0, 0, "cpu")
    losses, grads = [], []
    for module in (ref, port):
        module.zero_grad()
        loss = F.cross_entropy(module(images), labels)
        loss.backward()
        losses.append(loss.detach())
        grads.append({n: p.grad for n, p in module.named_parameters()})
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=1e-6)
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=1e-4,
                                   atol=1e-5, msg=n)


def test_reducer_is_the_ports_bitwise():
    """The port's scatter_allgather at a world of one (its plain kernels
    on the CPU) against the reference's, with error feedback, over three
    calls."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compression import MaxMinQuantizer
    from horovod_tpu_torch.compression.reducers import \
        compressed_grouped_allreduce
    from reference import maxmin
    hvd.init(device="cpu")
    try:
        gen = torch.Generator().manual_seed(0)
        leaves = [torch.randn(700, generator=gen),
                  torch.randn(33, 5, generator=gen)]
        res_port = [torch.zeros_like(t) for t in leaves]
        res_ref = [torch.zeros(sum(t.numel() for t in leaves))]
        for _ in range(3):
            out, new = compressed_grouped_allreduce(
                leaves, MaxMinQuantizer(bits=4, bucket_size=512),
                reduction="scatter_allgather", residuals=res_port)
            res_port = new
            flat = torch.cat([t.reshape(-1) for t in leaves])
            want, res_ref = maxmin.scatter_allgather([flat], res_ref, 4, 512)
            assert torch.equal(torch.cat([o.reshape(-1) for o in out]), want)
            assert torch.equal(torch.cat([r.reshape(-1) for r in res_port]),
                               res_ref[0])
            leaves = [t * 1.5 + 0.1 for t in leaves]
    finally:
        hvd.shutdown()


def test_checked_steps_agree_in_float32(tiny_checkout, monkeypatch):
    """The harness's checked steps of the tiny VGG cell, the program run in
    float32 (no autocast): every compared number reads 0, but the
    reducer's, whose input is rebuilt from SGD's momentum buffers and moves
    a value a level where that rounds across a level's edge."""
    def fp32_step(dtype, device_type, cache):
        def step(model, opt, batch):
            images, labels = batch
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(images), labels)
            loss.backward()
            opt.step()
            return loss.detach()
        return step
    monkeypatch.setattr(harness, "train_step", fp32_step)
    cell = spec.load_cell("tiny_vgg.maxmin4.eager", tiny_checkout,
                          tiny_checkout / "benchmark")
    record = harness.run_rank(cell, 2**31 + 5, 0.01, False, "cpu")
    checks = harness.check(cell, 2**31 + 5, [record], torch.device("cpu"))
    values = {k: c["value"] for k, c in checks.items()}
    assert values.pop("reduce_diff") < 1e-4
    assert values == {"loss": 0.0, "grad_norm": 0.0, "change_norm": 0.0}


def test_compare_reads_infinity_for_nan():
    ref = {"ranks": [0], "losses": [[1.0]],
           "first_grad": {"w": torch.ones(3)}, "change": {"w": torch.ones(3)}}
    bad = dict(ref, losses=[[float("nan")]])
    assert compare.readings(bad, ref)["loss"] == float("inf")
    worse = dict(ref, first_grad={"w": torch.tensor([1., 1., float("nan")])})
    assert compare.readings(worse, ref)["grad_norm"] == float("inf")
    assert set(compare.readings(ref, ref).values()) == {0.0}


def test_compare_numbers_by_leaf_and_whole():
    ref = {"ranks": [0, 1], "losses": [[2.0, 2.0], [4.0, 4.0]],
           "first_grad": {"a": torch.tensor([3.0, 4.0]),
                          "b": torch.tensor([1.0]), "c": torch.tensor([0.0])},
           "change": {"a": torch.ones(2), "b": torch.ones(1),
                      "c": torch.ones(1)}}
    got = {"ranks": [0, 1], "losses": [[2.0, 2.2], [4.0, 3.0]],
           "first_grad": {"a": torch.tensor([3.0, 4.0]),
                          "b": torch.tensor([2.0]), "c": torch.tensor([0.0])},
           "change": {"a": torch.ones(2), "b": torch.ones(1),
                      "c": torch.zeros(1)}}
    r = compare.readings(got, ref)
    assert r["loss"] == pytest.approx(0.25)
    # Leaf norms 5, 1, 0 (median 1): b reads |2 - 1| / max(1, 1) = 1.
    assert r["grad_leaf"] == pytest.approx(1.0)
    assert r["grad_norm"] == pytest.approx(29 ** 0.5 / 26 ** 0.5 - 1)
    assert r["grad_diff.b"] == pytest.approx(1.0)
    assert r["grad_diff.a"] == 0.0
    # c's gradient is quiet: its change is left out.
    assert r["change_leaf"] == 0.0 and r["change_norm"] == 0.0
