"""The frozen bytes and operations of B1, B3 and B4 against
``chip_smoke.kernel_work``'s, at ResNet-50's fused gradient."""

from __future__ import annotations

import pytest

from kernel_work import maxmin

RESNET50 = 25_557_032


@pytest.fixture(scope="module")
def smoke_work():
    import torch
    import chip_smoke
    from horovod_tpu_torch.compression import kernels, norm_kernels
    x = torch.randn(RESNET50, generator=torch.Generator().manual_seed(0))
    work, _ = chip_smoke.kernel_work(kernels, norm_kernels, x, 67e12,
                                     copies=1)
    return {k: (v[2], v[3]) for k, v in work.items()}


def test_frozen_counts_match_chip_smoke(smoke_work):
    buckets = -(-RESNET50 // 512)
    assert maxmin.quantize(RESNET50, 512) == smoke_work["maxmin_quantize"]
    assert maxmin.dequantize(1, buckets, 512, 4) == \
        smoke_work["maxmin_dequantize"]
    assert maxmin.dequantize_sum(1, buckets, 512, 4) == \
        smoke_work["maxmin_dequantize_sum"]


def test_a_step_launches_five_kernels_on_its_chunks():
    launches = maxmin.step_launches(1000, 4, 4, 512)
    assert [name for name, _, _ in launches] == [
        "maxmin_quantize", "maxmin_dequantize", "maxmin_dequantize_sum",
        "maxmin_quantize", "maxmin_dequantize"]
    # 250 values a chunk, one bucket of 512 each: B1 reads the 4 padded
    # rows, then the 250-value reduced chunk.
    assert launches[0][1] == 4 * 2048 + 2048 + 8 * 4
    assert launches[3][1] == 4 * 250 + 512 + 8
    assert launches[2][2] == 3 * 4 * 512


def test_names_in_a_trace():
    assert maxmin.kernel_of("void maxmin_quantize_kernel<4>(float const*)") \
        == "maxmin_quantize"
    assert maxmin.kernel_of("maxmin_decode_packed_kernel<true, 4>") == \
        "maxmin_dequantize_sum"
    assert maxmin.kernel_of("maxmin_decode_generic_kernel<false>") == \
        "maxmin_dequantize"
    assert maxmin.kernel_of("ncclDevKernel_AllGather_RING_LL") is None
