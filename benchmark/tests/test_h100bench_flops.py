"""The FLOP counters against torchvision's published multiply-adds."""

from __future__ import annotations

import json

import pytest

import spec
from conftest import REPO
from flops import train_flops_per_image

# torchvision's model cards: GFLOPS as multiply-adds of a 224x224 image.
PUBLISHED = {"resnet50": 4.09e9, "vgg16": 15.47e9}


@pytest.mark.parametrize("config", sorted(PUBLISHED))
def test_forward_macs_match_torchvision(config):
    data = json.loads((REPO / "benchmark" / "configs" /
                       f"{config}.json").read_text())
    macs = spec.importlib.import_module(
        f"flops.{data['family']}").forward_macs(data)
    assert abs(macs / PUBLISHED[config] - 1) < 0.01


def test_training_is_three_forward_passes_at_two_flops_a_macc():
    assert train_flops_per_image(4_089_184_256) == 24_535_105_536
