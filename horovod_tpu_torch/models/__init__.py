"""Models of the PyTorch port (counterpart of ``horovod_tpu.models``)."""

from .resnet import (BottleneckResNetBlock, ResNet, ResNet18,  # noqa: F401
                     ResNet34, ResNet50, ResNet101, ResNet152, ResNetBlock)
from .gpt import GPT, GPTConfig, loss_fn  # noqa: F401
from .transformer import Transformer, default_attention  # noqa: F401
from .encoder import Encoder, masked_lm_loss  # noqa: F401
