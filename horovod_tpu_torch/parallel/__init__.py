"""Data-parallel training of the PyTorch port."""

from .optimizer import (DistributedOptimizer,  # noqa: F401
                        broadcast_optimizer_state, broadcast_parameters)
