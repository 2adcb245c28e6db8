"""Error feedback: carry the quantization error into the next step.

Counterpart of ``horovod_tpu/compression/error_feedback.py`` (:21-40).
Reference: ``horovod/common/ops/compressed/compression/error_feedback.{h,cc}``
(h:10-31) — the compressor sees ``x + residual`` and the new residual is
what compression lost. Residuals are tensors the caller keeps (the
distributed optimizer keeps them in its state).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


def init_error_feedback(tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """Zero residuals shaped like the gradients."""
    return [torch.zeros_like(t) for t in tensors]


def compress_with_feedback(compressor, x: torch.Tensor,
                           residual: Optional[torch.Tensor], key=None
                           ) -> Tuple[Dict[str, torch.Tensor], Any,
                                      torch.Tensor]:
    """Compress ``x + residual`` (``key`` goes to ``compress``); return
    (payload, ctx, new_residual), where
    ``new_residual = (x + residual) - decompress(payload)``."""
    comp_in = x if residual is None else x + residual.to(x.dtype)
    payload, ctx = compressor.compress(comp_in, key)
    reconstructed = compressor.decompress(payload, ctx)
    new_residual = (comp_in - reconstructed).to(
        residual.dtype if residual is not None else x.dtype)
    return payload, ctx, new_residual
