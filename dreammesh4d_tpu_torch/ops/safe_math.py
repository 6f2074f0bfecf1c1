"""NaN-free numeric helpers (counterpart of ``dreammesh4d_tpu/ops/safe_math.py``).

``x / (‖x‖ + ε)`` is value-safe but its gradient is NaN at x = 0; exactly-zero
vectors do occur (splatted background normals, zero-init rotations), so
normalizations in gradient paths go through these.
"""

from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2 normalize with finite gradients everywhere (rsqrt(‖x‖²+ε))."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def safe_norm(x: torch.Tensor, eps: float = 1e-12, axis=-1, keepdims: bool = False) -> torch.Tensor:
    """‖x‖ with a finite gradient at 0: sqrt(‖x‖² + ε)."""
    return torch.sqrt((x * x).sum(dim=axis, keepdim=keepdims) + eps)
