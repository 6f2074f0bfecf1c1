"""Image resize with the semantics of ``jax.image.resize`` for ``"bilinear"``
and ``"bicubic"`` (the JAX package resizes with it; ``F.interpolate`` does
not compute the same function).

What ``jax.image.resize`` computes, with its default ``antialias=True``:

- pixel centres are half-pixel: output pixel ``o`` samples input position
  ``(o + 0.5) / scale - 0.5``;
- when downsampling, the kernel is widened by ``1 / scale`` (a low-pass
  filter); when upsampling it is not;
- each output's weights are normalised over the taps that fall inside the
  image (no clamping or reflection at the borders);
- ``"bilinear"`` is the triangle kernel, ``"bicubic"`` Keys' cubic with
  a = −0.5 (``F.interpolate``'s bicubic uses a = −0.75 and clamps).

The resize is applied as two separable weight matrices, one per spatial
axis, and is differentiable in the image.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 resampling weights of one axis, computed
    in float32 as ``jax.image.resize`` computes them (the sample positions'
    rounding moves a bicubic weight by ~1e-5)."""
    f32 = np.float32
    kernel = KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None, :]) / kernel_scale
    w = kernel(x).astype(f32)
    total = w.sum(1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


def resize_hw(images: torch.Tensor, height: int, width: int, method: str = "bilinear") -> torch.Tensor:
    """Resize (..., H, W, C) images to (..., height, width, C).  An axis
    that already has its size is left as it is."""
    out = images
    for ax, size in ((-3, height), (-2, width)):
        n = out.shape[ax]
        if n == size:
            continue
        w = torch.as_tensor(weight_matrix(int(n), int(size), method), device=out.device,
                            dtype=out.dtype)
        out = torch.tensordot(out, w, dims=([ax], [1])).movedim(-1, ax)
    return out
