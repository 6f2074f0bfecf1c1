"""Diffusion noise schedule and DDIM stepping (counterpart of
``dreammesh4d_tpu/models/guidance/zero123/scheduler.py``).

Zero123 trains with a scaled-linear (sqrt-space) beta schedule: 1000 steps,
linear_start 0.00085, linear_end 0.012.  Tensors are NCHW; ``t`` is (B,)
integer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor  # (T,) float32
    alphas_cumprod: torch.Tensor  # (T,) float32
    num_train_timesteps: int


def make_schedule(num_train_timesteps: int = 1000, linear_start: float = 0.00085,
                  linear_end: float = 0.012, device="cuda") -> DiffusionSchedule:
    """Betas linear in sqrt space, computed in float64 and stored as float32."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    return DiffusionSchedule(torch.as_tensor(betas.astype(np.float32), device=device),
                             torch.as_tensor(acp.astype(np.float32), device=device),
                             num_train_timesteps)


def _per_sample(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape((-1,) + (1,) * (ndim - 1))


def add_noise(sched: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): sqrt(ᾱ_t) x0 + sqrt(1 − ᾱ_t) ε."""
    a = _per_sample(sched.alphas_cumprod[t], x0.ndim)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def ddim_step(sched: DiffusionSchedule, x_t: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor) -> torch.Tensor:
    """Deterministic (eta = 0) DDIM update x_t → x_{t_prev}; ``t_prev < 0``
    steps to ᾱ = 1."""
    acp = sched.alphas_cumprod
    a_t = _per_sample(acp[t], x_t.ndim)
    a_prev = _per_sample(torch.where(t_prev >= 0, acp[torch.clamp(t_prev, min=0)],
                                     torch.ones_like(acp[0])), x_t.ndim)
    x0_pred = (x_t - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1 - a_prev, min=0.0)) * eps
    return torch.sqrt(a_prev) * x0_pred + dir_xt
