"""zero123-system (counterpart of ``dreammesh4d_tpu/systems/zero123_system.py``).
Only the two masked depth losses that the dynamic stage borrows are ported
so far; the static NeRF stage itself is later work (ROADMAP.md queue A)."""

from __future__ import annotations

import torch


def masked_lstsq_depth_loss(pred: torch.Tensor, gt: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Least-squares-align gt depth to pred inside the mask (scale and shift
    from the 2x2 weighted normal equations, as constants), then the masked
    MSE."""
    m = mask.reshape(-1)
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    n = torch.clamp(m.sum(), min=1.0)
    sgg = (m * g * g).sum()
    sg = (m * g).sum()
    sgp = (m * g * p).sum()
    sp = (m * p).sum()
    det = sgg * n - sg * sg
    det = torch.where(det.abs() < 1e-8, torch.ones_like(det), det)
    a = (sgp * n - sg * sp) / det
    b = (sgg * sp - sg * sgp) / det
    aligned = a.detach() * g + b.detach()
    return (m * (aligned - p) ** 2).sum() / n


def masked_pearson(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over the masked pixels."""
    m = mask.reshape(-1)
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    n = torch.clamp(m.sum(), min=1.0)
    mp = (m * p).sum() / n
    mg = (m * g).sum() / n
    cov = (m * (p - mp) * (g - mg)).sum()
    vp = (m * (p - mp) ** 2).sum()
    vg = (m * (g - mg) ** 2).sum()
    return cov / torch.sqrt(torch.clamp(vp * vg, min=1e-8))
