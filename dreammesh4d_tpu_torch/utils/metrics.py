"""Evaluation metrics: PSNR, SSIM, LPIPS and CLIP similarity (counterpart
of ``dreammesh4d_tpu/utils/metrics.py``: ``psnr`` :23, ``ssim`` :48,
``LPIPSMetric`` :69, ``CLIPSimilarityMetric`` :97).  Images are
(..., H, W, C) in [0, 1], on any device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """(..., H, W, C) → PSNR in dB over the image axes."""
    mse = ((pred - target) ** 2).mean((-3, -2, -1))
    return 10.0 * torch.log10(max_val * max_val / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return g / g.sum()


def _blur(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur, depthwise, VALID: (B, C, H, W)."""
    C, K = x.shape[1], k.shape[0]
    x = F.conv2d(x, k.view(1, 1, K, 1).expand(C, 1, K, 1), groups=C)
    return F.conv2d(x, k.view(1, 1, 1, K).expand(C, 1, 1, K), groups=C)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Single-scale SSIM with an 11-tap σ 1.5 Gaussian window (torchmetrics'
    defaults): (B, H, W, C) or (H, W, C) → (B,)."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    pred = pred.permute(0, 3, 1, 2).float()
    target = target.permute(0, 3, 1, 2).float()
    k = _gaussian_kernel(kernel_size, sigma, device=pred.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x, mu_y = _blur(pred, k), _blur(target, k)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _blur(pred * pred, k) - mu_x2
    sig_y = _blur(target * target, k) - mu_y2
    sig_xy = _blur(pred * target, k) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return (num / den).mean((1, 2, 3))


class LPIPSMetric:
    """LPIPS distance with its weights' provenance.

    ``params``: a ``{"stages", "lins"}`` tree with OIHW convolutions
    (``convert.perceptual_params`` of the JAX tree, for one); ``weights_path``:
    a ``torch.load``-able ``PerceptualNet`` state dict (converted torchvision
    VGG16 + LPIPS heads).  With either ``converted`` is True.  Without them
    the features are deterministic-random from ``seed`` and ``converted`` is
    False: such numbers rank renders consistently but are not comparable to
    published LPIPS.  The JAX package's orbax caches are not readable here."""

    def __init__(self, weights_path: Optional[str] = None, params: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device="cuda"):
        from .perceptual import PerceptualNet, from_params, init_perceptual

        if params is not None:
            self.net = from_params(params, device=device)
        elif weights_path:
            self.net = PerceptualNet()
            self.net.load_state_dict(torch.load(weights_path, map_location="cpu"))
            self.net = self.net.to(device).eval().requires_grad_(False)
        else:
            self.net = init_perceptual(torch.Generator().manual_seed(seed), device=device)
        self.converted = params is not None or bool(weights_path)
        self.device = torch.device(device)

    def __call__(self, pred, target) -> torch.Tensor:
        """(B, H, W, 3) or (H, W, 3) in [0, 1] → (B,) distances."""
        pred, target = (x.to(self.device, torch.float32) if torch.is_tensor(x) else
                        torch.as_tensor(np.array(x, np.float32), device=self.device)
                        for x in (pred, target))
        if pred.ndim == 3:
            pred, target = pred[None], target[None]
        with torch.no_grad():
            return self.net(pred, target)


class CLIPSimilarityMetric:
    """Cosine similarity of CLIP image embeddings (the paper's CLIP metric),
    on the port's CLIP tower (``models.guidance.zero123.clip``).

    ``params``: a state dict of the tower in OpenAI CLIP's ``visual.*``
    layout without the prefix (the ``cond_stage_model.model.visual.*``
    entries of a Stable Zero123 checkpoint, for one); ``converted`` is then
    True.  Without it the weights are random from a ``torch.Generator``
    seeded with ``seed`` and ``converted`` is False: relative only, as the
    random LPIPS features are.  ``config``: the tower's widths
    (``VisionTransformer``'s keyword arguments; default ViT-L/14)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None, config: Optional[dict] = None,
                 seed: int = 0, device="cuda"):
        from ..models.guidance.zero123.clip import VisionTransformer
        from ..models.guidance.zero123.unet import init_weights

        with torch.device("meta"):
            tower = VisionTransformer(**(config or {}))
        self.tower = tower.to_empty(device=torch.device(device)).requires_grad_(False)
        if params is not None:
            self.tower.load_state_dict({k: v if torch.is_tensor(v) else torch.as_tensor(np.array(v))
                                        for k, v in params.items()})
        else:
            init_weights(self.tower, torch.Generator().manual_seed(seed))
        self.converted = params is not None
        self.device = torch.device(device)

    def __call__(self, pred, target) -> torch.Tensor:
        """(B, H, W, 3) or (H, W, 3) in [0, 1] → (B,) cosine similarities."""
        pred, target = (x.to(self.device, torch.float32) if torch.is_tensor(x) else
                        torch.as_tensor(np.array(x, np.float32), device=self.device)
                        for x in (pred, target))
        if pred.ndim == 3:
            pred, target = pred[None], target[None]
        with torch.no_grad():
            a, b = self.tower.embed(pred), self.tower.embed(target)
        a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
        b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
        return (a * b).sum(-1)
