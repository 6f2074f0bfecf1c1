"""CLIP image conditioning: the port's own vision transformer in OpenAI
CLIP's ``visual.*`` layout (counterpart of
``dreammesh4d_tpu/models/guidance/zero123/clip.py``, which runs
``transformers``' ``FlaxCLIPVisionModel`` on the weights its converter gives
it; this computes the same function).

``conv1`` (no bias), ``class_embedding``, ``positional_embedding``,
``ln_pre``, ``transformer.resblocks.{i}.{ln_1, attn.in_proj_weight /
in_proj_bias, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`` with QuickGELU,
``ln_post`` on the class token, then ``@ proj``.  LayerNorm eps 1e-5.  The
default is ViT-L/14: 1024 wide, 24 layers, 16 heads, MLP 4096, patch 14 at
224², projection 768.  Precision as in ``unet.py``; the embeddings are summed
and the projection applied in float32, as the flax model does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ....ops.resize import resize_hw
from .unet import Conv2d, LayerNorm32, Linear, attention

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


class SelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameter layout (fused ``in_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x):
        dt = self.out_proj.compute_dtype
        qkv = torch.nn.functional.linear(x.to(dt), self.in_proj_weight.to(dt),
                                         self.in_proj_bias.to(dt))
        q, k, v = qkv.chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, self.heads))


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = Linear(width, hidden)
        self.c_proj = Linear(hidden, width)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.ln_1 = LayerNorm32(width)
        self.attn = SelfAttention(width, heads)
        self.ln_2 = LayerNorm32(width)
        self.mlp = MLP(width, mlp)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, mlp: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, mlp)
                                       for _ in range(layers))

    def forward(self, x):
        for block in self.resblocks:
            x = block(x)
        return x


class VisionTransformer(nn.Module):
    """``forward(pixels (B, 3, S, S), CLIP-normalised)`` → (B, output_dim)
    float32: ``ln_post(x[:, 0]) @ proj``."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, mlp: int = 4096, output_dim: int = 768):
        super().__init__()
        self.image_size = image_size
        grid = image_size // patch_size
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm32(width)
        self.transformer = Transformer(width, layers, heads, mlp)
        self.ln_post = LayerNorm32(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, pixels):
        dt = self.conv1.compute_dtype
        x = self.conv1(pixels).flatten(2).transpose(1, 2).float()
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x).to(dt))
        return self.ln_post(x[:, 0]).float() @ self.proj

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → CLIP-normalised (B, 3, S, S): bicubic to
        the tower's size with ``jax.image.resize``'s semantics."""
        s = self.image_size
        img = resize_hw(images, s, s, "bicubic")
        mean = torch.as_tensor(CLIP_MEAN, device=img.device)
        std = torch.as_tensor(CLIP_STD, device=img.device)
        return ((img - mean) / std).permute(0, 3, 1, 2)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → (B, output_dim)."""
        return self(self.preprocess(images))
