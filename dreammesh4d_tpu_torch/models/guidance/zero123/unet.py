"""The Zero123 / Stable-Diffusion UNet in PyTorch, NCHW (counterpart of
``dreammesh4d_tpu/models/guidance/zero123/unet.py``).

The modules carry the torch LDM names (``time_embed.{0,2}``,
``input_blocks.{i}.{j}``, ``middle_block.{0,1,2}``, ``output_blocks.{i}.{j}``,
``out.{0,2}``; ``in_layers`` / ``emb_layers`` / ``out_layers`` /
``skip_connection`` in a ResBlock; ``transformer_blocks.0.{attn1, attn2,
ff.net.0.proj, ff.net.2, norm1-3}``), so that ``load_state_dict`` takes the
``model.diffusion_model.*`` entries of a Stable Zero123 checkpoint as they
are.

Precision follows flax's ``dtype=`` with float32 parameters, which is what
the JAX package runs: every convolution and dense layer rounds its input and
its weights to ``compute_dtype`` (:func:`set_compute_dtype`; float32 or
bfloat16, or float64 for checks) and returns that dtype; GroupNorm and
LayerNorm compute in float32 (float64 for float64 inputs) and return their
input's dtype; attention goes through ``scaled_dot_product_attention``,
whose softmax accumulates in float32; the UNet returns float32 (float64
where it computes in float64).  The GEGLU feed-forward uses the
tanh-approximate GELU, flax's ``nn.gelu`` default (the torch LDM uses the
exact one).

``UNetModel.forward`` takes an optional ``control``: a ControlNet's
residuals (``models/guidance/controlnet.py``), one per skip activation and
one for the middle block's output.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` from float32 weights."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` from float32 weights."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every :class:`Conv2d` / :class:`Linear` under ``module`` computes in
    ``dtype`` from now on."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = dtype


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, zeros=()) -> None:
    """Random weights from ``generator`` for every parameter of ``module``:
    convolution and dense weights N(0, 1/fan_in), biases and the parameters
    named in ``zeros`` zero, norm scales 1, a ViT's class and positional
    embeddings N(0, 1/width) and its projection ``proj`` N(0, 0.02²)."""

    def normal(shape, std):
        x = torch.randn(tuple(shape), generator=generator, device=generator.device)
        return x * std

    for name, p in module.named_parameters():
        if name.endswith("class_embedding") or name.endswith("positional_embedding"):
            p.copy_(normal(p.shape, p.shape[-1] ** -0.5))
        elif name in zeros or name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:  # norm scales
            p.fill_(1.0)
        elif name.endswith("proj") and not name.endswith("in_proj"):
            p.copy_(normal(p.shape, 0.02))
        else:
            p.copy_(normal(p.shape, p[0].numel() ** -0.5))


def norm_groups(channels: int) -> int:
    """The largest divisor of ``channels`` that is ≤ 32."""
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return groups


def _norm_input(x: torch.Tensor) -> torch.Tensor:
    """A norm's input in float32, or float64 where it is float64."""
    return x if x.dtype == torch.float64 else x.float()


class GroupNorm32(nn.GroupNorm):
    """GroupNorm in float32 whatever the activation dtype (float64 for
    float64 activations)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(norm_groups(channels), channels, eps=eps)

    def forward(self, x):
        return F.group_norm(_norm_input(x), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm (eps 1e-5) in float32 whatever the activation dtype
    (float64 for float64 activations)."""

    def forward(self, x):
        return F.layer_norm(_norm_input(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """OpenAI sinusoidal embedding, ``[cos, sin]`` in that order: (B,) → (B, dim),
    computed in ``dtype``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=dtype, device=t.device) / half)
    args = t.to(dtype)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head attention scaled by 1/√(C / heads): (B, L, C) → (B, Lq, C)."""
    B, Lq, C = q.shape
    dh = C // num_heads

    def heads(x):
        return x.reshape(B, x.shape[1], num_heads, dh).transpose(1, 2)

    out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
    return out.transpose(1, 2).reshape(B, Lq, C)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, emb_ch: int, out_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(in_ch), nn.SiLU(),
                                       Conv2d(in_ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, out_ch))
        # index 2 is the LDM's dropout: out_layers.3 is the zero-initialised conv
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(), nn.Identity(),
                                        Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        h = self.out_layers(h)
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = query_dim // num_heads
        self.to_q = Linear(query_dim, query_dim, bias=False)
        self.to_k = Linear(context_dim, query_dim, bias=False)
        self.to_v = Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.Sequential(Linear(query_dim, query_dim), nn.Identity())

    def forward(self, x, context=None):
        ctx = x if context is None else context
        q = self.to_q(x)
        # the head count of the local width: a tensor-parallel shard holds
        # num_heads / tp whole heads (``parallel/sharding_rules.py``)
        out = attention(q, self.to_k(ctx), self.to_v(ctx), q.shape[-1] // self.head_dim)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Identity(), Linear(dim * 4, dim))

    def forward(self, x):
        return self.net(x)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, num_heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, num_heads)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, num_heads: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(channels, context_dim, num_heads) for _ in range(depth))
        self.proj_out = Conv2d(channels, channels, 1)  # zero-initialised

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest2(x))


class TimestepEmbedSequential(nn.Sequential):
    """Layers that take the timestep embedding or the context as well."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


def input_blocks(in_channels: int, mc: int, channel_mult: Sequence[int], num_res_blocks: int,
                 attention_resolutions: Sequence[int], transformer):
    """The UNet's down path (``input_blocks``: the input convolution, then
    per level ``num_res_blocks`` ResBlocks, each with a transformer at the
    downsample factors of ``attention_resolutions``, and a Downsample but
    after the last level) → (the blocks, each block's output channels, the
    downsample factor reached).  A ControlNet copies it."""
    emb_ch = mc * 4
    blocks = nn.ModuleList([TimestepEmbedSequential(Conv2d(in_channels, mc, 3, padding=1))])
    chans, ch, ds = [mc], mc, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            layers = [ResBlock(ch, emb_ch, mc * mult)]
            ch = mc * mult
            if ds in attention_resolutions:
                layers.append(transformer(ch))
            blocks.append(TimestepEmbedSequential(*layers))
            chans.append(ch)
        if level != len(channel_mult) - 1:
            blocks.append(TimestepEmbedSequential(Downsample(ch)))
            chans.append(ch)
            ds *= 2
    return blocks, chans, ds


def zero_init_names(module: nn.Module) -> list:
    """The parameters the LDM initialises to zero under ``module``: each
    ResBlock's last conv and each SpatialTransformer's ``proj_out``."""
    names = []
    for name, m in module.named_modules():
        if isinstance(m, ResBlock):
            names += [f"{name}.out_layers.3.weight", f"{name}.out_layers.3.bias"]
        elif isinstance(m, SpatialTransformer):
            names += [f"{name}.proj_out.weight", f"{name}.proj_out.bias"]
    return names


def compute_dtype_of(linear: Linear) -> torch.dtype:
    """float64 where ``linear`` computes in float64, else float32: the dtype
    of a network's timestep embedding and of its output."""
    return torch.float64 if linear.compute_dtype == torch.float64 else torch.float32


class UNetModel(nn.Module):
    """NCHW UNet: ``forward(x (B, in_ch, H, W), t (B,), context (B, L,
    context_dim))`` → (B, out_ch, H, W) float32."""

    def __init__(self, in_channels: int = 8, out_channels: int = 4, model_channels: int = 320,
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1), num_heads: int = 8,
                 context_dim: int = 768, transformer_depth: int = 1):
        super().__init__()
        mc = model_channels
        emb_ch = mc * 4
        self.model_channels = mc

        def transformer(ch):
            return SpatialTransformer(ch, num_heads, context_dim, transformer_depth)

        self.time_embed = nn.Sequential(Linear(mc, emb_ch), nn.SiLU(), Linear(emb_ch, emb_ch))
        self.input_blocks, chans, ds = input_blocks(in_channels, mc, channel_mult, num_res_blocks,
                                                    attention_resolutions, transformer)
        ch = chans[-1]
        self.middle_block = TimestepEmbedSequential(ResBlock(ch, emb_ch, ch), transformer(ch),
                                                    ResBlock(ch, emb_ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), emb_ch, mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(transformer(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                self.output_blocks.append(TimestepEmbedSequential(*layers))
            if level:
                ds //= 2
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(mc, out_channels, 3, padding=1))

    def zero_init_names(self) -> list:
        """The parameters the LDM initialises to zero: each ResBlock's last
        conv, each SpatialTransformer's ``proj_out`` and the output conv."""
        return zero_init_names(self) + ["out.2.weight", "out.2.bias"]

    def forward(self, x, t, context, control=None):
        """``control``: {"down": [one residual per skip activation], "mid":
        the middle block's}, added to them before the up path (a
        ControlNet's injection points)."""
        dtype = compute_dtype_of(self.time_embed[0])
        emb = self.time_embed(timestep_embedding(t, self.model_channels, dtype=dtype))
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        if control is not None:
            h = h + control["mid"]
            hs = [s + c for s, c in zip(hs, control["down"])]
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], 1), emb, context)
        return self.out(h).to(dtype)
