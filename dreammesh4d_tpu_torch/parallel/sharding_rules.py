"""Tensor parallelism of the Zero123 UNet over the ``model`` group
(counterpart of ``dreammesh4d_tpu/parallel/sharding_rules.py``).

The roles are the JAX package's fixed Megatron layout inside each
transformer block: column-parallel ``to_q`` / ``to_k`` / ``to_v`` and the
GEGLU fan-out (``ff.net.0.proj``: its value half and its gate half are
split alike, so each rank gates its own columns), feeding row-parallel
``to_out.0`` and the FF output ``ff.net.2``, whose partial products are
summed by ONE all-reduce per attention or FF block.  A column shard holds
``num_heads / tp`` whole heads; ``CrossAttention`` takes its head count from
its local width.

The JAX package also shards other large dense and conv kernels by a size
heuristic (a TPU placement choice); the port keeps them replicated: the
same numbers, more memory per rank.  The UNet runs without gradients (SDS),
so the shards are plain tensors and the all-reduce needs no backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.guidance.zero123.unet import Linear, TransformerBlock
from .mesh import ProcessGrid, all_reduce_

COLUMN = ("to_q", "to_k", "to_v", "ff.net.0.proj")
ROW = ("to_out.0", "ff.net.2")


def role_for(name: str) -> Optional[str]:
    """``"column"`` / ``"row"`` for a transformer block's attention / FF
    weight (a UNet parameter name ending in ``.weight``), else None
    (replicated)."""
    if ".transformer_blocks." not in name or not name.endswith(".weight"):
        return None
    module = name[:-len(".weight")]
    if any(module.endswith("." + c) for c in COLUMN):
        return "column"
    if any(module.endswith("." + r) for r in ROW):
        return "row"
    return None


class RowParallelLinear(nn.Module):
    """``Linear`` on this rank's input columns.  The partial products are
    float32 products of the operands rounded to ``compute_dtype`` (exact for
    bfloat16) summed in float32, over the model group too, and the bias is
    added before the one rounding to ``compute_dtype``: the rounding of the
    unsplit layer, whose GEMM accumulates in float32."""

    def __init__(self, linear: Linear, tp: int, index: int, group):
        super().__init__()
        n = linear.in_features // tp
        self.weight = nn.Parameter(linear.weight.detach()[:, index * n:(index + 1) * n].clone(),
                                   requires_grad=False)
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone(),
                                                                  requires_grad=False)
        self.compute_dtype = linear.compute_dtype
        self.group = group

    def forward(self, x):
        dt = self.compute_dtype
        part = F.linear(x.to(dt).float(), self.weight.to(dt).float())
        all_reduce_(part, self.group)
        if self.bias is not None:
            part = part + self.bias.to(dt).float()
        return part.to(dt)


def _column(linear: Linear, rows: torch.Tensor) -> None:
    """Keep the output rows ``rows`` of ``linear`` (in place)."""
    linear.weight = nn.Parameter(linear.weight.detach()[rows].clone(), requires_grad=False)
    if linear.bias is not None:
        linear.bias = nn.Parameter(linear.bias.detach()[rows].clone(), requires_grad=False)
    linear.out_features = int(rows.numel())


def shard_unet(unet: nn.Module, grid: ProcessGrid, num_heads: int) -> nn.Module:
    """Every transformer block of ``unet`` split over ``grid``'s model group,
    in place: this rank keeps shard ``grid.model_index`` of ``grid.tp``.
    ``tp`` must divide ``num_heads`` (``ValueError`` naming both)."""
    tp, m = grid.tp, grid.model_index
    if tp == 1:
        return unet
    if num_heads % tp:
        raise ValueError(f"trainer.mesh model axis tp={tp} must divide the UNet's "
                         f"num_heads={num_heads}")
    for block in unet.modules():
        if not isinstance(block, TransformerBlock):
            continue
        for attn in (block.attn1, block.attn2):
            n = attn.to_q.out_features // tp
            rows = torch.arange(m * n, (m + 1) * n)
            for lin in (attn.to_q, attn.to_k, attn.to_v):
                _column(lin, rows)
            attn.to_out[0] = RowParallelLinear(attn.to_out[0], tp, m, grid.model_group)
        proj = block.ff.net[0].proj
        inner = proj.out_features // 2
        n = inner // tp
        half = torch.arange(m * n, (m + 1) * n)
        _column(proj, torch.cat([half, inner + half]))  # value half, gate half
        block.ff.net[2] = RowParallelLinear(block.ff.net[2], tp, m, grid.model_group)
    return unet
