"""Launch-surface multi-device context (counterpart of
``dreammesh4d_tpu/parallel/context.py``).

YAML surface, as in the JAX package::

    trainer:
      devices: 4        # -1 / "auto" = all visible devices; 1 = off (default)
      mesh: [2, 2]      # optional [data, model] shape; default [devices, 1]

``trainer.mesh`` alone sets ``devices`` to its product (the JAX package
ignores a mesh without ``devices``).  Every experiment builds one of these
from ``cfg.trainer``; ``ParallelContext(None)`` is the single-device no-op
and makes no process group.

The port runs one process per rank (the launcher spawns them) and keeps the
JAX package's numbers: every rank draws the global batch from the same
seeded generators and keeps its rows (:meth:`shard_batch`, :meth:`rows`);
each rank computes the whole loss, where a term is not a mean of equal
per-rank means on :meth:`gather` / :meth:`all_sum` of the values of the
rows it does not own; the gradients are averaged over ``data`` before the
optimiser step (:meth:`average_gradients`).  The gather's and the sum's
backward sum over the ranks, so the averaged gradient is the single-device
one, as in DDP.  Logged metrics are the data-group mean (:meth:`reduce_metrics`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import ProcessGrid, all_reduce_, make_mesh, replicate_tensors, shard_batch
from .sharding_rules import shard_unet


def visible_devices(device) -> int:
    """The ranks of the process group inside one; else the cards for
    ``cuda``, and on the CPU, where the ranks are processes, the cores."""
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def plan_from_trainer_cfg(trainer_cfg: Optional[dict], device="cuda") -> Optional[Tuple[int, int, int]]:
    """``(devices, dp, tp)`` of ``trainer.devices`` / ``trainer.mesh``, or
    None for one device.  ``ValueError`` as the JAX package raises it: more
    devices than visible ("only N ... visible"), a mesh that does not factor
    the devices ("does not factor")."""
    tcfg = dict(trainer_cfg or {})
    mesh = tcfg.get("mesh")
    devices = tcfg.get("devices", int(np.prod(mesh)) if mesh is not None else 1)
    if devices in ("auto", "-1", -1):
        n = visible_devices(device)
    else:
        n = int(devices)
    if n <= 1:
        return None
    avail = visible_devices(device)
    if n > avail:
        raise ValueError(f"trainer.devices={n} but only {avail} {torch.device(device).type} "
                         "devices are visible")
    if mesh is not None:
        dp, tp = int(mesh[0]), int(mesh[1])
        if dp * tp != n:
            raise ValueError(f"trainer.mesh={list(mesh)} does not factor trainer.devices={n} "
                             "(need data*model == devices)")
    else:
        dp, tp = n, 1
    return n, dp, tp


def check_batch_size(batch_size: Any, dp: int, what: str) -> None:
    """``ValueError`` unless every size (a milestone list too) divides ``dp``."""
    sizes = batch_size if isinstance(batch_size, (list, tuple)) else [batch_size]
    for b in sizes:
        if int(b) % dp != 0:
            raise ValueError(f"{what}={b} must be divisible by the data-parallel axis (dp={dp}); "
                             "set data batch sizes to a multiple of dp")


class _Gather(torch.autograd.Function):
    """Rows of every data rank stacked in rank order; the backward sums the
    incoming gradient over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, grid: ProcessGrid):
        ctx.grid = grid
        n = x.shape[0]
        full = x.new_zeros((grid.dp * n,) + tuple(x.shape[1:]))
        i = grid.data_index
        full[i * n:(i + 1) * n] = x
        return all_reduce_(full, grid.data_group)

    @staticmethod
    def backward(ctx, grad):
        grid = ctx.grid
        g = all_reduce_(grad.contiguous().clone(), grid.data_group)
        n = g.shape[0] // grid.dp
        i = grid.data_index
        return g[i * n:(i + 1) * n], None


class _AllSum(torch.autograd.Function):
    """Sum over the data ranks; its backward is the same sum."""

    @staticmethod
    def forward(ctx, x, grid: ProcessGrid):
        ctx.grid = grid
        return all_reduce_(x.clone(), grid.data_group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.grid.data_group), None


@dataclass
class ParallelContext:
    """No-op when ``grid`` is None (single device, the default)."""

    grid: Optional[ProcessGrid] = None

    @property
    def active(self) -> bool:
        return self.grid is not None

    @property
    def dp(self) -> int:
        return self.grid.dp if self.grid is not None else 1

    @property
    def tp(self) -> int:
        return self.grid.tp if self.grid is not None else 1

    @property
    def rank(self) -> int:
        return self.grid.rank if self.grid is not None else 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @classmethod
    def from_trainer_cfg(cls, trainer_cfg: Optional[dict], device="cuda") -> "ParallelContext":
        """The context of ``trainer.devices`` / ``trainer.mesh`` inside the
        process group the launcher made; ``RuntimeError`` outside one (run
        through the launcher) or in a group of another size."""
        plan = plan_from_trainer_cfg(trainer_cfg, device)
        if plan is None:
            return cls(None)
        n, dp, tp = plan
        if not dist.is_initialized():
            raise RuntimeError(
                f"trainer.devices={n} (mesh [{dp}, {tp}]) runs one process per rank: run it through "
                "the launcher, python3 -m dreammesh4d_tpu_torch.launch --config <yaml> --train "
                f"trainer.devices={n} ...")
        if dist.get_world_size() != n:
            raise RuntimeError(f"trainer.devices={n} inside a process group of "
                               f"{dist.get_world_size()} ranks")
        return cls(make_mesh(dp, tp))

    # -- placement -----------------------------------------------------------

    def check_batch_size(self, batch_size: Any, what: str) -> None:
        check_batch_size(batch_size, self.dp, what)

    def rows(self, n_local: int) -> Tuple[int, int]:
        """(offset, global count) of this rank's ``n_local`` rows."""
        return self.grid.data_index * n_local if self.grid else 0, n_local * self.dp

    def shard_batch(self, batch: Any) -> Any:
        """Leading (view/frame) dims: this rank's rows; an indivisible leaf
        whole."""
        if self.grid is None:
            return batch
        return shard_batch(batch, self.dp, self.grid.data_index)

    def replicate(self, tensors: Iterable[torch.Tensor]) -> None:
        """Rank 0's values in ``tensors`` on every rank, in place."""
        if self.grid is not None:
            replicate_tensors(list(tensors))

    def shard_guidance(self, guidance) -> Any:
        """The guidance's UNet split over ``model`` (the attention / FF
        roles of :mod:`.sharding_rules`); VAE, CLIP and the embedding bank
        stay whole."""
        if self.grid is None or guidance is None:
            return guidance
        shard_unet(guidance.modules.unet, self.grid, guidance.cfg.num_heads)
        return guidance

    # -- the loss and the step -------------------------------------------------

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every data rank, differentiable (backward: the sum over ranks)."""
        if self.grid is None or self.dp == 1:
            return x
        return _Gather.apply(x, self.grid)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data ranks, differentiable (backward: the same sum)."""
        if self.grid is None or self.dp == 1:
            return x
        return _AllSum.apply(x, self.grid)

    def all_max_(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the data ranks, in place (no gradient)."""
        if self.grid is not None and self.dp > 1:
            all_reduce_(x, self.grid.data_group, dist.ReduceOp.MAX)
        return x

    def average_gradients(self, tensors: Iterable[torch.Tensor]) -> None:
        """Every ``.grad`` of ``tensors`` replaced by its mean over the data
        ranks (one flat all-reduce; a missing grad counts as zero)."""
        if self.grid is None or self.dp == 1:
            return
        tensors = list(tensors)
        flat = torch.cat([(t.grad if t.grad is not None else torch.zeros_like(t)).reshape(-1)
                          for t in tensors])
        all_reduce_(flat, self.grid.data_group)
        flat /= self.dp
        i = 0
        for t in tensors:
            n = t.numel()
            t.grad = flat[i:i + n].view_as(t).clone()
            i += n

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The data-group mean of every metric, ``psnr`` from the mean
        ``loss_rgb``."""
        if self.grid is None or self.dp == 1:
            return metrics
        names = sorted(metrics)
        flat = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
        all_reduce_(flat, self.grid.data_group)
        flat /= self.dp
        out = dict(zip(names, flat.unbind()))
        if "psnr" in out and "loss_rgb" in out:
            out["psnr"] = -10.0 * torch.log10(out["loss_rgb"] + 1e-8)
        return out
