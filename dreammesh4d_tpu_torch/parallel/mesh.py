"""Process groups, placement and the collectives of more than one device
(counterpart of ``dreammesh4d_tpu/parallel/mesh.py``).

The JAX package runs one process over a dp × tp ``jax.sharding.Mesh`` and
lets XLA insert the collectives.  The port runs one process per rank under
``torch.distributed``, laid out row-major on a ``(data, model)`` grid: rank
``d·tp + m`` holds row block ``d`` of every view/frame batch and shard ``m``
of the tensor-parallel UNet weights.  Each rank belongs to one ``data``
group (the ranks of its model index: batch gathers, gradient averages) and
one ``model`` group (the ranks of its data index: the UNet's row-parallel
all-reduce).

Every collective goes through :func:`all_reduce_`.  Under ``gloo`` a CUDA
tensor is staged through host memory there, so ranks that share one card
(``gloo`` with CUDA tensors) need no op that ``gloo`` cannot carry on the
device; a gather is an all-reduce of zero-padded rows, exact because
``x + 0 == x``.  ``is_main_process`` / ``barrier`` are the file-ownership
rule of the trainer, the checkpoints, the loggers and the saver: rank 0
writes, the others wait.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_map


def free_port() -> int:
    """A free TCP port on this host for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: card ``rank mod count`` for ``cuda`` (ranks
    beyond the card count share cards, which only ``gloo`` allows), the
    CPU otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def init_process_group(world: int, rank: int, device, port: int,
                       backend: Optional[str] = None) -> str:
    """Join the ``world``-rank group at ``tcp://localhost:<port>`` as
    ``rank``; ``backend`` defaults to NCCL on cards (one per rank) and
    ``gloo`` on the CPU.  Returns the backend, which rank 0 prints."""
    dev = rank_device(device, rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    if rank == 0:
        print(f"[INFO] process group: {world} ranks, backend {backend}, device {dev.type}",
              flush=True)
    return backend


def is_main_process() -> bool:
    """True outside a process group and on rank 0: the rank that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if dist.is_initialized():
        dist.barrier()


@dataclass
class ProcessGrid:
    """This rank's place on the ``(data, model)`` grid and its two groups."""

    dp: int
    tp: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp


def make_mesh(dp: int, tp: int) -> ProcessGrid:
    """The ``(data, model)`` grid over the initialised world (``dp·tp``
    ranks).  Every rank creates every group, in the same order, as
    ``new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp != world:
        raise RuntimeError(f"a {dp} x {tp} grid needs {dp * tp} ranks, the group has {world}")
    data_group = model_group = None
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model_group = g
    return ProcessGrid(dp, tp, rank, data_group, model_group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group``; ``gloo`` carries a CUDA
    tensor through host memory, and a half-precision one in float32."""
    staged = (x.is_cuda and dist.get_backend(group) == "gloo") or x.dtype in (torch.bfloat16,
                                                                             torch.float16)
    if not staged:
        dist.all_reduce(x, op=op, group=group)
        return x
    h = x.detach().to("cpu" if dist.get_backend(group) == "gloo" else x.device,
                      torch.float32 if x.is_floating_point() else x.dtype)
    dist.all_reduce(h, op=op, group=group)
    with torch.no_grad():
        x.copy_(h)
    return x


def broadcast_(x: torch.Tensor) -> torch.Tensor:
    """In-place broadcast of rank 0's ``x`` to the world (the same host
    staging as :func:`all_reduce_`)."""
    if x.is_cuda and dist.get_backend() == "gloo":
        h = x.detach().cpu()
        dist.broadcast(h, src=0)
        with torch.no_grad():
            x.copy_(h)
        return x
    dist.broadcast(x, src=0)
    return x


def shard_rows(x, dp: int, index: int):
    """Row block ``index`` of ``dp`` of a tensor whose leading dimension
    divides ``dp``; any other leaf is replicated (kept whole)."""
    if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] % dp == 0:
        n = x.shape[0] // dp
        return x[index * n:(index + 1) * n]
    return x


def shard_batch(batch, dp: int, index: int):
    """Every leaf of ``batch`` through :func:`shard_rows`."""
    return tree_map(lambda x: shard_rows(x, dp, index), batch)


def replicate_tensors(tensors: List[torch.Tensor]) -> None:
    """Rank 0's values in every tensor of ``tensors``, in place."""
    with torch.no_grad():
        for x in tensors:
            broadcast_(x)
