"""More than one device: ``trainer.devices`` / ``trainer.mesh`` as a
data × model process grid over ``torch.distributed`` (counterpart of
``dreammesh4d_tpu/parallel/``)."""

from .context import ParallelContext, plan_from_trainer_cfg
from .mesh import barrier, init_process_group, is_main_process, make_mesh

__all__ = ["ParallelContext", "plan_from_trainer_cfg", "barrier", "init_process_group",
           "is_main_process", "make_mesh"]
