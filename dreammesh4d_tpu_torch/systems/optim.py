"""Per-parameter-group Adam with ``C()``-scheduled learning rates (counterpart
of the optimizer half of ``dreammesh4d_tpu/systems/optim.py``, :23-65).

The JAX package builds one optax Adam chain per ``SuGaRParams`` field under
``optax.multi_transform``, each with a learning-rate schedule
``C(value, step, "exp") · scale``.  The port's idiom is one
``torch.optim.Adam`` with one parameter group per field; every group
carries its schedule (``"schedule"``), and :func:`set_learning_rates` writes
each group's ``lr`` before an update: the schedule at the number of updates
the group has taken, as optax counts them.

Defaults are ``adam_group``'s: betas (0.9, 0.999) and eps 1e-15.  The static
stage never reads its YAML's ``optimizer.args`` (``systems/assembly.py``
:369-376 of the JAX package), and neither does the port.  The LR-scheduler
half of the JAX module (``scheduler_factor_fn``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..models.geometry.sugar import SuGaRParams
from ..utils.schedule import C_step


def c_schedule(value: Any, scale: float = 1.0,
               interpolation: str = "exp") -> Callable[[int], float]:
    """``step -> C(value, step) · scale`` (exponential interpolation by
    default, as the reference's ``update_learning_rate``)."""

    def sched(step: int) -> float:
        return C_step(value, step, interpolation=interpolation) * scale

    return sched


def adam_group(params: torch.Tensor, lr_value: Any, scale: float = 1.0, eps: float = 1e-15,
               b1: float = 0.9, b2: float = 0.999, interpolation: str = "exp",
               name: str = "") -> Dict[str, Any]:
    """One Adam parameter group with its own schedule, its lr set for step 0."""
    sched = c_schedule(lr_value, scale, interpolation)
    return {"params": [params], "lr": sched(0), "betas": (b1, b2), "eps": eps,
            "schedule": sched, "name": name}


def sugar_optimizer(params: SuGaRParams, position_lr: Any = 0.00048, scaling_lr: Any = 0.005,
                    feature_lr: Any = 0.001, opacity_lr: Any = 0.02, rotation_lr: Any = 0.001,
                    spatial_lr_scale: float = 1.0, eps: float = 1e-15) -> torch.optim.Adam:
    """Adam over the six ``SuGaRParams`` leaves, one group each (parity with
    ``SuGaRModel.training_setup``): points at ``position_lr`` ×
    ``spatial_lr_scale``, ``sh_rest`` at ``feature_lr`` / 20."""
    lrs = {
        "points": (position_lr, spatial_lr_scale),
        "log_scales": (scaling_lr, 1.0),
        "complex_rot": (rotation_lr, 1.0),
        "sh_dc": (feature_lr, 1.0),
        "sh_rest": (feature_lr, 1.0 / 20.0),
        "density_logits": (opacity_lr, 1.0),
    }
    groups = [adam_group(getattr(params, f), *lrs[f], eps=eps, name=f) for f in SuGaRParams._fields]
    return torch.optim.Adam(groups)


def set_learning_rates(optimizer: torch.optim.Optimizer) -> None:
    """Set each scheduled group's lr for its next update: the schedule at the
    number of updates the group has taken so far (optax's ``count``, which
    a converted state carries over)."""
    for group in optimizer.param_groups:
        if "schedule" in group:
            done = optimizer.state.get(group["params"][0], {}).get("step", 0)
            group["lr"] = group["schedule"](int(done))
