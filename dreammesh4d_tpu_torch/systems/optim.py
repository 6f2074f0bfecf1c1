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
:369-376 of the JAX package), and neither does the port.

The LR-scheduler half (counterpart of the JAX module's :75-254):
:func:`scheduler_factor_fn` turns a ``system.scheduler`` block (the
``torch.optim.lr_scheduler`` names the reference's ``parse_scheduler``
reaches) into ``factor(step) -> float``, and :func:`scheduled_lr` gives a
group's ``"schedule"``: ``lr · factor(k)`` for update k, counted from 0 as
optax's ``scale_by_schedule`` counts (:func:`set_learning_rates` reads the
group's Adam count, which a checkpoint restores).  The factor is evaluated in float32,
as the JAX package's jitted step evaluates ``jnp_factor_fn``.
SequentialLR restarts each sub-schedule's counter at its milestone;
``interval: epoch`` is read as ``step`` (the trainer has no epochs);
CosineAnnealingLR reads ``eta_min`` as a factor, as the JAX package does.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Any, Callable, Dict, Optional

import numpy as np
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


# ---------------------------------------------------------------------------
# The LR scheduler
# ---------------------------------------------------------------------------

_f32 = np.float32


def _get(config, key, default=None):
    return config.get(key, default) if hasattr(config, "get") else getattr(config, key, default)


def scheduler_factor_fn(config: Any) -> Callable[[int], float]:
    """``factor(step) -> float`` of a scheduler block (a dict with ``name``,
    ``args``, and for SequentialLR / ChainedScheduler ``schedulers`` and
    ``milestones``): StepLR, MultiStepLR, ExponentialLR, LinearLR,
    ConstantLR, CosineAnnealingLR, LambdaLR (``args.lr_lambda`` a ``C()``
    schedule), SequentialLR and ChainedScheduler.  Any other name raises
    ``NotImplementedError``."""
    name = _get(config, "name")
    args = dict(_get(config, "args", {}) or {})

    if name in ("SequentialLR", "Sequential"):
        subs = [scheduler_factor_fn(c) for c in _get(config, "schedulers")]
        miles = [int(m) for m in _get(config, "milestones")]

        def sequential(step):
            i = bisect_right(miles, step)
            return subs[i](step - (miles[i - 1] if i else 0))

        return sequential
    if name == "ChainedScheduler":
        subs = [scheduler_factor_fn(c) for c in _get(config, "schedulers")]

        def chained(step):
            out = _f32(1.0)
            for f in subs:
                out = out * _f32(f(step))
            return float(out)

        return chained
    if name == "StepLR":
        size, gamma = int(args["step_size"]), _f32(args.get("gamma", 0.1))
        return lambda step: float(gamma ** _f32(step // size))
    if name == "MultiStepLR":
        miles = sorted(int(m) for m in args["milestones"])
        gamma = _f32(args.get("gamma", 0.1))
        return lambda step: float(gamma ** _f32(bisect_right(miles, step)))
    if name == "ExponentialLR":
        gamma = _f32(args["gamma"])
        return lambda step: float(gamma ** _f32(step))
    if name == "LinearLR":
        s, e = float(args.get("start_factor", 1.0 / 3.0)), float(args.get("end_factor", 1.0))
        n = int(args.get("total_iters", 5))
        return lambda step: float(_f32(s) + _f32(e - s) * _f32(min(max(step, 0), n)) / _f32(n))
    if name == "ConstantLR":
        f, n = float(args.get("factor", 1.0 / 3.0)), int(args.get("total_iters", 5))
        return lambda step: float(_f32(f)) if step < n else 1.0
    if name == "CosineAnnealingLR":
        t_max = int(args["T_max"])
        eta = float(args.get("eta_min_factor", args.get("eta_min", 0.0)))
        return lambda step: float(_f32(eta) + _f32(1.0 - eta) * _f32(0.5) * (_f32(1.0) + np.cos(
            _f32(math.pi) * _f32(min(max(step, 0), t_max)) / _f32(t_max))))
    if name == "LambdaLR":
        sched = args["lr_lambda"]
        return lambda step: float(_f32(C_step(sched, step)))
    raise NotImplementedError(f"scheduler {name!r}: the port knows the torch.optim.lr_scheduler names "
                              "StepLR, MultiStepLR, ExponentialLR, LinearLR, ConstantLR, CosineAnnealingLR, "
                              "LambdaLR, SequentialLR and ChainedScheduler")


def scheduled_lr(lr: float, scheduler_cfg: Any) -> Optional[Callable[[int], float]]:
    """A group's ``"schedule"``: ``k -> lr · factor(k)`` of ``scheduler_cfg``
    (``system.scheduler``), or None when the block is empty."""
    if not scheduler_cfg:
        return None
    interval = _get(scheduler_cfg, "interval", "step")
    if interval not in ("epoch", "step"):
        raise ValueError(f"system.scheduler.interval {interval!r} (epoch | step)")
    factor = scheduler_factor_fn(scheduler_cfg)
    return lambda step: lr * factor(step)
