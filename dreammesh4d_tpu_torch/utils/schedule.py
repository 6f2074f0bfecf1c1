"""Step-scheduled scalar hyperparameters (counterpart of
``dreammesh4d_tpu/utils/schedule.py``).

A scalar hyperparameter may instead be a list ``[start_step, start_value,
end_value, end_step]`` (the 3-element form gets a leading 0; the form with 6
or more elements chains segments ``[s0, v0, v1, e1, v2, e2, ...]``),
interpolated linearly or exponentially.  An integer ``end_step``
interpolates over global steps, a float over epochs.

- :func:`C` — the host-side evaluation at (epoch, global_step);
- :func:`C_max` — the largest value a schedule can take;
- :func:`C_step` — the evaluation the train steps use, on a Python step
  counter: the values ``C_jax`` of the JAX package gives inside its jitted
  step (segments applied in order, each from its start step on; the first
  segment's start value before any segment has begun).
"""

from __future__ import annotations

import math
from typing import Any, List, Tuple


def _normalize(value: list) -> list:
    if len(value) == 3:
        value = [0] + list(value)
    return list(value)


def C(value: Any, epoch: int = 0, global_step: int = 0, interpolation: str = "linear") -> float:
    """Evaluate a scheduled scalar at (epoch, global_step)."""
    if isinstance(value, (int, float)):
        return value
    value = _normalize(list(value))
    if len(value) >= 6:
        select_i = 3
        for i in range(3, len(value) - 2, 2):
            if global_step >= value[i]:
                select_i = i + 2
        if select_i != 3:
            start_value, start_step = value[select_i - 3], value[select_i - 2]
        else:
            start_step, start_value = value[:2]
        end_value, end_step = value[select_i - 1], value[select_i]
        value = [start_step, start_value, end_value, end_step]
    if len(value) != 4:
        raise ValueError(f"Schedule list must have 3, 4 or >=6 elements, got {value}")
    start_step, start_value, end_value, end_step = value
    current = epoch if isinstance(end_step, float) else global_step
    t = max(min(1.0, (current - start_step) / (end_step - start_step)), 0.0)
    if interpolation == "linear":
        return start_value + (end_value - start_value) * t
    if interpolation == "exp":
        return math.exp(math.log(start_value) * (1 - t) + math.log(end_value) * t)
    raise ValueError(f"Unknown interpolation {interpolation!r} (linear|exp)")


def C_max(value: Any) -> float:
    """The largest value a schedule can take."""
    if isinstance(value, (int, float)):
        return value
    value = _normalize(list(value))
    # values sit at [s0, v0, v1, e1, v2, e2, ...]
    return max([value[1]] + [value[i] for i in range(2, len(value), 2)])


def _segments(value: list) -> List[Tuple[float, float, float, float]]:
    if len(value) < 6:
        return [tuple(value)]
    segs = []
    prev_s, prev_v = value[0], value[1]
    rest = value[2:]
    for i in range(0, len(rest), 2):
        v1, e1 = rest[i], rest[i + 1]
        segs.append((prev_s, prev_v, v1, e1))
        prev_s, prev_v = e1, v1
    return segs


def C_step(value: Any, global_step: int, interpolation: str = "linear") -> float:
    """Schedule evaluation on an integer step counter, segment by segment."""
    if isinstance(value, (int, float)):
        return float(value)
    segs = _segments(_normalize(list(value)))
    step = float(global_step)
    out = float(segs[0][1])
    for (ss, sv, ev, es) in segs:
        t = min(max((step - ss) / max(es - ss, 1e-8), 0.0), 1.0)
        if interpolation == "linear":
            seg_val = sv + (ev - sv) * t
        elif interpolation == "exp":
            seg_val = math.exp(math.log(sv) * (1 - t) + math.log(ev) * t)
        else:
            raise ValueError(f"Unknown interpolation {interpolation!r} (linear|exp)")
        if step >= ss:
            out = seg_val
    return out
