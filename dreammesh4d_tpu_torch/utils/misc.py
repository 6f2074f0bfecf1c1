"""Activation lookup (counterpart of ``get_activation`` in
``dreammesh4d_tpu/utils/misc.py:61-92``, the reference's ``ops.py:78-110``):
the same names, including the ``scale_<s>`` and ``clamp_<lo>_<hi>`` forms.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _lin2srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.0031308, torch.pow(torch.clamp(x, min=0.0031308), 1 / 2.4) * 1.055 - 0.055,
                       12.92 * x)


_TABLE = {
    "lin2srgb": _lin2srgb,
    "exp": torch.exp,
    "trunc_exp": lambda x: torch.exp(torch.clamp(x, -15.0, 15.0)),
    "shifted_trunc_exp": lambda x: torch.exp(torch.clamp(x - 1.0, -15.0, 15.0)),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "shifted_softplus": lambda x: F.softplus(x - 1.0),
    "relu": F.relu,
    "silu": F.silu,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation named ``name``: ``None`` / ``"none"`` the identity,
    ``scale_<s>`` x·s, ``clamp_<lo>_<hi>`` a clamp, else one of the table's
    names (case-insensitive); an unknown name raises ``ValueError``."""
    if name is None or name == "none":
        return lambda x: x
    name_l = str(name).lower()
    if name_l.startswith("scale_"):
        scale = float(name_l.replace("scale_", ""))
        return lambda x: x * scale
    if name_l.startswith("clamp_"):
        lo, hi = (float(v) for v in name_l.replace("clamp_", "").split("_"))
        return lambda x: torch.clamp(x, lo, hi)
    if name_l in _TABLE:
        return _TABLE[name_l]
    raise ValueError(f"Unknown activation {name!r}")
