"""Carry the JAX package's parameters and static structures into the port.

Inputs are numpy arrays — never jax arrays — in the JAX package's own
containers, e.g. ``jax.tree.map(np.asarray, params)`` of a ``SuGaRParams``
NamedTuple, or plain dicts with the same field names.  Scalars that the
tree map turned into 0-d arrays (``n_per_face``, ``skinning_method``, …)
are read back as Python values.  This module imports no jax.

- :func:`sugar_params` / :func:`sugar_static` — ``SuGaRParams`` / ``SuGaRStatic``;
- :func:`deformation_params` — the ``init_deformation`` tree
  (``grids[scale][plane]``, ``trunk[i].w/b``, ``head_*.res/out.w/b``);
- :func:`dynamic_static` — ``DynamicStatic``;
- :func:`camera_batch` — ``CameraBatch`` (e.g. the JAX random camera
  sampler's ``rand_cameras``);
- :func:`losses` — ``Sugar4DGenLosses``;
- :func:`dyn_train_state` — a ``DynTrainState`` from the JAX one's
  deformation parameters and step (Adam's moments start at zero, as after
  ``init_dyn_state`` on both sides);
- :func:`config` — a JAX config dataclass / NamedTuple as the port's
  (``DeformationConfig``, ``DynamicSuGaRConfig``, ``SuGaRConfig``,
  ``RasterizerConfig``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.geometry.deformation import DeformationConfig
from .models.geometry.dynamic_sugar import DynamicStatic, DynamicSuGaRConfig
from .models.geometry.sugar import SuGaRConfig, SuGaRParams, SuGaRStatic
from .models.renderers.sugar_rasterizer import CameraBatch
from .ops.gs.rasterize import RasterizerConfig
from .systems.sugar_4dgen import DynTrainState, Sugar4DGenLosses, init_dyn_state


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _item(x):
    return np.asarray(x).item()


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _i64(x, device):
    return torch.as_tensor(np.array(x, np.int64), device=device)


def sugar_params(src, device="cuda") -> SuGaRParams:
    return SuGaRParams(*(_f32(_get(src, k), device) for k in SuGaRParams._fields))


def sugar_static(src, device="cuda") -> SuGaRStatic:
    return SuGaRStatic(
        faces=_i64(_get(src, "faces"), device),
        bary_coords=_f32(_get(src, "bary_coords"), device),
        n_per_face=int(_item(_get(src, "n_per_face"))),
        sh_degree=int(_item(_get(src, "sh_degree"))),
        surface_mesh_thickness=float(_item(_get(src, "surface_mesh_thickness"))),
        color_clip=float(_item(_get(src, "color_clip"))),
        edge_face_pairs=_i64(_get(src, "edge_face_pairs"), device),
        ring_idx=_i64(_get(src, "ring_idx"), device),
        ring_mask=torch.as_tensor(np.array(_get(src, "ring_mask"), bool), device=device),
    )


def deformation_params(tree, device="cuda"):
    """Nested dicts/lists of arrays -> the same tree of float32 tensors."""
    if isinstance(tree, dict):
        return {k: deformation_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [deformation_params(v, device) for v in tree]
    return _f32(tree, device)


def dynamic_static(src, device="cuda") -> DynamicStatic:
    return DynamicStatic(
        sugar=sugar_static(_get(src, "sugar"), device),
        node_xyz=_f32(_get(src, "node_xyz"), device),
        nbr_idx=_i64(_get(src, "nbr_idx"), device),
        nbr_w=_f32(_get(src, "nbr_w"), device),
        gs_vert_idx=_i64(_get(src, "gs_vert_idx"), device),
        gs_bary_w=_f32(_get(src, "gs_bary_w"), device),
        skinning_method=str(_item(_get(src, "skinning_method"))),
        d_scale=bool(_item(_get(src, "d_scale"))),
        dynamic_mode=str(_item(_get(src, "dynamic_mode"))),
        use_deform_graph=bool(_item(_get(src, "use_deform_graph"))),
        num_frames=int(_item(_get(src, "num_frames"))),
    )


def camera_batch(src, device="cuda") -> CameraBatch:
    return CameraBatch(*(_f32(_get(src, k), device) for k in CameraBatch._fields))


def losses(src) -> Sugar4DGenLosses:
    return Sugar4DGenLosses(**dataclasses.asdict(src))


def dyn_train_state(src, lr: float = 1.6e-3, betas=(0.9, 0.99), eps: float = 1e-8,
                    device="cuda") -> DynTrainState:
    """``src``: the JAX ``DynTrainState`` (or a dict) with ``deform_params``
    and ``step`` as numpy; the optimizer is a fresh Adam with these settings."""
    return init_dyn_state(deformation_params(_get(src, "deform_params"), "cpu"), lr=lr,
                          betas=betas, eps=eps, step=int(_item(_get(src, "step"))), device=device)


def config(src):
    """A JAX-package config object as the port's class of the same name."""
    name = type(src).__name__
    if name == "RasterizerConfig":
        return RasterizerConfig(**src._asdict())
    fields = dataclasses.asdict(src)
    if name == "DeformationConfig":
        return DeformationConfig(**fields)
    if name == "SuGaRConfig":
        return SuGaRConfig(**fields)
    if name == "DynamicSuGaRConfig":
        fields["deformation"] = DeformationConfig(**fields["deformation"])
        return DynamicSuGaRConfig(**fields)
    raise TypeError(f"no port counterpart for {name}")
