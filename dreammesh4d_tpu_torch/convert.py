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
  ``RasterizerConfig``);
- stage 1: :func:`hashgrid_config`, :func:`implicit_volume_config`,
  :func:`nerf_renderer_config`, :func:`zero123_losses`,
  :func:`implicit_volume_params` (the tree ``{"encoding": {"tables"},
  "density_mlp": [{w, b}, …], "feature_mlp": […]}``), :func:`occgrid_state`
  and :func:`nerf_train_state` (optax Adam's ``mu`` / ``nu`` / ``count``
  become ``exp_avg`` / ``exp_avg_sq`` / ``step``); :func:`zero123_checkpoint`
  — a JAX ``Zero123Experiment``'s state as the port experiment's
  ``load_state`` dict;
- stage 4: :func:`sugar_static_losses` and :func:`static_train_state` (the
  params and the ``optax.multi_transform`` Adam moments of every
  ``SuGaRParams`` field).  ``RasterizerConfig`` crosses over through
  :func:`config` as it is;
- evaluation: :func:`perceptual_params` — the LPIPS tree
  ``{"stages": [[{w HWIO, b}, …], …], "lins": […]}`` with OIHW convolutions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.geometry.deformation import DeformationConfig
from .models.geometry.dynamic_sugar import DynamicStatic, DynamicSuGaRConfig
from .models.geometry.implicit_volume import ImplicitVolumeConfig
from .models.geometry.sugar import SuGaRConfig, SuGaRParams, SuGaRStatic
from .models.renderers.nerf_volume_renderer import NeRFRendererConfig, OccGridState
from .models.renderers.sugar_rasterizer import CameraBatch
from .ops.gs.rasterize import RasterizerConfig
from .ops.hashgrid import HashGridConfig
from .systems.sugar_4dgen import DynTrainState, Sugar4DGenLosses, init_dyn_state
from .systems.sugar_static import StaticTrainState, SugarStaticLosses, init_static_state
from .systems.zero123_system import NeRFTrainState, Zero123Losses, init_nerf_state
from .utils.tree import tree_leaves, tree_map


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


# --- stage 1: the implicit volume, its renderer and the zero123 step --------


def hashgrid_config(src) -> HashGridConfig:
    return HashGridConfig(**dataclasses.asdict(src))


def implicit_volume_config(src) -> ImplicitVolumeConfig:
    fields = dataclasses.asdict(src)
    fields["hashgrid"] = HashGridConfig(**fields["hashgrid"])
    return ImplicitVolumeConfig(**fields)


def nerf_renderer_config(src) -> NeRFRendererConfig:
    return NeRFRendererConfig(**dataclasses.asdict(src))


def zero123_losses(src) -> Zero123Losses:
    return Zero123Losses(**dataclasses.asdict(src))


def implicit_volume_params(tree, device="cuda"):
    """The ``init_implicit_volume`` tree as float32 tensors (same nesting)."""
    return deformation_params(tree, device)


def occgrid_state(src, device="cuda") -> OccGridState:
    return OccGridState(_f32(_get(src, "occ"), device), _f32(_get(src, "binary"), device))


def nerf_train_state(src, lr: float = 0.01, betas=(0.9, 0.99), eps: float = 1e-8,
                     device="cuda") -> NeRFTrainState:
    """``src``: the JAX ``NeRFTrainState`` (or a dict) with ``geo_params``,
    ``step`` and optionally ``opt_state`` as numpy.  Without ``opt_state``
    Adam starts from zero moments; with optax Adam's state
    (``(ScaleByAdamState(count, mu, nu), …)``) its moments and count are
    carried over."""
    state = init_nerf_state(implicit_volume_params(_get(src, "geo_params"), "cpu"), lr=lr,
                            betas=betas, eps=eps, step=int(_item(_get(src, "step"))), device=device)
    opt_state = _opt_state(src)
    if opt_state is not None:
        # optax.adam's state is (ScaleByAdamState, EmptyState); the first alone is taken too
        adam = opt_state if isinstance(opt_state, dict) or hasattr(opt_state, "mu") else opt_state[0]
        mu = tree_leaves(implicit_volume_params(_get(adam, "mu"), device))
        nu = tree_leaves(implicit_volume_params(_get(adam, "nu"), device))
        for p, m, v in zip(tree_leaves(state.geo_params), mu, nu):
            _set_adam(state.opt_state, p, _get(adam, "count"), m, v)
    return state


def zero123_checkpoint(src, lr: float = 0.01, betas=(0.9, 0.99), eps: float = 1e-8) -> dict:
    """A JAX ``Zero123Experiment``'s state (its ``NeRFTrainState`` as numpy,
    as for :func:`nerf_train_state`) as the dict the port experiment's
    ``load_state`` takes (``geo_params``, Adam's moments, ``step``), on the
    CPU; ``lr`` / ``betas`` / ``eps`` only shape the intermediate optimizer."""
    state = nerf_train_state(src, lr=lr, betas=betas, eps=eps, device="cpu")
    return {"geo_params": tree_map(lambda x: x.detach(), state.geo_params),
            "opt_state": {"state": state.opt_state.state_dict()["state"]}, "step": state.step}


def _opt_state(src):
    return src.get("opt_state") if isinstance(src, dict) else getattr(src, "opt_state", None)


def _set_adam(optimizer: torch.optim.Optimizer, param: torch.Tensor, count, mu, nu) -> None:
    """optax Adam's ``count`` / ``mu`` / ``nu`` of one leaf as torch Adam's state."""
    optimizer.state[param] = {"step": torch.tensor(float(_item(count))), "exp_avg": mu.clone(),
                              "exp_avg_sq": nu.clone()}


# --- stage 4: the static SuGaR refine step ---------------------------------


def sugar_static_losses(src) -> SugarStaticLosses:
    return SugarStaticLosses(**dataclasses.asdict(src))


def static_train_state(src, optimizer=None, device="cuda") -> StaticTrainState:
    """``src``: the JAX static ``TrainState`` (or a dict) with ``params``,
    ``step`` and optionally ``opt_state`` as numpy; ``optimizer`` the
    keyword arguments of ``sugar_optimizer`` (the schedules are not part of
    the JAX state).  Without ``opt_state`` Adam starts from zero moments;
    with the ``optax.multi_transform`` state of ``sugar_optimizer`` —
    ``inner_states[field].inner_state[0]`` a ``ScaleByAdamState`` whose
    ``mu`` / ``nu`` hold that field and masked nodes elsewhere — every
    field's moments and count are carried over."""
    state = init_static_state(sugar_params(_get(src, "params"), "cpu"), optimizer,
                              step=int(_item(_get(src, "step"))), device=device)
    opt_state = _opt_state(src)
    if opt_state is not None:
        inner = _get(opt_state, "inner_states")
        for field, param in zip(SuGaRParams._fields, state.params):
            adam = _get(inner[field], "inner_state")[0]
            _set_adam(state.opt_state, param, _get(adam, "count"),
                      _f32(_get(_get(adam, "mu"), field), device),
                      _f32(_get(_get(adam, "nu"), field), device))
    return state


def perceptual_params(tree, device="cuda") -> dict:
    """The JAX ``init_perceptual`` / ``load_torch_weights`` tree with each
    convolution turned from HWIO to OIHW, as float32 tensors (the
    ``params=`` of ``utils.metrics.LPIPSMetric`` and
    ``utils.perceptual.from_params``)."""
    return {
        "stages": [[{"w": _f32(np.asarray(c["w"]).transpose(3, 2, 0, 1), device),
                     "b": _f32(c["b"], device)} for c in stage] for stage in tree["stages"]],
        "lins": [_f32(w, device) for w in tree["lins"]],
    }
