"""Fixed-mesh geometry, ``custom-mesh`` (counterpart of
``dreammesh4d_tpu/models/geometry/custom_mesh.py``, :24-56): a user mesh
read with the port's ``export/mesh_io.load_mesh``, centred on its box and
scaled to a half-extent of ``shape_init_params``, and per-point features
from a hash-encoded MLP for texturing the frozen surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...export.mesh_io import MeshData, load_mesh
from ...ops.hashgrid import HashGridConfig, hashgrid_encode, init_hashgrid
from .implicit_volume import _mlp_apply, _mlp_init


@dataclass
class CustomMeshConfig:
    shape_init: str = ""  # mesh path ("mesh:/path/to.obj" accepted too)
    shape_init_params: float = 1.0  # the largest half-extent after normalising
    radius: float = 1.0
    n_feature_dims: int = 3
    hashgrid: HashGridConfig = field(default_factory=HashGridConfig)
    n_neurons: int = 64
    n_hidden_layers: int = 1


def load_and_normalize(cfg: CustomMeshConfig) -> MeshData:
    path = cfg.shape_init[5:] if cfg.shape_init.startswith("mesh:") else cfg.shape_init
    mesh = load_mesh(path)
    v = np.asarray(mesh.v_pos, np.float32)
    center = (v.max(0) + v.min(0)) / 2
    scale = float(np.abs(v - center).max())
    v = (v - center) / max(scale, 1e-8) * cfg.shape_init_params
    return MeshData(v_pos=v, t_pos_idx=mesh.t_pos_idx, v_rgb=mesh.v_rgb)


def init_custom_mesh(cfg: CustomMeshConfig, generator: Optional[torch.Generator] = None,
                     device="cuda") -> Dict[str, Any]:
    dims = [cfg.hashgrid.out_dim, cfg.n_neurons] + [cfg.n_neurons] * (cfg.n_hidden_layers - 1)
    return {"encoding": init_hashgrid(cfg.hashgrid, generator, device),
            "feature_mlp": _mlp_init(generator, dims + [cfg.n_feature_dims], device)}


def forward_features(params, cfg: CustomMeshConfig, points: torch.Tensor) -> torch.Tensor:
    x = (points / cfg.radius + 1.0) / 2.0
    enc = hashgrid_encode(params["encoding"], cfg.hashgrid, x)
    return torch.sigmoid(_mlp_apply(params["feature_mlp"], enc))
