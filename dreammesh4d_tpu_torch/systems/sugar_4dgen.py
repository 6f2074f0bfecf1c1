"""sugar-4dgen-system, the dynamic ("motion") stage (counterpart of
``dreammesh4d_tpu/systems/sugar_4dgen.py``).  Only the timed evaluation
render is ported so far; the train step comes with the training slice."""

from __future__ import annotations

import torch

from ..models.geometry.deformation import DeformationConfig
from ..models.geometry.dynamic_sugar import DynamicStatic, timed_all
from ..models.geometry.sugar import SuGaRParams, gaussian_attributes
from ..models.renderers.sugar_rasterizer import CameraBatch, render_batch
from ..ops.gs.rasterize import RasterizerConfig
from ..ops.meshops import face_normals


def make_dynamic_render_eval(sugar_params: SuGaRParams, static: DynamicStatic,
                             deform_cfg: DeformationConfig, raster_cfg: RasterizerConfig,
                             bg_color=(1.0, 1.0, 1.0)):
    """Timed evaluation render: ``render_eval(deform_params, cameras,
    timestamps, frame_indices=None)`` renders view b at ``timestamps[b]``
    (rgb + face normals + depth in one blend per view)."""
    sg = static.sugar
    G = sg.n_per_face
    attrs0 = gaussian_attributes(sugar_params, sg)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=sugar_params.points.device)

    def render_eval(deform_params, cameras: CameraBatch, timestamps, frame_indices=None):
        gs, vert = timed_all(sugar_params, deform_params, deform_cfg, static,
                             timestamps, frame_indices=frame_indices)
        gs_normals = torch.repeat_interleave(face_normals(vert.xyz, sg.faces), G, dim=-2)
        return render_batch(
            attrs0.means3d, attrs0.quats, attrs0.scales, attrs0.opacities,
            attrs0.sh, sg.sh_degree, None, cameras, bg, raster_cfg,
            timed_attrs=(gs.means3d, gs.quats, gs.scales, gs_normals),
        )

    return render_eval
