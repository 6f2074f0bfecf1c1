"""Dynamic SuGaR: time-varying mesh-bound Gaussians via a sparse deformation
graph with hybrid LBS/DQS skinning (counterpart of
``dreammesh4d_tpu/models/geometry/dynamic_sugar.py``).

The chain, with a leading timestamp axis throughout:

    HexPlane deltas at graph nodes → skinning to vertices → barycentric
    re-derivation of Gaussian attributes

- node deltas: ``forward_dynamic_delta(node_xyz, 2t−1)``, rotation residual
  added to the identity quaternion (wxyz) then normalized;
- strain: 6-vector → symmetric I+ε matrix;
- LBS: x' = Σ_k w_k (R_k S_k x + t_k);
- DQS: per-node dual quaternions blended with the binding weights,
  normalized, then applied;
- hybrid: per-vertex blend weight clamp(Σ w_k σ(o_k) + 0.4, ≤ 1);
- vertex rotations fused in so(3) log space;
- timed Gaussians: xyz = barycentric of deformed vertices, rot =
  (barycentric-fused vertex Δrot) ∘ static rot, scales through the strain.

The JAX package runs skinning in a component-planar layout (a TPU lane
choice); here the component axis stays last, with the same values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...ops.quaternion import (
    dq_apply,
    dq_blend,
    dq_from_quat_translation,
    fuse_rotations,
    quat_apply,
    quat_exp,
    quat_log,
    quat_multiply,
    quat_normalize,
)
from .deformation import (
    DeformationConfig,
    forward_dynamic_delta,
    strain_tensor_to_matrix,
)
from .deformation_graph import build_deformation_graph
from .sugar import SuGaRParams, SuGaRStatic, gaussian_attributes, gaussian_centers


@dataclass
class DynamicSuGaRConfig:
    num_frames: int = 32
    dynamic_mode: str = "deformation"  # deformation | discrete
    use_deform_graph: bool = True
    n_dg_nodes: int = 1000
    dg_node_connectivity: int = 4
    dist_mode: str = "geodisc"  # geodisc | eucdisc
    skinning_method: str = "hybrid"  # lbs | dqs | hybrid
    d_scale: bool = True
    deformation: DeformationConfig = field(default_factory=DeformationConfig)


class DynamicStatic(NamedTuple):
    """Immutable topology: SuGaR static + deformation-graph binding."""

    sugar: SuGaRStatic
    node_xyz: torch.Tensor  # (M, 3)
    nbr_idx: torch.Tensor  # (V, K) per-vertex nearest nodes
    nbr_w: torch.Tensor  # (V, K) normalized binding weights
    gs_vert_idx: torch.Tensor  # (N_gs, 3) vertex ids per gaussian (its face)
    gs_bary_w: torch.Tensor  # (N_gs, 3) barycentric weights
    skinning_method: str
    d_scale: bool
    dynamic_mode: str = "deformation"
    use_deform_graph: bool = True
    num_frames: int = 32


class NodeAttrs(NamedTuple):
    trans: torch.Tensor  # (..., M, 3)
    rots: torch.Tensor  # (..., M, 4) wxyz
    strain: Optional[torch.Tensor]  # (..., M, 3, 3)
    blendw: Optional[torch.Tensor]  # (..., M, 1) sigmoid blend weight (hybrid)


class VertexAttrs(NamedTuple):
    xyz: torch.Tensor  # (..., V, 3)
    rots: torch.Tensor  # (..., V, 4)
    strain: Optional[torch.Tensor]  # (..., V, 3, 3)


class TimedGS(NamedTuple):
    means3d: torch.Tensor  # (..., N, 3)
    quats: torch.Tensor  # (..., N, 4)
    scales: torch.Tensor  # (..., N, 3)


def build_dynamic_static(cfg: DynamicSuGaRConfig, sugar_static: SuGaRStatic,
                         points: np.ndarray, seed: int = 0, device="cuda") -> DynamicStatic:
    """Host-side: build the deformation-graph binding for the bound mesh.
    With ``use_deform_graph=False`` the graph build is skipped and the node
    fields hold 1-node placeholders that no code path reads."""
    faces = sugar_static.faces.cpu().numpy()
    points = np.asarray(points)
    if cfg.use_deform_graph:
        graph = build_deformation_graph(
            points, faces, cfg.n_dg_nodes, cfg.dg_node_connectivity,
            mode=cfg.dist_mode, seed=seed,
        )
        node_xyz, nbr_idx, nbr_w = graph.node_xyz, graph.neighbor_idx, graph.neighbor_weights
    else:
        V = len(points)
        node_xyz = np.zeros((1, 3), np.float32)
        nbr_idx = np.zeros((V, 1), np.int32)
        nbr_w = np.ones((V, 1), np.float32)
    G = sugar_static.n_per_face
    gs_vert_idx = np.repeat(faces, G, axis=0)  # (F*G, 3)
    gs_bary_w = np.tile(sugar_static.bary_coords.cpu().numpy(), (len(faces), 1))
    return DynamicStatic(
        sugar=sugar_static,
        node_xyz=torch.as_tensor(np.asarray(node_xyz, np.float32), device=device),
        nbr_idx=torch.as_tensor(np.asarray(nbr_idx), dtype=torch.int64, device=device),
        nbr_w=torch.as_tensor(np.asarray(nbr_w, np.float32), device=device),
        gs_vert_idx=torch.as_tensor(gs_vert_idx, dtype=torch.int64, device=device),
        gs_bary_w=torch.as_tensor(np.asarray(gs_bary_w, np.float32), device=device),
        skinning_method=cfg.skinning_method,
        d_scale=cfg.d_scale,
        dynamic_mode=cfg.dynamic_mode,
        use_deform_graph=cfg.use_deform_graph,
        num_frames=cfg.num_frames,
    )


# ---------------------------------------------------------------------------
# Discrete mode and direct vertex deformation
# ---------------------------------------------------------------------------


def init_discrete_params(cfg: DynamicSuGaRConfig, n_points: int, device="cuda") -> Dict[str, Any]:
    """Per-frame transform tables for ``dynamic_mode="discrete"``: zero
    translations, identity rotations, zero strain and zero blend logits per
    frame x node (per frame x vertex without the graph)."""
    L = cfg.num_frames
    M = cfg.n_dg_nodes if cfg.use_deform_graph else n_points
    rots = torch.zeros((L, M, 4), device=device)
    rots[..., 0] = 1.0
    params = {"trans": torch.zeros((L, M, 3), device=device), "rots": rots}
    if cfg.use_deform_graph:
        if cfg.d_scale or cfg.skinning_method in ("hybrid", "lbs"):
            params["strain"] = torch.zeros((L, M, 6), device=device)
        if cfg.skinning_method == "hybrid":
            params["blendw"] = torch.zeros((L, M, 1), device=device)
    elif cfg.d_scale:
        params["strain"] = torch.zeros((L, M, 6), device=device)
    return params


def discrete_node_attrs(discrete_params: Dict[str, Any],
                        frame_indices: torch.Tensor) -> NodeAttrs:
    """Table lookup for discrete mode: per-frame learned node transforms."""
    trans = discrete_params["trans"][frame_indices]
    rots = quat_normalize(discrete_params["rots"][frame_indices])
    strain = None
    if "strain" in discrete_params:
        strain = strain_tensor_to_matrix(discrete_params["strain"][frame_indices])
    blendw = None
    if "blendw" in discrete_params:
        blendw = torch.sigmoid(discrete_params["blendw"][frame_indices])
    return NodeAttrs(trans, rots, strain, blendw)


def direct_vertex_attrs(params: SuGaRParams, deform_params: Dict[str, Any],
                        deform_cfg: DeformationConfig, static: DynamicStatic,
                        timestamps: Optional[torch.Tensor],
                        frame_indices: Optional[torch.Tensor]) -> VertexAttrs:
    """``use_deform_graph=False``: deform every mesh vertex directly, no
    skinning."""
    verts = params.points
    V = verts.shape[0]
    if static.dynamic_mode == "discrete":
        node = discrete_node_attrs(deform_params, frame_indices)
        return VertexAttrs(verts[None] + node.trans, node.rots, node.strain)
    T = timestamps.shape[0]
    pts = verts[None].expand(T, V, 3)
    ts = timestamps[:, None].expand(T, V) * 2.0 - 1.0
    deltas = forward_dynamic_delta(deform_params, deform_cfg, pts, ts)
    rots = quat_normalize(deltas.drot + deltas.drot.new_tensor([1.0, 0.0, 0.0, 0.0]))
    strain = strain_tensor_to_matrix(deltas.dstrain) if deltas.dstrain is not None else None
    return VertexAttrs(pts + deltas.dx, rots, strain)


# ---------------------------------------------------------------------------
# Timed attribute chain
# ---------------------------------------------------------------------------


def timed_node_attrs(deform_params: Dict[str, Any], deform_cfg: DeformationConfig,
                     static: DynamicStatic, timestamps: torch.Tensor) -> NodeAttrs:
    """Query the HexPlane field at the graph nodes for each timestamp (T,)."""
    T = timestamps.shape[0]
    M = static.node_xyz.shape[0]
    pts = static.node_xyz[None].expand(T, M, 3)
    ts = timestamps[:, None].expand(T, M) * 2.0 - 1.0
    deltas = forward_dynamic_delta(deform_params, deform_cfg, pts, ts)
    rots = quat_normalize(deltas.drot + deltas.drot.new_tensor([1.0, 0.0, 0.0, 0.0]))
    strain = strain_tensor_to_matrix(deltas.dstrain) if deltas.dstrain is not None else None
    blendw = torch.sigmoid(deltas.dopacity) if deltas.dopacity is not None else None
    return NodeAttrs(deltas.dx, rots, strain, blendw)


def skin_vertices(static: DynamicStatic, verts: torch.Tensor, node: NodeAttrs) -> VertexAttrs:
    """Deform mesh vertices (V, 3) or (..., V, 3) from node transforms."""
    idx = static.nbr_idx  # (V, K)
    w = static.nbr_w  # (V, K)
    n_trans = node.trans[..., idx, :]  # (..., V, K, 3)
    n_rots = node.rots[..., idx, :]  # (..., V, K, 4)
    x = verts[..., :, None, :]  # (..., V, 1, 3)

    method = static.skinning_method
    n_strain = node.strain[..., idx, :, :] if node.strain is not None else None  # (..., V, K, 3, 3)
    deformed_lbs = None
    if method in ("lbs", "hybrid"):
        assert n_strain is not None, "lbs/hybrid needs the strain head"
        sx = (n_strain * x[..., None, :]).sum(-1)  # (..., V, K, 3) = S · x
        deformed = quat_apply(n_rots, sx) + n_trans
        deformed_lbs = (w[..., None] * deformed).sum(-2)  # (..., V, 3)

    deformed_dqs = None
    if method in ("dqs", "hybrid"):
        dq = dq_from_quat_translation(n_rots, n_trans)  # (..., V, K, 8)
        deformed_dqs = dq_apply(dq_blend(dq, w), verts)

    if method == "lbs":
        xyz = deformed_lbs
    elif method == "dqs":
        xyz = deformed_dqs
    else:  # hybrid
        assert node.blendw is not None, "hybrid needs the opacity/blend head"
        n_bw = node.blendw[..., 0][..., idx]  # (..., V, K)
        vert_lbs_w = torch.clamp((w * n_bw).sum(-1) + 0.4, max=1.0)  # (..., V)
        xyz = vert_lbs_w[..., None] * deformed_lbs + (1.0 - vert_lbs_w[..., None]) * deformed_dqs

    vert_rots = fuse_rotations(idx, w, node.rots)  # (..., V, 4)

    vert_strain = None
    if static.d_scale and node.strain is not None:
        if method == "hybrid":
            s = ((w * n_bw)[..., None, None] * n_strain).sum(-3)  # (..., V, 3, 3)
            eye = torch.eye(3, dtype=s.dtype, device=s.device)
            s = s + (1.0 - vert_lbs_w)[..., None, None] * eye
        else:
            s = (w[..., None, None] * n_strain).sum(-3)
        vert_strain = s
    return VertexAttrs(xyz, vert_rots, vert_strain)


def timed_gs_attrs(params: SuGaRParams, static: DynamicStatic, vert: VertexAttrs) -> TimedGS:
    """Re-derive renderable Gaussian attributes at each timestamp: Gaussians
    bound G-per-face to the same 3 vertices gather per FACE and expand to
    their G slots with the barycentric weights."""
    sg = static.sugar
    attrs0 = gaussian_attributes(params, sg)
    F = sg.faces.shape[0]
    G = sg.n_per_face
    bary = sg.bary_coords  # (G, 3)
    lead = vert.xyz.shape[:-2]

    means = gaussian_centers(vert.xyz, sg)  # (..., N, 3)

    flogs = quat_log(vert.rots)[..., sg.faces, :]  # (..., F, 3v, 3)
    fused = torch.einsum("gj,...fjc->...fgc", bary, flogs)  # (..., F, G, 3)
    q0 = attrs0.quats.reshape(F, G, 4)
    quats = quat_normalize(quat_multiply(quat_exp(fused), q0)).reshape(lead + (F * G, 4))

    if static.d_scale and vert.strain is not None:
        fstrain = vert.strain[..., sg.faces, :, :]  # (..., F, 3v, 3, 3)
        gs_strain = torch.einsum("gj,...fjab->...fgab", bary, fstrain)  # (..., F, G, 3, 3)
        s0 = attrs0.scales.reshape(F, G, 3)
        scales = (gs_strain * s0[..., None, :]).sum(-1).reshape(lead + (F * G, 3))
    else:
        scales = attrs0.scales.expand(means.shape)
    return TimedGS(means, quats, scales)


def timed_all(params: SuGaRParams, deform_params: Dict[str, Any],
              deform_cfg: DeformationConfig, static: DynamicStatic,
              timestamps: torch.Tensor,
              frame_indices: Optional[torch.Tensor] = None) -> Tuple[TimedGS, VertexAttrs]:
    """Full chain: timestamps (T,) -> per-time GS attrs + deformed vertices.
    Dispatches on the modes (HexPlane vs discrete tables, graph skinning vs
    direct vertex deformation); discrete mode derives missing frame indices
    from the timestamps (nearest frame)."""
    if static.dynamic_mode == "discrete" and frame_indices is None:
        frame_indices = torch.clamp(
            torch.round(timestamps * (static.num_frames - 1)).long(),
            0, static.num_frames - 1)
    if not static.use_deform_graph:
        vert = direct_vertex_attrs(params, deform_params, deform_cfg, static,
                                   timestamps, frame_indices)
    else:
        if static.dynamic_mode == "discrete":
            node = discrete_node_attrs(deform_params, frame_indices)
        else:
            node = timed_node_attrs(deform_params, deform_cfg, static, timestamps)
        vert = skin_vertices(static, params.points, node)
    return timed_gs_attrs(params, static, vert), vert
