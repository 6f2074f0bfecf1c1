"""Registry factories: component names -> constructable factories
(counterpart of ``dreammesh4d_tpu/models/registry_names.py``).

``find(name)(cfg)`` returns a constructed component, as the reference's
``threestudio.find(name)(cfg)`` does: the config mapping (the YAML sub-block
a reference config passes) resolved to the port's dataclass, parameters
initialised, forward functions bound.  Each factory also takes ``device=``
(default ``"cuda"``, as every entry point of the port).  Parameters are
drawn from a ``torch.Generator`` seeded by ``cfg["seed"]`` (default 0): they
are not the JAX package's ``PRNGKey`` draws; carry those across with
``convert`` where the numbers must agree.

Bound here, as the JAX ``register_reference_names`` binds them: ``sugar``,
``dynamic-sugar``, ``gaussian-splatting``, ``implicit-volume``,
``implicit-sdf``, ``custom-mesh``, ``tetrahedra-sdf-grid``, ``volume-grid``,
``diff-sugar-rasterizer-{normal,temporal,shading}``,
``nerf-volume-renderer``, ``neus-volume-renderer``, ``mesh-exporter``,
``gaussian-mesh-exporter``, ``gaussian-splatting-io``, ``perceptual-loss``
and ``dummy-exporter`` (``models/materials.py`` registers ``no-material``
and ``diffuse-with-point-light-material``, as the JAX package's does).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import registry

class Component:
    """A constructed component: config + state + bound callables.

    ``state`` holds initialised parameters / immutable topology; further
    keyword arguments become attributes (bound forward functions).  With
    ``call`` the handle itself is callable (exporter / loss surfaces)."""

    def __init__(self, cfg=None, state=None, call=None, **fns):
        self.cfg = cfg
        self.state = state
        self._call = call
        for k, v in fns.items():
            setattr(self, k, v)

    def __call__(self, *a, **k):
        if self._call is None:
            raise TypeError("component is not callable; use its bound methods")
        return self._call(*a, **k)


def _dc(cls, cfg: Optional[Dict[str, Any]]):
    """Dataclass from a config dict, ignoring unknown keys and recursing into
    nested dataclass fields (the YAML compatibility surface)."""
    cfg = dict(cfg or {})
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in cfg:
            continue
        v = cfg[f.name]
        if isinstance(v, dict):
            ft = f.type if dataclasses.is_dataclass(f.type) else None
            if ft is None and f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                proto = f.default_factory()  # type: ignore[misc]
                ft = type(proto) if dataclasses.is_dataclass(proto) else None
            if ft is not None:
                v = _dc(ft, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _gen(cfg: Optional[Dict[str, Any]], device="cpu") -> torch.Generator:
    """The factory's draws: a generator on ``device`` seeded by ``cfg["seed"]``
    (as the experiments seed theirs)."""
    return torch.Generator(device=device).manual_seed(int((cfg or {}).get("seed", 0)))


def _bind(name: str, target):
    if name not in registry.__modules__:
        registry.__modules__[name] = target
    return target


def _load_bind_mesh(cfg: Dict[str, Any]):
    """Mesh for sugar binding: explicit arrays (``mesh=``) or the reference
    key ``surface_mesh_to_bind_path``."""
    from ..export.mesh_io import MeshData, load_mesh

    if "mesh" in cfg:
        m = cfg["mesh"]
        if isinstance(m, MeshData):
            return m
        return MeshData(
            v_pos=np.asarray(m["v_pos"], np.float32),
            t_pos_idx=np.asarray(m["t_pos_idx"], np.int32),
            v_rgb=(np.asarray(m["v_rgb"], np.float32) if m.get("v_rgb") is not None else None),
        )
    path = cfg.get("surface_mesh_to_bind_path")
    if not path:
        raise ValueError("sugar geometry needs 'surface_mesh_to_bind_path' or 'mesh'")
    return load_mesh(str(path))


# ---------------------------------------------------------------------------
# Geometry factories
# ---------------------------------------------------------------------------


def make_implicit_volume(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import implicit_volume as m

    c = _dc(m.ImplicitVolumeConfig, cfg)
    params = m.init_implicit_volume(c, _gen(cfg, device), device=device)
    return Component(cfg=c, state=params,
                     forward_density=partial(m.forward_density, params, c),
                     forward_field=partial(m.forward_field, params, c))


def make_implicit_sdf(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import implicit_sdf as m

    c = _dc(m.ImplicitSDFConfig, cfg)
    params = m.init_implicit_sdf(c, _gen(cfg, device), device=device)
    return Component(cfg=c, state=params, forward_sdf=partial(m.forward_sdf, params, c),
                     sdf_normal=partial(m.sdf_normal, params, c))


def make_volume_grid(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import volume_grid as m

    c = _dc(m.VolumeGridConfig, cfg)
    params = m.init_volume_grid(c, _gen(cfg, device), device=device)
    return Component(cfg=c, state=params, forward_density=partial(m.forward_density, params, c),
                     forward_field=partial(m.forward_field, params, c))


def make_tet_sdf_grid(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import dmtet as m

    c = _dc(m.TetSDFGridConfig, cfg)
    params = m.init_tet_sdf_grid(c, _gen(cfg, device), device=device)
    return Component(cfg=c, state=params, isosurface=partial(m.isosurface, params, c))


def make_custom_mesh(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    """The feature network; the mesh itself is ``custom_mesh.load_and_normalize(cfg)``."""
    from .geometry import custom_mesh as m

    c = _dc(m.CustomMeshConfig, cfg)
    params = m.init_custom_mesh(c, _gen(cfg, device), device=device)
    return Component(cfg=c, state=params, forward_features=partial(m.forward_features, params, c))


def make_gaussian_splatting(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import gaussian as m

    c = _dc(m.GaussianConfig, cfg)
    state = m.init_random_sphere(c, _gen(cfg, device), device=device)
    return Component(cfg=c, state=state, renderable=partial(m.renderable, state))


def make_sugar(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import sugar as m

    cfg = dict(cfg or {})
    c = _dc(m.SuGaRConfig, cfg)
    params, static = m.create_sugar(c, _load_bind_mesh(cfg), device=device)
    return Component(cfg=c, state=(params, static),
                     gaussian_attributes=partial(m.gaussian_attributes, params, static))


def make_dynamic_sugar(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import deformation as dfm
    from .geometry import dynamic_sugar as dm
    from .geometry import sugar as sm

    cfg = dict(cfg or {})
    params, sugar_static = sm.create_sugar(_dc(sm.SuGaRConfig, cfg), _load_bind_mesh(cfg), device=device)
    c = _dc(dm.DynamicSuGaRConfig, cfg)
    static = dm.build_dynamic_static(c, sugar_static, params.points.cpu().numpy(),
                                     seed=int(cfg.get("seed", 0)), device=device)
    if c.dynamic_mode == "discrete":
        n_pts = static.node_xyz.shape[0] if c.use_deform_graph else params.points.shape[0]
        deform_params = dm.init_discrete_params(c, n_pts, device=device)
    else:
        deform_params = dfm.init_deformation(c.deformation, _gen(cfg, device), device=device)
    return Component(cfg=c, state=(params, deform_params, static),
                     timed_all=partial(dm.timed_all, params, deform_params, c.deformation, static))


# ---------------------------------------------------------------------------
# Renderer factories
# ---------------------------------------------------------------------------


def _make_sugar_rasterizer(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    """The SuGaR rasterizer's ``RasterizerConfig`` from the renderer block
    (``fovy_deg``, ``width``, ``height`` and every rasterizer field).  The
    render functions run where their inputs are; ``device`` is accepted for
    the factories' common signature."""
    from ..ops.gs.rasterize import RasterizerConfig
    from .renderers import sugar_rasterizer as m

    cfg = dict(cfg or {})
    fovy = math.radians(float(cfg.pop("fovy_deg", 49.1)))
    width = int(cfg.pop("width", 512))
    height = int(cfg.pop("height", 512))
    tan = math.tan(fovy / 2)
    fields = set(RasterizerConfig._fields) - {"width", "height", "tan_fovx", "tan_fovy"}
    rc = RasterizerConfig(width=width, height=height, tan_fovx=tan * width / height, tan_fovy=tan,
                          **{k: v for k, v in cfg.items() if k in fields})
    return Component(cfg=rc, render_view=partial(m.render_view, cfg=rc),
                     render_batch=partial(m.render_batch, cfg=rc), depth_to_normal=m.depth_to_normal)


def make_nerf_volume_renderer(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from .geometry import implicit_volume as gm
    from .renderers import nerf_volume_renderer as m

    cfg = dict(cfg or {})
    rc = _dc(m.NeRFRendererConfig, cfg)
    occ = m.init_occgrid(rc, device=device) if rc.estimator == "occgrid" else None
    geo_cfg = _dc(gm.ImplicitVolumeConfig, cfg.get("geometry"))

    def render(geo_params, rays_o, rays_d, light_positions, bg_color, **kw):
        return m.render_rays(geo_params, geo_cfg, rc, rays_o, rays_d, light_positions, bg_color,
                             occ_state=kw.pop("occ_state", occ), **kw)

    return Component(cfg=rc, state=occ, render_rays=render)


def make_neus_volume_renderer(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    """``state`` is the variance ``{"log_s"}``; ``render_rays(geo_params,
    rays_o, rays_d, bg_color, var_params=None, **kw)``."""
    from .geometry import implicit_sdf as gm
    from .renderers import neus_volume_renderer as m

    cfg = dict(cfg or {})
    c = _dc(m.NeuSRendererConfig, cfg)
    geo_cfg = _dc(gm.ImplicitSDFConfig, cfg.get("geometry"))
    variance = m.init_neus_variance(c, device=device)

    def render(geo_params, rays_o, rays_d, bg_color, var_params=None, **kw):
        return m.render_rays_neus(geo_params, variance if var_params is None else var_params, geo_cfg, c,
                                  rays_o, rays_d, bg_color, **kw)

    return Component(cfg=c, state=variance, render_rays=render, neus_alphas=m.neus_alphas)


# ---------------------------------------------------------------------------
# Exporter / IO / loss factories
# ---------------------------------------------------------------------------


def make_mesh_exporter(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    """Callable: the mesh of a density grid (the isosurface parameters of the
    geometry config); host code, ``device`` unused."""
    from ..export import isosurface as m

    cfg = dict(cfg or {})
    kw = dict(threshold=cfg.get("isosurface_threshold"),
              remove_outliers=bool(cfg.get("isosurface_remove_outliers", True)),
              outlier_ratio=float(cfg.get("isosurface_outlier_ratio", 0.1)))
    if cfg.get("isosurface_threshold") in ("auto", None):
        kw["threshold"] = None

    def export(density, bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0)):
        return m.extract_isosurface(np.asarray(density), bbox_min=bbox_min, bbox_max=bbox_max, **kw)

    return Component(cfg=cfg, call=export, marching_cubes=m.marching_cubes)


def make_gaussian_mesh_exporter(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    """Callable: a textured or vertex-coloured OBJ of a bound SuGaR mesh."""
    from ..export import texture_bake as m

    cfg = dict(cfg or {})

    def export(path, verts, faces, v_rgb=None, **kw):
        if kw.get("texture") is not None:
            return m.export_textured_mesh(str(path), np.asarray(verts), np.asarray(faces), **kw)
        from ..export.mesh_io import MeshData, save_obj

        save_obj(str(path), MeshData(
            v_pos=np.asarray(verts, np.float32), t_pos_idx=np.asarray(faces, np.int32),
            v_rgb=None if v_rgb is None else np.asarray(v_rgb, np.float32)))

    return Component(cfg=cfg, call=export, build_square_atlas=m.build_square_atlas,
                     bake_texture=m.bake_texture)


def make_gaussian_io(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    from ..export import gaussian_io as m

    return Component(cfg=dict(cfg or {}), save_ply=m.save_gaussians_ply, load_ply=m.load_gaussians_ply)


def make_perceptual_loss(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    """Callable: loss = p(x, y) on (B, H, W, 3) images in [0, 1].  ``state``
    is the network's parameters in ``utils.perceptual.from_params``'s layout
    (convolutions OIHW), drawn on the CPU as ``init_perceptual`` draws them."""
    from ..utils import perceptual as m

    net = m.init_perceptual(_gen(cfg), device=device)
    state = {"stages": [[{"w": c.weight, "b": c.bias} for c in convs] for convs in net.stages],
             "lins": list(net.lins)}
    return Component(cfg=dict(cfg or {}), state=state, call=net)


def _dummy_exporter(cfg: Optional[Dict[str, Any]] = None, device="cuda") -> Component:
    """``dummy-exporter``: a no-op that exports nothing."""
    return Component(cfg={}, call=lambda: [])


def register_reference_names() -> None:
    # geometries
    _bind("sugar", make_sugar)
    _bind("dynamic-sugar", make_dynamic_sugar)
    _bind("gaussian-splatting", make_gaussian_splatting)
    _bind("implicit-volume", make_implicit_volume)
    _bind("implicit-sdf", make_implicit_sdf)
    _bind("custom-mesh", make_custom_mesh)
    _bind("tetrahedra-sdf-grid", make_tet_sdf_grid)
    _bind("volume-grid", make_volume_grid)
    # renderers
    _bind("diff-sugar-rasterizer-normal", _make_sugar_rasterizer)
    _bind("diff-sugar-rasterizer-temporal", _make_sugar_rasterizer)
    _bind("diff-sugar-rasterizer-shading", _make_sugar_rasterizer)
    _bind("nerf-volume-renderer", make_nerf_volume_renderer)
    _bind("neus-volume-renderer", make_neus_volume_renderer)
    # exporters / IO / losses
    _bind("mesh-exporter", make_mesh_exporter)
    _bind("gaussian-mesh-exporter", make_gaussian_mesh_exporter)
    _bind("gaussian-splatting-io", make_gaussian_io)
    _bind("perceptual-loss", make_perceptual_loss)
    _bind("dummy-exporter", _dummy_exporter)


register_reference_names()
