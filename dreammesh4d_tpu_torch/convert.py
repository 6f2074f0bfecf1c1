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
- the Gaussian stage: :func:`gaussian_state_params` — a ``GaussianState``
  (``alive`` as bool); :func:`gaussian_train_state` — a
  ``GaussianTrainState`` with its per-field Adam (``mu`` / ``nu`` /
  ``count`` become each field's ``exp_avg`` / ``exp_avg_sq`` / ``step``),
  the densification statistics and the step;
- the guidance: :func:`zero123_guidance_params` — the JAX Stable Zero123
  param tree as the port's ``Zero123Modules`` state dict (the LDM layout);
  :func:`clip_vision_params` — the JAX CLIP tower as the port's
  ``VisionTransformer`` state dict;
- the Stable Diffusion guidance: :func:`sd_guidance_params` — the JAX SD
  param tree (UNet and VAE) as the port's ``StableDiffusionModules`` state
  dict; also the InstructPix2Pix tree (8 input channels), DeepFloyd's
  (no VAE) and ControlNet's (its ``controlnet`` entry through
  :func:`controlnet_params`, keyed ``control_model.*``);
- the editing systems: :func:`discriminator_params` — the PatchGAN tree
  (HWIO → OIHW); :func:`gan_renderer_params` — a ``GANVolumeRenderer``'s
  flax tree (``generator``, ``local_encoder``, ``global_encoder`` under
  flax's automatic names ``Conv_k``, ``_ResBlock_k``, ``GroupNorm_k``,
  ``Dense_0``) as the port renderer's state dict;
- VSD: :func:`vsd_lora_params` — the JAX LoRA tree (keys the flax paths
  ``…/attn1/to_q``) as the port's (keys the UNet's module names
  ``….attn1.to_q``, ``….to_out.0``; the same (in, r) / (r, out) layout);
  :func:`vsd_checkpoint` — a JAX ``ZooVSDExperiment``'s state (scene, LoRA,
  both Adams' moments) as the port experiment's ``load_state`` dict;
- the unified guidance: :func:`vsd_lora_params` also maps the JAX
  ``Zero123UnifiedGuidance.init_lora_params`` tree (the Zero123 UNet has
  the SD UNet's layout);
- the materials and backgrounds: :func:`component_params` — the trees of
  ``PBRMaterial`` (``env_levels``), ``NeuralRadianceMaterial`` (``mlp``),
  ``SDLatentAdapterMaterial`` (``adapter``), ``NeuralEnvironmentMapBackground``
  (``layers``), ``SolidColorBackground`` (``color``) and
  ``TexturedBackground`` (``texture``) as the ``params`` of their port
  counterparts;
- the SDF and mesh geometries: :func:`geometry_config` — a JAX
  ``ImplicitSDFConfig``, ``TetSDFGridConfig``, ``CustomMeshConfig``,
  ``VolumeGridConfig`` or ``NeuSRendererConfig`` as the port's class of the
  same name (the hash grid's too); :func:`geometry_params` — the trees of
  ``init_implicit_sdf`` (``encoding``, ``sdf_mlp``, ``feature_mlp``),
  ``init_tet_sdf_grid`` (``sdf``, ``deform``, ``encoding``,
  ``feature_mlp``), ``init_custom_mesh``, ``init_volume_grid`` (``grid``)
  and ``init_neus_variance`` (``log_s``) as float32 tensors;
- evaluation: :func:`perceptual_params` — the LPIPS tree
  ``{"stages": [[{w HWIO, b}, …], …], "lins": […]}`` with OIHW convolutions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.geometry.deformation import DeformationConfig
from .models.geometry.dynamic_sugar import DynamicStatic, DynamicSuGaRConfig
from .models.geometry.gaussian import DensifyStats, GaussianState
from .models.geometry.implicit_volume import ImplicitVolumeConfig
from .models.geometry.sugar import SuGaRConfig, SuGaRParams, SuGaRStatic
from .models.renderers.nerf_volume_renderer import NeRFRendererConfig, OccGridState
from .models.renderers.sugar_rasterizer import CameraBatch
from .ops.gs.rasterize import RasterizerConfig
from .ops.hashgrid import HashGridConfig
from .systems.gaussian_stage import GaussianParams, GaussianTrainState, init_gaussian_train_state
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


def geometry_config(src):
    """A JAX SDF / mesh geometry or NeuS renderer config as the port's."""
    from .models.geometry import custom_mesh, dmtet, implicit_sdf, volume_grid
    from .models.renderers import neus_volume_renderer

    classes = {"ImplicitSDFConfig": implicit_sdf.ImplicitSDFConfig, "TetSDFGridConfig": dmtet.TetSDFGridConfig,
               "CustomMeshConfig": custom_mesh.CustomMeshConfig, "VolumeGridConfig": volume_grid.VolumeGridConfig,
               "NeuSRendererConfig": neus_volume_renderer.NeuSRendererConfig}
    cls = classes[type(src).__name__]
    fields = dataclasses.asdict(src)
    if "hashgrid" in fields:
        fields["hashgrid"] = HashGridConfig(**fields["hashgrid"])
    return cls(**fields)


def geometry_params(tree, device="cuda"):
    """An SDF / mesh geometry's or the NeuS variance's JAX tree as the same
    tree of float32 tensors (0-d ``log_s`` included)."""
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


# --- the Gaussian stage ----------------------------------------------------


def gaussian_state_params(src, device="cuda") -> GaussianState:
    return GaussianState(*(_f32(_get(src, k), device) for k in GaussianParams._fields),
                         alive=torch.as_tensor(np.array(_get(src, "alive"), bool), device=device))


def gaussian_train_state(src, optimizer=None, device="cuda") -> GaussianTrainState:
    """``src``: the JAX ``GaussianTrainState`` (or a dict) with
    ``gaussians``, ``opt_state`` (``GaussianAdamState``: ``mu`` / ``nu``
    mirroring ``GaussianParams``, one ``count``), ``stats`` and ``step`` as
    numpy; ``optimizer`` the keyword arguments of ``gaussian_optimizer``
    (the schedules are not part of the JAX state).  A count of 0 leaves Adam
    without state, as a fresh optimizer has."""
    state = init_gaussian_train_state(gaussian_state_params(_get(src, "gaussians"), "cpu"), optimizer,
                                      step=int(_item(_get(src, "step"))), device=device)
    adam = _get(src, "opt_state")
    if int(_item(_get(adam, "count"))):
        for field in GaussianParams._fields:
            _set_adam(state.opt_state, getattr(state.gaussians, field), _get(adam, "count"),
                      _f32(_get(_get(adam, "mu"), field), device),
                      _f32(_get(_get(adam, "nu"), field), device))
    stats = _get(src, "stats")
    return state._replace(stats=DensifyStats(
        _f32(_get(stats, "grad_accum"), device), _f32(_get(stats, "denom"), device),
        torch.as_tensor(np.array(_get(stats, "max_radii"), np.int32), device=device)))


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


# --- the Stable Zero123 guidance --------------------------------------------
# The inverse of the JAX converters (``convert_unet`` / ``convert_vae`` /
# ``convert_clip_vision``): flax trees → the LDM checkpoint's layout, which is
# ``Zero123Modules.state_dict()``.


def _np32(x):
    return np.asarray(x, np.float32)


def _ldm_conv(sd, key, p):
    sd[f"{key}.weight"] = _np32(p["kernel"]).transpose(3, 2, 0, 1)  # HWIO → OIHW
    if "bias" in p:
        sd[f"{key}.bias"] = _np32(p["bias"])


def _ldm_dense(sd, key, p):
    sd[f"{key}.weight"] = _np32(p["kernel"]).T
    if "bias" in p:
        sd[f"{key}.bias"] = _np32(p["bias"])


def _ldm_norm(sd, key, p):
    p = p.get("GroupNorm_0", p.get("LayerNorm_0", p))
    sd[f"{key}.weight"], sd[f"{key}.bias"] = _np32(p["scale"]), _np32(p["bias"])


def _ldm_res_block(sd, key, p):
    _ldm_norm(sd, f"{key}.in_layers.0", p["norm_in"])
    _ldm_conv(sd, f"{key}.in_layers.2", p["conv_in"])
    _ldm_dense(sd, f"{key}.emb_layers.1", p["emb_proj"])
    _ldm_norm(sd, f"{key}.out_layers.0", p["norm_out"])
    _ldm_conv(sd, f"{key}.out_layers.3", p["conv_out"])
    if "skip" in p:
        _ldm_conv(sd, f"{key}.skip_connection", p["skip"])


def _ldm_spatial_transformer(sd, key, p):
    _ldm_norm(sd, f"{key}.norm", p["norm"])
    _ldm_conv(sd, f"{key}.proj_in", p["proj_in"])
    _ldm_conv(sd, f"{key}.proj_out", p["proj_out"])
    i = 0
    while f"block_{i}" in p:
        b, bk = p[f"block_{i}"], f"{key}.transformer_blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            _ldm_norm(sd, f"{bk}.{n}", b[n])
        for n in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _ldm_dense(sd, f"{bk}.{n}.{proj}", b[n][proj])
            _ldm_dense(sd, f"{bk}.{n}.to_out.0", b[n]["to_out"])
        _ldm_dense(sd, f"{bk}.ff.net.0.proj", b["ff"]["proj_in"])
        _ldm_dense(sd, f"{bk}.ff.net.2", b["ff"]["proj_out"])
        i += 1


def _ldm_down_and_mid(sd, pre, p, channel_mult, num_res_blocks, attention_resolutions=(4, 2, 1)):
    """The time embedding, the down path and the middle block (the UNet's
    and a ControlNet's) under ``pre``; returns the downsample factor reached."""
    _ldm_dense(sd, f"{pre}time_embed.0", p["time_embed_0"])
    _ldm_dense(sd, f"{pre}time_embed.2", p["time_embed_2"])
    _ldm_conv(sd, f"{pre}input_blocks.0.0", p["conv_in"])
    idx, ds = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _ldm_res_block(sd, f"{pre}input_blocks.{idx}.0", p[f"down_{level}_{i}_res"])
            if ds in attention_resolutions:
                _ldm_spatial_transformer(sd, f"{pre}input_blocks.{idx}.1", p[f"down_{level}_{i}_attn"])
            idx += 1
        if level != len(channel_mult) - 1:
            _ldm_conv(sd, f"{pre}input_blocks.{idx}.0.op", p[f"down_{level}_ds"]["op"])
            idx += 1
            ds *= 2
    _ldm_res_block(sd, f"{pre}middle_block.0", p["mid_res1"])
    _ldm_spatial_transformer(sd, f"{pre}middle_block.1", p["mid_attn"])
    _ldm_res_block(sd, f"{pre}middle_block.2", p["mid_res2"])
    return ds


def _ldm_unet(sd, pre, p, channel_mult, num_res_blocks, attention_resolutions=(4, 2, 1)):
    """``convert_unet``'s walk, writing the LDM keys under ``pre``."""
    ds = _ldm_down_and_mid(sd, pre, p, channel_mult, num_res_blocks, attention_resolutions)
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _ldm_res_block(sd, f"{pre}output_blocks.{idx}.0", p[f"up_{level}_{i}_res"])
            sub = 1
            if ds in attention_resolutions:
                _ldm_spatial_transformer(sd, f"{pre}output_blocks.{idx}.{sub}", p[f"up_{level}_{i}_attn"])
                sub += 1
            if level != 0 and i == num_res_blocks:
                _ldm_conv(sd, f"{pre}output_blocks.{idx}.{sub}.conv", p[f"up_{level}_us"]["conv"])
            idx += 1
        if level != 0:
            ds //= 2
    _ldm_norm(sd, f"{pre}out.0", p["norm_out"])
    _ldm_conv(sd, f"{pre}out.2", p["conv_out"])


def _ldm_vae_res(sd, key, p):
    for n in ("norm1", "norm2"):
        _ldm_norm(sd, f"{key}.{n}", p[n])
    for n in ("conv1", "conv2", "nin_shortcut"):
        if n in p:
            _ldm_conv(sd, f"{key}.{n}", p[n])


def _ldm_vae_mid(sd, key, p):
    _ldm_vae_res(sd, f"{key}.block_1", p["mid_res1"])
    a = p["mid_attn"]
    _ldm_norm(sd, f"{key}.attn_1.norm", a["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _ldm_conv(sd, f"{key}.attn_1.{n}", a[n])
    _ldm_vae_res(sd, f"{key}.block_2", p["mid_res2"])


def _ldm_vae(sd, pre, p, ch_mult, num_res_blocks):
    """``convert_vae``'s walk, writing the LDM keys under ``pre``."""
    enc, dec = p["encoder"], p["decoder"]
    _ldm_conv(sd, f"{pre}encoder.conv_in", enc["conv_in"])
    for level in range(len(ch_mult)):
        for i in range(num_res_blocks):
            _ldm_vae_res(sd, f"{pre}encoder.down.{level}.block.{i}", enc[f"down_{level}_{i}"])
        if level != len(ch_mult) - 1:
            _ldm_conv(sd, f"{pre}encoder.down.{level}.downsample.conv", enc[f"down_{level}_ds"])
    _ldm_vae_mid(sd, f"{pre}encoder.mid", enc)
    _ldm_norm(sd, f"{pre}encoder.norm_out", enc["norm_out"])
    _ldm_conv(sd, f"{pre}encoder.conv_out", enc["conv_out"])
    _ldm_conv(sd, f"{pre}decoder.conv_in", dec["conv_in"])
    _ldm_vae_mid(sd, f"{pre}decoder.mid", dec)
    for level in range(len(ch_mult)):
        for i in range(num_res_blocks + 1):
            _ldm_vae_res(sd, f"{pre}decoder.up.{level}.block.{i}", dec[f"up_{level}_{i}"])
        if level != 0:
            _ldm_conv(sd, f"{pre}decoder.up.{level}.upsample.conv", dec[f"up_{level}_us"])
    _ldm_norm(sd, f"{pre}decoder.norm_out", dec["norm_out"])
    _ldm_conv(sd, f"{pre}decoder.conv_out", dec["conv_out"])
    _ldm_conv(sd, f"{pre}quant_conv", p["quant_conv"])
    _ldm_conv(sd, f"{pre}post_quant_conv", p["post_quant_conv"])


def clip_vision_params(tree) -> dict:
    """The JAX CLIP tower ``{"vision": FlaxCLIPVisionModel params,
    "projection"}`` (``CLIPImageEncoder.init`` / ``convert_clip_vision``) →
    the port's ``VisionTransformer`` state dict (OpenAI CLIP's ``visual.*``
    keys without the prefix; q/k/v fused into ``in_proj``), float32 numpy."""
    sd: dict = {}
    vision = tree["vision"].get("params", tree["vision"])["vision_model"]
    emb = vision["embeddings"]
    sd["conv1.weight"] = _np32(emb["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1)
    sd["class_embedding"] = _np32(emb["class_embedding"])
    sd["positional_embedding"] = _np32(emb["position_embedding"]["embedding"])
    _ldm_norm(sd, "ln_pre", vision["pre_layrnorm"])
    layers = vision["encoder"]["layers"]
    for i in range(len(layers)):
        lp, key = layers[str(i)], f"transformer.resblocks.{i}"
        att = lp["self_attn"]
        sd[f"{key}.attn.in_proj_weight"] = np.concatenate(
            [_np32(att[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")])
        sd[f"{key}.attn.in_proj_bias"] = np.concatenate(
            [_np32(att[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
        _ldm_dense(sd, f"{key}.attn.out_proj", att["out_proj"])
        _ldm_norm(sd, f"{key}.ln_1", lp["layer_norm1"])
        _ldm_norm(sd, f"{key}.ln_2", lp["layer_norm2"])
        _ldm_dense(sd, f"{key}.mlp.c_fc", lp["mlp"]["fc1"])
        _ldm_dense(sd, f"{key}.mlp.c_proj", lp["mlp"]["fc2"])
    _ldm_norm(sd, "ln_post", vision["post_layernorm"])
    sd["proj"] = _np32(tree["projection"])
    return sd


def zero123_guidance_params(jax_params, cfg) -> dict:
    """The JAX guidance param tree (``Zero123Modules.init_params`` or
    ``convert_state_dict`` of the JAX package, as numpy) → the port's state
    dict, keyed as ``Zero123Modules.state_dict()`` (the LDM layout, plus
    ``clip_proj`` without CLIP), as float32 numpy arrays.  ``cfg``: the
    port's ``Zero123Config`` (or any object with the same architecture
    fields)."""
    sd: dict = {}
    _ldm_unet(sd, "model.diffusion_model.", jax_params["unet"], tuple(cfg.channel_mult),
              int(cfg.num_res_blocks))
    _ldm_vae(sd, "first_stage_model.", jax_params["vae"], tuple(cfg.vae_ch_mult),
             int(cfg.vae_num_res_blocks))
    _ldm_dense(sd, "cc_projection", jax_params["cc_projection"])
    if "clip" in jax_params:
        sd.update({f"cond_stage_model.model.visual.{k}": v
                   for k, v in clip_vision_params(jax_params["clip"]).items()})
    if "clip_proj" in jax_params:
        sd["clip_proj"] = _np32(jax_params["clip_proj"])
    return sd


def sd_guidance_params(jax_params, cfg) -> dict:
    """The JAX Stable Diffusion param tree (``StableDiffusionGuidance.
    init_params`` or ``convert_sd_state_dict``, as numpy; its ``text``
    entry, if any, is not carried) → the port's state dict, keyed as
    ``StableDiffusionModules.state_dict()`` (the SD LDM layout), as float32
    numpy arrays.  ``cfg``: the port's ``StableDiffusionConfig`` (or any
    object with the same architecture fields)."""
    sd: dict = {}
    _ldm_unet(sd, "model.diffusion_model.", jax_params["unet"], tuple(cfg.channel_mult),
              int(cfg.num_res_blocks))
    if "vae" in jax_params:  # DeepFloyd has none
        _ldm_vae(sd, "first_stage_model.", jax_params["vae"], tuple(cfg.vae_ch_mult),
                 int(cfg.vae_num_res_blocks))
    if "controlnet" in jax_params:
        sd.update(controlnet_params(jax_params["controlnet"], cfg))
    return sd


def _numbered(p, prefix: str) -> list:
    """The entries ``{prefix}0``, ``{prefix}1``, … of ``p``, in order."""
    n = 0
    while f"{prefix}{n}" in p:
        n += 1
    return [p[f"{prefix}{i}"] for i in range(n)]


def controlnet_params(tree, cfg, pre: str = "control_model.") -> dict:
    """The JAX ``ControlNetModel`` tree (``hint_{i}``, ``hint_out``,
    ``conv_in``, ``time_embed_{0,2}``, ``down_*``, ``mid_*``, ``zero_{i}``)
    → the port's ``ControlNetModel`` state dict under ``pre``: the hint
    convolutions at ``input_hint_block.{2i}`` (SiLU between), ``hint_out``
    last, ``zero_{i}`` → ``zero_convs.{i}.0`` and the last one →
    ``middle_block_out.0``."""
    sd: dict = {}
    _ldm_down_and_mid(sd, pre, tree, tuple(cfg.channel_mult), int(cfg.num_res_blocks))
    hints = _numbered(tree, "hint_")
    for i, h in enumerate(hints):
        _ldm_conv(sd, f"{pre}input_hint_block.{2 * i}", h)
    _ldm_conv(sd, f"{pre}input_hint_block.{2 * len(hints)}", tree["hint_out"])
    zeros = _numbered(tree, "zero_")
    for i, z in enumerate(zeros[:-1]):
        _ldm_conv(sd, f"{pre}zero_convs.{i}.0", z)
    _ldm_conv(sd, f"{pre}middle_block_out.0", zeros[-1])
    return sd


# --- the editing systems: the discriminator and the GAN renderer -------------


def discriminator_params(tree, device="cuda") -> dict:
    """The JAX PatchGAN tree ``{"layers": [{w HWIO, b}, …], "head"}`` →
    the port's (``utils/gan.py``: OIHW) as float32 tensors on ``device``."""
    def conv(p):
        return {"w": _f32(np.asarray(p["w"]).transpose(3, 2, 0, 1), device), "b": _f32(p["b"], device)}

    return {"layers": [conv(p) for p in tree["layers"]], "head": conv(tree["head"])}


def _flax_conv(sd, key, p):
    sd[f"{key}.weight"] = _np32(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{key}.bias"] = _np32(p["bias"])


def _flax_norm(sd, key, p):
    sd[f"{key}.weight"], sd[f"{key}.bias"] = _np32(p["scale"]), _np32(p["bias"])


def _gan_res_block(sd, key, p):
    """A flax ``_ResBlock``: ``GroupNorm_0`` → ``norm1``, ``film_s`` /
    ``film_b``, ``Conv_0`` → ``conv1``, ``GroupNorm_1`` → ``norm2``,
    ``Conv_1`` → ``conv2``, ``Conv_2`` → ``skip``."""
    _flax_norm(sd, f"{key}.norm1", p["GroupNorm_0"])
    _flax_norm(sd, f"{key}.norm2", p["GroupNorm_1"])
    for flax_name, name in (("Conv_0", "conv1"), ("Conv_1", "conv2"), ("Conv_2", "skip")):
        if flax_name in p:
            _flax_conv(sd, f"{key}.{name}", p[flax_name])
    for name in ("film_s", "film_b"):
        if name in p:
            _ldm_dense(sd, f"{key}.{name}", p[name])
    if len(p) != 4 + ("Conv_2" in p) + 2 * ("film_s" in p):
        raise ValueError(f"{key}: unexpected entries {sorted(p)}")


def gan_renderer_params(tree) -> dict:
    """A JAX ``GANVolumeRenderer.init_params`` tree → the port renderer's
    state dict (float32 numpy).  The flax names are numbered in creation
    order: the generator's ``Conv_0`` is its input convolution, ``Conv_1``…
    the convolutions after each upsample, the last its output; the local
    encoder's ``Conv_0`` its input, ``Conv_1``… the stride-2 convolutions,
    the last its output."""
    sd: dict = {}
    g = tree["generator"]
    convs, blocks = _numbered(g, "Conv_"), _numbered(g, "_ResBlock_")
    _flax_conv(sd, "generator.conv_in", convs[0])
    for i, c in enumerate(convs[1:-1]):
        _flax_conv(sd, f"generator.ups.{i}", c)
    _flax_conv(sd, "generator.conv_out", convs[-1])
    for i, b in enumerate(blocks):
        _gan_res_block(sd, f"generator.blocks.{i}", b)
    _flax_norm(sd, "generator.norm_out", g["GroupNorm_0"])
    e = tree["local_encoder"]
    convs, blocks = _numbered(e, "Conv_"), _numbered(e, "_ResBlock_")
    _flax_conv(sd, "local_encoder.conv_in", convs[0])
    for i, c in enumerate(convs[1:-1]):
        _flax_conv(sd, f"local_encoder.downs.{i}", c)
    _flax_conv(sd, "local_encoder.conv_out", convs[-1])
    for i, b in enumerate(blocks):
        _gan_res_block(sd, f"local_encoder.blocks.{i}", b)
    ge = tree["global_encoder"]
    for i, c in enumerate(_numbered(ge, "Conv_")):
        _flax_conv(sd, f"global_encoder.convs.{i}", c)
    _ldm_dense(sd, "global_encoder.dense", ge["Dense_0"])
    return sd


# --- VSD: the LoRA of the phi UNet ------------------------------------------


def _ldm_transformer_names(channel_mult, num_res_blocks, attention_resolutions=(4, 2, 1)) -> dict:
    """The JAX UNet's spatial transformers (``down_{level}_{i}_attn``,
    ``mid_attn``, ``up_{level}_{i}_attn``) → their LDM module names, in the
    order of ``_ldm_unet``'s walk (the port's ``named_modules`` order)."""
    names, idx, ds = {}, 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            if ds in attention_resolutions:
                names[f"down_{level}_{i}_attn"] = f"input_blocks.{idx}.1"
            idx += 1
        if level != len(channel_mult) - 1:
            idx += 1
            ds *= 2
    names["mid_attn"] = "middle_block.1"
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            if ds in attention_resolutions:
                names[f"up_{level}_{i}_attn"] = f"output_blocks.{idx}.1"
            idx += 1
        if level != 0:
            ds //= 2
    return names


def vsd_lora_params(jax_lora, cfg) -> dict:
    """The JAX VSD LoRA tree (``VSDGuidance.init_lora_params``, as numpy:
    ``{"<transformer>/block_<j>/<attn>/<proj>": {"A", "B"}, "camera_proj":
    {"w", "b"}}``) → the port's, keyed by the UNet's module names (``to_out``
    is ``to_out.0``, as in ``_ldm_spatial_transformer``), in the order of the
    port's ``VSDGuidance.lora_targets`` with ``camera_proj`` last; float32
    numpy.  ``cfg``: the port's ``VSDConfig`` (or any object with the UNet's
    ``channel_mult`` and ``num_res_blocks``, e.g. a ``Zero123UnifiedConfig``
    for that guidance's LoRA, whose UNet has the same layout).  Also maps
    trees of the same structure (Adam's ``mu`` / ``nu``)."""
    ldm = _ldm_transformer_names(tuple(cfg.channel_mult), int(cfg.num_res_blocks))
    out = {}
    for jname, prefix in ldm.items():
        j = 0
        while f"{jname}/block_{j}/attn1/to_q" in jax_lora:
            for attn in ("attn1", "attn2"):
                for proj in ("to_q", "to_k", "to_v", "to_out"):
                    ab = jax_lora[f"{jname}/block_{j}/{attn}/{proj}"]
                    name = f"{prefix}.transformer_blocks.{j}.{attn}.{'to_out.0' if proj == 'to_out' else proj}"
                    out[name] = {"A": _np32(ab["A"]), "B": _np32(ab["B"])}
            j += 1
    out["camera_proj"] = {k: _np32(v) for k, v in jax_lora["camera_proj"].items()}
    if len(out) != len(jax_lora):
        raise ValueError(f"LoRA entries not mapped: {sorted(set(jax_lora) - {'camera_proj'})[:4]}…")
    return out


def component_params(tree, device="cuda"):
    """A material's or background's JAX parameter tree (dicts and lists of
    numpy arrays; MLP layers ``{"w" (in, out), "b"}`` in the port's layout)
    → the same tree of float32 tensors on ``device`` that require grad."""
    if isinstance(tree, dict):
        return {k: component_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [component_params(v, device) for v in tree]
    return torch.tensor(_np32(tree), device=device).requires_grad_(True)


def vsd_checkpoint(src, cfg, lr: float = 0.01, betas=(0.9, 0.99), eps: float = 1e-8) -> dict:
    """A JAX ``ZooVSDExperiment``'s state (its ``VSDTrainState`` as numpy,
    or a dict with ``geo_params``, ``lora_params``, ``step`` and optionally
    ``opt_state`` / ``lora_opt_state``, optax Adam states) as the dict the
    port's ``ZooVSDExperiment.load_state`` takes, on the CPU: the scene as
    :func:`zero123_checkpoint`, the LoRA through :func:`vsd_lora_params`
    with its Adam's moments and count."""
    out = zero123_checkpoint({"geo_params": _get(src, "geo_params"), "step": _get(src, "step"),
                              "opt_state": _opt_state(src)}, lr=lr, betas=betas, eps=eps)

    def torch_tree(tree):
        return {k: {n: torch.tensor(v) for n, v in leaves.items()}
                for k, leaves in vsd_lora_params(tree, cfg).items()}

    lora = torch_tree(_get(src, "lora_params"))
    opt = torch.optim.Adam(tree_leaves(lora), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    lora_opt = src.get("lora_opt_state") if isinstance(src, dict) else getattr(src, "lora_opt_state", None)
    if lora_opt is not None:
        adam = lora_opt if isinstance(lora_opt, dict) or hasattr(lora_opt, "mu") else lora_opt[0]
        mu, nu = tree_leaves(torch_tree(_get(adam, "mu"))), tree_leaves(torch_tree(_get(adam, "nu")))
        for p, m, v in zip(tree_leaves(lora), mu, nu):
            _set_adam(opt, p, _get(adam, "count"), m, v)
    out.update(lora_params=lora, lora_opt_state={"state": opt.state_dict()["state"]})
    return out
