"""Component registry (counterpart of ``dreammesh4d_tpu/__init__.py:15-48``):
components register under a string name, ``find`` resolves a name to a class
or a factory, and ``"main:sub1,sub2"`` composes classes dynamically.

The port registers:
- the systems: ``zero123-system``, ``sugar-static-system``,
  ``sugar-4dgen-system`` and the zoo's ``dreamfusion-system``,
  ``magic3d-system``, ``efficient-dreamfusion-system``, ``magic123-system``,
  ``image-condition-dreamfusion-system``, ``latentnerf-system``,
  ``sjc-system`` and ``prolificdreamer-system``, and ``fantasia3d-system``,
  ``textmesh-system`` and ``zero123-simple-system``, and the editing
  systems ``instructnerf2nerf-system``, ``control4d-system`` and
  ``control4d-multiview-system`` (classes that hold their config, as the
  JAX package's);
- the data modules ``single-image-datamodule``,
  ``temporal-image-datamodule`` and ``random-camera-datamodule``;
- the guidance and prompts: ``stable-zero123-guidance``,
  ``temporal-stable-zero123-guidance``, ``zero123-guidance``,
  ``stable-diffusion-guidance``, ``stable-diffusion-vsd-guidance``,
  ``stable-diffusion-unified-guidance``, ``zero123-unified-guidance``,
  ``stable-diffusion-controlnet-guidance``,
  ``stable-diffusion-instructpix2pix-guidance``, ``deep-floyd-guidance``,
  ``stable-diffusion-prompt-processor`` (also
  ``deep-floyd-prompt-processor``) and ``dummy-prompt-processor``;
- the materials ``no-material``, ``diffuse-with-point-light-material``,
  ``pbr-material``, ``neural-radiance-material``,
  ``hybrid-rgb-latent-material`` and ``sd-latent-adapter-material``, and
  the backgrounds ``neural-environment-map-background`` (also
  ``gaussian-mvdream-neural-environment-map-background``),
  ``solid-color-background`` and ``textured-background``;
- the renderers ``nvdiff-rasterizer``, ``patch-renderer`` and
  ``gan-volume-renderer``;
- the factories of ``models/registry_names.py``, where ``find(name)(cfg)``
  returns a constructed component: ``sugar``, ``dynamic-sugar``,
  ``gaussian-splatting``, ``implicit-volume``, ``implicit-sdf``,
  ``custom-mesh``, ``tetrahedra-sdf-grid``, ``volume-grid``,
  ``diff-sugar-rasterizer-{normal,temporal,shading}``,
  ``nerf-volume-renderer``, ``neus-volume-renderer``, ``mesh-exporter``,
  ``gaussian-mesh-exporter``,
  ``gaussian-splatting-io``, ``perceptual-loss`` and ``dummy-exporter``.

``find`` imports the modules that register them on first use, so importing
the package stays light.  A JAX name whose module is still queued
(:data:`QUEUED`) raises ``KeyError`` naming its ROADMAP item.
"""

from __future__ import annotations

__modules__: dict = {}

# the JAX package's names whose modules the port has not got yet: name -> the ROADMAP item
QUEUED = dict.fromkeys(("co3d-datamodule", "multiview-camera-datamodule"), "ROADMAP A8.7")


def register(name: str):
    """Class decorator registering a component under ``name``; registering
    another class under a taken name raises."""

    def decorator(cls):
        if name in __modules__ and __modules__[name] is not cls:
            raise ValueError(f"Module {name} already registered as {__modules__[name]!r}")
        __modules__[name] = cls
        cls.__registered_name__ = name
        return cls

    return decorator


def find(name: str):
    """The class registered under ``name``; ``"main:sub1,sub2"`` gives a new
    type inheriting from (main, sub1, sub2)."""
    if ":" in name:
        main_name, mixin_names = name.split(":")
        mixins = [m.strip() for m in mixin_names.split(",") if m.strip()]
        bases = [find(main_name)] + [find(m) for m in mixins]
        return type(f"{bases[0].__name__}With{'And'.join(b.__name__ for b in bases[1:])}",
                    tuple(bases), {})
    if name not in __modules__:
        _import_builtin_modules()
    if name not in __modules__:
        if name in QUEUED:
            raise KeyError(f"{name!r} is not ported yet: {QUEUED[name]}")
        raise KeyError(f"No registered module named {name!r}. Known: {sorted(__modules__)}")
    return __modules__[name]


def _import_builtin_modules() -> None:
    # imported for their @register side effects
    from .data import image, temporal_image, uncond  # noqa: F401
    from .models import background, materials, prompt_processors, registry_names  # noqa: F401
    from .models.guidance import controlnet, deep_floyd, instructpix2pix, stable_diffusion, unified  # noqa: F401
    from .models.guidance.zero123 import guidance  # noqa: F401
    from .models.renderers import gan_volume_renderer, mesh_rasterizer  # noqa: F401
    from .systems import assembly, assembly_zoo, editing, threestudio_zoo2  # noqa: F401
