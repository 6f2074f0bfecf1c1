"""Component registry (counterpart of ``dreammesh4d_tpu/__init__.py:15-48``):
components register under a string name, ``find`` resolves a name to a class,
and ``"main:sub1,sub2"`` composes classes dynamically.

The port registers the names its YAML-driven stages resolve:
``zero123-system``, ``sugar-static-system``, ``sugar-4dgen-system``,
``single-image-datamodule``, ``temporal-image-datamodule``,
``random-camera-datamodule``, ``stable-zero123-guidance``,
``temporal-stable-zero123-guidance`` and ``zero123-guidance``, and the
zoo's ``dreamfusion-system``, ``magic3d-system``,
``efficient-dreamfusion-system``, ``magic123-system``,
``image-condition-dreamfusion-system``, ``stable-diffusion-guidance``,
``stable-diffusion-prompt-processor`` and ``dummy-prompt-processor``.
``find`` imports the modules that register them on first use, so importing
the package stays light.
"""

from __future__ import annotations

__modules__: dict = {}


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
        raise KeyError(f"No registered module named {name!r}. Known: {sorted(__modules__)}")
    return __modules__[name]


def _import_builtin_modules() -> None:
    # imported for their @register side effects
    from .data import image, temporal_image, uncond  # noqa: F401
    from .models import prompt_processors  # noqa: F401
    from .models.guidance import stable_diffusion  # noqa: F401
    from .models.guidance.zero123 import guidance  # noqa: F401
    from .systems import assembly, assembly_zoo  # noqa: F401
