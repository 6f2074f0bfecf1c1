"""The port's registry against the JAX package's (CPU): the port counterpart
of ``tests/test_registry_parity.py``.

- Every name the port registers (after ``_import_builtin_modules``) is one
  the JAX package registers (``dreammesh4d_tpu`` with its
  ``models/registry_names.py``): the port adds no component name of its own.
- Each port name resolves to a class, never a module, and the names the
  port's stages and the zoo build from their YAML resolve to the classes
  that build them; ``"a:b"`` composes.
- Every ``system_type`` of the port's launcher table is registered by the
  JAX package; the names not ported yet raise ``KeyError`` through ``find``.
"""

import types

import pytest

import dreammesh4d_tpu as ds
from dreammesh4d_tpu_torch import registry
from dreammesh4d_tpu_torch.systems import assembly

EXPECTED = {  # name: (module, class) in the port
    "zero123-system": ("systems.assembly", "Zero123Experiment"),
    "sugar-static-system": ("systems.assembly", "SugarStaticExperiment"),
    "sugar-4dgen-system": ("systems.assembly", "Sugar4DGenExperiment"),
    "dreamfusion-system": ("systems.assembly_zoo", "ZooTextExperiment"),
    "magic3d-system": ("systems.assembly_zoo", "ZooTextExperiment"),
    "efficient-dreamfusion-system": ("systems.assembly_zoo", "ZooTextExperiment"),
    "magic123-system": ("systems.assembly_zoo", "ZooImageExperiment"),
    "image-condition-dreamfusion-system": ("systems.assembly_zoo", "ZooImageExperiment"),
    "latentnerf-system": ("systems.assembly_zoo", "ZooTextExperiment"),
    "sjc-system": ("systems.assembly_zoo", "ZooTextExperiment"),
    "prolificdreamer-system": ("systems.assembly_zoo", "ZooVSDExperiment"),
    "stable-diffusion-vsd-guidance": ("models.guidance.vsd", "VSDGuidance"),
    "single-image-datamodule": ("data.image", "SingleImageDataModule"),
    "temporal-image-datamodule": ("data.temporal_image", "TemporalImageDataModule"),
    "random-camera-datamodule": ("data.uncond", "RandomCameraSampler"),
    "stable-zero123-guidance": ("models.guidance.zero123.guidance", "StableZero123GuidanceComponent"),
    "temporal-stable-zero123-guidance": ("models.guidance.zero123.guidance", "TemporalStableZero123Guidance"),
    "zero123-guidance": ("models.guidance.zero123.guidance", "Zero123Guidance"),
    "stable-diffusion-guidance": ("models.guidance.stable_diffusion", "StableDiffusionGuidance"),
    "stable-diffusion-prompt-processor": ("models.guidance.stable_diffusion", "StableDiffusionPromptProcessor"),
    "dummy-prompt-processor": ("models.prompt_processors", "DummyPromptProcessor"),
}


@pytest.fixture(scope="module")
def names():
    registry._import_builtin_modules()
    ds._import_builtin_modules()
    return sorted(registry.__modules__), set(ds.__modules__)


def test_port_names_are_jax_names(names):
    port, jax_names = names
    assert set(EXPECTED) <= set(port)
    assert sorted(set(port) - jax_names) == []


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_name_resolves_to_its_class(name):
    import importlib

    module, cls = EXPECTED[name]
    obj = registry.find(name)
    assert not isinstance(obj, types.ModuleType) and isinstance(obj, type)
    assert obj is getattr(importlib.import_module(f"dreammesh4d_tpu_torch.{module}"), cls)


def test_launcher_systems_and_unported_names(names):
    _, jax_names = names
    from dreammesh4d_tpu_torch.systems import assembly_zoo  # noqa: F401  (fills the launcher's table)

    assert set(assembly.EXPERIMENTS) <= jax_names
    assert {"dreamfusion-system", "magic123-system", "latentnerf-system", "sjc-system",
            "prolificdreamer-system"} <= set(assembly.EXPERIMENTS)
    mixed = registry.find("dreamfusion-system:random-camera-datamodule")
    assert issubclass(mixed, registry.find("dreamfusion-system"))
    for name in ("textmesh-system", "fantasia3d-system", "stable-diffusion-unified-guidance"):
        assert name in jax_names
        with pytest.raises(KeyError):
            registry.find(name)
