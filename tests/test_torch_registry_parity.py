"""The port's registry against the JAX package's (CPU): the port counterpart
of ``tests/test_registry_parity.py``.

- Every name the port registers (after ``_import_builtin_modules``) is one
  the JAX package registers (``dreammesh4d_tpu`` with its
  ``models/registry_names.py``): the port adds no component name of its own.
- Every name the JAX package registers is in the port or in ``QUEUED``, the
  names still to port, each with its ROADMAP item (also the port's
  ``registry.QUEUED``, whose ``KeyError`` names it): a name missing from
  both fails.
- Each port name resolves to a class (a factory for the names of
  ``models/registry_names.py``), never a module, and the names the
  port's stages and the zoo build from their YAML resolve to the classes
  that build them; ``"a:b"`` composes.
- Every ``system_type`` of the port's launcher table is registered by the
  JAX package; the names not ported yet raise ``KeyError`` through ``find``.
"""

import types

import pytest
import torch

import dreammesh4d_tpu as ds
from dreammesh4d_tpu_torch import registry
from dreammesh4d_tpu_torch.systems import assembly

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    "stable-diffusion-unified-guidance": ("models.guidance.unified", "SDUnifiedGuidance"),
    "zero123-unified-guidance": ("models.guidance.unified", "Zero123UnifiedGuidance"),
    "pbr-material": ("models.materials", "PBRMaterial"),
    "neural-radiance-material": ("models.materials", "NeuralRadianceMaterial"),
    "hybrid-rgb-latent-material": ("models.materials", "HybridRGBLatentMaterial"),
    "sd-latent-adapter-material": ("models.materials", "SDLatentAdapterMaterial"),
    "neural-environment-map-background": ("models.background", "NeuralEnvironmentMapBackground"),
    "gaussian-mvdream-neural-environment-map-background": ("models.background", "NeuralEnvironmentMapBackground"),
    "solid-color-background": ("models.background", "SolidColorBackground"),
    "textured-background": ("models.background", "TexturedBackground"),
    "implicit-sdf": ("models.registry_names", "make_implicit_sdf"),
    "custom-mesh": ("models.registry_names", "make_custom_mesh"),
    "tetrahedra-sdf-grid": ("models.registry_names", "make_tet_sdf_grid"),
    "volume-grid": ("models.registry_names", "make_volume_grid"),
    "neus-volume-renderer": ("models.registry_names", "make_neus_volume_renderer"),
    "nvdiff-rasterizer": ("models.renderers.mesh_rasterizer", "MeshRasterizer"),
    "patch-renderer": ("models.renderers.mesh_rasterizer", "PatchRenderer"),
    "fantasia3d-system": ("systems.threestudio_zoo2", "ConfigSystem"),
    "textmesh-system": ("systems.threestudio_zoo2", "ConfigSystem"),
    "zero123-simple-system": ("systems.threestudio_zoo2", "ConfigSystem"),
    "stable-diffusion-controlnet-guidance": ("models.guidance.controlnet", "ControlNetGuidance"),
    "stable-diffusion-instructpix2pix-guidance": ("models.guidance.instructpix2pix", "InstructPix2PixGuidance"),
    "deep-floyd-guidance": ("models.guidance.deep_floyd", "DeepFloydGuidance"),
    "deep-floyd-prompt-processor": ("models.guidance.stable_diffusion", "StableDiffusionPromptProcessor"),
    "instructnerf2nerf-system": ("systems.editing", "InstructNeRF2NeRFSystem"),
    "control4d-system": ("systems.editing", "Control4DSystem"),
    "control4d-multiview-system": ("systems.editing", "Control4DSystem"),
    "gan-volume-renderer": ("models.renderers.gan_volume_renderer", "GANVolumeRenderer"),
}


QUEUED = {  # JAX names the port has not got yet: the ROADMAP item that brings each
    "co3d-datamodule": "A8.7", "multiview-camera-datamodule": "A8.7",
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


def test_jax_names_are_ported_or_queued(names):
    port, jax_names = names
    assert sorted(jax_names - set(port) - set(QUEUED)) == []  # neither ported nor queued
    assert sorted(set(QUEUED) & set(port)) == []  # ported: take it off the queue
    assert set(QUEUED) <= jax_names
    assert {k: f"ROADMAP {v}" for k, v in QUEUED.items()} == registry.QUEUED
    for name, item in QUEUED.items():
        with pytest.raises(KeyError, match=f"ROADMAP {item}"):
            registry.find(name)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_name_resolves_to_its_class(name):
    import importlib

    module, cls = EXPECTED[name]
    obj = registry.find(name)
    assert not isinstance(obj, types.ModuleType)
    # a class, or a factory of models/registry_names.py, as the JAX package binds them
    assert isinstance(obj, type) or (module == "models.registry_names" and callable(obj))
    assert obj is getattr(importlib.import_module(f"dreammesh4d_tpu_torch.{module}"), cls)


def test_launcher_systems_and_unported_names(names):
    _, jax_names = names
    from dreammesh4d_tpu_torch.systems import assembly_zoo  # noqa: F401  (fills the launcher's table)

    assert set(assembly.EXPERIMENTS) <= jax_names
    assert {"dreamfusion-system", "magic123-system", "latentnerf-system", "sjc-system",
            "prolificdreamer-system"} <= set(assembly.EXPERIMENTS)
    mixed = registry.find("dreamfusion-system:random-camera-datamodule")
    assert issubclass(mixed, registry.find("dreamfusion-system"))
    for name in ("co3d-datamodule", "multiview-camera-datamodule"):
        assert name in jax_names
        with pytest.raises(KeyError):
            registry.find(name)
    # registered, but no launcher target in either package
    for name in ("textmesh-system", "fantasia3d-system", "zero123-simple-system", "instructnerf2nerf-system",
                 "control4d-system", "control4d-multiview-system"):
        assert name in jax_names and name not in assembly.EXPERIMENTS
        assert registry.find(name)({"k": 1}, device="cpu").cfg == {"k": 1}
