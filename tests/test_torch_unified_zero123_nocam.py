"""The port's ``zero123-unified-guidance`` with ``guidance_type: vsd``,
``vsd_guidance_scale_phi`` 1.5 and ``vsd_use_camera_condition: false``
against the JAX package's (CPU; the setup and bands of
``test_torch_unified_zero123.py``): phi takes no camera token, so
``camera_proj`` gets no gradient, nor do the cross-attention's query and
key over the one context token (zero on both sides); ``loss_vsd`` and
``loss_lora`` within 1e-4 relative, d loss_vsd/d rgb and every other LoRA
leaf's d loss_lora within 1e-3 of its max.  The JAX loss runs under one
``jax.jit``.
"""

from test_torch_unified_zero123 import _one_torch_thread, check_vsd_case, z_setup  # noqa: F401


def test_zero123_unified_vsd_without_camera_matches_jax(z_setup):  # noqa: F811
    check_vsd_case(z_setup, "no_camera")
