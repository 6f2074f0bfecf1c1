"""The port's ``zero123-unified-guidance`` (``models/guidance/unified.py``)
with ``guidance_type: vsd`` against the JAX package's (CPU; the weights,
draws and helpers of ``test_torch_unified_guidance.py``).  The LoRA has the
JAX ``init_lora_params`` tree's layout with every B drawn, carried by
``convert.vsd_lora_params``.

``vsd_guidance_scale_phi`` 1.5 with ``vsd_use_camera_condition`` (the phi
CFG against a zero camera) and ``vsd_lora_cfg_training`` (one view's
camera dropped, one kept), and in ``test_torch_unified_zero123_nocam.py``
without the camera token: ``loss_vsd`` and ``loss_lora`` within 1e-4
relative, d loss_vsd/d rgb and every LoRA leaf's d loss_lora within 1e-3 of
its max (without the camera token ``camera_proj`` gets no gradient, nor do
the cross-attention's query and key over the one context token: zero on
both sides).

Each JAX loss runs under one ``jax.jit``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_unified_guidance import (STEP, TINY123, Draws, _close, _jbank, _nhwc,  # noqa: F401
                                         _one_torch_thread, _z_args, inner_jit_unet, jit_run, z_setup)

from dreammesh4d_tpu.models.guidance import unified as ju
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.guidance import unified as pu


PHI_CASES = {"camera": dict(vsd_use_camera_condition=True, vsd_lora_cfg_training=True),
             "no_camera": dict(vsd_use_camera_condition=False)}


def jax_vsd_case(z_setup, case):
    """The JAX ``vsd`` of PHI_CASES[case]: both losses, d/d rgb and d/d LoRA (one jit)."""
    _, jparams, bank, jlora, _, d = z_setup
    gj = ju.Zero123UnifiedGuidance(ju.Zero123UnifiedConfig(
        **TINY123, guidance_type="vsd", vsd_guidance_scale_phi=1.5, **PHI_CASES[case]))
    inner_jit_unet(gj.modules)
    with pytest.MonkeyPatch.context() as mp:
        Draws([d["u"], d["u2"]], [_nhwc(d["noise"]), _nhwc(d["noise2"])], d["drop"]).patch(mp)

        def both(x, lo):
            o = gj.loss(jparams, _jbank(bank), jax.random.PRNGKey(0), x, d["el"], d["az"], d["dist"], STEP,
                        frame_indices=d["frames"], camera_condition=d["cam"], lora=lo)
            return o["loss_vsd"] + o["loss_lora"], o

        (_, o), (g_rgb, g_lora) = jit_run(jax.value_and_grad(both, argnums=(0, 1), has_aux=True), d["rgb"], jlora)
    return {n: float(v) for n, v in o.items()}, np.asarray(g_rgb), jax.tree.map(np.asarray, g_lora)


def check_vsd_case(z_setup, case):
    """The port's ``vsd`` of PHI_CASES[case] against the JAX package's."""
    guidance, _, _, _, lora_np, d = z_setup
    bank, view, frames = _z_args(z_setup)
    g = pu.Zero123UnifiedGuidance(dict(TINY123, guidance_type="vsd", vsd_guidance_scale_phi=1.5,
                                       **PHI_CASES[case]), modules=guidance.modules)
    lora = {k: {n: torch.tensor(v, requires_grad=True) for n, v in leaves.items()} for k, leaves in lora_np.items()}
    assert list(lora) == [n for n, _, _ in g.lora_targets()] + ["camera_proj"]
    assert lora["camera_proj"]["w"].shape == (16, 32)
    rgb = torch.as_tensor(d["rgb"]).requires_grad_(True)
    draws = {k: torch.as_tensor(d[k]) for k in ("u", "noise", "u2", "noise2", "drop")}
    out = g.loss(bank, rgb, *view, STEP, frame_indices=frames, camera_condition=torch.as_tensor(d["cam"]),
                 lora=lora, **draws)
    out["loss_vsd"].backward(retain_graph=True)
    assert all(v.grad is None for leaves in lora.values() for v in leaves.values())  # LoRA detached in loss_vsd
    out["loss_lora"].backward()
    jout, jg_rgb, jg_lora = jax_vsd_case(z_setup, case)
    for k in ("loss_vsd", "loss_lora"):
        got, want = float(out[k].detach()), jout[k]
        print(f"{k}: {got!r} vs JAX {want!r}")
        assert want > 0 and abs(got - want) <= 1e-4 * abs(want), (k, got, want)
    _close(rgb.grad.numpy(), jg_rgb, 1e-3, "d loss_vsd / d rgb")
    jg = convert.vsd_lora_params(jg_lora, g.cfg)
    top = max(np.abs(v).max() for leaves in jg.values() for v in leaves.values())
    for name, leaves in lora.items():
        for k, v in leaves.items():
            if not g.cfg.vsd_use_camera_condition and name == "camera_proj":
                assert v.grad is None and not np.abs(jg[name][k]).any()  # no camera token
            elif not np.abs(jg[name][k]).any():
                # a cross-attention over one context token: its query and key do not reach the output
                assert name.endswith(("attn2.to_q", "attn2.to_k")) and not g.cfg.vsd_use_camera_condition, name
                assert np.abs(v.grad.numpy()).max() <= 1e-6 * top, name
            else:
                _close(v.grad.numpy(), jg[name][k], 1e-3, f"d loss_lora / d {name}.{k}")


def test_zero123_unified_vsd_with_camera_matches_jax(z_setup):
    check_vsd_case(z_setup, "camera")
