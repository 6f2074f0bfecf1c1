"""The port's ``stable-diffusion-unified-guidance`` with ``guidance_type:
vsd`` against the JAX package's (CPU; the weights, draws and helpers of
``test_torch_unified_guidance.py``).

The dispatch reaches ``VSDGuidance.vsd_loss`` in both packages (it reads
``guidance_scale_lora``, never ``vsd_guidance_scale_phi``), with a rank-8
LoRA whose every B is drawn, carried by ``convert.vsd_lora_params``, and
one of three views' text condition dropped: ``loss_vsd`` and ``loss_lora``
within 1e-4 relative, d loss_vsd/d rgb and every LoRA leaf's d loss_lora
within 1e-3 of its max.  The JAX loss runs under one ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unified_guidance import (STEP, TINY, Draws, _close, _nhwc, _one_torch_thread,  # noqa: F401
                                         _port_view, _prompts, inner_jit_unet, jit_run, prompt_arrays,
                                         sd_setup)

from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.models.guidance import unified as ju
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd
from dreammesh4d_tpu_torch.models.guidance import unified as pu


@pytest.fixture(scope="module")
def jax_vsd(sd_setup, prompt_arrays):
    """The JAX ``vsd`` dispatch: both losses, d/d rgb and d/d LoRA (one jit)."""
    jparams, _, jlora, _, d = sd_setup
    prompts = _prompts(jsd, prompt_arrays, jnp.asarray)
    vsd = inner_jit_unet(ju.SDUnifiedGuidance(ju.SDUnifiedConfig(**TINY, guidance_type="vsd")))
    with pytest.MonkeyPatch.context() as mp:
        Draws([d["u"], d["u2"]], [_nhwc(d["noise"]), _nhwc(d["noise2"])], d["drop"]).patch(mp)

        def both(rgb, lora):
            o = vsd.loss(jparams, prompts, jax.random.PRNGKey(0), rgb, d["el"], d["az"], d["dist"], STEP,
                         camera_condition=d["cam"], lora=lora)
            return o["loss_vsd"] + o["loss_lora"], o

        (_, o), (g_rgb, g_lora) = jit_run(jax.value_and_grad(both, argnums=(0, 1), has_aux=True), d["rgb3"], jlora)
    return {n: float(v) for n, v in o.items()}, np.asarray(g_rgb), jax.tree.map(np.asarray, g_lora)


def test_sd_unified_vsd_matches_jax(sd_setup, jax_vsd, prompt_arrays):
    _, guidance, _, lora_np, d = sd_setup
    g = pu.SDUnifiedGuidance(dict(TINY, guidance_type="vsd"), modules=guidance.modules)
    assert isinstance(guidance, pu.SDUnifiedGuidance) and guidance.modules.device.type == "cpu"
    prompts = _prompts(psd, prompt_arrays, torch.as_tensor)
    lora = {k: {n: torch.tensor(v, requires_grad=True) for n, v in leaves.items()} for k, leaves in lora_np.items()}
    assert list(lora) == [n for n, _, _ in g.lora_targets()] + ["camera_proj"]
    rgb = torch.as_tensor(d["rgb3"]).requires_grad_(True)
    draws = {k: torch.as_tensor(d[k]) for k in ("u", "noise", "u2", "noise2", "drop")}
    out = g.loss(prompts, rgb, *_port_view(d), STEP, camera_condition=torch.as_tensor(d["cam"]), lora=lora,
                 **draws)
    (out["loss_vsd"] + out["loss_lora"]).backward()
    jout, jg_rgb, jg_lora = jax_vsd
    for k in ("loss_vsd", "loss_lora"):
        got, want = float(out[k].detach()), jout[k]
        print(f"{k}: {got!r} vs JAX {want!r}")
        assert want > 0 and abs(got - want) <= 1e-4 * abs(want), (k, got, want)
    _close(rgb.grad.numpy(), jg_rgb, 1e-3, "d loss_vsd / d rgb")
    jg = convert.vsd_lora_params(jg_lora, g.cfg)
    for name, leaves in lora.items():
        for k, v in leaves.items():
            _close(v.grad.numpy(), jg[name][k], 1e-3, f"d loss_lora / d {name}.{k}")
