"""The port's VSD guidance (``models/guidance/vsd.py``) against the JAX
package's (CPU, tiny widths).

The SD weights are those of ``test_torch_zoo_sd.py`` (every leaf drawn, so
the UNet's output is not zero), carried by ``convert.sd_guidance_params``.
The LoRA is the JAX ``init_lora_params`` tree with every B replaced by
seeded draws (so that phi differs from the pretrained UNet and every A
gets a gradient), carried by ``convert.vsd_lora_params``.  Both packages
take the same draws (t's u, ε, the LoRA term's u2 and ε2, and the
condition drop: one view dropped, one kept).  With ``guidance_scale_lora``
1.0 and 2.0 (phi with and without its own CFG), bands those of the zoo's
step tests: ``loss_vsd``, ``loss_lora`` and ``grad_norm`` within 1e-4
relative; d loss_vsd/d rgb and d loss_lora/d LoRA (every leaf) within 1e-3
of each one's max |g|.  The port's ``loss_vsd`` gives the LoRA no
gradient and its ``loss_lora`` gives the render none.  The JAX function
runs under one ``jax.jit`` (its UNet applies under an inner one,
compiled with XLA's cheaper passes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo_sd import (ARCH, SCHED, FAST_COMPILE, _close, _one_torch_thread, _seeded_tree,  # noqa: F401
                               shared_unet)

from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.models.guidance import vsd as jvsd
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd
from dreammesh4d_tpu_torch.models.guidance import vsd as pvsd
from dreammesh4d_tpu_torch.registry import find
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

B, L, SEQ, STEP = 2, 8, 6, 120


@pytest.fixture(scope="module")
def setup():
    """(JAX params, JAX LoRA, port modules, port LoRA as numpy, draws)."""
    jcfg = jvsd.VSDConfig(**ARCH, **SCHED)
    jguid = jvsd.VSDGuidance(jcfg)
    jparams = _seeded_tree(jax.eval_shape(jguid.init_params, jax.random.PRNGKey(0)), 0)
    rng = np.random.default_rng(4)
    jlora = jax.tree.map(np.asarray, jguid.init_lora_params(jax.random.PRNGKey(1), jparams["unet"]))
    for k, v in jlora.items():
        if "B" in v:
            v["B"] = (0.3 * rng.normal(size=v["B"].shape)).astype(np.float32)
    pcfg = pvsd.VSDConfig(**ARCH, **SCHED)
    modules = psd.StableDiffusionModules(pcfg, device="cpu")
    modules.load_state_dict({k: torch.as_tensor(v) for k, v in convert.sd_guidance_params(jparams, pcfg).items()})
    lora = convert.vsd_lora_params(jlora, pcfg)
    d = {"rgb": rng.random((B, 12, 12, 3), dtype=np.float32), "el": np.float32([10.0, 70.0]),
         "az": np.float32([30.0, -170.0]), "cam": rng.normal(size=(B, 16)).astype(np.float32),
         "u": np.float32([0.3, 0.9]), "u2": np.float32([0.55, 0.12]),
         "noise": rng.normal(size=(B, 4, L, L)).astype(np.float32),
         "noise2": rng.normal(size=(B, 4, L, L)).astype(np.float32), "drop": np.array([True, False]),
         "cond": (0.5 * rng.normal(size=(5, SEQ, ARCH["context_dim"]))).astype(np.float32),
         "uncond": (0.5 * rng.normal(size=(SEQ, ARCH["context_dim"]))).astype(np.float32)}
    return jparams, jlora, modules, lora, d


def test_lora_targets_and_init(setup):
    _, jlora, modules, lora, _ = setup
    assert find("stable-diffusion-vsd-guidance") is pvsd.VSDGuidance
    guidance = pvsd.VSDGuidance(pvsd.VSDConfig(**ARCH, **SCHED), modules=modules, device="cpu")
    fresh = guidance.init_lora_params(torch.Generator().manual_seed(1))
    assert list(fresh) == list(lora) and len(lora) == len(jlora)  # every attention projection + the camera
    for name, leaves in fresh.items():
        for k, v in leaves.items():
            assert v.shape == lora[name][k].shape and v.requires_grad, (name, k)
            if k in ("B", "b"):
                assert not v.any()
    r = guidance.cfg.lora_rank
    a = torch.cat([leaves["A"].detach().flatten() for n, leaves in fresh.items() if n != "camera_proj"])
    assert abs(float(a.std()) - r ** -0.5) < 0.02  # N(0, 1/r)


def _jax_outputs(setup, scale_lora):
    jparams, jlora, _, _, d = setup
    g = jvsd.VSDGuidance(jvsd.VSDConfig(**ARCH, **SCHED, guidance_scale_lora=scale_lora))
    shared_unet([g])
    prompts = jsd.PromptEmbeddings(jnp.asarray(d["cond"]), jnp.asarray(d["uncond"]),
                                   jsd.PromptProcessorConfig(context_dim=ARCH["context_dim"], seq_len=SEQ))
    uniforms = [d["u"], d["u2"]]
    normals = [d["noise"].transpose(0, 2, 3, 1), d["noise2"].transpose(0, 2, 3, 1)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(uniforms.pop(0)))
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(normals.pop(0)))
        mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(d["drop"]).reshape(shape))

        def both(rgb, lora):
            o = g.vsd_loss(jparams, lora, prompts, jax.random.PRNGKey(0), rgb, d["el"], d["az"], d["cam"], STEP)
            return o["loss_vsd"] + o["loss_lora"], o

        fn = jax.value_and_grad(both, argnums=(0, 1), has_aux=True)
        (_, out), (g_rgb, g_lora) = jax.jit(fn).lower(d["rgb"], jlora).compile(FAST_COMPILE)(d["rgb"], jlora)
    return {k: float(v) for k, v in out.items()}, np.asarray(g_rgb), jax.tree.map(np.asarray, g_lora)


@pytest.mark.parametrize("scale_lora", [1.0, 2.0])
def test_vsd_loss_matches_jax(setup, scale_lora):
    _, _, modules, lora_np, d = setup
    jout, jg_rgb, jg_lora = _jax_outputs(setup, scale_lora)
    cfg = pvsd.VSDConfig(**ARCH, **SCHED, guidance_scale_lora=scale_lora)
    guidance = pvsd.VSDGuidance(cfg, modules=modules, device="cpu")
    prompts = psd.PromptEmbeddings(torch.as_tensor(d["cond"]), torch.as_tensor(d["uncond"]),
                                   psd.PromptProcessorConfig(context_dim=ARCH["context_dim"], seq_len=SEQ))
    lora = {k: {n: torch.tensor(v, requires_grad=True) for n, v in leaves.items()} for k, leaves in lora_np.items()}
    rgb = torch.tensor(d["rgb"], requires_grad=True)
    draws = {k: torch.as_tensor(d[k]) for k in ("u", "noise", "u2", "noise2", "drop")}
    out = guidance.vsd_loss(lora, prompts, rgb, torch.as_tensor(d["el"]), torch.as_tensor(d["az"]),
                            torch.as_tensor(d["cam"]), STEP, **draws)
    out["loss_vsd"].backward(retain_graph=True)
    assert all(v.grad is None for v in tree_leaves(lora))  # the LoRA is detached in loss_vsd
    g_rgb = rgb.grad.clone()
    out["loss_lora"].backward()
    assert torch.equal(rgb.grad, g_rgb)  # and the render in loss_lora
    for k in ("loss_vsd", "loss_lora", "grad_norm"):
        got, want = float(out[k].detach()), jout[k]
        print(f"{k}: {got!r} vs JAX {want!r}")
        assert want > 0 and abs(got - want) <= max(1e-4 * abs(want), 1e-6), (k, got, want)
    _close(g_rgb.numpy(), jg_rgb, 1e-3, "d loss_vsd / d rgb")
    jg = convert.vsd_lora_params(jg_lora, cfg)
    for name, leaves in lora.items():
        for k, v in leaves.items():
            _close(v.grad.numpy(), jg[name][k], 1e-3, f"d loss_lora / d {name}.{k}")
