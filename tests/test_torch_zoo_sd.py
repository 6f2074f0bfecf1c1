"""The port's Stable Diffusion guidance and its checkpoint loader against
the JAX package (CPU, tiny widths).

The SD weights are seeded numpy draws in the JAX package's parameter tree
(UNet 32 × [1], 1 res block, 4 heads, context 32; VAE 16 × [1]; latents
8², images 8²), carried into the port by ``convert.sd_guidance_params``;
the JAX converter ``convert_sd_state_dict`` takes the port's state dict back
to the same tree exactly.  Bands (float32):

- ``encode_images`` within 1e-4 of its max |value|;
- ``sds_loss`` on the same draws (``jax.random.uniform`` / ``normal``
  monkeypatched to the test's u and ε), a 3-channel render through the VAE,
  with each weighting (``sds``, ``uniform``, ``fantasia3d``):
  the timesteps equal, ``loss_sds`` and ``grad_norm`` within 1e-5
  relative, d loss/d rgb within 1e-3 of its max;
- the SD ``.ckpt`` loader on a tiny synthetic state dict (the port's
  modules' keys, schedule buffers, EMA, a one-layer CLIP text tower with its
  ``position_ids``, a VAE loss head and one stray key): the port's
  ``consumed`` ∪ ``text`` is the JAX converter's ``consumed``, ``skipped``
  and ``unmapped`` equal; the loaded weights are the file's; ``strict``
  refuses the stray key; a directory is refused.

``rgb_as_latents`` and the vanilla ``zero123-guidance`` are held in
``test_torch_zoo_sd_latents.py``.

Each JAX function runs under one ``jax.jit`` (the three weightings' UNet
applies under one shared inner ``jax.jit``, the whole compiled with XLA's
cheaper passes).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import FAST_COMPILE

from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.models.guidance.zero123.convert import convert_sd_state_dict
from dreammesh4d_tpu.utils.schedule import C_jax
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd
from dreammesh4d_tpu_torch.models.guidance.zero123 import checkpoint as pckpt

ARCH = dict(model_channels=32, channel_mult=(1,), num_res_blocks=1, num_heads=4, context_dim=32,
            latent_size=8, image_size=8, vae_ch=16, vae_ch_mult=(1,), vae_num_res_blocks=1)
SCHED = dict(guidance_scale=7.5, min_step_percent=[50, 0.7, 0.3, 200],
             max_step_percent=[50, 0.98, 0.8, 200])
WEIGHTINGS = ("sds", "uniform", "fantasia3d")
B, L, SEQ = 2, 8, 6
STEP = 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shared_unet(guidances):
    """The JAX guidances' ``unet.apply`` (one architecture) through one
    shared ``jax.jit``: each batch shape is traced once for all of them."""
    guidances = list(guidances)
    apply = jax.jit(guidances[0].unet.apply)
    for g in guidances:
        g.unet = types.SimpleNamespace(apply=apply)


def _seeded_tree(shapes, seed):
    """A numpy draw for every leaf of a flax tree of shapes: kernels
    N(0, 1/fan_in), norm scales around 1, biases around 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        if "kernel" in name:
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def sd_pair():
    """(port guidance, JAX guidance, JAX params as numpy, the port's state dict)."""
    jguid = jsd.StableDiffusionGuidance(jsd.StableDiffusionConfig(**ARCH, **SCHED))
    jparams = _seeded_tree(jax.eval_shape(jguid.init_params, jax.random.PRNGKey(0)), 0)
    guidance = psd.StableDiffusionGuidance(psd.StableDiffusionConfig(**ARCH, **SCHED), device="cpu")
    sd = convert.sd_guidance_params(jparams, guidance.cfg)
    guidance.modules.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return guidance, jguid, jparams, sd


def test_sd_params_round_trip_exactly(sd_pair):
    guidance, jguid, jparams, sd = sd_pair
    assert set(sd) == set(guidance.modules.state_dict())
    back, report = convert_sd_state_dict(sd, jguid)
    assert report["unmapped"] == [] and report["skipped"] == [] and set(report["consumed"]) == set(sd)
    flat, jflat = jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    for (p, got), (_, want) in zip(flat, jflat):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(p))


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max() / scale
    print(f"{what}: max |d| / max |ref| = {err:.3g} (band {rel:g})")
    assert err <= rel, (what, err)


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(3)
    cond = (0.5 * rng.normal(size=(5, SEQ, ARCH["context_dim"]))).astype(np.float32)
    uncond = (0.5 * rng.normal(size=(SEQ, ARCH["context_dim"]))).astype(np.float32)
    return {"rgb3": rng.random((B, 12, 12, 3), dtype=np.float32),
            "rgb4": rng.random((B, 12, 12, 4), dtype=np.float32),
            "el": np.float32([10.0, 70.0]), "az": np.float32([30.0, -170.0]),
            "dist": np.float32([2.0, 2.5]), "u": np.float32([0.3, 0.9]),
            "noise": rng.normal(size=(B, 4, L, L)).astype(np.float32), "cond": cond, "uncond": uncond}


def test_encode_images_matches_jax(sd_pair, draws):
    guidance, jguid, jparams, _ = sd_pair
    want = jax.jit(jguid.encode_images)(jparams, draws["rgb3"])
    got = guidance.encode_images(torch.as_tensor(draws["rgb3"]))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4, "encode_images")


def jax_sds_outputs(sd_pair, draws, as_latents: bool) -> dict:
    """The JAX ``sds_loss`` (value and gradient in rgb) of every weighting,
    on the test's draws, in one jit."""
    _, _, jparams, _ = sd_pair
    d = draws
    pcfg = jsd.PromptProcessorConfig(context_dim=ARCH["context_dim"], seq_len=SEQ)
    prompts = jsd.PromptEmbeddings(jnp.asarray(d["cond"]), jnp.asarray(d["uncond"]), pcfg)
    guids = {w: jsd.StableDiffusionGuidance(jsd.StableDiffusionConfig(**ARCH, **SCHED, weighting_strategy=w))
             for w in WEIGHTINGS}
    shared_unet(guids.values())
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(d["u"]))
        mp.setattr(jax.random, "normal",
                   lambda key, shape, *a, **k: jnp.asarray(d["noise"].transpose(0, 2, 3, 1)))
        def all_weightings(rgb):
            res = {}
            for w, g in guids.items():
                def loss(x, g=g):
                    o = g.sds_loss(jparams, prompts, jax.random.PRNGKey(0), x, d["el"], d["az"],
                                   d["dist"], STEP, rgb_as_latents=as_latents)
                    return o["loss_sds"], o
                res[w] = jax.value_and_grad(loss, has_aux=True)(rgb)
            return res

        rgb = d["rgb4" if as_latents else "rgb3"]
        for w, ((_, o), grad) in jax.jit(all_weightings).lower(rgb).compile(FAST_COMPILE)(rgb).items():
            out[w] = ({k: float(v) for k, v in o.items()}, np.asarray(grad))
    return out


def check_sds_loss(sd_pair, draws, jax_out, as_latents, weighting):
    """The port's ``sds_loss`` against ``jax_out[weighting]``."""
    guidance, _, _, _ = sd_pair
    d = draws
    g = psd.StableDiffusionGuidance(psd.StableDiffusionConfig(**ARCH, **SCHED, weighting_strategy=weighting),
                                    modules=guidance.modules)
    prompts = psd.PromptEmbeddings(torch.as_tensor(d["cond"]), torch.as_tensor(d["uncond"]),
                                   psd.PromptProcessorConfig(context_dim=ARCH["context_dim"], seq_len=SEQ))
    rgb = torch.as_tensor(d["rgb4" if as_latents else "rgb3"]).requires_grad_(True)
    out = g.sds_loss(prompts, rgb, torch.as_tensor(d["el"]), torch.as_tensor(d["az"]),
                     torch.as_tensor(d["dist"]), STEP, rgb_as_latents=as_latents,
                     u=torch.as_tensor(d["u"]), noise=torch.as_tensor(d["noise"]))
    out["loss_sds"].backward()
    jout, jgrad = jax_out[weighting]
    min_p, max_p = C_jax(SCHED["min_step_percent"], STEP), C_jax(SCHED["max_step_percent"], STEP)
    t_jax = np.clip((min_p * 1000 + jnp.asarray(d["u"]) * (max_p - min_p) * 1000).astype(jnp.int32), 1, 999)
    np.testing.assert_array_equal(out["t"].numpy(), np.asarray(t_jax))
    for k in ("loss_sds", "grad_norm"):
        got, want = float(out[k].detach()), jout[k]
        print(f"{k}: {got!r} vs JAX {want!r}")
        assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    _close(rgb.grad.numpy(), jgrad, 1e-3, "d loss / d rgb")


@pytest.fixture(scope="module")
def jax_sds(sd_pair, draws):
    return jax_sds_outputs(sd_pair, draws, as_latents=False)


@pytest.mark.parametrize("weighting", WEIGHTINGS)
def test_sds_loss_matches_jax(sd_pair, draws, jax_sds, weighting):
    check_sds_loss(sd_pair, draws, jax_sds, False, weighting)


def test_sd_checkpoint_loads_like_jax(sd_pair, tmp_path):
    guidance, jguid, _, sd = sd_pair
    rng = np.random.default_rng(5)
    text = {"embeddings.token_embedding.weight": (16, 32), "embeddings.position_embedding.weight": (6, 32),
            "final_layer_norm.weight": (32,), "final_layer_norm.bias": (32,)}
    lp = "encoder.layers.0"
    for n in ("layer_norm1", "layer_norm2"):
        text.update({f"{lp}.{n}.weight": (32,), f"{lp}.{n}.bias": (32,)})
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        text.update({f"{lp}.self_attn.{n}.weight": (32, 32), f"{lp}.self_attn.{n}.bias": (32,)})
    text.update({f"{lp}.mlp.fc1.weight": (64, 32), f"{lp}.mlp.fc1.bias": (64,),
                 f"{lp}.mlp.fc2.weight": (32, 64), f"{lp}.mlp.fc2.bias": (32,)})
    full = dict(sd)
    full.update({f"cond_stage_model.transformer.text_model.{k}": rng.normal(size=s).astype(np.float32)
                 for k, s in text.items()})
    full["cond_stage_model.transformer.text_model.embeddings.position_ids"] = np.arange(6)[None]
    for k in ("betas", "alphas_cumprod", "model_ema.decay", "first_stage_model.loss.logvar", "stray.weight"):
        full[k] = np.ones(3, np.float32)
    _, jreport = convert_sd_state_dict(full, jguid)
    assert jreport["unmapped"] == ["stray.weight"]

    path = tmp_path / "sd.ckpt"
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in full.items()}}, path)
    fresh = psd.StableDiffusionModules(guidance.cfg, device="cpu")
    report = pckpt.load_sd_checkpoint(str(path), fresh)
    assert report["unmapped"] == jreport["unmapped"]
    assert report["skipped"] == jreport["skipped"]
    assert sorted(report["consumed"] + report["text"]) == jreport["consumed"]
    assert len(report["text"]) == len(text)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(KeyError, match="stray.weight"):
        pckpt.load_sd_checkpoint(str(path), fresh, strict=True)
    with pytest.raises(ValueError, match="directory"):
        pckpt.load_sd_checkpoint(str(tmp_path), fresh)
