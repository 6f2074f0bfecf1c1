"""The port's guidance zoo (ControlNet, InstructPix2Pix, DeepFloyd) against
the JAX package (CPU, tiny widths).

Widths: the UNet 16 × [1, 2], 1 res block, 2 heads, context 32 (DeepFloyd
64), renders and hints at 64², the VAE 8 × [1, 2, 4, 4] with 1 res block
(64² → 8² latents, the factor of 8 the ControlNet's hint encoder is built
for).  Every weight is a seeded numpy draw in the JAX package's tree, the
zero-initialised layers (the ControlNet's residual projections and hint
output, the UNet's output convolutions) drawn non-zero too, drawn in the
port's state dict and carried to the JAX trees by the JAX package's
converter.  Bands (float32):

- the UNet with ``control`` (the ControlNet's residuals) ≤ 1e-4 of max;
  zero residuals change nothing (bit-equal);
- ``canny_hint`` / ``normal_hint`` ≤ 1e-6;
- the ControlNet's residuals ≤ 1e-4 of each one's max;
- ``make_hint`` by ``control_type`` (normal: the normals' hint, canny:
  the renders' edges); the ControlNet with a given hint through the
  residuals above;
- the ControlNet (its canny hint), DeepFloyd and
  InstructPix2Pix losses on the same draws (``jax.random.uniform`` /
  ``normal`` monkeypatched to the test's u and ε): the timesteps equal,
  ``loss_sds`` and ``grad_norm`` ≤ 1e-5 relative, d loss / d rgb ≤ 1e-3 of
  its max;
- ``deep-floyd-prompt-processor`` and ``stable-diffusion-prompt-processor``
  give bit-equal embeddings, the JAX package's too;
- the parameters round trip exactly: the port's seeded weights → the JAX
  trees (the JAX package's converter pieces; the ControlNet's tree has the
  structure and shapes of the JAX ``ControlNetModel``'s own init) →
  ``convert.sd_guidance_params`` → the same weights.

Each JAX function runs under one ``jax.jit`` with XLA's cheaper passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import jit_fast
from test_torch_zoo_sd import _close

from dreammesh4d_tpu.models.guidance import controlnet as jcn
from dreammesh4d_tpu.models.guidance import deep_floyd as jdf
from dreammesh4d_tpu.models.guidance import instructpix2pix as jip
from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.models.guidance.zero123 import convert as jconv
from dreammesh4d_tpu.utils.schedule import C_jax
from dreammesh4d_tpu_torch import convert, registry
from dreammesh4d_tpu_torch.models.guidance import controlnet as pcn
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd

TINY = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, num_heads=2, context_dim=32,
            latent_size=16, image_size=64, min_step_percent=0.2, max_step_percent=0.6, vae_ch=8,
            vae_ch_mult=(1, 2, 4, 4), vae_num_res_blocks=1)
FLOYD = dict(TINY, context_dim=64, image_size=32, latent_size=32)
B, SEQ, STEP = 2, 6, 10
NAMES = {"controlnet": ("stable-diffusion-controlnet-guidance", jcn.ControlNetGuidance, jcn.ControlNetConfig),
         "ip2p": ("stable-diffusion-instructpix2pix-guidance", jip.InstructPix2PixGuidance,
                  jip.InstructPix2PixConfig),
         "floyd": ("deep-floyd-guidance", jdf.DeepFloydGuidance, jdf.DeepFloydConfig)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arch(kind):
    return dict(FLOYD if kind == "floyd" else TINY, guidance_scale=7.5, **(
        {"control_type": "canny"} if kind == "controlnet" else {}))


def seeded_state_dict(modules, seed):
    """A numpy draw for every entry of the port's state dict: weights
    N(0, 1/fan_in), norm scales around 1, biases around 0 (the
    zero-initialised layers drawn too)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in modules.state_dict().items():
        shape = tuple(v.shape)
        if len(shape) > 1:
            out[k] = (rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        else:
            out[k] = ((1.0 if k.endswith("weight") else 0.0) + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return out


def jax_controlnet_tree(sd, channel_mult, num_res_blocks, pre="control_model."):
    """The JAX ``ControlNetModel`` tree of the port's ``control_model.*``
    entries, through the JAX package's own converter pieces."""
    sub = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    p = {k: v for k, v in jconv.convert_unet(
        {**sub, **{k: v for k, v in dummy_up(channel_mult, num_res_blocks).items()}}, channel_mult,
        num_res_blocks).items() if not k.startswith("up_") and k not in ("norm_out", "conv_out")}
    n_hint = (len([k for k in sub if k.startswith("input_hint_block.") and k.endswith(".weight")]) - 1)
    for i in range(n_hint):
        p[f"hint_{i}"] = jconv._conv(sub, f"input_hint_block.{2 * i}")
    p["hint_out"] = jconv._conv(sub, f"input_hint_block.{2 * n_hint}")
    n_zero = len([k for k in sub if k.startswith("zero_convs.") and k.endswith(".weight")])
    for i in range(n_zero):
        p[f"zero_{i}"] = jconv._conv(sub, f"zero_convs.{i}.0")
    p[f"zero_{n_zero}"] = jconv._conv(sub, "middle_block_out.0")
    return p


def dummy_up(channel_mult, num_res_blocks):
    """Placeholder up-path entries for ``convert_unet`` (a ControlNet has
    none; they are dropped after the walk)."""
    from dreammesh4d_tpu_torch.models.guidance.zero123.unet import UNetModel

    with torch.device("meta"):
        unet = UNetModel(in_channels=4, model_channels=TINY["model_channels"], channel_mult=channel_mult,
                         num_res_blocks=num_res_blocks, num_heads=2, context_dim=TINY["context_dim"])
    return {k: np.zeros(tuple(v.shape), np.float32) for k, v in unet.state_dict().items()
            if k.startswith(("output_blocks.", "out."))}


@pytest.fixture(scope="module")
def pairs():
    """kind → (port guidance, JAX guidance, JAX params as numpy, the port's
    state dict): the port's weights drawn, the JAX trees through the JAX
    package's converter."""
    out = {}
    for seed, (kind, (name, jcls, jcfg)) in enumerate(NAMES.items()):
        jguid = jcls(jcfg(**arch(kind)))
        guidance = registry.find(name)(arch(kind), device="cpu")
        sd = seeded_state_dict(guidance.modules, seed)
        guidance.modules.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        cm, nrb = TINY["channel_mult"], TINY["num_res_blocks"]
        if kind == "floyd":
            pre = "model.diffusion_model."
            jparams = {"unet": jconv.convert_unet({k[len(pre):]: v for k, v in sd.items()}, cm, nrb)}
        else:
            jparams, report = jconv.convert_sd_state_dict(sd, jguid)
            assert report["unmapped"] == sorted(k for k in sd if k.startswith("control_model."))
        if kind == "controlnet":
            jparams["controlnet"] = jax_controlnet_tree(sd, cm, nrb)
        out[kind] = (guidance, jguid, jparams, sd)
    return out


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(3)
    c = TINY["context_dim"]
    return {"rgb": rng.random((B, 64, 64, 3), dtype=np.float32),
            "cond_rgb": rng.random((B, 64, 64, 3), dtype=np.float32),
            "normal": rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32),
            "el": np.float32([10.0, 70.0]), "az": np.float32([30.0, -170.0]), "dist": np.float32([3.8, 3.8]),
            "u": np.float32([0.3, 0.9]), "noise": rng.normal(size=(B, 4, 8, 8)).astype(np.float32),
            "noise_px": rng.normal(size=(B, 3, 32, 32)).astype(np.float32),
            "cond": (0.5 * rng.normal(size=(5, SEQ, c))).astype(np.float32),
            "uncond": (0.5 * rng.normal(size=(SEQ, c))).astype(np.float32),
            "cond64": (0.5 * rng.normal(size=(5, SEQ, 64))).astype(np.float32),
            "uncond64": (0.5 * rng.normal(size=(SEQ, 64))).astype(np.float32),
            "x": rng.normal(size=(B, 8, 8, 4)).astype(np.float32), "t": np.int32([100, 700]),
            "ctx": (0.5 * rng.normal(size=(B, SEQ, c))).astype(np.float32)}


def test_params_round_trip_exactly(pairs):
    """The port's weights → the JAX trees (the JAX package's converter) →
    ``convert.sd_guidance_params`` → the same weights, bit for bit; the
    JAX trees have the shapes of the JAX guidances' own ``init_params``."""
    for kind, (guidance, jguid, jparams, sd) in pairs.items():
        back = convert.sd_guidance_params(jparams, guidance.cfg)
        assert sorted(back) == sorted(sd), kind
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert ("first_stage_model.encoder.conv_in.weight" in sd) == (kind != "floyd")
        if kind == "controlnet":  # the branch's tree as the JAX guidance builds it, leaf for leaf
            S, L, c = TINY["image_size"], TINY["image_size"] // 8, TINY["context_dim"]
            shapes = jax.eval_shape(lambda k: jguid.controlnet.init(
                k, jnp.zeros((1, L, L, 4)), jnp.zeros((1, S, S, 3)), jnp.zeros((1,)), jnp.zeros((1, 77, c)))["params"],
                jax.random.PRNGKey(0))
            got = jax.tree_util.tree_map(np.shape, jparams["controlnet"])
            want = jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes)
            assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
            assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)


def test_prompt_processor_names_bit_equal():
    jpp = jsd.StableDiffusionPromptProcessor(jsd.PromptProcessorConfig(prompt="a test", context_dim=64))()
    got = [registry.find(n)({"prompt": "a test", "context_dim": 64}, device="cpu")()
           for n in ("deep-floyd-prompt-processor", "stable-diffusion-prompt-processor")]
    for p in got:
        np.testing.assert_array_equal(p.cond.numpy(), np.asarray(jpp.cond))
        np.testing.assert_array_equal(p.uncond.numpy(), np.asarray(jpp.uncond))


def test_hints_match_jax(draws):
    img = draws["rgb"].copy()
    img[:, :, 32:] += 0.8  # a hard vertical edge over the noise
    # the ramp (mag - low) / (high - low) scales the Sobel magnitude's float32 rounding (one ulp
    # of ~4 is 4.8e-7) by 1 / (high - low): the band is 1e-6 of the magnitude's max before it
    mag = np.abs(np.asarray(jcn.canny_hint(img, 0.0, 1e9))).max() * 1e9
    for low, high in ((0.1, 0.3), (0.5, 2.0)):
        want = np.asarray(jit_fast(lambda x: jcn.canny_hint(x, low, high))(img))
        got = pcn.canny_hint(torch.as_tensor(img), low, high).numpy()
        err = np.abs(got - want).max()
        print(f"canny_hint ({low}, {high}): max |d| {err:.3g}, band {1e-6 * mag / (high - low):.3g}")
        assert err <= 1e-6 * mag / (high - low) and 0 < want.mean() < 1
    np.testing.assert_allclose(pcn.normal_hint(torch.as_tensor(draws["normal"])).numpy(),
                               np.asarray(jcn.normal_hint(draws["normal"])), rtol=0, atol=1e-6)
    # make_hint by control_type: the normals' hint, or the renders' edges; normal needs normals
    cfg = dict(TINY, vae_ch_mult=(1,))
    for kind in ("normal", "canny"):
        jg = jcn.ControlNetGuidance(jcn.ControlNetConfig(**cfg, control_type=kind))
        g = registry.find("stable-diffusion-controlnet-guidance")({**cfg, "control_type": kind}, device="cpu")
        want = np.asarray(jg.make_hint(img, draws["normal"]))
        got = g.make_hint(torch.as_tensor(img), torch.as_tensor(draws["normal"])).numpy()
        assert np.abs(got - want).max() <= (1e-6 if kind == "normal" else 1e-6 * mag / 0.2)
    with pytest.raises(ValueError, match="normals"):
        g = registry.find("stable-diffusion-controlnet-guidance")({**cfg, "control_type": "normal"}, device="cpu")
        g.make_hint(torch.as_tensor(img))


@pytest.fixture(scope="module")
def jax_control(pairs, draws):
    """The JAX ControlNet's residuals (its zero layers drawn) and the UNet
    with and without them, in one jit."""
    _, jguid, jparams, _ = pairs["controlnet"]
    d = draws
    hint = d["cond_rgb"]

    def run(x, t, ctx):
        control = jguid.controlnet.apply({"params": jparams["controlnet"]}, x, hint, t, ctx)
        eps = jguid.unet.apply({"params": jparams["unet"]}, x, t, ctx, control=control)
        return control, eps

    control, eps = jit_fast(run)(d["x"], d["t"], d["ctx"])
    return jax.tree_util.tree_map(np.asarray, control), np.asarray(eps)


def test_controlnet_residuals_and_unet_control_match_jax(pairs, draws, jax_control):
    guidance = pairs["controlnet"][0]
    mod = guidance.modules
    d = draws
    x, t, ctx = (torch.as_tensor(d["x"]).permute(0, 3, 1, 2), torch.as_tensor(d["t"]).long(),
                 torch.as_tensor(d["ctx"]))
    with torch.no_grad():
        control = mod.control_model(x, torch.as_tensor(d["cond_rgb"]).permute(0, 3, 1, 2), t, ctx)
        want_control, want_eps = jax_control
        assert len(control["down"]) == len(want_control["down"])
        for i, (a, b) in enumerate(zip(control["down"] + [control["mid"]], want_control["down"] + [want_control["mid"]])):
            _close(a.permute(0, 2, 3, 1).numpy(), b, 1e-4, f"residual {i}")
        eps = mod.unet(x, t, ctx, control=control)
        _close(eps.permute(0, 2, 3, 1).numpy(), want_eps, 1e-4, "UNet with control")
        zero = {"down": [torch.zeros_like(r) for r in control["down"]], "mid": torch.zeros_like(control["mid"])}
        np.testing.assert_array_equal(mod.unet(x, t, ctx, control=zero).numpy(), mod.unet(x, t, ctx).numpy())
    with pytest.raises(ValueError, match="halvings"):
        mod.control_model(x, torch.zeros((B, 3, 32, 32)), t, ctx)


def jax_losses(pairs, draws):
    """Each JAX loss's value and d / d rgb on the test's draws: kind → (outputs, grad)."""
    d = draws
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        noise = {"now": None}
        mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(d["u"]))
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise["now"]))
        cases = {
            "controlnet_canny": ("controlnet", d["noise"], lambda g, p, pr, r: g.sds_loss(
                p, pr, jax.random.PRNGKey(0), r, d["el"], d["az"], d["dist"], STEP)),
            "ip2p": ("ip2p", d["noise"], lambda g, p, pr, r: g.edit_loss(
                p, pr, jax.random.PRNGKey(0), r, d["cond_rgb"], d["el"], d["az"], STEP)),
            "floyd": ("floyd", d["noise_px"], lambda g, p, pr, r: g.sds_loss(
                p, pr, jax.random.PRNGKey(0), r, d["el"], d["az"], d["dist"], STEP)),
        }
        for case, (kind, eps, fn) in cases.items():
            _, jguid, jparams, _ = pairs[kind]
            wide = kind == "floyd"
            pcfg = jsd.PromptProcessorConfig(context_dim=64 if wide else 32, seq_len=SEQ)
            prompts = jsd.PromptEmbeddings(jnp.asarray(d["cond64" if wide else "cond"]),
                                           jnp.asarray(d["uncond64" if wide else "uncond"]), pcfg)
            noise["now"] = eps.transpose(0, 2, 3, 1)

            def loss(r, fn=fn, jguid=jguid, jparams=jparams, prompts=prompts):
                o = fn(jguid, jparams, prompts, r)
                return o["loss_sds"], o

            (_, o), grad = jit_fast(jax.value_and_grad(loss, has_aux=True))(d["rgb"])
            out[case] = ({k: float(v) for k, v in o.items()}, np.asarray(grad))
    return out


@pytest.fixture(scope="module")
def jax_out(pairs, draws):
    return jax_losses(pairs, draws)


@pytest.mark.parametrize("case", ["controlnet_canny", "ip2p", "floyd"])
def test_losses_match_jax(pairs, draws, jax_out, case):
    d = draws
    kind = case.split("_")[0]
    guidance = pairs[kind][0]
    wide = kind == "floyd"
    prompts = psd.PromptEmbeddings(torch.as_tensor(d["cond64" if wide else "cond"]),
                                   torch.as_tensor(d["uncond64" if wide else "uncond"]),
                                   psd.PromptProcessorConfig(context_dim=64 if wide else 32, seq_len=SEQ))
    rgb = torch.as_tensor(d["rgb"]).requires_grad_(True)
    el, az, dist = (torch.as_tensor(d[k]) for k in ("el", "az", "dist"))
    draw = {"u": torch.as_tensor(d["u"]), "noise": torch.as_tensor(d["noise_px" if wide else "noise"])}
    if kind == "ip2p":
        out = guidance.edit_loss(prompts, rgb, torch.as_tensor(d["cond_rgb"]), el, az, STEP, **draw)
    else:
        out = guidance.sds_loss(prompts, rgb, el, az, dist, STEP, **draw)
    out["loss_sds"].backward()
    jout, jgrad = jax_out[case]
    cfg = guidance.cfg
    min_p, max_p = C_jax(cfg.min_step_percent, STEP), C_jax(cfg.max_step_percent, STEP)
    t_jax = np.clip((min_p * 1000 + jnp.asarray(d["u"]) * (max_p - min_p) * 1000).astype(jnp.int32), 1, 999)
    np.testing.assert_array_equal(out["t"].numpy(), np.asarray(t_jax))
    for k in ("loss_sds", "grad_norm"):
        got, want = float(out[k].detach()), jout[k]
        print(f"{case} {k}: {got!r} vs JAX {want!r}")
        assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (case, k, got, want)
    _close(rgb.grad.numpy(), jgrad, 1e-3, f"{case} d loss / d rgb")
