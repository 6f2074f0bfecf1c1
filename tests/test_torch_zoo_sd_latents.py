"""The port's SDS with ``rgb_as_latents`` and the vanilla
``zero123-guidance`` against the JAX package (CPU, tiny widths).

- SD ``sds_loss`` with ``rgb_as_latents`` (a 4-channel render resized to
  the latents), each weighting, on the weights, draws and bands of
  ``test_torch_zoo_sd.py``: the timesteps equal, ``loss_sds`` and
  ``grad_norm`` within 1e-5 relative, d loss/d rgb within 1e-3 of its max;
- ``find("zero123-guidance")`` (the distance-delta camera embedding)
  against the JAX ``unified.Zero123Guidance`` (seeded weights carried by
  the JAX ``convert_state_dict``, no CLIP): the embedding within 1e-6,
  ``loss_sds`` and ``grad_norm`` within 1e-5 relative and d loss/d rgb
  within 1e-3 of its max on the same draws; the stable variant's loss lies
  outside that band.

Each JAX function runs under one ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo_sd import (L, STEP, WEIGHTINGS, _close, _one_torch_thread, check_sds_loss,  # noqa: F401
                               draws, jax_sds_outputs, sd_pair)

from dreammesh4d_tpu.models.guidance import unified as junified
from dreammesh4d_tpu.models.guidance.zero123 import guidance as jg
from dreammesh4d_tpu.models.guidance.zero123.convert import convert_state_dict
from dreammesh4d_tpu_torch.models.guidance.zero123 import guidance as pg
from dreammesh4d_tpu_torch.registry import find


@pytest.fixture(scope="module")
def jax_sds_latents(sd_pair, draws):
    return jax_sds_outputs(sd_pair, draws, as_latents=True)


@pytest.mark.parametrize("weighting", WEIGHTINGS)
def test_sds_loss_as_latents_matches_jax(sd_pair, draws, jax_sds_latents, weighting):
    check_sds_loss(sd_pair, draws, jax_sds_latents, True, weighting)


Z_TINY = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, num_heads=2, context_dim=16,
              vae_ch=8, vae_ch_mult=(1, 2), vae_num_res_blocks=1, latent_size=8, image_size=16,
              use_clip=False, guidance_scale=3.0, cond_camera_distance=1.5, cond_elevation_deg=10.0)


def test_zero123_guidance_matches_jax_unified(draws, monkeypatch):
    """``find("zero123-guidance")`` against ``unified.Zero123Guidance``."""
    d = draws
    cls = find("zero123-guidance")
    assert cls is pg.Zero123Guidance and issubclass(cls, pg.StableZero123Guidance)
    guidance = cls(pg.Zero123Config(**Z_TINY), device="cpu")
    rng = np.random.default_rng(7)
    sd = {k: (rng.normal(size=tuple(v.shape)) / np.sqrt(max(v[0].numel(), 1))).astype(np.float32)
          for k, v in guidance.modules.state_dict().items()}
    guidance.modules.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    jguid = junified.Zero123Guidance(jg.Zero123Config(**Z_TINY))
    jparams, report = convert_state_dict({k: v for k, v in sd.items() if k != "clip_proj"}, jguid.modules)
    assert report["unmapped"] == []
    jparams["clip_proj"] = sd["clip_proj"]
    bank = {"c_crossattn": torch.as_tensor(rng.normal(size=(1, 16)).astype(np.float32)),
            "c_concat": torch.as_tensor(rng.normal(size=(1, 4, L, L)).astype(np.float32))}
    jbank = {"c_crossattn": jnp.asarray(bank["c_crossattn"].numpy()),
             "c_concat": jnp.asarray(bank["c_concat"].numpy().transpose(0, 2, 3, 1))}
    args = [torch.as_tensor(d[k]) for k in ("el", "az", "dist")]
    np.testing.assert_allclose(
        guidance.camera_embedding(*args).numpy(),
        np.asarray(junified.zero123_delta_T(d["el"], d["az"], d["dist"], 10.0, 0.0, 1.5)), atol=1e-6)

    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(d["u"]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(d["noise"].transpose(0, 2, 3, 1)))

    def j_loss(rgb):
        out = jguid.sds_loss(jparams, jbank, jax.random.PRNGKey(0), rgb, d["el"], d["az"], d["dist"],
                             None, STEP)
        return out["loss_sds"], out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(d["rgb3"])
    rgb = torch.as_tensor(d["rgb3"]).requires_grad_(True)
    kw = dict(u=torch.as_tensor(d["u"]), noise=torch.as_tensor(d["noise"]))
    out = guidance.sds_loss(bank, rgb, *args, None, STEP, **kw)
    out["loss_sds"].backward()
    for k in ("loss_sds", "grad_norm"):
        got, want = float(out[k].detach()), float(jout[k])
        print(f"{k}: {got!r} vs JAX {want!r}")
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    _close(rgb.grad.numpy(), jgrad, 1e-3, "d loss / d rgb")
    stable = pg.StableZero123Guidance(guidance.cfg, modules=guidance.modules)
    with torch.no_grad():
        other = float(stable.sds_loss(bank, rgb, *args, None, STEP, **kw)["loss_sds"])
    # the stable embedding's loss lies outside the band the vanilla one meets
    assert abs(other - float(jout["loss_sds"])) > 10 * 1e-5 * abs(float(jout["loss_sds"]))
